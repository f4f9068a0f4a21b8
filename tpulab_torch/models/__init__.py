"""The model tier: the labformer, its int8 decode weights, and generation."""
