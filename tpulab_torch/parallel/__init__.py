"""Attention building blocks shared by the model tier (dense oracle, flash dispatch)."""
