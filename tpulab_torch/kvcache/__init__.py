"""Hierarchical prefix and KV cache of the ``PagedEngine``: the radix-tree
partial-hit index over the device block pool, and the host-RAM spill tier
that cold evictions land in and admissions restore from."""

from tpulab_torch.kvcache.radix import RadixPrefixIndex
from tpulab_torch.kvcache.spill import (
    DEFAULT_WATERMARK,
    SPILL_DTYPES,
    HostSpillTier,
    SpillPolicy,
)

__all__ = ["RadixPrefixIndex", "HostSpillTier", "SpillPolicy", "SPILL_DTYPES",
           "DEFAULT_WATERMARK"]
