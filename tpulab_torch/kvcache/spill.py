"""Host-RAM spill tier for cold KV blocks (the counterpart of
``tpulab.kvcache.spill``).

When the radix prefix index evicts a cold leaf whose block nothing live
references, the engine hands the block's KV here instead of dropping it;
an admission that walks back onto that prefix restores the block to the
device ahead of its prefill, so a spill hit costs a host-to-device copy,
never a recompute.

A payload is one block in the pool's own representation, on the host: a
torch CPU tensor ``(L, BS, kv, d)`` in the pool's dtype for a dense pool,
or the ``(int8 data, f32 scale (L, BS, kv))`` pair of an int8 pool.

* ``dtype="native"`` stores the payload as it is, so a round trip is
  lossless for both pool kinds and spill-armed streams stay bit-identical
  to a spill-free engine's.
* ``dtype="int8"`` and ``"int4"`` re-encode to a smaller host footprint
  (symmetric amax over the head dim; int4 packs two nibbles a byte with
  :func:`~tpulab_torch.models.quant.pack_int4`).  Lossy for dense pools.
  The arithmetic is ``tpulab``'s, in numpy over float32: a bfloat16
  payload widens to float32 exactly first (numpy has no bfloat16), so the
  encoded bytes equal ``tpulab``'s for the same values.

Keys are opaque bytes (the engine's sha256 digest chain over the
block-aligned token prefix).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from tpulab_torch.models.quant import pack_int4, unpack_int4

SPILL_DTYPES = ("native", "int8", "int4")

#: Proactive-spill watermark: below the 0.95 occupancy at which
#: ``tpulab``'s ``kv_occupancy_high`` alert warns, so the cache tier sheds
#: cold blocks to the host before that alert fires.
DEFAULT_WATERMARK = 0.90


class SpillPolicy:
    """When and how much to spill at admission boundaries: past the
    ``watermark`` share of the pool in use, at most ``batch`` blocks an
    admission, so a pressure spike never turns one admission into an
    unbounded device-to-host stall."""

    def __init__(self, watermark: float = DEFAULT_WATERMARK, batch: int = 8) -> None:
        if not 0.0 < watermark <= 1.0:
            raise ValueError(f"watermark must be in (0, 1], got {watermark}")
        if batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        self.watermark = float(watermark)
        self.batch = int(batch)

    def overage(self, blocks_used: int, blocks_total: int) -> int:
        """How many blocks to shed now (0 below the watermark)."""
        if blocks_total <= 0:
            return 0
        limit = int(self.watermark * blocks_total)
        return max(0, min(self.batch, blocks_used - limit))


def _f32(x) -> np.ndarray:
    """A host payload as float32 numpy (bfloat16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _np_quant(x: np.ndarray, qmax: int) -> Tuple[np.ndarray, np.ndarray]:
    """(..., d) -> (int8 data, f32 scale (...,)): symmetric amax, the numpy
    mirror of ``paged._kv_quant`` generalized to ``qmax``."""
    xf = np.asarray(x, np.float32)
    scale = np.maximum(np.max(np.abs(xf), axis=-1), 1e-8) / float(qmax)
    q = np.clip(np.round(xf / scale[..., None]), -qmax, qmax).astype(np.int8)
    return q, scale.astype(np.float32)


def _np_dequant(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale[..., None].astype(np.float32)


def _to_pool(x: np.ndarray, pool_dtype: torch.dtype) -> torch.Tensor:
    """float32 numpy -> a torch tensor in the pool's dtype (round to
    nearest even, as numpy's ``astype`` to ``ml_dtypes.bfloat16`` does)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(pool_dtype)


def _pair(q, s) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.as_tensor(np.asarray(q)), torch.as_tensor(np.asarray(s))


def _encode(raw, dtype: str):
    """Pool-representation payload -> host entry for one K or V slab:
    ``raw`` is a dense tensor (a native pool's block) or an ``(int8,
    f32 scale)`` pair (an int8 pool's block)."""
    if dtype == "native":
        return ("raw", raw)
    if isinstance(raw, tuple):
        q, s = raw
        if dtype == "int8":  # already the pool's int8 representation
            return ("q8", (np.asarray(q), np.asarray(s)))
        x = _np_dequant(np.asarray(q), np.asarray(s))
    else:
        x = _f32(raw)
    if dtype == "int8":
        return ("q8", _np_quant(x, 127))
    q4, s4 = _np_quant(x, 7)
    packed, odd = pack_int4(q4)
    return ("q4", (packed, s4, q4.shape, odd))


def _decode(entry, pool_is_quantized: bool, pool_dtype: torch.dtype):
    """Host entry -> the pool's representation as torch CPU tensors (a
    dense tensor for a native pool, an (int8, scale) pair for an int8
    pool)."""
    kind, payload = entry
    if kind == "raw":
        return payload
    if kind == "q8":
        q, s = payload
        if pool_is_quantized:
            return _pair(q, s)
        return _to_pool(_np_dequant(q, s), pool_dtype)
    packed, s4, shape, odd = payload
    x = _np_dequant(unpack_int4(packed, odd).reshape(shape), s4)
    if pool_is_quantized:
        return _pair(*_np_quant(x, 127))
    return _to_pool(x, pool_dtype)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.numel() * x.element_size())
    return int(x.nbytes)


def _entry_nbytes(entry) -> int:
    """Bytes an entry holds: the payload's data, plus its scales where it
    has them (``tpulab``'s charge; an int4 entry's shape and padding flag
    are not counted)."""
    kind, payload = entry
    if kind == "raw" and not isinstance(payload, tuple):
        return _nbytes(payload)
    return _nbytes(payload[0]) + _nbytes(payload[1])


class HostSpillTier:
    """Bounded LRU host cache of spilled KV blocks.

    One entry per block: ``put(key, kraw, vraw)`` at eviction, ``get(key)``
    at prefetch (it freshens and does not remove: the block may be evicted
    and spilled again cheaply).  At capacity the tier drops its least
    recently used entry (``dropped`` counts them); a dropped block falls
    back to prefill recompute, never an error."""

    def __init__(self, capacity_blocks: int, dtype: str = "native") -> None:
        if capacity_blocks <= 0:
            raise ValueError(f"capacity_blocks must be positive, got {capacity_blocks}")
        if dtype not in SPILL_DTYPES:
            raise ValueError(f"spill dtype={dtype!r}; expected one of {SPILL_DTYPES}")
        self.capacity = int(capacity_blocks)
        self.dtype = dtype
        self._entries: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._nbytes = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def put(self, key: bytes, kraw, vraw) -> int:
        """Insert (or refresh) one block; the entry's encoded bytes, which
        the handoff charges as what crossed in the host format."""
        old = self._entries.pop(key, None)
        if old is not None:
            self._nbytes -= _entry_nbytes(old[0]) + _entry_nbytes(old[1])
        while len(self._entries) >= self.capacity:
            _, (ek, ev) = self._entries.popitem(last=False)
            self._nbytes -= _entry_nbytes(ek) + _entry_nbytes(ev)
            self.dropped += 1
        entry = (_encode(kraw, self.dtype), _encode(vraw, self.dtype))
        self._entries[key] = entry
        nbytes = _entry_nbytes(entry[0]) + _entry_nbytes(entry[1])
        self._nbytes += nbytes
        return nbytes

    def get(self, key: bytes, *, pool_is_quantized: bool,
            pool_dtype: torch.dtype) -> Optional[tuple]:
        """``(kblk, vblk)`` decoded into the pool's representation, or None."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        return (_decode(entry[0], pool_is_quantized, pool_dtype),
                _decode(entry[1], pool_is_quantized, pool_dtype))

    def clear(self) -> None:
        self._entries.clear()
        self._nbytes = 0
