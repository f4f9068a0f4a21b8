"""Kernel B7: single-token decode attention read in place from the paged
KV pools (the counterpart of ``tpulab.ops.pallas.paged``).

B7 replaces ``tpulab/ops/pallas/paged.py::_kernel`` as reached through
``paged_attend_pallas``.  :func:`paged_attend_kernel` takes that function's
arguments and layout: ``q`` (slots, 1, heads, head_dim); per-layer pools
(blocks, block_size, kv_heads, head_dim) in q's dtype, or ``(int8 data,
f32 scale (blocks, block_size, kv_heads))`` pairs; ``tables`` (slots, M)
int32 mapping each slot's logical block to a pool block; ``lengths``
(slots,) int32, the number of keys each slot's query sees.  It returns
(slots, 1, heads, head_dim) in q's dtype.  Query head ``i`` reads kv head
``i // (heads // kv_heads)``.

The function is the Pallas kernel's, which rounds otherwise than the
engine's gather path (``models/paged.py::_paged_attend``):

- q is divided by ``sqrt(head_dim)`` rounded to q's dtype, in q's dtype;
- scores are q times k, both in q's dtype, summed in f32; a key at or past
  ``length``, or with ``window > 0`` at or below ``length - 1 - window``,
  is masked with ``NEG_INF`` (the float32 minimum);
- the running max, denominator and accumulator are f32, ``p`` is not
  rounded, v is widened to f32, and the output is ``acc / l`` rounded once
  to q's dtype;
- an int8 pool holds ``round(x / scale)``; both read paths see
  ``(int8 -> f32) * scale`` rounded to q's dtype;
- a slot of length 0 sees no key and gives NaN (0 / 0); engines never
  read an idle slot.

:func:`paged_attend_plain` computes that function in one pass (gather by
the table, then a masked f32 softmax) and is the CPU path and the
kernel's oracle; the two sum in other orders and are held to
:func:`paged_over_tolerance`.

The kernel splits each slot's key range across blocks (flash-decoding,
``csrc/paged_decode.cu``): :func:`split_plan` picks the splits and each
one's span from the shapes and the SM count alone, so a call reads no
length back to the host and its grid depends on shapes only.  Each split
writes its partial (max, denominator, accumulator) to a workspace; the
block that draws a (slot, kv head) counter's last ticket merges the
partials in split order within the same launch and resets the counter.
The workspace and the counters are made once per shape and device
(:func:`_workspace`), so a call allocates nothing in the steady state and
repeated calls give the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import numpy as np
import torch

from tpulab_torch.ops.cuda import _build
from tpulab_torch.runtime.fpenv import ensure_nearest
from tpulab_torch.ops.cuda.attention import DTYPES, HEAD_DIMS, o_tolerance

NEG_INF = float(np.finfo(np.float32).min)
#: threads per block of csrc/paged_decode.cu
THREADS = 128
#: query rows of a kv head's group that one block holds (zero-padded)
ROWS = 4
#: shared-memory stages of the kernel's K/V stream
STAGES = 3
#: streaming multiprocessors of an H100 SXM
SMS = 132
#: blocks resident on an SM (the kernel's launch bounds cap a thread at
#: 128 registers for 4 blocks of 128 threads; a bf16 block's 48 KB stages
#: allow 4 too): the split fills one wave of them
BLOCKS_PER_SM = 4
#: the most chunks one split covers, which bounds its table entries
MAX_SPAN_CHUNKS = 64


def chunk_positions(d: int) -> int:
    """Key positions the kernel streams per step at head dim ``d`` (``CK``:
    4 warps, 32 / (d / 8) keys a warp reads at once, 4 keys a lane group)."""
    return 4096 // d


def row_blocks(g: int) -> int:
    """Blocks that share one kv head's group of ``g`` query rows."""
    return -(-g // ROWS)


def split_plan(slots: int, kv_heads: int, positions: int, d: int, row_blocks: int = 1,
               sms: int = SMS) -> Tuple[int, int]:
    """``(splits, span)``: how many blocks share each slot's key range, and
    the positions each covers (a multiple of the chunk).  A function of the
    shapes and the SM count alone, never of the lengths: as many splits as
    one wave of ``BLOCKS_PER_SM`` blocks on each SM holds (so no second,
    part-empty wave trails), at most one per chunk, and at least enough
    that no span exceeds ``MAX_SPAN_CHUNKS`` chunks."""
    ck = chunk_positions(d)
    chunks = max(1, -(-positions // ck))
    groups = max(1, slots * kv_heads * row_blocks)
    splits = min(chunks, max(1, BLOCKS_PER_SM * sms // groups))
    splits = max(splits, -(-chunks // MAX_SPAN_CHUNKS))
    span = -(-chunks // splits) * ck
    return max(1, -(-positions // span)), span


def table_entries(span: int, block_size: int, max_blocks: int) -> int:
    """Table entries a block stages: its span's, one more where the span
    straddles a block."""
    return min(max_blocks, -(-span // block_size) + 1)


def shared_bytes(d: int, itemsize: int, quantized: bool, entries: int) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes: the K/V
    stages (rows of ``d`` stored elements of ``itemsize`` bytes, and for
    int8 pools each row's two scales), which the merge of the 4 warps'
    partials reuses, then the staged table entries."""
    ck = chunk_positions(d)
    stage = 2 * ck * d * itemsize + (2 * ck * 4 if quantized else 0)
    merge = (THREADS // 32) * ROWS * (d + 2) * 4
    return max(STAGES * stage, merge) + 4 * entries


#: a pool as the engine holds one layer of it: dense, or (int8 data, f32 scale)
Pool = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def pool_gather(pool: Pool, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pool blocks gathered by the table ``idx``, dense (..., head_dim) in
    ``dtype``; an int8 pool is dequantized as ``(int8 -> f32) * scale``,
    then rounded to ``dtype`` (``tpulab``'s ``_pool_gather``)."""
    if isinstance(pool, tuple):
        data, scale = pool
        return (data[idx].float() * scale[idx][..., None]).to(dtype)
    return pool[idx]


def prescale_divisor(d: int, dtype: torch.dtype) -> torch.Tensor:
    """``sqrt(d)`` rounded to ``dtype``, the divisor of the q prescale."""
    return torch.tensor(math.sqrt(d), dtype=torch.float64).to(dtype)


def _unpack(kpool_l: Pool, vpool_l: Pool):
    quantized = isinstance(kpool_l, tuple)
    if quantized != isinstance(vpool_l, tuple):
        raise ValueError("kpool and vpool must both be quantized or both native")
    return quantized, (kpool_l[0] if quantized else kpool_l)


def _check(q: torch.Tensor, kpool_l: Pool, vpool_l: Pool, tables: torch.Tensor,
           lengths: torch.Tensor, block_size: int, window: int) -> bool:
    """The refusals of ``paged_attend_pallas``, then the kernel's; whether
    the pools are quantized."""
    quantized, data = _unpack(kpool_l, vpool_l)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (slots, 1, heads, head_dim), got {tuple(q.shape)}")
    S, _, h, d = q.shape
    if data.dim() != 4 or data.shape[3] != d:
        raise ValueError(f"pool {tuple(data.shape)} does not match q {tuple(q.shape)}")
    P, BS, kvh, _ = data.shape
    if BS != block_size:
        raise ValueError(f"pool block size {BS} != engine block size {block_size}")
    parts = (kpool_l + vpool_l) if quantized else (kpool_l, vpool_l)
    if any(t.shape[:3] != (P, BS, kvh) for t in parts):
        raise ValueError("kpool and vpool shapes differ")
    if quantized and (kpool_l[0].dtype != torch.int8 or kpool_l[1].dtype != torch.float32
                      or vpool_l[0].dtype != torch.int8 or vpool_l[1].dtype != torch.float32):
        raise ValueError("a quantized pool is (int8 data, float32 scale)")
    if not quantized and not (kpool_l.dtype == vpool_l.dtype == q.dtype):
        raise ValueError(f"pool dtypes {kpool_l.dtype}, {vpool_l.dtype} differ from q's {q.dtype}")
    if h % kvh:
        raise ValueError(f"heads={h} must be a multiple of kv_heads={kvh}")
    if tables.dim() != 2 or tables.shape[0] != S or lengths.shape != (S,):
        raise ValueError(f"tables {tuple(tables.shape)} and lengths {tuple(lengths.shape)} "
                         f"do not match {S} slots")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; have {list(DTYPES)}")
    if any(t.device != q.device for t in (*parts, tables, lengths)):
        raise ValueError("q, the pools, tables and lengths lie on different devices")
    return quantized


def paged_attend_plain(q: torch.Tensor, kpool_l: Pool, vpool_l: Pool, tables: torch.Tensor,
                       lengths: torch.Tensor, block_size: int, window: int = 0) -> torch.Tensor:
    """Plain PyTorch version of B7 (the Pallas kernel's function, in one
    pass): (slots, 1, heads, head_dim) in q's dtype."""
    S, _, h, d = q.shape
    _, data = _unpack(kpool_l, vpool_l)
    kvh = data.shape[2]
    M = tables.shape[1]
    idx = tables.long()
    k = pool_gather(kpool_l, idx, q.dtype).reshape(S, M * block_size, kvh, d)
    v = pool_gather(vpool_l, idx, q.dtype).reshape(S, M * block_size, kvh, d)
    qs = (q / prescale_divisor(d, q.dtype).to(q.device)).reshape(S, kvh, h // kvh, d)
    scores = torch.einsum("scgd,skcd->scgk", qs.float(), k.float())
    pos = torch.arange(M * block_size, device=q.device)[None, :]
    n = lengths.long()[:, None]
    valid = pos < n
    if window:
        valid = valid & (pos > n - 1 - window)
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    acc = torch.einsum("scgk,skcd->scgd", p, v.float())
    return (acc / p.sum(dim=-1, keepdim=True)).reshape(S, 1, h, d).to(q.dtype)


_WORKSPACES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, heads: int, splits: int, d: int):
    """The partials' workspace and the zeroed tickets for ``heads`` (slot,
    kv head, row block) triples, made once per shape and device: the kernel
    leaves every ticket at zero, so a call allocates nothing and reads
    nothing back.  Calls on one device share them, so they run in stream
    order (the engines use one stream)."""
    key = (device, heads, splits, d)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = (
            torch.empty(heads * splits * ROWS * (d + 2), dtype=torch.float32, device=device),
            torch.zeros(heads, dtype=torch.int32, device=device),
        )
    return _WORKSPACES[key]


def paged_attend_kernel(q: torch.Tensor, kpool_l: Pool, vpool_l: Pool, tables: torch.Tensor,
                        lengths: torch.Tensor, block_size: int, window: int = 0) -> torch.Tensor:
    """Single-token decode attention over the paged pools: kernel B7 for a
    CUDA tensor, the plain version for a CPU tensor; ``launches`` counts
    kernel launches (one a call)."""
    window = int(window)
    quantized = _check(q, kpool_l, vpool_l, tables, lengths, block_size, window)
    if q.device.type == "cpu":
        ensure_nearest()
        return paged_attend_plain(q, kpool_l, vpool_l, tables, lengths, block_size, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    S, _, h, d = q.shape
    data = kpool_l[0] if quantized else kpool_l
    kvh = data.shape[2]
    M = tables.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {d}; the kernel is built for {HEAD_DIMS}")
    nrb = row_blocks(h // kvh)
    splits, span = split_plan(S, kvh, M * block_size, d, nrb, _build.sm_count(q.device))
    smem = shared_bytes(d, data.element_size(), quantized, table_entries(span, block_size, M))
    if smem > _build.MAX_SHARED:
        raise ValueError(f"a block of the paged decode kernel needs {smem} bytes of shared "
                         f"memory at head_dim {d}, block size {block_size}; a block has "
                         f"{_build.MAX_SHARED}")
    parts = (kpool_l + vpool_l) if quantized else (kpool_l, vpool_l)
    if not all(t.is_contiguous() for t in parts):
        raise ValueError("the pools must be contiguous")
    kdata, kscale = kpool_l if quantized else (kpool_l, None)
    vdata, vscale = vpool_l if quantized else (vpool_l, None)
    align = min(d * data.element_size(), 16)  # bytes of the kernel's row copies
    if kdata.data_ptr() % align or vdata.data_ptr() % align:
        raise ValueError(f"the pools must be {align}-byte aligned")
    q, tables, lengths = q.contiguous(), tables.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.check_geometry((kvh * nrb, splits, S), (THREADS,))
    work, tickets = _workspace(q.device, S * kvh * nrb, splits, d)
    lib = _build.load_library()
    rc = lib.tl_paged_decode(
        DTYPES[q.dtype], d, int(quantized), q.data_ptr(), kdata.data_ptr(), vdata.data_ptr(),
        kscale.data_ptr() if quantized else None, vscale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), work.data_ptr(),
        tickets.data_ptr(), S, h, kvh, block_size, M, window,
        float(prescale_divisor(d, q.dtype)), splits, span, smem, _build.stream_handle(q.device),
    )
    paged_attend_kernel.launches += 1
    _build.check_launch(rc, "paged decode kernel")
    return out


paged_attend_kernel.launches = 0


def paged_over_tolerance(o: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``|o - want|`` over ``attention.o_tolerance(want)``: f32
    ``2e-5 + 2e-5 * |want|``; bf16 two ulps of the element plus two of the
    largest ``|want|`` of its (slot, head) row.  Rows of length-0 slots are
    NaN and must be NaN in both; any other disagreement on NaN is ``inf``
    (<= 1 passes)."""
    nan_o, nan_w = torch.isnan(o), torch.isnan(want)
    if not torch.equal(nan_o, nan_w):
        return math.inf
    finite = ~nan_w.any(dim=-1)
    if not bool(finite.any()):
        return 0.0
    o, want = o[finite], want[finite]
    err = (o.float() - want.float()).abs()
    return float(torch.where(err == 0, 0.0, err / o_tolerance(want)).max())
