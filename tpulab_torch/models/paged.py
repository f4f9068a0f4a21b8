"""Paged KV cache and continuous-batching engine (the counterpart of
``tpulab.models.paged``, single device).

The KV cache is a pool of fixed-size blocks shared by every request slot:

* pools ``(L, P, BS, kv, d)`` for K and V (P physical blocks of BS
  positions each), or ``(int8 data, f32 scale (L, P, BS, kv))`` pairs with
  ``kv_dtype="int8"``;
* per-slot block tables ``(S, M)`` int32 mapping logical block j of slot
  s to a physical block (M = max_seq // BS);
* a host-side free list hands blocks out at admission and takes them back
  when a request finishes.

Physical block 0 is TRASH: writes that must land nowhere (prefill
padding, idle slots, the one overshoot token of a finished slot) go
there, and reads are masked by position, so its contents are never
attended.

``tpulab`` jits its programs and donates the pools through every call;
here every program is an eager function and the pools, like the per-slot
decode state, are updated in place (``index_put_``), which is what the
donation buys there.  Writes routed to TRASH may repeat an index, and
which of them lands is unspecified: that block is never read.

One tick (:func:`paged_tick`) is the batched decode step over every slot,
per-slot sampling and the state advance.  The per-slot state (``last_tok,
lengths, tables, temps, seeds, draws, penalties, seen, active``) lives in
device tensors that the tick updates in place, so a steady-state tick
uploads nothing; admission, release and sliding-window retirement write
one slot's entries.  The engine keeps numpy mirrors of the same state for
its bookkeeping.  With ``overlap=1`` the host runs one tick behind the
device: each tick's tokens are copied, right after its dispatch, into
pinned host memory with ``non_blocking=True`` behind a recorded CUDA
event, and the drain waits on that event alone, so the host's bookkeeping
for tick t-1 overlaps the device's work on tick t.

``attn="pallas"`` reads the pools in place with kernel B7
(``ops/cuda/paged.py``; its plain version on the CPU), ``attn="gather"``
gathers each slot's blocks and runs a dense masked attention.  The two
round differently, as in ``tpulab``.

Admission is interleaved by default: admitting a request does host
bookkeeping only, and its prompt's prefill advances one ``paged_extend``
chunk per tick while the other slots decode.  A cache-miss admission with
no chunking prefills densely (``generate._prefill``, kernel B4 where the
config picks flash) and scatters the K/V into the pool.  Block-aligned
prompt prefixes are cached (LRU, evicted under pool pressure) and their
blocks reference-counted, so a prompt that repeats a cached prefix shares
its blocks and computes only its tail.

Sampled slots draw by Gumbel-max from a counter-based hash of each slot's
``(seed, draw)`` and the vocabulary index, written in integer tensor
ops, so the same bits come out on the CPU and on the card; the draw
counter advances every tick for every slot and is set at admission (0,
or where a resumed request stopped).  These are not ``jax.random``'s
streams: sampled output is held to its distribution, greedy output token
for token.

``spec_k > 0`` adds batched speculative decoding.  A tick in which some
decoding slot speculates is one :func:`paged_verify` pass over a
``(slots, spec_k + 1)`` window: each speculating slot's ``[committed,
d_1..d_k]``, its drafts from the n-gram lookup proposer (``spec="lookup"``)
or from a dense draft model (``spec="draft"``, :meth:`PagedEngine.set_draft`,
typically the int8-quantized target), while plain and sampled slots ride
row 0 as an ordinary single-token tick.  Each slot commits its longest
agreeing draft prefix plus the target's own next token, so a greedy
stream is the one plain ticks give.  The verify window attends through
the gather path, as in ``tpulab``; ticks in which no slot speculates run
:func:`paged_tick`, through kernel B7 under ``attn="pallas"`` (``tpulab``
refuses ``spec_k`` beside ``"pallas"``; the port lets the two rounding
paths share an engine, since a greedy stream differs between them only at
a near-tie).  Every tick advances every slot's draw counter once, so a
sampled stream is the same with and without speculating neighbours.  A
speculative tick waits for the device once: its drafts, choices and
row-0 tokens come back in one copy.

``prefix_index="radix"`` swaps the exact-match prefix dict for a radix
tree over block-sized token chunks (``kvcache/radix.py``), whose lookup
returns the longest partial hit and whose eviction drops one cold leaf at
a time.  ``spill_blocks > 0`` arms a host-RAM tier (``kvcache/spill.py``):
a cold leaf evicted with nothing else holding its block is copied to the
host, and an admission whose prompt walks back onto a spilled prefix
restores those blocks ahead of its prefill.  Both copies happen at
admission boundaries only: an eviction's reads are gathered into one
device-to-host copy and one wait, a prefetch's writes into one upload, so
steady ticks with the tier armed upload nothing.

Requests carry a priority.  When the head of the queue cannot be
admitted even after eviction, it preempts the lowest-priority slot of
strictly lower priority (:meth:`PagedEngine._preempt_for_head`): the
window is drained, the victim's blocks are released and the victim is
requeued behind the head through :meth:`PagedEngine.resubmit`, which
folds its emitted tokens into its prompt, so the resumed greedy stream is
the uninterrupted one.  A sampled slot resumes its draw counter at the
number of tokens it has emitted: token ``i`` of a request is always drawn
at counter ``i``, because the last prompt token is held back for the
first tick and every tick, plain or speculative, advances every slot's
counter once and gives a sampled slot one token.

A prefill engine with ``handoff_at_boundary`` parks each request at the
end of its prefill (phase ``"handoff"``) instead of decoding it;
:meth:`PagedEngine.export_handoff` reads the parked requests' full blocks
back to the host, and a decode engine with a spill tier takes them in
with :meth:`PagedEngine.import_handoff` and resumes the request with
``resubmit(req, fresh_id=True)``, its admission restoring the blocks.

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item: mesh serving (A12), and observability (histograms, tracer,
journeys, slow log, fault sites, request ids and tags, published metrics:
A11).
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpulab_torch.kvcache.radix import RadixPrefixIndex
from tpulab_torch.kvcache.spill import SPILL_DTYPES, HostSpillTier, SpillPolicy
from tpulab_torch.models import generate as _gen
from tpulab_torch.models.generate import _attend_cached, apply_repetition_penalty
from tpulab_torch.models.labformer import (
    Labformer,
    LabformerConfig,
    _mlp,
    _rmsnorm,
    _rope,
    _rope_freqs,
)
from tpulab_torch.models.quant import embed_lookup, qmat, unembed
from tpulab_torch.models.speculative import _draft_propose_slots, _lookup_propose
from tpulab_torch.ops.cuda.paged import Pool, paged_attend_kernel
from tpulab_torch.ops.cuda.paged import pool_gather as _pool_gather
from tpulab_torch.parallel.ring import NEG_INF
from tpulab_torch.runtime.device import resolve_device

TRASH = 0  # physical block 0 swallows must-not-land writes


class EngineIntegrityError(RuntimeError):
    """Engine state failed an always-on invariant check (a corrupt slot
    table, an out-of-vocab drained token)."""


class QueueFullError(RuntimeError):
    """``submit`` refused: the admission queue is at ``max_pending``."""


class EngineConfigError(ValueError):
    """A serving-knob combination the engine refuses to build."""


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


# ------------------------------------------------------------ the pools


def init_pools(cfg: LabformerConfig, n_blocks: int, block_size: int,
               kv_dtype: str = "native", device=None) -> Tuple[Pool, Pool]:
    """K/V pools (L, P, BS, kv, d) on ``device``; block 0 is TRASH.

    ``device`` is a ``torch.device`` or a backend name, resolved as every
    entry point resolves it: None is the card (an error where none is
    visible), ``"cpu"`` the host.  ``kv_dtype="int8"`` makes each pool an
    ``(int8 data, f32 scale)`` pair, quantized at write time by symmetric
    amax along the head dim."""
    device = resolve_device(device) if device is None or isinstance(device, str) \
        else torch.device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        def one():
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return one(), one()
    if kv_dtype != "native":
        raise ValueError(f"kv_dtype={kv_dtype!r}; expected 'native' or 'int8'")
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


#: 1/127 in f32: ``tpulab`` writes ``amax / 127.0``, which XLA compiles, in
#: every jitted program that writes a pool, to ``amax * f32(1/127)``
_INV_127 = float(np.float32(1.0 / 127.0))


def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., d) -> (int8 data, f32 scale (...,)): symmetric amax;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) * _INV_127
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _pool_write(pool: Pool, idx, x: torch.Tensor) -> None:
    """Write K/V rows ``x`` at index tuple ``idx`` of ``pool``, in place,
    quantizing for an int8 pool: the one quantize-on-write site."""
    if isinstance(pool, tuple):
        data, scale = pool
        q, s = _kv_quant(x)
        data[idx] = q
        scale[idx] = s
    else:
        pool[idx] = x.to(pool.dtype)


def _pool_nbytes(pool: Pool) -> int:
    """Bytes one pool holds (int8 pools: data and scales)."""
    parts = pool if isinstance(pool, tuple) else (pool,)
    return int(sum(t.numel() * t.element_size() for t in parts))


def _layer(pool: Pool, i: int) -> Pool:
    """Layer ``i`` of a pool, as a view (writes land in the pool)."""
    if isinstance(pool, tuple):
        return pool[0][i], pool[1][i]
    return pool[i]


def _spill_read(kpool: Pool, vpool: Pool, blocks: torch.Tensor):
    """Copies of pool blocks ``blocks`` (n,) on the pools' device, block
    first: ``(n, L, BS, kv, d)`` for a native pool, an ``(int8 data, f32
    scale)`` pair of such for an int8 pool (the read leg of a spill and of
    a handoff export)."""
    def rd(pool):
        if isinstance(pool, tuple):
            return tuple(rd(t) for t in pool)
        return pool.index_select(1, blocks).transpose(0, 1).contiguous()
    return rd(kpool), rd(vpool)


def _spill_restore(kpool: Pool, vpool: Pool, kblk, vblk, blocks: torch.Tensor) -> None:
    """Write blocks ``(n, L, BS, kv, d)`` (an int8 pool: ``(data, scale)``
    pairs) into the pools at ``blocks`` (n,), in place: a placement in the
    pool's own representation, never a requantize (the write leg of a
    prefetch)."""
    def put(pool, blk):
        if isinstance(pool, tuple):
            for t, b in zip(pool, blk):
                put(t, b)
        else:
            pool[:, blocks] = blk.transpose(0, 1)
    put(kpool, kblk)
    put(vpool, vblk)


# ------------------------------------------------------------ attention


def _rope_cos_sin(pos: torch.Tensor, d: int, theta: float, dtype: torch.dtype):
    """cos and sin (S, W, 1, d/2) in ``dtype`` of the rotary angles at
    positions ``pos`` (S,) or (S, W)."""
    freqs = _rope_freqs(d // 2, float(theta), pos.device)
    if pos.dim() == 1:
        pos = pos[:, None]
    ang = pos[..., None].float() * freqs[None, None, :]
    return torch.cos(ang)[:, :, None, :].to(dtype), torch.sin(ang)[:, :, None, :].to(dtype)


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_at(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``labformer._rope`` at per-slot positions: x (S, W, heads, d), pos (S,)
    (one token per slot) or (S, W); the frequencies are labformer's, in
    float64 rounded to f32 and cached on the device."""
    return _rope_apply(x, *_rope_cos_sin(pos, x.shape[-1], theta, x.dtype))


def _paged_attend(q: torch.Tensor, kpool_l: Pool, vpool_l: Pool, tables: torch.Tensor,
                  lengths: torch.Tensor, block_size: int, window: int = 0) -> torch.Tensor:
    """The gather path: q (S, W, h, d); pools (P, BS, kv, d); tables (S, M);
    ``lengths`` (S,) keys seen by query row 0 (row j sees lengths + j).

    Its rounding is ``tpulab``'s gather path, not B7's: q is scaled and the
    scores formed in q's dtype, then widened to f32 for the softmax."""
    S, W, h, dh = q.shape
    kvh = (kpool_l[0] if isinstance(kpool_l, tuple) else kpool_l).shape[2]
    g = h // kvh
    M = tables.shape[1]
    idx = tables.long()
    k = _pool_gather(kpool_l, idx, q.dtype).reshape(S, M * block_size, kvh, dh)
    v = _pool_gather(vpool_l, idx, q.dtype).reshape(S, M * block_size, kvh, dh)
    q = q / torch.tensor(math.sqrt(dh), dtype=torch.float64).to(q.dtype)
    qg = q.reshape(S, W, kvh, g, dh)
    s = torch.einsum("bqcgd,bkcd->bcgqk", qg, k).float()
    key_pos = torch.arange(M * block_size, device=q.device)[None, None, :]
    row_len = lengths.long()[:, None] + torch.arange(W, device=q.device)[None, :]
    valid = key_pos < row_len[:, :, None]
    if window:
        valid = valid & (key_pos > row_len[:, :, None] - 1 - window)
    s = torch.where(valid[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bcgqk,bkcd->bqcgd", p, v.float())
    return o.reshape(S, W, h, dh).to(q.dtype)


def _decode_core(model: Labformer, tokens: torch.Tensor, kpool: Pool, vpool: Pool,
                 tables: torch.Tensor, lengths: torch.Tensor, cfg: LabformerConfig,
                 block_size: int, attn: str = "gather") -> torch.Tensor:
    """One batched decode step for every slot; the (S, vocab) logits.

    tokens (S,) sit at positions ``lengths`` (each slot's next free
    position); every layer writes the new K/V through the block table into
    the pools (in place) and attends [0, lengths] inclusive: through kernel
    B7 under ``attn="pallas"``, the gather path under ``"gather"``.  Idle
    slots point their table at TRASH."""
    S = tokens.shape[0]
    h, dh, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    x = embed_lookup(model.top.embed, tokens, cfg.dtype)[:, None, :]
    pos = lengths.long()
    blk = tables.gather(1, (pos // block_size)[:, None])[:, 0].long()
    off = pos % block_size
    seen_len = lengths + 1
    cos, sin = _rope_cos_sin(pos, dh, cfg.rope_theta, cfg.dtype)
    for i, layer in enumerate(model.blocks):
        xn = _rmsnorm(x, layer.ln1)
        q = _rope_apply(qmat(xn, layer.wq).reshape(S, 1, h, dh), cos, sin)
        k = _rope_apply(qmat(xn, layer.wk).reshape(S, 1, kvh, dh), cos, sin)
        v = qmat(xn, layer.wv).reshape(S, 1, kvh, dh)
        kpool_l, vpool_l = _layer(kpool, i), _layer(vpool, i)
        _pool_write(kpool_l, (blk, off), k[:, 0])
        _pool_write(vpool_l, (blk, off), v[:, 0])
        if attn == "pallas":
            o = paged_attend_kernel(q, kpool_l, vpool_l, tables, seen_len, block_size,
                                    window=cfg.attn_window)
        else:
            o = _paged_attend(q, kpool_l, vpool_l, tables, seen_len, block_size,
                              window=cfg.attn_window)
        x = x + qmat(o.reshape(S, 1, cfg.d_model), layer.wo)
        y, _ = _mlp(_rmsnorm(x, layer.ln2), layer, cfg)
        x = x + y
    x = _rmsnorm(x, model.top.final_norm)
    return unembed(x, model.top.embed)[:, 0, :]


def paged_decode_step(model: Labformer, tokens: torch.Tensor, kpool: Pool, vpool: Pool,
                      tables: torch.Tensor, lengths: torch.Tensor, cfg: LabformerConfig,
                      block_size: int, attn: str = "gather"):
    """The standalone decode step: ``(logits, kpool, vpool)``, the pools
    updated in place."""
    return _decode_core(model, tokens, kpool, vpool, tables, lengths, cfg, block_size,
                        attn), kpool, vpool


def paged_verify(model: Labformer, tokens: torch.Tensor, kpool: Pool, vpool: Pool,
                 tables: torch.Tensor, lengths: torch.Tensor, n_draft: torch.Tensor,
                 cfg: LabformerConfig, block_size: int):
    """One batched speculative verify pass over every slot:
    ``(logits (S, W, vocab), kpool, vpool)``, the pools updated in place.

    tokens (S, W): row 0 is each slot's committed last token, rows 1..k its
    drafts; token j of slot s sits at position ``lengths[s] + j``, and
    logits row j is the target's next-token distribution after
    ``tokens[s, :j+1]``.  ``n_draft`` (S,) counts each slot's valid drafts:
    K/V of rows past it (padding; a plain or sampled slot runs with 0) and
    of rows whose block would fall past the table go to TRASH.  Query row j
    attends keys [0, lengths + j], so rejected drafts leave only stale K/V
    past the committed frontier, which the next round overwrites.  The
    window attends through the gather path (``tpulab`` takes W as a static
    argument for its jit; here it is ``tokens.shape[1]``)."""
    S, W = tokens.shape
    h, dh, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    x = embed_lookup(model.top.embed, tokens, cfg.dtype)
    j = torch.arange(W, device=tokens.device)
    pos = lengths.long()[:, None] + j
    logical = pos // block_size
    M = tables.shape[1]
    writable = (j <= n_draft.long()[:, None]) & (logical < M)
    blk = torch.where(writable, tables.gather(1, torch.clamp(logical, max=M - 1)).long(),
                      TRASH)
    off = pos % block_size
    cos, sin = _rope_cos_sin(pos, dh, cfg.rope_theta, cfg.dtype)
    for i, layer in enumerate(model.blocks):
        xn = _rmsnorm(x, layer.ln1)
        q = _rope_apply(qmat(xn, layer.wq).reshape(S, W, h, dh), cos, sin)
        k = _rope_apply(qmat(xn, layer.wk).reshape(S, W, kvh, dh), cos, sin)
        v = qmat(xn, layer.wv).reshape(S, W, kvh, dh)
        kpool_l, vpool_l = _layer(kpool, i), _layer(vpool, i)
        _pool_write(kpool_l, (blk, off), k)
        _pool_write(vpool_l, (blk, off), v)
        o = _paged_attend(q, kpool_l, vpool_l, tables, lengths + 1, block_size,
                          window=cfg.attn_window)
        x = x + qmat(o.reshape(S, W, cfg.d_model), layer.wo)
        y, _ = _mlp(_rmsnorm(x, layer.ln2), layer, cfg)
        x = x + y
    x = _rmsnorm(x, model.top.final_norm)
    return unembed(x, model.top.embed), kpool, vpool


def _draft_extend(draft: Labformer, tokens: torch.Tensor, d_kc: torch.Tensor,
                  d_vc: torch.Tensor, s: int, start: int) -> None:
    """Advance slot ``s``'s dense draft cache by one prefill window:
    ``tokens`` (1, bucket) at positions ``start``.. through the draft's
    windowed forward, written into the slot's cache rows in place.  The
    last window's padding lands past the prompt's frontier, where the
    proposer rewrites every position before it reads it."""
    _gen._forward_window(draft, tokens, d_kc[:, s:s + 1], d_vc[:, s:s + 1], start)


def paged_extend(model: Labformer, tokens: torch.Tensor, kpool: Pool, vpool: Pool,
                 table_row: torch.Tensor, start: int, n_valid: int, cfg: LabformerConfig,
                 block_size: int, bucket: int):
    """Extend one slot's paged KV by running the model over ``tokens``
    (1, bucket; valid through ``n_valid``) at positions ``start``..,
    attending the slot's pool contents (a shared prefix, earlier chunks)
    and the window's own causal prefix; positions from ``n_valid`` on write
    to TRASH.  Returns the pools (updated in place)."""
    h, dh, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    dev = tokens.device
    x = embed_lookup(model.top.embed, tokens, cfg.dtype)
    j = torch.arange(bucket, device=dev)
    pos = start + j
    M = table_row.shape[0]
    row = table_row.long()
    blk = torch.where(j < n_valid, row[torch.clamp(pos // block_size, max=M - 1)], TRASH)
    off = pos % block_size
    for i, layer in enumerate(model.blocks):
        xn = _rmsnorm(x, layer.ln1)
        q = _rope(qmat(xn, layer.wq).reshape(1, bucket, h, dh), pos, cfg.rope_theta)
        k = _rope(qmat(xn, layer.wk).reshape(1, bucket, kvh, dh), pos, cfg.rope_theta)
        v = qmat(xn, layer.wv).reshape(1, bucket, kvh, dh)
        kpool_l, vpool_l = _layer(kpool, i), _layer(vpool, i)
        _pool_write(kpool_l, (blk, off), k[0])
        _pool_write(vpool_l, (blk, off), v[0])
        kg = _pool_gather(kpool_l, row, cfg.dtype).reshape(1, M * block_size, kvh, dh)
        vg = _pool_gather(vpool_l, row, cfg.dtype).reshape(1, M * block_size, kvh, dh)
        o = _attend_cached(q, kg, vg, start, cfg.attn_window)
        x = x + qmat(o.reshape(1, bucket, cfg.d_model), layer.wo)
        y, _ = _mlp(_rmsnorm(x, layer.ln2), layer, cfg)
        x = x + y
    return kpool, vpool


def _scatter_prefill(kpool: Pool, vpool: Pool, k_seq: torch.Tensor, v_seq: torch.Tensor,
                     table_row: torch.Tensor, start: int, p: int, bucket: int,
                     block_size: int):
    """Move dense prefill K/V (L, bucket, kv, d) into the pools along one
    slot's block table, in place; positions outside [start, p) go to TRASH
    (below ``start`` they live in shared prefix blocks that must not be
    rewritten, from ``p`` on they are padding)."""
    j = torch.arange(bucket, device=k_seq.device)
    row = table_row.long()
    blk = torch.where((j >= start) & (j < p),
                      row[torch.clamp(j // block_size, max=row.shape[0] - 1)], TRASH)
    off = j % block_size
    _pool_write(kpool, (slice(None), blk, off), k_seq)
    _pool_write(vpool, (slice(None), blk, off), v_seq)
    return kpool, vpool


# ------------------------------------------------------------ sampling

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of each element of ``x`` (int64 holding values
    in [0, 2**32)); every product stays below 2**63, so int64 arithmetic is
    exact on the CPU and on the card."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, draws: torch.Tensor, vocab: int) -> torch.Tensor:
    """(S, vocab) f32 standard Gumbel noise, a function of each slot's
    ``(seed, draw)`` and the vocabulary index alone."""
    key = _mix32(_mix32((seeds & _M32) ^ 0x3C6EF372) ^ ((seeds >> 32) & _M32))
    key = _mix32(key ^ (draws & _M32))
    idx = _mix32((torch.arange(vocab, device=seeds.device) * 0x9E3779B9) & _M32)
    bits = _mix32(_mix32(key[:, None] ^ idx[None, :]) ^ key[:, None])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # (0, 1), exact in f32
    return -torch.log(-torch.log(u))


def _sample_core(logits: torch.Tensor, temps: torch.Tensor, seeds: torch.Tensor,
                 draws: torch.Tensor, penalties: torch.Tensor, seen: torch.Tensor,
                 sampled: bool = True) -> torch.Tensor:
    """Per-slot next token (S,) int64: greedy where the temperature is 0,
    else a Gumbel-max draw from the slot's ``(seed, draw)``.  The
    repetition penalty (1.0 = off) applies to both, as in ``generate``.
    ``sampled=False`` skips the noise when no slot samples."""
    logits = apply_repetition_penalty(logits, seen, penalties[:, None])
    greedy = logits.argmax(dim=-1)
    if not sampled:
        return greedy
    noisy = logits / torch.clamp(temps, min=1e-6)[:, None] + gumbel_noise(
        seeds, draws, logits.shape[-1])
    return torch.where(temps > 0, noisy.argmax(dim=-1), greedy)


def paged_tick(model: Labformer, state: Dict[str, torch.Tensor], kpool: Pool, vpool: Pool,
               cfg: LabformerConfig, block_size: int, attn: str = "gather",
               sampled: bool = True) -> torch.Tensor:
    """One steady-state tick: decode step, per-slot sampling and the state
    advance, all on the device; the (S,) tokens.

    ``state`` is the engine's per-slot device state, updated in place:
    ``last_tok`` takes the sampled token, ``lengths`` grows by one and
    ``seen`` marks the token, each only where ``active`` (idle slots keep
    their state for the next admission); ``draws`` advances for every slot,
    so admission sets a slot's draw counter."""
    logits = _decode_core(model, state["last_tok"], kpool, vpool, state["tables"],
                          state["lengths"], cfg, block_size, attn)
    toks = _sample_core(logits, state["temps"], state["seeds"], state["draws"],
                        state["penalties"], state["seen"], sampled)
    act = state["active"]
    state["last_tok"].copy_(torch.where(act, toks, state["last_tok"]))
    state["lengths"] += act.to(torch.int32)
    state["draws"] += 1
    rows = torch.arange(toks.shape[0], device=toks.device)
    state["seen"][rows, toks] |= act
    return toks


def _spec_commit(state: Dict[str, torch.Tensor], adv: torch.Tensor, last_tok: torch.Tensor,
                 marks: torch.Tensor, mark_vals: torch.Tensor) -> None:
    """Advance the device state after a speculative tick's host-side
    accept, in place: ``adv`` (S,) tokens committed per slot,
    ``last_tok`` (S,) the last of them (kept where ``adv`` is 0), the
    ``seen`` marks at ``marks`` (S, W) with ``mark_vals``, and every
    slot's draw counter, once, as a plain tick advances it.  The host
    points a row's padding marks at a committed token of that row, so a
    repeated index always writes one value."""
    state["lengths"] += adv.to(torch.int32)
    state["last_tok"].copy_(torch.where(adv > 0, last_tok, state["last_tok"]))
    state["draws"] += 1
    rows = torch.arange(marks.shape[0], device=marks.device)[:, None]
    state["seen"][rows, marks] |= mark_vals


# ------------------------------------------------------------ requests


def _chain_digests(key: bytes, step: int) -> List[bytes]:
    """sha256 digest chain over ``step``-byte chunks of ``key``: ``out[j]``
    names the block-aligned prefix of j+1 chunks."""
    h = hashlib.sha256()
    out = []
    for i in range(0, len(key), step):
        h.update(key[i:i + step])
        out.append(h.digest())
    return out


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


@dataclass
class _Request:
    req_id: int
    prompt: np.ndarray          # (p,) int32
    max_new: int
    temperature: float = 0.0    # 0 = greedy
    seed: int = 0
    repetition_penalty: float = 1.0  # HF convention; 1.0 = off
    stop_byte: int = -1         # finish early after emitting it; -1 = off
    spec: str = "off"           # "off" | "lookup" | "draft" proposer
    spec_k: int = 0             # drafts per verify round (<= the engine's)
    spec_ngram: int = 3         # the lookup proposer's n-gram length
    priority: int = 0           # preemption rank under KV pressure (higher wins)
    out: List[int] = field(default_factory=list)
    cancelled: bool = False     # finish at the next tick (client gone)
    # resume (preemption requeue, replay, handoff): how many of out's
    # tokens resubmit has folded into prompt, and the draw counter a
    # sampled slot resumes at (token i is drawn at counter i)
    n_resumed: int = 0
    resume_draw: int = 0
    preemptions: int = 0        # times this request was preempted
    resubmits: int = 0          # preemption requeues, replays, handoffs
    # admission order: the victim tie-break (tpulab's -t_admit from
    # time.monotonic(); a counter gives the same order unless two
    # monotonic reads tie)
    admit_seq: int = 0
    hops: List[int] = field(default_factory=list)  # replicas placed on
    # interleaved admission: "prefill" while chunks are owed (device slot
    # inactive, no tokens yet), "decode" once live, "handoff" parked for
    # export at the end of its prefill
    phase: str = "decode"
    pf_pos: int = 0             # next prompt position to paged_extend
    pf_end: int = 0             # prefill frontier: len(prompt) - 1
    d_pf_pos: int = 0           # draft-cache prefill cursor ("draft")

    def total_positions(self) -> int:
        """Positions this request can ever occupy: prompt plus the budget
        left.  A resumed prompt holds the tokens ``out`` already counts, so
        every sizing site (submit, admission, release) uses this."""
        return len(self.prompt) + self.max_new - self.n_resumed


# ------------------------------------------------------------ the engine


class PagedEngine:
    """Continuous-batching decode over a paged KV pool.

    ``slots`` concurrent sequences share ``n_blocks`` physical blocks of
    ``block_size`` positions.  ``submit`` queues a request; ``step()``
    admits queued requests into free slots (when enough blocks are free)
    and advances every active slot one token; ``run()`` drains everything
    and returns {req_id: generated tokens}.  Greedy by default;
    per-request temperature and seed make sampled slots that share the
    batch with greedy ones; ``spec_k > 0`` lets requests speculate
    (``submit(spec=...)``, :meth:`set_draft`).

    ``model`` is the port's :class:`Labformer` (the engine runs where it
    lies) or ``tpulab``'s parameter tree, then placed on ``device`` (the
    card unless ``"cpu"``).  ``interleave``, ``overlap``, ``prefill_chunk``,
    ``attn``, ``kv_dtype``, ``spec_k``, ``spec_ngram``, ``draft_params``,
    ``draft_cfg``, ``max_pending``, ``prefix_index``, ``spill_blocks`` and
    ``spill_dtype`` are ``tpulab``'s knobs."""

    def __init__(self, model, cfg: LabformerConfig, *, slots: int = 4,
                 n_blocks: int = 64, block_size: int = 16, max_seq: int = 256,
                 prefill_chunk: int = 0, mesh=None, attn: str = "gather",
                 kv_dtype: str = "native", spec_k: int = 0, spec_ngram: int = 3,
                 draft_params=None, draft_cfg=None, overlap: int = 1,
                 interleave: bool = True, obs: bool = False, max_pending: int = 0,
                 prefix_index: str = "dict", spill_blocks: int = 0,
                 spill_dtype: str = "native", device=None):
        if mesh is not None:
            raise _unported("mesh serving", "A12")
        if obs:
            raise _unported("engine observability (histograms, tracer, journeys, slow log)",
                            "A11")
        if max_seq % block_size:
            raise ValueError("max_seq must be a multiple of block_size")
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = whole tail)")
        if overlap not in (0, 1):
            raise ValueError(f"overlap must be 0 or 1, got {overlap}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        if cfg.lora_rank:
            raise ValueError(
                "PagedEngine with lora_rank > 0: fold the adapters first "
                "(labformer.merge_lora(params, cfg))")
        if attn not in ("gather", "pallas"):
            raise ValueError(f"attn={attn!r}; expected 'gather' or 'pallas'")
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r}; expected 'native' or 'int8'")
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        if prefix_index not in ("dict", "radix"):
            raise ValueError(f"prefix_index={prefix_index!r}; expected 'dict' or 'radix'")
        if spill_blocks < 0:
            raise ValueError(f"spill_blocks must be >= 0, got {spill_blocks}")
        if spill_blocks and prefix_index != "radix":
            # the tier keys host payloads by radix token paths; the dict
            # index cannot name a single evicted block
            raise ValueError("spill_blocks > 0 requires prefix_index='radix'")
        if spill_dtype not in SPILL_DTYPES:
            raise ValueError(f"spill_dtype={spill_dtype!r}; expected one of {SPILL_DTYPES}")
        self.model = model if isinstance(model, Labformer) else Labformer.from_numpy(
            model, cfg, device)
        self.device = self.model.device
        self.cfg = cfg
        self.slots = slots
        self.attn = attn
        self.block_size = block_size
        self.max_blocks = max_seq // block_size
        self.kpool, self.vpool = init_pools(cfg, n_blocks, block_size, kv_dtype, self.device)
        self.n_usable_blocks = n_blocks - 1
        self.free = list(range(1, n_blocks))  # block 0 is TRASH
        # host mirrors of the per-slot decode state
        self.tables = np.zeros((slots, self.max_blocks), np.int32)
        self.lengths = np.zeros(slots, np.int32)
        self.last_tok = np.zeros(slots, np.int32)
        self.temps = np.zeros(slots, np.float32)
        self.seeds = np.zeros(slots, np.int64)
        self.draws = np.zeros(slots, np.int64)  # each slot's counter at its push
        self.penalties = np.ones(slots, np.float32)
        self.seen = np.zeros((slots, cfg.vocab), bool)
        self.active: List[Optional[_Request]] = [None] * slots
        self.pending: List[_Request] = []
        self._done: Dict[int, np.ndarray] = {}
        self._next_id = 0
        self._admit_seq = 0
        # prefix sharing: block-aligned prompt prefixes cached with their
        # blocks reference-counted; the digest side-index lets a lookup
        # hash a prompt once and probe every block depth in O(1)
        self.block_refs = np.zeros(n_blocks, np.int64)
        self.prefix_cache: "OrderedDict[bytes, List[int]]" = OrderedDict()
        self._pc_digest: Dict[bytes, bytes] = {}
        self._pc_by_digest: Dict[bytes, bytes] = {}
        # the hierarchical cache: a radix index in place of the dict, and
        # the host tier cold evictions land in
        self.prefix_index = prefix_index
        self._radix = RadixPrefixIndex(block_size) if prefix_index == "radix" else None
        self._spill = HostSpillTier(spill_blocks, spill_dtype) if spill_blocks else None
        self._spill_policy = SpillPolicy() if spill_blocks else None
        self.prefill_chunk = prefill_chunk
        self.interleave = bool(interleave)
        # prompt-length buckets of unchunked prefills, per program
        self._dense_buckets: set = set()
        self._extend_buckets: set = set()
        # per-step stall accounting scratch (reset by step())
        self._stall_prefill_dispatches = 0
        self._stall_prefill_credit = 0
        self.counters = {
            "prefix_hits": 0, "prefix_misses": 0, "evictions": 0,
            "ticks": 0, "tokens_out": 0, "requests_done": 0,
            "blocks_retired": 0,
            # verify_passes = verify ticks; spec_rounds, spec_accepted and
            # spec_tokens = per-slot rounds, drafts accepted, tokens committed
            "verify_passes": 0, "spec_rounds": 0, "spec_accepted": 0,
            "spec_tokens": 0,
            # host_syncs = barriers that drained the async window;
            # h2d_ticks = ticks that needed a host upload
            "host_syncs": 0, "h2d_ticks": 0,
            "admissions": 0, "prefill_chunks": 0, "stall_ticks": 0,
            # preemptions = slots released under KV pressure and requeued;
            # recompiles: always 0 here (no jit)
            "preemptions": 0, "recompiles": 0,
            # spill_spilled = cold blocks handed to the host tier;
            # spill_prefetched = blocks restored at admission; spill_hits =
            # admissions the host tier extended past the radix hit
            "spill_spilled": 0, "spill_prefetched": 0, "spill_hits": 0,
        }
        self.max_pending = max_pending
        self._dev = self._init_dev_state()
        # one-tick async window: (host tokens, their event, slot snapshot)
        self.overlap = overlap
        self._inflight: List = []
        self._h2d = False
        # per slot: first logical block not yet window-retired
        self._retire_from = [0] * slots
        # fleet identity, set by a serving daemon (None for a bare engine)
        self.replica_index: Optional[int] = None
        self.pool_role: Optional[str] = None
        # disaggregated serving: a prefill engine parks each request at the
        # end of its prefill; export_handoff drains handoff_ready
        self.handoff_at_boundary = False
        self.handoff_ready: List[Tuple[int, _Request]] = []
        # host waits that read KV blocks back (a spill at eviction, an
        # export): one each, whatever the number of blocks
        self.kv_fetches = 0
        self._kv_pool_bytes = _pool_nbytes(self.kpool) + _pool_nbytes(self.vpool)
        self._block_bytes = self._kv_pool_bytes // n_blocks
        # speculative decoding: a tick verifies (spec_k + 1)-token windows
        # whenever a decoding slot speculates; spec_fetches counts the
        # host's waits in those ticks (one each)
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_fetches = 0
        self.draft: Optional[Labformer] = None
        self.draft_cfg: Optional[LabformerConfig] = None
        self.d_kc = self.d_vc = None
        if draft_params is not None:
            self.set_draft(draft_params, draft_cfg)

    def _init_dev_state(self) -> Dict[str, torch.Tensor]:
        S, dev = self.slots, self.device
        return {
            "last_tok": torch.zeros(S, dtype=torch.int64, device=dev),
            "lengths": torch.zeros(S, dtype=torch.int32, device=dev),
            "tables": torch.zeros((S, self.max_blocks), dtype=torch.int32, device=dev),
            "temps": torch.zeros(S, dtype=torch.float32, device=dev),
            "seeds": torch.zeros(S, dtype=torch.int64, device=dev),
            "draws": torch.zeros(S, dtype=torch.int64, device=dev),
            "penalties": torch.ones(S, dtype=torch.float32, device=dev),
            "seen": torch.zeros((S, self.cfg.vocab), dtype=torch.bool, device=dev),
            "active": torch.zeros(S, dtype=torch.bool, device=dev),
        }

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of host ``arr`` on the engine's device: through pinned
        memory with ``non_blocking=True`` on the card, so the host never
        waits for the ticks in flight."""
        return self._to_device(torch.from_numpy(np.array(arr)))

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """Host tensor ``host`` on the engine's device (itself on the CPU).
        On the card the copy leaves from a pinned staging copy, queued
        behind the ticks in flight.  The staging copy may be dropped at
        once: PyTorch's pinned-memory allocator records the copy's stream
        event and reuses that memory only once the copy has run."""
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _push_slot(self, s: int, active: bool):
        """Write slot ``s``'s host-mirror state into the device state (the
        admission and release upload); marks the tick as h2d."""
        self._h2d = True
        st = self._dev
        # fill_ takes the scalar as a launch argument; assigning one would
        # copy it from pageable memory and wait for the device
        st["lengths"][s].fill_(int(self.lengths[s]))
        st["last_tok"][s].fill_(int(self.last_tok[s]))
        st["temps"][s].fill_(float(self.temps[s]))
        st["seeds"][s].fill_(int(self.seeds[s]))
        st["draws"][s].fill_(int(self.draws[s]))
        st["penalties"][s].fill_(float(self.penalties[s]))
        st["seen"][s] = self._upload(self.seen[s])
        st["tables"][s] = self._upload(self.tables[s])
        st["active"][s].fill_(bool(active))

    def set_draft(self, draft_params, draft_cfg: LabformerConfig = None):
        """Enable the dense-draft proposer (``spec="draft"``): a second
        model with the target's vocabulary (a :class:`Labformer`, or a
        parameter tree placed on the engine's device), typically the
        int8-quantized target, proposes from per-slot dense KV caches.
        The first draft set stays (the daemon sets it lazily)."""
        if self.draft is not None:
            return
        if self.spec_k <= 0:
            raise ValueError("set_draft on an engine with spec_k=0: "
                             "build the engine with spec_k > 0")
        if draft_cfg is None:
            draft_cfg = draft_params.cfg if isinstance(draft_params, Labformer) else self.cfg
        if draft_cfg.vocab != self.cfg.vocab:
            raise ValueError("draft and target must share a vocabulary")
        self.draft_cfg = draft_cfg
        self.draft = (draft_params if isinstance(draft_params, Labformer)
                      else Labformer.from_numpy(draft_params, draft_cfg, self.device))
        # the proposer writes k+1 positions past any committed frontier
        # (< max_seq), a dense prefill pads to a power-of-two bucket, and a
        # chunked draft prefill writes a whole chunk bucket from anywhere
        # below the frontier: the cache holds all three
        self._draft_cache_len = max(
            self.max_blocks * self.block_size + self.spec_k + 2,
            _bucket(self.max_blocks * self.block_size),
        ) + (_bucket(self.prefill_chunk) if self.prefill_chunk else 0)
        self.d_kc, self.d_vc = _gen.init_kv_cache(draft_cfg, self.slots,
                                                  self._draft_cache_len, self.device)

    # ------------------------------------------------------------- admission
    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               seed: int = 0, repetition_penalty: float = 1.0,
               stop_byte: int = -1, spec: str = "off", spec_k: int = 0,
               spec_ngram: int = 0, priority: int = 0,
               rid: Optional[int] = None, tag: str = "") -> int:
        """Queue a request; its id.  ``temperature == 0`` decodes greedily,
        else the slot samples from its seeded stream.  ``repetition_penalty``
        discounts bytes already in the prompt or output (HF convention; greedy
        too); ``stop_byte >= 0`` finishes the request right after that byte
        (it is the last output token).

        ``spec="lookup"`` or ``"draft"`` (an engine with ``spec_k > 0``;
        ``"draft"`` also needs :meth:`set_draft`) lets the request
        speculate: each tick it proposes up to ``spec_k`` drafts (0 = the
        engine's) and commits 1..spec_k+1 tokens, the greedy stream of
        ``spec="off"``.  A sampled request keeps single-token ticks.
        ``spec_ngram`` overrides the engine's lookup n-gram (0 = its own).

        ``priority`` ranks the request under KV pressure: a head request
        that cannot be admitted preempts an active one of strictly lower
        priority, which later resumes where it stopped."""
        if spec not in ("off", "lookup", "draft"):
            raise ValueError(f"spec={spec!r}; expected 'off', 'lookup' or 'draft'")
        if spec != "off":
            if self.spec_k <= 0:
                raise ValueError(f"spec={spec!r} needs an engine built with spec_k > 0")
            if spec == "draft" and self.draft is None:
                raise ValueError("spec='draft' needs a draft model: call "
                                 "engine.set_draft(...) first")
        if not 0 <= spec_k <= self.spec_k:
            raise ValueError(
                f"spec_k must be in [0, {self.spec_k}] (engine verify window), got {spec_k}")
        if spec_ngram < 0:
            raise ValueError(f"spec_ngram must be >= 0, got {spec_ngram}")
        if rid is not None or tag:
            raise _unported("request tracing ids and tags", "A11")
        if self.max_pending and len(self.pending) >= self.max_pending:
            raise QueueFullError(
                f"admission queue at max_pending={self.max_pending}; retry later")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if not temperature >= 0:  # rejects negatives and NaN
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not repetition_penalty > 0:  # rejects <= 0 and NaN
            raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
        if not -1 <= stop_byte < self.cfg.vocab:
            raise ValueError(
                f"stop_byte must be -1 (off) or a byte in "
                f"[0, {self.cfg.vocab - 1}], got {stop_byte}")
        need = self._blocks_needed(len(prompt) + max_new)
        if need > min(self.max_blocks, self.n_usable_blocks):
            raise ValueError(
                f"request needs {need} blocks > capacity "
                f"({self.max_blocks} blocks/slot, pool "
                f"{self.n_usable_blocks} blocks)")
        req = _Request(self._next_id, prompt, max_new, float(temperature), int(seed),
                       float(repetition_penalty), int(stop_byte), spec,
                       int(spec_k) or self.spec_k, int(spec_ngram) or self.spec_ngram,
                       int(priority))
        self._next_id += 1
        if self.replica_index is not None:
            req.hops.append(self.replica_index)
        self.pending.append(req)
        return req.req_id

    def _blocks_needed(self, n_positions: int) -> int:
        return -(-n_positions // self.block_size)

    def _lookup_prefix(self, prompt: np.ndarray):
        """Longest cached block-aligned prefix of the prefill region
        (prompt[:-1]): (shared_blocks, shared_positions).  The radix walk
        returns the longest partial hit; the dict probes the digest chain
        and confirms the deepest exact hit against its key bytes."""
        nb_full = (len(prompt) - 1) // self.block_size
        if nb_full <= 0:
            return [], 0
        if self._radix is not None:
            blocks, nb = self._radix.lookup(prompt[: nb_full * self.block_size])
            return blocks, nb * self.block_size
        key = prompt[: nb_full * self.block_size].tobytes()
        step = self.block_size * prompt.itemsize
        best = 0
        for j, d in enumerate(_chain_digests(key, step), start=1):
            if d in self._pc_by_digest:
                best = j
        while best:
            k = key[: best * step]
            hit = self.prefix_cache.get(k)
            if hit is not None:
                self.prefix_cache.move_to_end(k)  # LRU freshen
                return list(hit), best * self.block_size
            best -= 1
        return [], 0

    def _read_blocks(self, blocks: List[int]) -> Tuple[list, list]:
        """Host copies of pool ``blocks`` in the pool's representation:
        (K payloads, V payloads), one per block, each ``(L, BS, kv, d)``
        (an int8 pool: a ``(data, scale)`` pair).  One gather, one copy
        and one wait for the device, counted in ``kv_fetches``."""
        kd, vd = _spill_read(self.kpool, self.vpool, self._upload(np.asarray(blocks, np.int64)))
        quantized = isinstance(kd, tuple)
        host = self._fetch_all([*kd, *vd] if quantized else [kd, vd])
        self.kv_fetches += 1
        if quantized:
            kq, ks, vq, vs = host
            return ([(kq[i], ks[i]) for i in range(len(blocks))],
                    [(vq[i], vs[i]) for i in range(len(blocks))])
        return list(host[0]), list(host[1])

    def _write_blocks(self, blocks: List[int], kparts: list, vparts: list) -> None:
        """Write host payloads (as :meth:`_read_blocks` gives them) into
        pool ``blocks``: one upload of each stacked part."""
        def stack(parts):
            if isinstance(parts[0], tuple):
                return tuple(self._to_device(torch.stack([p[i] for p in parts]))
                             for i in range(2))
            return self._to_device(torch.stack(parts))
        _spill_restore(self.kpool, self.vpool, stack(kparts), stack(vparts),
                       self._upload(np.asarray(blocks, np.int64)))

    def _spill_out(self, evicted: List[Tuple[int, Tuple[int, ...]]]):
        """Hand cold evicted blocks ``(block, token path)`` to the host tier,
        keyed by the path's digest: one read-back at an eviction boundary,
        never inside steady decode.  The blocks are already on the free
        list, but nothing writes to them before the read: the read is
        queued now, ahead of any later dispatch."""
        kparts, vparts = self._read_blocks([b for b, _ in evicted])
        for (_, path), kblk, vblk in zip(evicted, kparts, vparts):
            key = _chain_digests(np.asarray(path, np.int32).tobytes(), self.block_size * 4)[-1]
            self._spill.put(key, kblk, vblk)
            self.counters["spill_spilled"] += 1

    def _evict_prefixes(self, want_free: int):
        """Drop least-recently-used cached prefixes until ``want_free``
        blocks are free (a block a live request holds only loses the
        cache's reference).

        radix: one leaf at a time, so cold deep suffixes go first and the
        hot shared trunk stays; with the spill tier armed, a cold leaf
        (the cache's reference alone) goes to the host on its way out."""
        if self._radix is not None:
            evicted = []
            while len(self.free) < want_free and self._radix.n_blocks:
                got = self._radix.evict_leaf()
                if got is None:
                    break
                block, path = got
                self.counters["evictions"] += 1
                if self._spill is not None and self.block_refs[block] == 1:
                    evicted.append((block, path))
                self._deref(block)
            if evicted:
                self._spill_out(evicted)
            return
        while len(self.free) < want_free and self.prefix_cache:
            key, blocks = self.prefix_cache.popitem(last=False)
            d = self._pc_digest.pop(key, None)
            if d is not None and self._pc_by_digest.get(d) == key:
                del self._pc_by_digest[d]
            self.counters["evictions"] += 1
            for b in blocks:
                self._deref(b)

    def _evictable_blocks(self) -> int:
        """Blocks the cache alone holds: what eviction could free."""
        if self._radix is not None:
            # one cache reference a node: cache-only means a refcount of 1
            return sum(1 for b in self._radix.blocks() if self.block_refs[b] == 1)
        cache_refs: Dict[int, int] = {}
        for blocks in self.prefix_cache.values():
            for b in blocks:
                cache_refs[b] = cache_refs.get(b, 0) + 1
        return sum(1 for b, n in cache_refs.items() if self.block_refs[b] == n)

    def _deref(self, block: int):
        self.block_refs[block] -= 1
        if self.block_refs[block] < 0:
            raise EngineIntegrityError(f"block {block} refcount underflow")
        if self.block_refs[block] == 0:
            self.free.append(int(block))

    def _prefetch_spill(self, req: _Request, shared: List[int], shared_pos: int):
        """Extend the radix hit with host-tier blocks: probe the tier for
        successively deeper block-aligned prefixes and restore each hit into
        a free block before prefill decides what to recompute.  The restored
        blocks become ordinary radix entries (one cache reference each), so
        each one takes a free block and shortens the prefill tail by a
        block, and ``_head_admittable``'s arithmetic holds.  Runs at
        admission only; the restores leave in one upload."""
        prompt = req.prompt
        bs = self.block_size
        nb_full = (len(prompt) - 1) // bs
        j = shared_pos // bs
        if j >= nb_full or len(self._spill) == 0:
            return shared, shared_pos
        digs = _chain_digests(np.ascontiguousarray(prompt[: nb_full * bs], np.int32).tobytes(),
                              bs * 4)
        quantized = isinstance(self.kpool, tuple)
        pool_dtype = (self.kpool[0] if quantized else self.kpool).dtype
        shared = list(shared)
        got, restored, kparts, vparts = 0, [], [], []
        while j + got < nb_full and self.free:
            payload = self._spill.get(digs[j + got], pool_is_quantized=quantized,
                                      pool_dtype=pool_dtype)
            if payload is None:
                break
            b = self.free.pop()
            adopted = self._radix.insert(prompt[: (j + got + 1) * bs], shared + [b])
            for a in adopted:
                self.block_refs[a] += 1
            if adopted != [b]:
                # the path already existed past the lookup's depth: b stays free
                self.free.append(b)
                break
            restored.append(b)
            kparts.append(payload[0])
            vparts.append(payload[1])
            shared.append(b)
            got += 1
            self.counters["spill_prefetched"] += 1
        if restored:
            self._h2d = True
            self._write_blocks(restored, kparts, vparts)
        if got:
            self.counters["spill_hits"] += 1
            shared_pos = (j + got) * bs
        return shared, shared_pos

    def _admit(self):
        if self._spill_policy is not None and self.pending:
            # proactive spill past the watermark: shed a bounded batch of
            # cold leaves to the host tier at this admission boundary
            used = self.n_usable_blocks - len(self.free)
            over = self._spill_policy.overage(used, self.n_usable_blocks)
            if over > 0:
                self._evict_prefixes(len(self.free) + over)
        for s in range(self.slots):
            if self.active[s] is not None or not self.pending:
                continue
            req = self.pending[0]
            shared, shared_pos = self._lookup_prefix(req.prompt)
            if self._spill is not None:
                shared, shared_pos = self._prefetch_spill(req, shared, shared_pos)
            # pin the shared blocks now: eviction below may drop the very
            # cache entry just matched
            for b in shared:
                self.block_refs[b] += 1
            need_total = self._blocks_needed(req.total_positions())
            need_new = need_total - len(shared)
            if need_new > len(self.free):
                # evict only when eviction can admit the head this tick
                if need_new <= len(self.free) + self._evictable_blocks():
                    self._evict_prefixes(need_new)
            if need_new > len(self.free):
                for b in shared:  # unpin; retry after a release
                    self._deref(b)
                break  # FIFO: wait rather than starve the head request
            self.pending.pop(0)
            self.counters["prefix_hits" if shared else "prefix_misses"] += 1
            self.counters["admissions"] += 1
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            fresh = [self.free.pop() for _ in range(need_new)]
            for b in fresh:
                self.block_refs[b] += 1
            row = np.zeros(self.max_blocks, np.int32)
            row[:need_total] = shared + fresh
            self.tables[s] = row
            self.temps[s] = req.temperature
            self.seeds[s] = req.seed
            # a resumed sampled slot continues its stream where it stopped
            self.draws[s] = req.resume_draw
            self.penalties[s] = req.repetition_penalty
            self.seen[s] = False
            self.seen[s, req.prompt] = True
            self.active[s] = req
            p = len(req.prompt) - 1
            req.pf_end = p
            if (self.interleave and p > shared_pos
                    and (shared_pos > 0 or self.prefill_chunk)):
                # interleaved: the prefill advances one chunk per tick
                # (_prefill_tick); the device slot stays inactive until
                # the last chunk lands, and the prefix registers only then
                req.phase = "prefill"
                req.pf_pos = shared_pos
                self.lengths[s] = 0
                self.last_tok[s] = 0
                if req.spec == "draft":
                    if self.prefill_chunk:
                        req.d_pf_pos = 0  # draft windows ride the ticks too
                    else:
                        self._draft_prefill_slot(s, req)
                        req.d_pf_pos = p
            else:
                self._prefill_slot(s, req, row, shared_pos)
                if req.spec == "draft":
                    self._draft_prefill_slot(s, req)
                self._register_prefix(req.prompt, row)
                if self.handoff_at_boundary:
                    self._park_handoff(s, req)
                    continue
                req.phase = "decode"
                self._push_slot(s, True)

    def _register_prefix(self, prompt: np.ndarray, row: np.ndarray):
        """Cache this request's full prefill blocks (the cache holds its
        own reference on each).  radix: the first writer of a chunk wins,
        so the cache takes a reference on the newly adopted blocks only; a
        duplicate block this request prefilled privately frees on
        release."""
        nb_full = (len(prompt) - 1) // self.block_size
        if nb_full == 0:
            return
        if self._radix is not None:
            adopted = self._radix.insert(prompt[: nb_full * self.block_size],
                                         [int(b) for b in row[:nb_full]])
            for b in adopted:
                self.block_refs[b] += 1
            return
        key = prompt[: nb_full * self.block_size].tobytes()
        if key in self.prefix_cache:
            return
        blocks = [int(b) for b in row[:nb_full]]
        for b in blocks:
            self.block_refs[b] += 1
        self.prefix_cache[key] = blocks
        d = _chain_digests(key, self.block_size * prompt.itemsize)[-1]
        self._pc_digest[key] = d
        self._pc_by_digest[d] = key

    def _prefill_slot(self, s: int, req: _Request, row: np.ndarray, shared_pos: int = 0):
        """Fill the slot's KV for prompt[:-1], holding the last prompt
        token back for the first tick.  A cache miss prefills densely and
        scatters; a hit (or a chunked engine) extends from ``shared_pos``."""
        p = len(req.prompt) - 1
        if p > shared_pos:
            if shared_pos > 0 or self.prefill_chunk:
                start = shared_pos
                chunk = self.prefill_chunk or (p - shared_pos)
                while start < p:
                    start = self._extend_window(s, req.prompt, start, chunk, p)
                self._stall_prefill_credit += 1
            else:
                bucket = _bucket(p)
                self._note_dense_bucket(bucket)
                padded = np.zeros((1, bucket), np.int64)
                padded[0, :p] = req.prompt[:-1]
                _, kc, vc = _gen._prefill(self.model, self._upload(padded), bucket)
                _scatter_prefill(self.kpool, self.vpool, kc[:, 0], vc[:, 0],
                                 self._upload(row), shared_pos, p, bucket, self.block_size)
                self.counters["prefill_chunks"] += 1
                self._stall_prefill_dispatches += 1
                self._stall_prefill_credit += 1
        self.lengths[s] = p
        self.last_tok[s] = req.prompt[-1]

    def _draft_prefill_slot(self, s: int, req: _Request):
        """Fill the slot's dense draft cache for prompt[:-1] in one prefill
        (the draft has no paged pool and no prefix cache).  Bucket padding
        past the frontier is rewritten by the proposer before it is read."""
        p = len(req.prompt) - 1
        if p == 0:
            return
        bucket = _bucket(p)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :p] = req.prompt[:-1]
        _, kc, vc = _gen._prefill(self.draft, self._upload(padded), self._draft_cache_len)
        self.d_kc[:, s] = kc[:, 0]
        self.d_vc[:, s] = vc[:, 0]
        self.counters["prefill_chunks"] += 1
        self._stall_prefill_dispatches += 1
        self._stall_prefill_credit += 1

    def _extend_window(self, s: int, prompt: np.ndarray, start: int, chunk: int,
                       end: int) -> int:
        """Dispatch one ``paged_extend`` window for slot ``s`` (positions
        ``start .. min(start + chunk, end)``), bucketed by the chunk; the
        new cursor."""
        tail = prompt[start:min(start + chunk, end)]
        bucket = _bucket(chunk)
        if not self.prefill_chunk:
            self._note_dense_bucket(bucket, "extend")
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(tail)] = tail
        paged_extend(self.model, self._upload(padded), self.kpool, self.vpool,
                     self._upload(self.tables[s]), start, len(tail), self.cfg,
                     self.block_size, bucket)
        self.counters["prefill_chunks"] += 1
        self._stall_prefill_dispatches += 1
        return start + len(tail)

    def _note_dense_bucket(self, bucket: int, program: str = "dense"):
        """Census of the unchunked engine's prompt-length buckets, per
        program (the ``compile_buckets_*`` stats)."""
        (self._extend_buckets if program == "extend" else self._dense_buckets).add(bucket)

    # ----------------------------------------------- interleaved prefill
    def _advance_prefill(self, s: int, req: _Request):
        """Advance one prefilling slot by one ``paged_extend`` chunk (and,
        for a draft-speculating slot, one draft-cache window)."""
        p = req.pf_end
        if req.pf_pos < p:
            chunk = self.prefill_chunk or (p - req.pf_pos)
            req.pf_pos = self._extend_window(s, req.prompt, req.pf_pos, chunk, p)
            self._stall_prefill_credit += 1
            self._h2d = True
        if req.spec == "draft" and req.d_pf_pos < p:
            # chunked by construction: an unchunked engine prefills the
            # draft at admission
            n = min(self.prefill_chunk, p - req.d_pf_pos)
            padded = np.zeros((1, _bucket(self.prefill_chunk)), np.int64)
            padded[0, :n] = req.prompt[req.d_pf_pos:req.d_pf_pos + n]
            _draft_extend(self.draft, self._upload(padded), self.d_kc, self.d_vc, s,
                          req.d_pf_pos)
            req.d_pf_pos += n
            self.counters["prefill_chunks"] += 1
            self._stall_prefill_dispatches += 1
            self._stall_prefill_credit += 1
            self._h2d = True
        if req.pf_pos >= p and (req.spec != "draft" or req.d_pf_pos >= p):
            self._finish_prefill(s, req)

    def _finish_prefill(self, s: int, req: _Request):
        """Interleaved admission completes: set the host mirrors, register
        the prefix (only now: nobody may share half-written blocks) and
        activate the device slot for the next tick."""
        self.lengths[s] = req.pf_end
        self.last_tok[s] = req.prompt[-1]
        self._register_prefix(req.prompt, self.tables[s])
        if self.handoff_at_boundary:
            self._park_handoff(s, req)
            return
        req.phase = "decode"
        self._push_slot(s, True)

    def _prefill_tick(self) -> List[int]:
        """One admission tick for every prefilling slot: cancelled requests
        release at once, live ones advance one chunk; the req_ids finished
        (cancelled mid-prefill)."""
        finished: List[int] = []
        for s, req in enumerate(self.active):
            if req is None or req.phase != "prefill":
                continue
            if req.cancelled:
                self._release_slot(s, req)
                finished.append(req.req_id)
                continue
            self._advance_prefill(s, req)
        return finished

    def _drain_could_free(self) -> bool:
        """Whether draining the async window is known to release blocks:
        some decoding slot finishes inside the in-flight ticks."""
        n = len(self._inflight)
        return any(
            r is not None and r.phase == "decode"
            and (r.cancelled or len(r.out) + n >= r.max_new)
            for r in self.active)

    def _count_stalls(self, decode_waiting: bool, decode_dispatched: bool):
        """stall_ticks: prefill dispatches that rode no decode dispatch while
        a decoding slot still owed tokens (0 under interleave)."""
        if self._stall_prefill_dispatches and decode_waiting:
            credit = self._stall_prefill_credit if decode_dispatched else 0
            self.counters["stall_ticks"] += max(
                0, self._stall_prefill_dispatches - credit)

    # ---------------------------------------------------------------- decode
    def _emit(self, s: int, req: _Request, tok: int) -> bool:
        """Append one committed token to slot ``s``; True when the request
        is done (stop byte, cancel or budget)."""
        tok = int(tok)
        self.counters["tokens_out"] += 1
        req.out.append(tok)
        self.lengths[s] += 1
        self.last_tok[s] = tok
        self.seen[s, tok] = True
        stopped = req.stop_byte >= 0 and tok == req.stop_byte
        return stopped or req.cancelled or len(req.out) >= req.max_new

    def _release_slot(self, s: int, req: _Request):
        """Retire a finished request: release what admission allocated."""
        self._release_blocks(s, req)
        self._clear_slot(s)
        self._done[req.req_id] = np.asarray(req.out, np.int32)
        self.counters["requests_done"] += 1

    def _release_blocks(self, s: int, req: _Request):
        """Deref every block admission allocated for slot ``s`` and point
        its table at TRASH.  A corrupt entry (out of range, or a block nobody
        holds) raises :class:`EngineIntegrityError` before any deref, so a
        corruption cannot free a block twice."""
        used = self._blocks_needed(req.total_positions())
        row = [int(b) for b in self.tables[s, :used]]
        for b in row:
            if not 0 <= b < len(self.block_refs) or (
                    b != TRASH and self.block_refs[b] <= 0):
                raise EngineIntegrityError(
                    f"slot {s} table corrupt: block {b} "
                    f"(pool {len(self.block_refs)}, "
                    f"refs {self.block_refs[b] if 0 <= b < len(self.block_refs) else 'oob'})")
        for b in row:
            if b != TRASH:
                self._deref(b)
        self.tables[s] = TRASH

    def _clear_slot(self, s: int):
        """Reset slot ``s``'s host mirrors to idle and deactivate the device
        slot."""
        self.lengths[s] = 0
        self.last_tok[s] = 0
        self.temps[s] = 0.0
        self.penalties[s] = 1.0
        self.seen[s] = False
        self.seeds[s] = 0
        self.draws[s] = 0
        self._retire_from[s] = 0
        self.active[s] = None
        self._push_slot(s, False)

    # ---------------------------------------------------- resume, preempt
    def resubmit(self, req: _Request, fresh_id: bool = False) -> int:
        """Requeue ``req`` so that its decode resumes where it stopped: the
        mechanism behind preemption, a supervisor's replay on a rebuilt
        engine and the decode side of a handoff.

        The tokens emitted since the last resume fold into the prompt
        (``out`` keeps them, so the result is the whole stream and the
        budget is unchanged); admission then prefills them and the next
        tick continues the stream, bit-identical for greedy decoding.  A
        sampled request resumes its draw counter at ``len(out)``.

        ``req_id`` is kept (waiters keep their handle) and the id counter
        moves past it; ``fresh_id=True`` takes a new id from this engine's
        counter instead, for a request arriving from another engine."""
        if req.cancelled:
            raise ValueError("resubmit of a cancelled request")
        if len(req.out) > req.n_resumed:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(req.out[req.n_resumed:], np.int32)])
            req.n_resumed = len(req.out)
        if req.temperature > 0:
            req.resume_draw = len(req.out)
        req.phase = "decode"
        req.pf_pos = req.pf_end = req.d_pf_pos = 0
        req.resubmits += 1
        if self.replica_index is not None and (not req.hops
                                               or req.hops[-1] != self.replica_index):
            req.hops.append(self.replica_index)
        if fresh_id:
            req.req_id = self._next_id
        self._next_id = max(self._next_id, req.req_id + 1)
        self.pending.append(req)
        return req.req_id

    def _preempt_for_head(self, finished: List[int]) -> bool:
        """KV pressure: the head request cannot be admitted even after
        eviction, so preempt the lowest-priority active slot whose priority
        is strictly below the head's (never an equal one: FIFO arrivals do
        not evict each other), release its blocks and requeue it right
        behind the head.  Ties go to the most recently admitted slot, the
        least prefill thrown away.  A slot parked for a handoff is not a
        victim.

        The window is drained first: the ticks in flight read the victim's
        blocks and hold tokens it has not emitted yet.  True when a slot was
        preempted or the drain itself freed one (the caller looks again)."""
        head = self.pending[0]
        victims = [(r.priority, -r.admit_seq, s) for s, r in enumerate(self.active)
                   if r is not None and not r.cancelled and r.phase != "handoff"
                   and r.priority < head.priority]
        if not victims:
            return False
        self._drain_all(finished)
        if any(r is None for r in self.active) and self._head_admittable():
            return True  # a request finished inside the window
        _, _, s = min(victims)
        req = self.active[s]
        if req is None or req.cancelled:
            return True  # the drain retired the victim
        self.counters["preemptions"] += 1
        req.preemptions += 1
        self._release_blocks(s, req)
        self._clear_slot(s)
        self.resubmit(req)
        self.pending.insert(1, self.pending.pop())
        return True

    # ----------------------------------------------------------- handoff
    def _park_handoff(self, s: int, req: _Request):
        """The end of a prefill on a prefill engine: park the request in
        phase ``"handoff"`` instead of decoding it.  No dispatch path reads
        a parked slot (each filters on the phase) and its device slot stays
        inactive, but ``active[s]`` holds it until :meth:`export_handoff`."""
        req.phase = "handoff"
        self.handoff_ready.append((s, req))

    def export_handoff(self) -> List[Tuple[_Request, List[tuple]]]:
        """Drain the parked requests: read each one's full prefill blocks
        back to the host, keyed by the digest chain the decode side's
        prefetch probes, then release its slot (the prefix it registered
        here keeps its own references).

        ``[(req, [(digest, kblk, vblk), ...]), ...]``, the blocks in the
        pool's representation (what a spill hands the host tier).  A
        cancelled request, or any on an engine without a spill tier,
        exports an empty payload; a prompt shorter than a block exports
        none either.  All blocks of the call come back in one read."""
        ready, self.handoff_ready = self.handoff_ready, []
        wanted = []
        for s, req in ready:
            digs, blocks = [], []
            if not req.cancelled and self._spill is not None:
                bs = self.block_size
                prompt = np.ascontiguousarray(req.prompt, np.int32)
                nb_full = (len(prompt) - 1) // bs
                digs = _chain_digests(prompt[: nb_full * bs].tobytes(), bs * 4)
                blocks = [int(b) for b in self.tables[s, :nb_full]]
            wanted.append((digs, blocks))
        all_blocks = [b for _, blocks in wanted for b in blocks]
        kparts, vparts = self._read_blocks(all_blocks) if all_blocks else ([], [])
        out, at = [], 0
        for (s, req), (digs, blocks) in zip(ready, wanted):
            n = len(blocks)
            out.append((req, list(zip(digs, kparts[at:at + n], vparts[at:at + n]))))
            at += n
            self._release_blocks(s, req)
            self._clear_slot(s)
        return out

    def import_handoff(self, payload: List[tuple]) -> int:
        """Land a peer's exported blocks ``[(digest, kblk, vblk), ...]`` in
        this engine's host tier, where the admission of the resubmitted
        request restores them, so its prefill recomputes only the tail
        shorter than a block.  The encoded bytes taken (what a handoff
        charges; a quantized spill dtype charges its own size)."""
        if self._spill is None:
            raise EngineConfigError("import_handoff requires spill_blocks > 0")
        return sum(self._spill.put(key, kblk, vblk) for key, kblk, vblk in payload)

    def publish_metrics(self):
        raise _unported("published engine metrics", "A11")

    def _head_admittable(self) -> bool:
        """Whether the head request could be admitted now (a free slot
        given): _admit's arithmetic without its side effects."""
        req = self.pending[0]
        shared, _ = self._lookup_prefix(req.prompt)
        need_new = self._blocks_needed(req.total_positions()) - len(shared)
        if need_new <= len(self.free):
            return True
        # the credit is computed after _admit's pin of the matched blocks
        for b in shared:
            self.block_refs[b] += 1
        try:
            return need_new <= len(self.free) + self._evictable_blocks()
        finally:
            for b in shared:
                self.block_refs[b] -= 1

    def _fetch(self, toks: torch.Tensor):
        """Start the copy of a tick's tokens to the host, right after its
        dispatch: (host tensor, event to wait on or None)."""
        if toks.device.type != "cuda":
            return toks.clone(), None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _drain_one(self, finished: List[int]):
        """Take the oldest in-flight tick's tokens (waiting on that tick
        alone) and run its host bookkeeping: emit, stop, release, window
        retirement.  A slot whose request finished in an earlier drained
        tick, or was admitted after this tick's dispatch (its snapshot),
        skips its token."""
        host, event, snap = self._inflight.pop(0)
        if event is not None:
            event.synchronize()
        nxt = host.numpy()
        if ((nxt < 0) | (nxt >= self.cfg.vocab)).any():
            raise EngineIntegrityError(
                f"drained tick carries out-of-vocab tokens {nxt.tolist()} "
                f"(non-finite logits?)")
        for s, req in enumerate(self.active):
            if req is None or snap[s] is not req:
                continue
            if self._emit(s, req, int(nxt[s])):
                self._release_slot(s, req)
                finished.append(req.req_id)
        if self.cfg.attn_window:
            self._retire_windowed_blocks()

    def _drain_all(self, finished: List[int]):
        """Sync barrier: empty the async window."""
        if not self._inflight:
            return
        self.counters["host_syncs"] += 1
        while self._inflight:
            self._drain_one(finished)

    @torch.no_grad()
    def step(self) -> List[int]:
        """One engine tick; the req_ids finished in it (under ``overlap=1``
        a request finishes the tick after its last token was computed).

        Admission does bookkeeping only and never drains the async window
        under ``interleave``; the one admission sync left is block
        reclamation, when the head request needs blocks held by a request
        that finishes inside the window; preemption drains it too."""
        finished: List[int] = []
        self._h2d = False
        self._stall_prefill_dispatches = 0
        self._stall_prefill_credit = 0
        decode_dispatched = False
        decode_waiting = any(
            r is not None and r.phase == "decode" and not r.cancelled
            and len(r.out) + len(self._inflight) < r.max_new
            for r in self.active)
        if self.pending:
            free_slot = any(r is None for r in self.active)
            if free_slot and self._head_admittable():
                if not self.interleave:
                    # synchronous admission rewrites slot state under a
                    # drained window
                    self._drain_all(finished)
                self._admit()
            elif (free_slot and self.interleave and self._inflight
                    and self._drain_could_free()):
                # block reclamation: a finishing request's blocks are the
                # head's only way in
                self._drain_all(finished)
                if self._head_admittable():
                    self._admit()
            elif self._preempt_for_head(finished):
                # a strictly higher-priority head released the lowest-priority
                # slot, which is requeued behind it
                if self.pending and self._head_admittable():
                    if not self.interleave:
                        self._drain_all(finished)
                    self._admit()
        spec = self._spec_wanted()
        if spec and self._inflight:
            # the verify tick proposes and accepts on the host: drain, then
            # look again (a stale budget only overestimates)
            self._drain_all(finished)
            spec = self._spec_wanted()
        if not any(r is not None for r in self.active):
            self._drain_all(finished)
            self._count_stalls(decode_waiting, decode_dispatched)
            self._count_h2d()
            return finished
        if spec:
            finished.extend(self._step_spec())
            self._h2d = True
            # prefill chunks ride the verify tick as they ride plain ticks
            finished.extend(self._prefill_tick())
            self._count_stalls(decode_waiting, True)
            self._count_h2d()
            return finished
        if any(r is not None and r.phase == "decode" for r in self.active):
            if self._inflight and all(
                r is None or r.phase != "decode" or r.cancelled
                or len(r.out) + len(self._inflight) >= r.max_new
                for r in self.active
            ):
                # every decoding slot's final token is already in flight:
                # drain instead of a tick no request could consume
                self._drain_one(finished)
            else:
                # which request each slot decodes for at dispatch: the
                # drain never emits this tick's token to a later occupant
                snap = [r if (r is not None and r.phase == "decode") else None
                        for r in self.active]
                toks = paged_tick(self.model, self._dev, self.kpool, self.vpool, self.cfg,
                                  self.block_size, self.attn,
                                  sampled=bool((self.temps > 0).any()))
                self._inflight.append((*self._fetch(toks), snap))
                self.counters["ticks"] += 1
                decode_dispatched = True
                while len(self._inflight) > self.overlap:
                    self._drain_one(finished)
        finished.extend(self._prefill_tick())
        if not any(r is not None for r in self.active):
            # the wave ended: drain stragglers
            self._drain_all(finished)
        self._count_stalls(decode_waiting, decode_dispatched)
        self._count_h2d()
        return finished

    def _count_h2d(self):
        if self._h2d:
            self.counters["h2d_ticks"] += 1
            self._h2d = False

    # ------------------------------------------------------------ speculation
    def _spec_budget(self, req: _Request) -> int:
        """Drafts this round for a speculating slot: at most its own k and
        its budget less one, so every accepted position lies in the blocks
        admission allocated."""
        if req.spec == "off" or req.temperature > 0:
            return 0
        return max(0, min(req.spec_k, req.max_new - len(req.out) - 1))

    def _spec_wanted(self) -> bool:
        # a prefilling slot speculates from the tick after it activates
        return bool(self.spec_k) and any(
            r is not None and r.phase == "decode" and self._spec_budget(r) > 0
            for r in self.active)

    def _fetch_all(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Copy ``tensors`` to the host and wait for the device once: the
        copies run in stream order, so the last one's event covers all."""
        fetched = [self._fetch(t) for t in tensors]
        if fetched[-1][1] is not None:
            fetched[-1][1].synchronize()
        return [host for host, _ in fetched]

    def _fetch_wait(self, tensors: List[torch.Tensor]) -> List[np.ndarray]:
        """:meth:`_fetch_all` as numpy arrays."""
        return [host.numpy() for host in self._fetch_all(tensors)]

    def _step_spec(self) -> List[int]:
        """One speculative tick: per-slot proposals, one batched
        :func:`paged_verify` pass, and each slot's commit of its longest
        agreeing draft prefix plus the target's next token (1..k+1 tokens).
        Plain and sampled slots ride row 0 as a single-token tick and draw
        from their counters as a plain tick does.

        The dense draft's proposals stay on the device and enter the window
        there; the window, the target's choices and the row-0 tokens (and
        the logits, where a penalized slot speculates) come back in one
        copy, and the commit goes back in one :func:`_spec_commit`."""
        k, W, S = self.spec_k, self.spec_k + 1, self.slots
        dev = self.device
        tokens = np.zeros((S, W), np.int64)
        tokens[:, 0] = self.last_tok
        n_draft = np.zeros(S, np.int64)
        from_draft = np.zeros((S, W), bool)
        for s, req in enumerate(self.active):
            if req is None or req.phase != "decode":
                continue
            k_eff = self._spec_budget(req)
            if k_eff < 1:
                continue
            n_draft[s] = k_eff
            if req.spec == "draft":
                from_draft[s, 1:1 + k_eff] = True
            else:
                hist = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
                tokens[s, 1:1 + k_eff] = _lookup_propose(hist, k_eff, req.spec_ngram)
        window = self._upload(tokens)
        if from_draft.any():
            # every slot proposes from its own cache row; a device-inactive
            # slot (idle, or prefilling) writes past max_seq, where nothing
            # reads, so a prefilling draft's fresh rows stay intact
            st = self._dev
            safe_pos = torch.where(st["active"], st["lengths"],
                                   self.max_blocks * self.block_size)
            drafts = _draft_propose_slots(self.draft, st["last_tok"], self.d_kc, self.d_vc,
                                          safe_pos, k)
            drafts = torch.cat([drafts[:, :1], drafts], dim=1)  # column j = draft j
            window = torch.where(self._upload(from_draft), drafts, window)
        logits, _, _ = paged_verify(self.model, window, self.kpool, self.vpool,
                                    self._dev["tables"], self._dev["lengths"],
                                    self._upload(n_draft), self.cfg, self.block_size)
        st = self._dev
        toks0 = _sample_core(logits[:, 0], st["temps"], st["seeds"], st["draws"],
                             st["penalties"], st["seen"], bool((self.temps > 0).any()))
        ints = torch.cat([window, logits.argmax(dim=-1), toks0[:, None]], dim=1)
        need_logits = any(n_draft[s] > 0 and self.penalties[s] != 1.0 for s in range(S))
        fetched = self._fetch_wait([ints, logits.float()] if need_logits else [ints])
        self.spec_fetches += 1
        window_np, choices, nxt0 = fetched[0][:, :W], fetched[0][:, W:2 * W], fetched[0][:, -1]
        logits_np = fetched[1] if need_logits else None
        if ((choices < 0) | (choices >= self.cfg.vocab)).any():
            raise EngineIntegrityError(
                f"verify pass carries out-of-vocab tokens {choices.tolist()}")
        self.counters["ticks"] += 1
        self.counters["verify_passes"] += 1
        finished: List[int] = []
        adv = np.zeros(S, np.int64)
        last = np.zeros(S, np.int64)
        marks = np.zeros((S, W), np.int64)
        to_release = []
        for s, req in enumerate(self.active):
            if req is None or req.phase != "decode":
                continue  # a prefilling slot rode inert: TRASH table, no draft
            if n_draft[s] == 0:
                committed = [int(nxt0[s])]
            else:
                committed = self._accept(s, window_np[s], int(n_draft[s]), choices[s],
                                         None if logits_np is None else logits_np[s])
                self.counters["spec_rounds"] += 1
                self.counters["spec_accepted"] += len(committed) - 1
            for t in committed:
                if n_draft[s]:
                    self.counters["spec_tokens"] += 1
                marks[s, adv[s]] = t
                adv[s] += 1
                last[s] = t
                if self._emit(s, req, t):
                    to_release.append((s, req))
                    break
        # padding marks repeat a committed token of their row, so each
        # index of the seen scatter gets one value
        mark_vals = np.broadcast_to((adv > 0)[:, None], (S, W))
        marks = np.where(np.arange(W)[None, :] < adv[:, None], marks, marks[:, :1])
        # commit every slot before the releases, whose slot resets would
        # otherwise be advanced a second time
        _spec_commit(self._dev, self._upload(adv), self._upload(last), self._upload(marks),
                     self._upload(mark_vals))
        for s, req in to_release:
            self._release_slot(s, req)
            finished.append(req.req_id)
        if self.cfg.attn_window:
            self._retire_windowed_blocks()
        return finished

    def _accept(self, s: int, window: np.ndarray, k_eff: int, choices: np.ndarray,
                logits: Optional[np.ndarray] = None) -> List[int]:
        """One slot's greedy accept: the longest draft prefix the target
        agrees with, plus its token after that prefix; 1..k_eff+1 tokens,
        what plain greedy ticks would emit.

        The choices are the device's argmax; a penalized slot re-argmaxes
        its logits rows here with the seen set growing over the window
        (draft j is seen by every later row), as the plain tick's
        ``apply_repetition_penalty`` and argmax would, in the same float32
        operations with the same first-index tie-break."""
        drafts = window[1:1 + k_eff]
        pen = float(self.penalties[s])
        seen = self.seen[s].copy() if pen != 1.0 else None
        committed: List[int] = []
        for j in range(k_eff + 1):
            if seen is None:
                choice = int(choices[j])
            else:
                lg = logits[j]
                lg = np.where(seen, np.where(lg > 0, lg / np.float32(pen),
                                             lg * np.float32(pen)), lg)
                choice = int(np.argmax(lg))
            committed.append(choice)
            if j >= k_eff or int(drafts[j]) != choice:
                break
            if seen is not None:
                seen[choice] = True
        return committed

    def _retire_windowed_blocks(self):
        """Free KV blocks wholly behind the sliding window.

        With ``attn_window = w`` every current and future query at position
        ``q >= length`` reaches keys ``>= length - w + 1`` only, so logical
        block ``j`` is dead once ``length >= (j+1)*BS + w - 1``.  The slot
        drops its reference (a cache entry keeps its own) and its table
        entry points at TRASH."""
        w, bs = self.cfg.attn_window, self.block_size
        for s, req in enumerate(self.active):
            if req is None:
                continue
            n_dead = min(max(0, (int(self.lengths[s]) - w + 1) // bs), self.max_blocks)
            for j in range(self._retire_from[s], n_dead):
                b = int(self.tables[s, j])
                if b != TRASH:
                    self._deref(b)
                    self.tables[s, j] = TRASH
                    # the device table follows; safe under overlap, since
                    # the block is already outside every in-flight window
                    self._h2d = True
                    self._dev["tables"][s, j].fill_(TRASH)
                    self.counters["blocks_retired"] += 1
            self._retire_from[s] = max(self._retire_from[s], n_dead)

    def cancel(self, req_id: int) -> str:
        """Abandon a request: "pending" (dropped, no blocks were allocated),
        "active" (flagged; the next tick finishes it through the normal
        path) or "gone" (finished or unknown)."""
        before = len(self.pending)
        self.pending = [r for r in self.pending if r.req_id != req_id]
        if len(self.pending) != before:
            return "pending"
        for req in self.active:
            if req is not None and req.req_id == req_id:
                req.cancelled = True
                return "active"
        return "gone"

    @property
    def inflight_depth(self) -> int:
        """Ticks dispatched but not yet drained by the host."""
        return len(self._inflight)

    def stats(self) -> Dict[str, int]:
        """``tpulab``'s stats keys: the counters, pool occupancy, the cache
        and its host tier (zeros while disarmed) and the async window's
        depth; the mesh reports its disarmed values."""
        radix, spill = self._radix, self._spill
        return {
            **self.counters,
            "blocks_free": len(self.free),
            "blocks_used": self.n_usable_blocks - len(self.free),
            "blocks_total": self.n_usable_blocks,
            "cache_entries": radix.n_entries if radix is not None else len(self.prefix_cache),
            # one reference a radix node; a dict entry counts each block it lists
            "cache_bytes": self._block_bytes * (
                radix.n_blocks if radix is not None
                else sum(len(b) for b in self.prefix_cache.values())),
            "spill_host_blocks": len(spill) if spill is not None else 0,
            "spill_host_bytes": spill.nbytes if spill is not None else 0,
            "spill_capacity_blocks": spill.capacity if spill is not None else 0,
            "spill_dropped": spill.dropped if spill is not None else 0,
            "kv_pool_bytes": self._kv_pool_bytes,
            "kv_pool_device_bytes": self._kv_pool_bytes,
            "kv_pool_bytes_per_shard": self._kv_pool_bytes,
            "mesh_devices": 1,
            "compile_buckets_dense": len(self._dense_buckets),
            "compile_buckets_extend": len(self._extend_buckets),
            "inflight_depth": self.inflight_depth,
            "prefill_inflight": sum(
                1 for r in self.active if r is not None and r.phase == "prefill"),
        }

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue and the active slots; {req_id: generated tokens}
        for the requests this call completed.  Raises where nothing can
        progress (a pending request no admission can take, nothing active
        or in flight)."""
        guard = 0
        while (self.pending or self._inflight
               or any(r is not None for r in self.active)):
            before = (self.counters["ticks"], self.counters["prefill_chunks"],
                      self.counters["tokens_out"], self.counters["requests_done"],
                      len(self.pending), len(self._inflight))
            self.step()
            if (self.counters["ticks"] != before[0]
                    or self.counters["prefill_chunks"] != before[1]):
                guard += 1
                if guard > 100_000:
                    raise RuntimeError("engine did not converge")
            elif (self.counters["tokens_out"], self.counters["requests_done"],
                  len(self.pending), len(self._inflight)) == before[2:]:
                raise RuntimeError(
                    "engine cannot make progress: pending request not "
                    "admittable and nothing active or in flight")
        done, self._done = self._done, {}
        return done
