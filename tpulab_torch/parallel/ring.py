"""Sequence parallelism: ring, zigzag and Ulysses attention over a mesh
axis (the counterpart of ``tpulab.parallel.ring``), with the dense
attention oracle and the one flash-selection predicate.

Every function runs on every rank with the same full ``(batch, seq,
heads, head_dim)`` q, k and v, and gives every rank the same full result
(:mod:`tpulab_torch.parallel.spmd`'s rule, gradients included):

* **Ring** (:func:`ring_attention`): each rank keeps its sequence shard of
  q; the K/V blocks travel round the ring, one shift a step, and each
  visiting block folds into the rank's result.  The dense body folds
  score blocks into an online softmax; the flash body runs kernel B4 on
  each block and merges its ``(o, lse)`` partials with ``logaddexp``.
  With a ``window`` only the rotations that can reach a query run
  (:func:`n_live_rotations`), B4 placing the visiting block by
  ``q_offset``.
* **Zigzag** (:func:`zigzag_ring_attention`, causal only): rank ``i``
  holds half-blocks ``i`` and ``2p - 1 - i``, which gives every rank the
  same causal work; the result comes back in sequence order.
* **Ulysses** (:func:`ulysses_attention`): an all-to-all turns sequence
  shards into head groups over the whole sequence, each rank attends its
  group, and a second all-to-all turns them back.

A rank knows its index, so where ``tpulab`` selects between a block's
merge and the running result (``take``, the zigzag's ``cond``), the rank
runs only the branch it takes; a block that no query of the rank can see
(a later block of a causal ring) is not computed.  The shifts run on
every rank all the same, and each body ends in :func:`spmd.keep` of the
last K/V it held, so every rank's backward posts every shift.

Each body takes its exchanges as a parameter: a :class:`GroupExchange`
over the process group on the distributed path, or, in the
``*_in_process`` helpers that run all p bodies in one process (on one
card), a :class:`LocalExchange`, which hands rank ``idx`` the block of
rank ``(idx - t) % p``, or a :class:`LocalHeads`, which hands it its head
group of the whole input.  Nothing on the distributed path calls them.

The local attention is B4 through :func:`~tpulab_torch.ops.cuda.
attention.flash_attention_partial` (its plain version on a CPU tensor),
which refuses no local length: ``tpulab`` picks the ring's flash block to
divide it.  Ulysses calls :func:`~tpulab_torch.ops.cuda.attention.
flash_attention` as ``tpulab`` calls its ``flash_attention``, with the
default block's refusals.  The dense path is :func:`attention_reference`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from tpulab_torch.parallel import spmd
from tpulab_torch.parallel.mesh import axis_mesh

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

FLASH_AUTO_TOKENS = 1024  # "auto" switches to flash from this many local tokens


def use_flash(local_impl: str, n_tokens: int) -> bool:
    """"flash" always, "auto" from FLASH_AUTO_TOKENS tokens, "dense" never."""
    return local_impl == "flash" or (
        local_impl == "auto" and n_tokens >= FLASH_AUTO_TOKENS)


def _inv_root(d: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(d) in ``dtype`` (``np.sqrt(d).astype(q.dtype)``)."""
    return torch.tensor(math.sqrt(d), dtype=torch.float64).to(dtype)


def _causal_bias(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(q, k) additive bias: 0 where k_pos <= q_pos else NEG_INF."""
    return torch.where(k_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF).to(torch.float32)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense scaled-dot-product attention over ``(..., seq, heads, head_dim)``.

    q is divided by sqrt(d) in its own dtype before the product and the
    scores are formed in that dtype, then widened to f32 for the softmax
    (``tpulab.parallel.ring.attention_reference``).  ``window`` > 0
    (causal only) keeps each query's ``window`` most recent keys.
    """
    d = q.shape[-1]
    qs = q / _inv_root(d, q.dtype).to(q.device)
    s = torch.einsum("...qhd,...khd->...hqk", qs, k).float()
    if causal:
        n_q, n_k = q.shape[-3], k.shape[-3]
        q_pos = torch.arange(n_q, device=q.device)[:, None]
        k_pos = torch.arange(n_k, device=q.device)[None, :]
        bias = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
        s = s + bias
        if window:
            s = torch.where(q_pos - k_pos >= window, NEG_INF, s)
    elif window:
        raise NotImplementedError("sliding window requires causal=True")
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("...hqk,...khd->...qhd", p, v.float())
    o = o / p.sum(dim=-1)[..., None].transpose(-2, -3)
    return o.to(q.dtype)


def n_live_rotations(window: int, shard: int, p: int) -> int:
    """How many of a causal ring's p-1 K/V rotations can contribute under a
    sliding ``window``: the block visiting at step t sits t shards earlier,
    so its nearest (query, key) pair is (t-1)*shard + 1 apart, dead once
    that exceeds window - 1.  Shared by the dense and flash windowed
    bodies; window <= 1 (self only) needs no rotation."""
    if window <= 1:
        return 0
    return min(p - 1, 1 + (window - 2) // shard)


# ------------------------------------------------------------ exchanges


class GroupExchange:
    """A rank's exchanges over its process group (``ax``)."""

    def __init__(self, ax: spmd.Axis):
        self.ax, self.idx, self.p = ax, ax.idx, ax.p

    def rotate(self, kv: torch.Tensor, t: int) -> torch.Tensor:
        """The stacked K/V this rank holds at step ``t``: one shift of what
        it held at ``t - 1``, the block of rank ``(idx - t) % p``."""
        return spmd.ring_shift(kv, self.ax)

    def to_heads(self, q, k, v):
        """(batch, seq/p, heads, d) shards -> (batch, seq, heads/p, d): this
        rank's head group over the whole sequence, in rank order
        (``lax.all_to_all(split_axis=2, concat_axis=1, tiled=True)``)."""
        x = torch.stack([q, k, v])                                 # (3, b, sl, h, d)
        t, b, sl, h, d = x.shape
        x = x.reshape(t, b, sl, self.p, h // self.p, d).permute(3, 0, 1, 2, 4, 5)
        x = spmd.all_to_all(x, self.ax)                           # (p, 3, b, sl, hg, d)
        return x.permute(1, 2, 0, 3, 4, 5).reshape(t, b, self.p * sl, h // self.p, d).unbind(0)

    def to_seq(self, o: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`to_heads` for one tensor."""
        b, s, hg, d = o.shape
        x = o.reshape(b, self.p, s // self.p, hg, d).permute(1, 0, 2, 3, 4)
        x = spmd.all_to_all(x, self.ax)                           # (p, b, sl, hg, d)
        return x.permute(1, 2, 0, 3, 4).reshape(b, s // self.p, self.p * hg, d)


class LocalExchange:
    """A ring's p ranks in one process: rank ``idx`` is handed the stacked
    K/V block of rank ``(idx - t) % p`` from ``kv`` (every rank's, in its
    layout)."""

    def __init__(self, idx: int, p: int, kv):
        self.idx, self.p, self.kv = idx, p, kv

    def rotate(self, kv: torch.Tensor, t: int) -> torch.Tensor:
        return self.kv[(self.idx - t) % self.p]


class LocalHeads:
    """Ulysses's p ranks in one process: rank ``idx`` is handed its head
    group of the whole stacked ``qkv``."""

    def __init__(self, idx: int, p: int, qkv: torch.Tensor):
        self.idx, self.p, self.qkv = idx, p, qkv

    def to_heads(self, q, k, v):
        hg = self.qkv.shape[3] // self.p
        return self.qkv[:, :, :, self.idx * hg:(self.idx + 1) * hg].contiguous().unbind(0)

    def to_seq(self, o: torch.Tensor) -> torch.Tensor:
        return o


# ------------------------------------------------------------ dense bodies


def _block_attend(q, k, bias):
    """Scores for one (q-block, k-block) pair: (..., h, q, k) f32."""
    return torch.einsum("...qhd,...khd->...hqk", q, k).float() + bias


def _online_softmax_step(carry, s, v):
    """Fold one score block into the running (max, denom, weighted sum)."""
    m_prev, l_prev, o_prev = carry
    m_new = torch.maximum(m_prev, s.amax(dim=-1))                 # (..., h, q)
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    pv = torch.einsum("...hqk,...khd->...qhd", p, v.float())
    return m_new, l_new, o_prev * alpha[..., None].transpose(-2, -3) + pv


def _empty_carry(q: torch.Tensor):
    """(max, denom, sum) before any block: (..., h, s) and (..., s, h, d) f32."""
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    zeros_hq = o[..., 0].transpose(-1, -2)
    return zeros_hq + NEG_INF, zeros_hq.clone(), o


def _normalized(m_l_o, dtype):
    _, l, o = m_l_o
    return (o / l[..., None].transpose(-2, -3)).to(dtype)


def _ring_body(q, k, v, ex, *, causal: bool, window: int = 0):
    """One rank of the dense ring (``tpulab``'s ``_ring_body``): ``(...,
    seq/p, heads, d)`` blocks; K/V rotate, each visiting block folds into
    the online softmax with its global causal offsets and the window's
    cut; a windowed ring stops after its live rotations."""
    p, idx = ex.p, ex.idx
    sl, d = q.shape[-3], q.shape[-1]
    qs = q / _inv_root(d, q.dtype).to(q.device)
    carry = _empty_carry(q)
    local_pos = torch.arange(sl, device=q.device)
    kv = torch.stack([k, v])
    n_steps = 1 + n_live_rotations(window, sl, p) if causal and window else p
    for t in range(n_steps):
        if t:
            kv = ex.rotate(kv, t)
        src = (idx - t) % p  # the visiting block's rank
        if causal and src > idx:
            continue  # every key is later than every query: it folds in at weight 0
        bias = 0.0
        if causal:
            q_glob, k_glob = idx * sl + local_pos, src * sl + local_pos
            bias = _causal_bias(q_glob, k_glob)
            if window:
                reach = q_glob[:, None] - k_glob[None, :]
                bias = torch.where(reach >= window, NEG_INF, bias)
        carry = _online_softmax_step(carry, _block_attend(qs, kv[0], bias), kv[1])
    return spmd.keep(_normalized(carry, q.dtype), kv)


def _zigzag_body(q, k, v, ex):
    """One rank of the dense zigzag ring (``tpulab``'s ``_zigzag_body``):
    the local block is half-blocks ``[idx; 2p-1-idx]``.  Step 0 folds the
    self block causally; then a visitor from an earlier rank is attended by
    both q halves over its low half only, and one from a later rank by the
    high q half over both its halves."""
    p, idx = ex.p, ex.idx
    hl, d = q.shape[-3] // 2, q.shape[-1]
    qs = q / _inv_root(d, q.dtype).to(q.device)
    pos = torch.arange(hl, device=q.device)
    a_pos, b_pos = idx * hl + pos, (2 * p - 1 - idx) * hl + pos
    q_pos = torch.cat([a_pos, b_pos])
    qs_b = qs[..., hl:, :, :]

    def fold_high(carry, s, vb):
        m, l, o = carry
        mb, lb, ob = _online_softmax_step((m[..., hl:], l[..., hl:], o[..., hl:, :, :]), s, vb)
        return (torch.cat([m[..., :hl], mb], -1), torch.cat([l[..., :hl], lb], -1),
                torch.cat([o[..., :hl, :, :], ob], -3))

    carry = _online_softmax_step(_empty_carry(q), _block_attend(
        qs, k[..., :hl, :, :], _causal_bias(q_pos, a_pos)), v[..., :hl, :, :])
    carry = fold_high(carry, _block_attend(qs_b, k[..., hl:, :, :], _causal_bias(b_pos, b_pos)),
                      v[..., hl:, :, :])
    kv = torch.stack([k, v])
    for t in range(1, p):
        kv = ex.rotate(kv, t)
        kt, vt = kv[0], kv[1]
        if (idx - t) % p < idx:
            carry = _online_softmax_step(carry, _block_attend(qs, kt[..., :hl, :, :], 0.0),
                                         vt[..., :hl, :, :])
        else:
            carry = fold_high(carry, _block_attend(qs_b, kt, 0.0), vt)
    return spmd.keep(_normalized(carry, q.dtype), kv)


# ------------------------------------------------------------ flash bodies


def _lse_merge(o1, lse1, o2, lse2):
    """Combine two attention partials over disjoint key sets: ``o`` (..., s,
    h, d) f32 and ``lse`` (..., s, h) f32.  A partial whose rows saw no key
    (``lse = -inf``, ``o = 0``) gets weight 0, in the forward and the
    backward, as long as the other's lse is finite."""
    lse = torch.logaddexp(lse1, lse2)
    o = o1 * torch.exp(lse1 - lse)[..., None] + o2 * torch.exp(lse2 - lse)[..., None]
    return o, lse


def _attend(q, k, v, **kw):
    """B4's ``(o, lse)``, ``o`` widened to f32 for the merges."""
    from tpulab_torch.ops.cuda.attention import flash_attention_partial

    o, lse = flash_attention_partial(q, k, v, **kw)
    return o.float(), lse


def _ring_body_flash(q, k, v, ex, *, causal: bool):
    """One rank of the flash ring (``tpulab``'s ``_ring_body_flash``):
    (batch, seq/p, heads, d); each visiting block through B4, the
    ``(o, lse)`` partials merged.  In a causal ring only the blocks of
    earlier ranks merge."""
    p, idx = ex.p, ex.idx
    o, lse = _attend(q, k, v, causal=causal)
    kv = torch.stack([k, v])
    for t in range(1, p):
        kv = ex.rotate(kv, t)
        if causal and (idx - t) % p > idx:
            continue  # a later block: wholly masked
        o, lse = _lse_merge(o, lse, *_attend(q, kv[0], kv[1], causal=False))
    return spmd.keep(o.to(q.dtype), kv)


def _ring_body_flash_windowed(q, k, v, ex, *, window: int):
    """One rank of the windowed flash ring (``tpulab``'s
    ``_ring_body_flash_windowed``, causal only): the self block, then the
    :func:`n_live_rotations` live steps, step ``t`` one B4 call with
    ``q_offset = t * shard`` whose masks do the banding; rows the window
    misses return lse = -inf partials that merge at weight 0.  A rank
    whose step wrapped past rank 0 (``t > idx``) has no such keys."""
    p, idx = ex.p, ex.idx
    sl = q.shape[1]
    o, lse = _attend(q, k, v, causal=True, window=window)
    kv = torch.stack([k, v])
    for t in range(1, n_live_rotations(window, sl, p) + 1):
        kv = ex.rotate(kv, t)
        if t <= idx:
            o, lse = _lse_merge(o, lse, *_attend(q, kv[0], kv[1], causal=True, window=window,
                                                 q_offset=t * sl))
    return spmd.keep(o.to(q.dtype), kv)


def _zigzag_body_flash(q, k, v, ex):
    """One rank of the flash zigzag (``tpulab``'s ``_zigzag_body_flash``):
    every block pair as equal-length (hl x hl) B4 calls, partials merged."""
    p, idx = ex.p, ex.idx
    hl = q.shape[1] // 2
    q_a, q_b = q[:, :hl], q[:, hl:]
    o_a, lse_a = _attend(q_a, k[:, :hl], v[:, :hl], causal=True)
    o_b, lse_b = _lse_merge(*_attend(q_b, k[:, hl:], v[:, hl:], causal=True),
                            *_attend(q_b, k[:, :hl], v[:, :hl], causal=False))
    kv = torch.stack([k, v])
    for t in range(1, p):
        kv = ex.rotate(kv, t)
        kt_a, vt_a = kv[0, :, :hl], kv[1, :, :hl]
        if (idx - t) % p < idx:  # both q halves attend the visitor's low half
            o_a, lse_a = _lse_merge(o_a, lse_a, *_attend(q_a, kt_a, vt_a, causal=False))
            o_b, lse_b = _lse_merge(o_b, lse_b, *_attend(q_b, kt_a, vt_a, causal=False))
        else:  # the high q half attends both visitor halves
            o_b, lse_b = _lse_merge(o_b, lse_b, *_attend(q_b, kt_a, vt_a, causal=False))
            o_b, lse_b = _lse_merge(o_b, lse_b, *_attend(q_b, kv[0, :, hl:], kv[1, :, hl:],
                                                         causal=False))
    return spmd.keep(torch.cat([o_a, o_b], dim=1).to(q.dtype), kv)


def _ring_local_body(local_impl: str, s_local: int, causal: bool = True, window: int = 0):
    """The ring body for ``local_impl`` (shared with the model's sp
    attention in ``tpulab``): windowed flash, flash, or dense with the
    window in its bias."""
    if use_flash(local_impl, s_local):
        if window:
            return functools.partial(_ring_body_flash_windowed, window=window)
        return functools.partial(_ring_body_flash, causal=causal)
    return functools.partial(_ring_body, causal=causal, window=window)


def _zigzag_local_body(local_impl: str, s_local: int):
    if use_flash(local_impl, s_local):
        return _zigzag_body_flash
    return _zigzag_body


def _ulysses_local_attention(q, k, v, causal: bool, local_impl: str, window: int = 0):
    """One head group's attention over the whole sequence: B4 (``auto``
    from 1024 gathered tokens), or the dense oracle."""
    if use_flash(local_impl, q.shape[1]):
        from tpulab_torch.ops.cuda.attention import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window)
    return attention_reference(q, k, v, causal=causal, window=window)


def _ulysses_body(q, k, v, ex, *, causal: bool, local_impl: str = "dense", window: int = 0):
    """One rank of Ulysses: sequence shards to a head group over the whole
    sequence, its attention, and back."""
    qh, kh, vh = ex.to_heads(q, k, v)
    return ex.to_seq(_ulysses_local_attention(qh, kh, vh, causal, local_impl, window))


# ------------------------------------------------------------ entry points


def _zigzag_perm(seq: int, p: int) -> np.ndarray:
    """The global sequence permutation of the zigzag layout (``tpulab``'s):
    rank ``i`` holds half-blocks ``i`` and ``2p - 1 - i``, in that order."""
    hl = seq // (2 * p)
    order = []
    for i in range(p):
        order.extend(range(i * hl, (i + 1) * hl))
        j = 2 * p - 1 - i
        order.extend(range(j * hl, (j + 1) * hl))
    return np.asarray(order, dtype=np.int32)


def _check_window(causal: bool, window: int) -> None:
    if window and not causal:
        raise NotImplementedError("sliding window requires causal=True")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_seq(seq: int, p: int) -> None:
    if seq % p:
        raise ValueError(f"seq {seq} not divisible by mesh axis {p}")


def _check_zigzag(seq: int, p: int) -> None:
    if seq % (2 * p):
        raise ValueError(f"zigzag needs seq divisible by 2*axis ({2 * p}); got {seq}")


def _check_ulysses(q_shape, p: int, causal: bool, local_impl: str, window: int) -> None:
    """``tpulab``'s refusals, and those its local attention would make
    after the all-to-all, made before it."""
    from tpulab_torch.ops.cuda.attention import refuse_padded

    if q_shape[2] % p:
        raise ValueError(f"heads {q_shape[2]} not divisible by mesh axis {p}")
    _check_seq(q_shape[1], p)
    if window and not causal:
        raise NotImplementedError("sliding window requires causal=True")
    if use_flash(local_impl, q_shape[1]):
        _check_window(causal, window)
        refuse_padded(q_shape[1], causal, 0)


def _sharded(body, q, k, v, ax: spmd.Axis, layout) -> torch.Tensor:
    """``body`` on this rank's shards of the full q, k, v; the full result."""
    plan = [(1, layout)] * 3
    ql, kl, vl = spmd.distribute(ax, plan, q, k, v)
    return spmd.collect(body(ql, kl, vl, GroupExchange(ax)), ax, 1, layout)


def _in_process(body, q, k, v, p: int, layout, exchange) -> torch.Tensor:
    """``body`` for each of ``p`` ranks in this process, the K/V exchange
    handed out by ``exchange(idx, p, kv)``; the full result."""
    qs, ks, vs = ([spmd.take(x, 1, layout, r) for r in range(p)] for x in (q, k, v))
    kv = [torch.stack([ks[r], vs[r]]) for r in range(p)]
    outs = [body(qs[r], ks[r], vs[r], exchange(r, p, kv)) for r in range(p)]
    return spmd.assemble(outs, 1, layout)


def ring_attention(q, k, v, *, mesh=None, axis: str = "sp", causal: bool = True,
                   local_impl: str = "dense", window: int = 0,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Exact attention over a sequence-sharded (batch, seq, heads, d)
    input; seq must divide by the axis size.  ``local_impl``: "dense" |
    "flash" | "auto" (flash from 1024 local tokens): the per-step block
    attention.  ``window`` > 0 (causal only) is sliding-window attention
    with only the live rotations.  ``backend`` shapes the mesh made when
    ``mesh`` is None (a 1-D mesh named ``axis`` over every rank)."""
    mesh = axis_mesh(mesh, axis, backend=backend)
    _check_window(causal, window)
    ax = spmd.mesh_axis(mesh, axis)
    q, k, v = (spmd.stage(x, mesh) for x in (q, k, v))
    _check_seq(q.shape[1], ax.p)
    body = _ring_local_body(local_impl, q.shape[1] // ax.p, causal, window)
    return _sharded(body, q, k, v, ax, spmd.contiguous(ax.p))


def zigzag_ring_attention(q, k, v, *, mesh=None, axis: str = "sp", local_impl: str = "dense",
                          backend: Optional[str] = None) -> torch.Tensor:
    """Load-balanced causal ring attention over (batch, seq, heads, d):
    :func:`ring_attention` with ``causal=True``, each rank holding
    half-blocks ``i`` and ``2p-1-i``; inputs and output in sequence order.
    seq must divide by twice the axis size."""
    mesh = axis_mesh(mesh, axis, backend=backend)
    ax = spmd.mesh_axis(mesh, axis)
    q, k, v = (spmd.stage(x, mesh) for x in (q, k, v))
    _check_zigzag(q.shape[1], ax.p)
    return _sharded(_zigzag_local_body(local_impl, q.shape[1] // ax.p), q, k, v, ax,
                    spmd.zigzag(ax.p))


def ulysses_attention(q, k, v, *, mesh=None, axis: str = "sp", causal: bool = True,
                      local_impl: str = "dense", window: int = 0,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Exact attention by an all-to-all head/sequence transposition; heads
    and seq must divide by the axis size.  ``local_impl``: the head group's
    attention over the gathered sequence ("flash" = B4)."""
    mesh = axis_mesh(mesh, axis, backend=backend)
    ax = spmd.mesh_axis(mesh, axis)
    q, k, v = (spmd.stage(x, mesh) for x in (q, k, v))
    _check_ulysses(q.shape, ax.p, causal, local_impl, window)
    body = functools.partial(_ulysses_body, causal=causal, local_impl=local_impl, window=window)
    return _sharded(body, q, k, v, ax, spmd.contiguous(ax.p))


# ------------------------------------------------------------ in one process


def ring_attention_in_process(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: int, *,
                              causal: bool = True, local_impl: str = "dense", window: int = 0,
                              exchange=LocalExchange) -> torch.Tensor:
    """:func:`ring_attention` over ``p`` ranks run one after another in
    this process, on q's device: the same bodies, each K/V block handed
    over by ``exchange(idx, p, kv)`` (:class:`LocalExchange`) instead of a
    shift.  Its result equals the distributed one's bytes."""
    _check_window(causal, window)
    _check_seq(q.shape[1], p)
    body = _ring_local_body(local_impl, q.shape[1] // p, causal, window)
    return _in_process(body, q, k, v, p, spmd.contiguous(p), exchange)


def zigzag_ring_attention_in_process(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: int,
                                     *, local_impl: str = "dense",
                                     exchange=LocalExchange) -> torch.Tensor:
    """:func:`zigzag_ring_attention` over ``p`` ranks in this process."""
    _check_zigzag(q.shape[1], p)
    return _in_process(_zigzag_local_body(local_impl, q.shape[1] // p), q, k, v, p,
                       spmd.zigzag(p), exchange)


def ulysses_attention_in_process(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: int, *,
                                 causal: bool = True, local_impl: str = "dense",
                                 window: int = 0) -> torch.Tensor:
    """:func:`ulysses_attention` over ``p`` ranks in this process: rank
    ``idx`` is handed its head group of the whole q, k and v, and the
    groups' results are put side by side."""
    _check_ulysses(q.shape, p, causal, local_impl, window)
    qkv = torch.stack([q, k, v])
    body = functools.partial(_ulysses_body, causal=causal, local_impl=local_impl, window=window)
    return torch.cat([body(q, k, v, LocalHeads(r, p, qkv)) for r in range(p)], dim=2)
