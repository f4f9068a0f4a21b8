"""Kernel B4: the flash-attention forward.

Replaces ``tpulab/ops/pallas/attention.py::_flash_kernel``, reached
through ``_flash_fwd_call`` and ``_flash_bshd``.  The public functions take
that module's layout, ``(batch, seq, heads, head_dim)``, and its
arguments ``causal``, ``window`` and ``q_offset``; they make the checks and
refusals ``_flash_bshd`` makes with its default 1024-row blocks, and have
no block knobs: the CUDA kernel (``csrc/flash_fwd.cu``) picks its own
tiles and masks by position, so it needs no padding.

K and V may be narrower than q (grouped-query attention): query head ``i``
reads kv head ``i // (heads // kv_heads)``, the contiguous mapping of
``repeat_kv``, so a call with kv-width K/V equals the call with K/V
repeated to full width.

Only the forward exists.  A tensor that requires grad is refused: the
backward kernels (ROADMAP B5, B6) come with the training slice.

:func:`flash_attention_plain` is the same function in plain PyTorch: q
prescaled by 1/sqrt(d) in f32 and rounded back to q's dtype, scores in f32
from the inputs' exact values, p rounded to v's dtype before P.V, rows
with no visible key at ``o = 0``, ``lse = -inf``.  It takes the softmax in
one pass where the kernel takes it tile by tile, so the two differ by f32
rounding, and in bf16 by the rounding of p at another running maximum.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from tpulab_torch.ops.cuda import _build

#: head dims the kernel is built for (a template parameter of csrc/flash_fwd.cu)
HEAD_DIMS = (8, 16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query rows per block (``BQ`` in csrc/flash_fwd.cu)
BLOCK_Q = 64
#: the JAX wrapper's default block; a sequence it would have to pad is
#: refused where padding is refused there
_JAX_BLOCK = 1024


def _threads(d: int) -> int:
    """Threads per block of the kernel for head dim ``d`` (``Geometry``)."""
    return BLOCK_Q * min(d // 4, 4)


def softmax_scale(d: int) -> float:
    """``np.float32(1 / sqrt(d))`` as a Python float, the wrapper's prescale."""
    return float(np.float32(1.0 / np.sqrt(d)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
           q_offset: int) -> None:
    """The refusals of ``_flash_bshd`` (default blocks), then the kernel's."""
    if window and not causal:
        raise NotImplementedError("sliding window requires causal=True")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q_offset and not causal:
        raise ValueError("q_offset requires causal=True")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (batch, seq, heads, head_dim)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    if h % k.shape[2]:
        raise ValueError(f"heads={h} must be a multiple of kv_heads={k.shape[2]}")
    # the JAX wrapper pads seq to its block (max(8, s) up to 1024, then
    # 1024) and refuses the padded cases below
    block = min(_JAX_BLOCK, max(8, s))
    if s % block:
        if q_offset:
            raise NotImplementedError(
                "q_offset requires seq % block == 0 (zero-padded keys would "
                "receive weight); pick block_q/block_k dividing seq")
        if not causal:
            raise NotImplementedError(
                "non-causal flash requires seq % block == 0 (padded keys "
                "would receive weight); pick block_q/block_k dividing seq")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; have {list(DTYPES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {d}; the kernel is built for {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention has no backward yet (ROADMAP B5/B6): call it on "
            "tensors that do not require grad")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch flash forward: ``(o, lse)``, ``o`` in q's dtype,
    ``lse`` (batch, seq, heads) f32."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    qs = (q.float() * softmax_scale(d)).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        q_pos = q_offset + torch.arange(s, device=q.device)[:, None]
        k_pos = torch.arange(s, device=q.device)[None, :]
        keep = k_pos <= q_pos
        if window:
            keep = keep & (k_pos > q_pos - window)
        scores = scores.masked_fill(~keep, -math.inf)
    m = scores.amax(dim=-1, keepdim=True)
    live = m > -math.inf
    p = torch.exp(scores - torch.where(live, m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)), torch.zeros_like(acc))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, -math.inf))
    return o.permute(0, 2, 1, 3).to(q.dtype), lse[..., 0].permute(0, 2, 1).contiguous()


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each ``|x|`` (0 where ``x`` is 0), in f32."""
    a = x.float().abs()
    _, e = torch.frexp(a)  # a = m * 2**e with m in [0.5, 1)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8), torch.zeros_like(a))


def o_tolerance(want_o: torch.Tensor) -> torch.Tensor:
    """Per-element limit on ``|o - want_o|`` for ``o`` from the kernel and
    ``want_o`` from :func:`flash_attention_plain` on the same inputs, in f32.

    float32: ``2e-5 + 2e-5 * |want_o|``: the same products summed in
    another order.  bfloat16: two bf16 ulps of the element plus two of
    the largest ``|want_o|`` in its (batch, seq, head) row.  Both round p
    to bf16, the kernel at each tile's running maximum and the plain
    version at the row's, so an element moves by a few p-roundings of the
    row's scale, and o's final rounding adds an ulp of its own.  A kernel
    that drops or doubles one key tile for a late row misses by tens of
    the row's ulps (pinned in ``tests/test_torch_flash.py``).
    """
    w = want_o.float()
    if want_o.dtype == torch.float32:
        return 2e-5 + 2e-5 * w.abs()
    row = w.abs().amax(dim=-1, keepdim=True)
    return 2 * bf16_ulp(w) + 2 * bf16_ulp(row)


def over_tolerance(o: torch.Tensor, want_o: torch.Tensor) -> float:
    """Largest ``|o - want_o|`` over its :func:`o_tolerance` (<= 1 passes;
    a row with no visible key is 0 in both, where the limit is 0 too)."""
    err = (o.float() - want_o.float()).abs()
    return float(torch.where(err == 0, 0.0, err / o_tolerance(want_o)).max())


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of exact attention over (batch, seq, heads, head_dim):
    ``o`` in q's dtype, ``lse`` (batch, seq, heads) f32.

    ``window`` > 0 (causal only) keeps each query's ``window`` most recent
    keys, itself included.  ``q_offset`` > 0 (causal only) places query row
    ``i`` at position ``q_offset + i`` while keys stay at ``0..seq-1``; a
    row that then sees no key gets ``o = 0`` and ``lse = -inf``.

    The kernel for a CUDA tensor, the plain version for a CPU tensor;
    ``launches`` counts kernel launches.
    """
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, h, d = q.shape
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _build.check_geometry((-(-s // BLOCK_Q), b * h), (_threads(d),))
    lib = _build.load_library()
    rc = lib.tl_flash_fwd(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2],
        *(t.stride(i) for t in (q, k, v) for i in range(3)),
        softmax_scale(d), int(bool(causal)), window, q_offset,
        _build.stream_handle(q.device),
    )
    flash_attention_with_lse.launches += 1
    _build.check_launch(rc, "flash forward kernel")
    return o, lse


flash_attention_with_lse.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """:func:`flash_attention_with_lse` without the logsumexp."""
    return flash_attention_with_lse(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)[0]
