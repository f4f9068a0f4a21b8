"""Kernels B4, B5 and B6: the flash-attention forward and its gradient.

B4 replaces ``tpulab/ops/pallas/attention.py::_flash_kernel``, reached
through ``_flash_fwd_call`` and ``_flash_bshd``; B5 and B6 replace
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``, reached through
``_flash_bwd_call``.  The public functions take that module's layout,
``(batch, seq, heads, head_dim)``, and its arguments ``causal``, ``window``
and ``q_offset``; they make the checks and refusals ``_flash_bshd`` makes
with its default 1024-row blocks, and have no block knobs: the CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) pick their own tiles and
mask by position, so they need no padding.  The dtype picks the kernel:
float32 runs on the FMA pipes, as the Pallas kernel's ``Precision.HIGHEST``
asks; bfloat16 runs B4, B5 and B6 on the tensor cores (``wgmma``), whose
16-byte copies need 16-byte-aligned rows, so a bfloat16 operand that is
not aligned is copied first.  In bfloat16, B5 recomputes the scores with
B4's own product, so its ``p = exp(s - lse)`` comes from the scores
behind the forward's lse.

K and V may be narrower than q (grouped-query attention): query head ``i``
reads kv head ``i // (heads // kv_heads)``, the contiguous mapping of
``repeat_kv``, so a call with kv-width K/V equals the call with K/V
repeated to full width, and its dk, dv are the repeated call's summed
over each group of query heads.

Gradients: when q, k or v requires grad, :func:`flash_attention_with_lse`
runs as a ``torch.autograd.Function`` (the counterpart of
``_flash_bhsd_lse``'s ``jax.custom_vjp``) whose forward is B4 and saves q,
k, v, o and lse, and whose backward computes ``delta = rowsum(do * o) -
dlse`` with plain tensor ops (``_flash_bwd_call`` leaves it to XLA too),
then B5 (dq) and B6 (dk, dv).  Both o and lse are differentiable.  The
1/sqrt(d) prescale, which ``tpulab`` applies outside its custom_vjp, sits
inside B4 here, so B5 ends with the chain autodiff gives it: dq' rounded
to q's dtype, times the scale in f32, rounded again.

Each kernel has a plain PyTorch version, the CPU path and the kernel's
oracle: :func:`flash_attention_plain` (q prescaled by 1/sqrt(d) in f32 and
rounded back to q's dtype, scores in f32 from the inputs' exact values, p
rounded to v's dtype before P.V, rows with no visible key at ``o = 0``,
``lse = -inf``), :func:`flash_attention_bwd_dq_plain` and
:func:`flash_attention_bwd_dkv_plain` (p = exp(s - lse) with masked
positions set to 0, ds and p rounded to the operand dtype before their
products, f32 sums, dk and dv summed over the GQA group in f32 and rounded
once).  They sum in another order than the kernels; the limits they are
held to are :func:`o_tolerance` and :func:`grad_tolerance`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tpulab_torch.ops.cuda import _build

#: head dims the kernel is built for (a template parameter of csrc/flash_fwd.cu)
HEAD_DIMS = (8, 16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query rows per block (``BQ`` in csrc/flash_fwd.cu)
BLOCK_Q = 64
#: threads of a tensor-core (bfloat16) block of B4, B5 or B6: one warpgroup
TC_THREADS = 128
#: the JAX wrapper's default block; a sequence it would have to pad is
#: refused where padding is refused there
_JAX_BLOCK = 1024


def _threads(d: int) -> int:
    """Threads per block of an FMA kernel for head dim ``d`` (``Geometry``)."""
    return BLOCK_Q * min(d // 4, 4)


#: the bfloat16 kernels, by their rows in ``chip_smoke.py``
TC_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def tc_shared_bytes(d: int, kernel: str) -> int:
    """Dynamic shared memory of one block of the bfloat16 ``kernel`` (one
    of :data:`TC_KERNELS`: B4, B5 or B6), in bytes (``FwdTC``, ``DqTC``
    and ``DkvTC`` in csrc/): 1024 bytes of alignment, then bf16 tiles of
    128-byte rows per 64 head dims.  B4: the q' tile and two stages of K
    and V, 64 rows each.  B5: the q' and do tiles and two stages of K and
    V, 64 rows each.  B6: the block's K and V (64 rows each) and two
    stages of q', do (64 query rows, 32 at head_dim 128), lse and delta."""
    row = 128 * (2 if d > 64 else 1)
    if kernel == "flash_fwd":
        return 1024 + 5 * BLOCK_Q * row
    if kernel == "flash_dq":
        return 1024 + 6 * BLOCK_Q * row
    if kernel == "flash_dkv":
        bt = 32 if d > 64 else 64
        return 1024 + 2 * BLOCK_Q * row + 4 * bt * row + 4 * bt * 4
    raise ValueError(f"no tensor-core kernel {kernel!r}; have {TC_KERNELS}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its base and its batch, seq and head strides are
    16-byte aligned and its head dimension contiguous (what the tensor
    cores' 16-byte copies need), else a contiguous copy."""
    e = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * e % 16 == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


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


def visible(s: int, causal: bool, window: int, q_offset: int,
            device) -> Optional[torch.Tensor]:
    """(s, s) bool: query row ``i`` sees key ``j``; None when not causal
    (every pair is visible)."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    keep = k_pos <= q_pos
    if window:
        keep = keep & (k_pos > q_pos - window)
    return keep


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
    keep = visible(s, causal, window, q_offset, q.device)
    if keep is not None:
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


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
             q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4 for a CUDA tensor, the plain version for a CPU tensor (checked)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, h, d = q.shape
    tc = q.dtype == torch.bfloat16  # the tensor-core kernel; float32 runs on the FMA pipes
    q, k, v = (_aligned(t) if tc else t if t.stride(-1) == 1 else t.contiguous()
               for t in (q, k, v))
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    smem = tc_shared_bytes(d, "flash_fwd") if tc else 0
    _build.check_geometry((-(-s // BLOCK_Q), b * h), (TC_THREADS if tc else _threads(d),), smem)
    lib = _build.load_library()
    args = (d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, s, h, k.shape[2], *(t.stride(i) for t in (q, k, v) for i in range(3)),
            softmax_scale(d), int(bool(causal)), window, q_offset)
    stream = _build.stream_handle(q.device)
    rc = lib.tl_flash_fwd_bf16(*args, smem, stream) if tc else lib.tl_flash_fwd(*args, stream)
    flash_attention_with_lse.launches += 1
    _build.check_launch(rc, "flash forward kernel")
    return o, lse


class _Flash(torch.autograd.Function):
    """B4 forward, B5 and B6 backward; both outputs differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = _forward(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):  # an unused output's cotangent arrives as zeros
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, dlse, **ctx.mask), None, None, None)


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
    ``launches`` counts kernel launches.  Where grad is on and q, k or v
    requires it, the call records B5 and B6 as its backward (second-order
    gradients are refused).
    """
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, causal, window, q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, bool(causal), window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)


flash_attention_with_lse.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """:func:`flash_attention_with_lse` without the logsumexp."""
    return flash_attention_with_lse(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)[0]


# ------------------------------------------------------------ the backward


def bwd_delta(o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """``delta = rowsum(do * o) - dlse``, (batch, seq, heads) f32: the lse
    cotangent folds in here (d lse / d s = p), so B5 and B6 run unchanged."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def flash_bwd_plain_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                           keep: Optional[torch.Tensor], want_dq: bool = True,
                           want_dkv: bool = True):
    """``(dq, dk, dv)`` in plain PyTorch under the (s, s) visibility mask
    ``keep`` (None: every pair visible); a part not wanted is None."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    scale = softmax_scale(d)
    qs = (q.float() * scale).to(q.dtype).float()
    kf, vf = (t.repeat_interleave(h // kvh, dim=2).float() for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    p = torch.exp(scores - lse.permute(0, 2, 1)[..., None])
    if keep is not None:  # select, so a row with lse = -inf gives 0, not inf * 0
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = dk = dv = None
    if want_dq:
        dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf).to(q.dtype)
        dq = (dq.float() * scale).to(q.dtype)
    if want_dkv:
        dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs)
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
        dk, dv = (t.reshape(b, s, kvh, h // kvh, d).sum(dim=3).to(k.dtype) for t in (dk, dv))
    return dq, dk, dv


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                                 window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of B5: dq, in q's dtype."""
    keep = visible(q.shape[1], causal, window, q_offset, q.device)
    return flash_bwd_plain_masked(q, k, v, do, lse, delta, keep, want_dkv=False)[0]


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                                  window: int = 0, q_offset: int = 0):
    """Plain PyTorch version of B6: ``(dk, dv)`` at kv width, in k's dtype."""
    keep = visible(q.shape[1], causal, window, q_offset, q.device)
    return flash_bwd_plain_masked(q, k, v, do, lse, delta, keep, want_dq=False)[1:]


def flash_attention_bwd_plain(q, k, v, o, lse, do, dlse=None, causal: bool = True,
                              window: int = 0, q_offset: int = 0):
    """Plain PyTorch version of :func:`flash_attention_bwd`: ``(dq, dk, dv)``."""
    keep = visible(q.shape[1], causal, window, q_offset, q.device)
    return flash_bwd_plain_masked(q, k, v, do, lse, bwd_delta(o, do, dlse), keep)


def _check_bwd(q, k, v, do, lse, delta, causal, window, q_offset) -> None:
    _check(q, k, v, causal, window, q_offset)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {tuple(q.shape[:3])} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not all(t.device == q.device for t in (do, lse, delta)):
        raise ValueError("the backward's operands lie on different devices")


def _bwd_operands(q, k, v, do, lse, delta):
    """The backward's operands as its kernels read them: contiguous, and
    in bfloat16 (the tensor-core kernels) q, k, v and do 16-byte aligned."""
    q, k, v, do, lse, delta = (t.contiguous() for t in (q, k, v, do, lse, delta))
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    return q, k, v, do, lse, delta


def _launch_bwd(kernel: str, q, k, v, do, lse, delta, outs, causal, window, q_offset) -> None:
    """B5 (``kernel="flash_dq"``) or B6 (``"flash_dkv"``) on contiguous
    operands: ``tl_flash_bwd_dq`` or ``tl_flash_bwd_dkv`` in float32 on the
    FMA pipes, their ``_bf16`` entry points on the tensor cores (operands
    16-byte aligned)."""
    b, s, h, d = q.shape
    tc = q.dtype == torch.bfloat16
    name = {"flash_dq": "tl_flash_bwd_dq", "flash_dkv": "tl_flash_bwd_dkv"}[kernel]
    name += "_bf16" if tc else ""
    smem = tc_shared_bytes(d, kernel) if tc else 0
    _build.check_geometry((-(-s // BLOCK_Q), b * (h if kernel == "flash_dq" else k.shape[2])),
                          (TC_THREADS if tc else _threads(d),), smem)
    lib = _build.load_library()
    rc = getattr(lib, name)(
        d, *(t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)),
        b, s, h, k.shape[2], softmax_scale(d), int(bool(causal)), window, q_offset,
        *((smem,) if tc else ()), _build.stream_handle(q.device),
    )
    _build.check_launch(rc, f"{name} kernel")


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = True,
                           window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """dq of flash attention from the forward's lse and ``delta``
    (:func:`bwd_delta`): kernel B5 for a CUDA tensor, the plain version for
    a CPU tensor; ``launches`` counts kernel launches."""
    window, q_offset = int(window), int(q_offset)
    _check_bwd(q, k, v, do, lse, delta, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch_bwd("flash_dq", q, k, v, do, lse, delta, (dq,), causal, window, q_offset)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` at kv width: kernel B6 for a CUDA tensor, the plain
    version for a CPU tensor; ``launches`` counts kernel launches."""
    window, q_offset = int(window), int(q_offset)
    _check_bwd(q, k, v, do, lse, delta, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch_bwd("flash_dkv", q, k, v, do, lse, delta, (dk, dv), causal, window, q_offset)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, dlse=None, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """``(dq, dk, dv)`` of :func:`flash_attention_with_lse` for the
    cotangents ``do`` and ``dlse`` (None: zero): delta in plain tensor ops,
    then B5 and B6 (their plain versions on the CPU)."""
    delta = bwd_delta(o, do, dlse)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))


def grad_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element limit on ``|g - want|`` for a gradient ``g`` (dq, dk or
    dv, (batch, seq, heads, head_dim)) from B5 or B6 and ``want`` from the
    plain backward on the same inputs, in f32.

    float32: ``GRAD_F32 * (|want| + row + head)``, where ``row`` is the
    largest ``|want|`` of its (batch, seq, head) row and ``head`` of its
    (batch, head): the kernels sum key by key (query by query) where the
    plain version sums in einsum's order, and a gradient's terms cancel
    (``sum_k ds = 0`` when dlse is 0), so rounding scales with the
    operands, not with the result; a row that sees one key has ``ds = dp
    - delta``, zero but for rounding, and only ``head`` bounds it.
    bfloat16: two bf16 ulps of the element and two of ``row`` (p and ds
    round to bf16 from f32 values that differ by f32 rounding, and the
    result rounds once more), plus ``GRAD_F32 * head``.
    """
    w = want.float()
    row = w.abs().amax(dim=-1, keepdim=True)
    head = w.abs().amax(dim=(1, 3), keepdim=True)
    if want.dtype == torch.float32:
        return GRAD_F32 * (w.abs() + row + head)
    return 2 * bf16_ulp(w) + 2 * bf16_ulp(row) + GRAD_F32 * head


#: float32 factor of :func:`grad_tolerance`
GRAD_F32 = 2e-5


def grad_over_tolerance(g: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``|g - want|`` over its :func:`grad_tolerance` (<= 1 passes;
    an element 0 in both passes)."""
    err = (g.float() - want.float()).abs()
    return float(torch.where(err == 0, 0.0, err / grad_tolerance(want)).max())
