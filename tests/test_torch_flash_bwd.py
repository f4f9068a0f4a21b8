"""tpulab_torch's flash-attention gradient (kernels B5 and B6 behind a
``torch.autograd.Function``; on the CPU their plain versions) held against
``jax.grad`` of tpulab's Pallas flash attention in interpret mode.

Inputs and cotangents are made from a seed with numpy and fed to both; the
loss is ``sum(o * do) + sum(lse * dlse)``, so each side's gradient is its
backward for those cotangents.  Tolerance: ``grad_tolerance`` of the JAX
gradient.  float32: ``2e-5 * (|g| + row + head)`` (row and head: the
largest magnitude of the element's (batch, seq, head) row and of its
(batch, head)): the two sum the same products in other orders, a gradient
row's terms cancel, and with GQA the port sums dk and dv over each group
of query heads inside the kernel where JAX sums the repeated heads'
gradients after.  bfloat16: two bf16 ulps of the element and of its row
(both round p and ds to bf16 before their products, from f32 values that
differ by f32 rounding, and round the result once more), plus the same
``2e-5 * head``.  The last tests show that the same limit admits the
kernels' orders of summation (key by key and query by query on the FMA
pipes, one tensor-core product's tile at a time in bfloat16) and rejects
a backward that skips one key tile.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.ops.pallas.attention import flash_attention as jax_flash
from tpulab.ops.pallas.attention import flash_attention_with_lse as jax_flash_lse

from tpulab_torch.ops.cuda.attention import (
    bwd_delta,
    flash_attention_bwd_plain,
    flash_attention_with_lse,
    flash_bwd_plain_masked,
    grad_over_tolerance,
    softmax_scale,
    visible,
)

torch.set_num_threads(2)


def _arrays(seed, b=2, s=128, h=2, d=32, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or h
    shapes = [(b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d), (b, s, h)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _jax_grads(q, k, v, do, dlse, dtype=jnp.float32, use_lse=False, **kw):
    """jax.grad of tpulab's flash (interpret mode) w.r.t. q and kv-width
    k, v (repeated to q's heads inside, as tpulab's model does)."""
    g = q.shape[2] // k.shape[2]

    def loss(q, k, v):
        k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        if not use_lse:
            return jnp.sum(jax_flash(q, k, v, **kw).astype(jnp.float32) * do)
        o, lse = jax_flash_lse(q, k, v, **kw)
        lse = jnp.where(jnp.isfinite(lse), lse, 0.0)
        return jnp.sum(o.astype(jnp.float32) * do) + jnp.sum(lse * dlse)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, jnp.dtype(dtype).name))
            for x in grads]


def _torch_grads(q, k, v, do, dlse, dtype=torch.float32, use_lse=False, **kw):
    """The port's gradient through the autograd Function; also checks it
    is exactly the plain backward (the CPU path).  It runs on the calling
    thread alone: under pytest-xdist with many workers, a worker thread of
    torch's intra-op pool has been found computing in round-toward-zero,
    which moves an f32 gradient past the limit it is held to."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v))
        o, lse = flash_attention_with_lse(q, k, v, **kw)
        tdo = torch.from_numpy(do).to(dtype)
        tdlse = torch.from_numpy(dlse) if use_lse else None
        outs, cots = [o], [tdo]
        if use_lse:
            outs.append(torch.where(torch.isfinite(lse), lse, torch.zeros(())))
            cots.append(tdlse)
        got = torch.autograd.grad(outs, (q, k, v), cots)
        plain = flash_attention_bwd_plain(
            q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), tdo,
            torch.where(torch.isfinite(lse), tdlse, torch.zeros(())) if use_lse else None, **kw)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    return got


def _assert_grads_close(got, want):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert grad_over_tolerance(g, w) <= 1, name


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_tpulab(d, causal):
    """The 1/sqrt(d) prescale's gradient: exact for d = 64 (a power of
    two), rounded for d = 16 and 32, as autodiff rounds it in tpulab."""
    arrays = _arrays(d, d=d)
    _assert_grads_close(_torch_grads(*arrays, causal=causal),
                        _jax_grads(*arrays, causal=causal))


@pytest.mark.parametrize("window", [40, 17])
def test_flash_grads_window_match_tpulab(window):
    arrays = _arrays(window, s=160)
    _assert_grads_close(_torch_grads(*arrays, window=window), _jax_grads(*arrays, window=window))


@pytest.mark.parametrize("kvh,window", [(1, 0), (2, 0), (2, 48)])
def test_flash_grads_gqa_match_tpulab_repeated(kvh, window):
    """kv-width K/V through the port against JAX on repeated K/V: dk and dv
    come back at kv width, summed over each group of query heads."""
    arrays = _arrays(kvh, s=96, h=4, kvh=kvh)
    got = _torch_grads(*arrays, window=window)
    assert got[1].shape == (2, 96, kvh, 32)
    _assert_grads_close(got, _jax_grads(*arrays, window=window))


@pytest.mark.parametrize("q_offset,window", [(128, 100), (40, 0), (64, 32)])
def test_flash_grads_q_offset_and_lse_cotangent(q_offset, window):
    """A query offset (with a window, rows that see no key: lse = -inf, no
    gradient) and a cotangent on lse, which folds into delta."""
    arrays = _arrays(q_offset, s=64)
    kw = dict(q_offset=q_offset, window=window, use_lse=True)
    got = _torch_grads(*arrays, **kw)
    want = _jax_grads(*arrays, **kw)
    if window:  # rows past the window's reach take no gradient
        dead = np.arange(64) + q_offset - window + 1 > 63
        assert dead.any() and torch.all(got[0][:, dead] == 0)
    _assert_grads_close(got, want)


def test_flash_grads_lse_cotangent_causal():
    arrays = _arrays(5, s=128)
    _assert_grads_close(_torch_grads(*arrays, use_lse=True), _jax_grads(*arrays, use_lse=True))


def test_flash_grads_padded_sequence():
    """s = 100 with 64-row blocks: JAX pads to 128 inside its wrapper, the
    port masks by position; the gradients of the real positions agree."""
    arrays = _arrays(100, s=100)
    want = _jax_grads(*arrays, block_q=64, block_k=64)
    _assert_grads_close(_torch_grads(*arrays), want)


@pytest.mark.parametrize("window", [0, 40])
def test_flash_grads_bf16_match_tpulab(window):
    arrays = _arrays(7, s=128, d=64)
    got = _torch_grads(*arrays, dtype=torch.bfloat16, window=window)
    want = _jax_grads(*arrays, dtype=jnp.bfloat16, window=window)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("d,window", [(8, 0), (32, 0), (128, 40)])
def test_flash_grads_bf16_head_dims_match_tpulab(d, window):
    """bfloat16 at the other head dims of the bf16 ``ORDER_CASES``: the
    plain backward they are held against is jax.grad of tpulab's flash."""
    arrays = _arrays(7, s=128, d=d)
    got = _torch_grads(*arrays, dtype=torch.bfloat16, window=window)
    want = _jax_grads(*arrays, dtype=jnp.bfloat16, window=window)
    _assert_grads_close(got, want)


def _kernel_order(q, k, v, do, lse, delta, keep, skip_tile=None, bk=64, bq=1, bk_dq=1):
    """The kernels' sums in PyTorch: B5 accumulates dq one tile of ``bk_dq``
    keys at a time, B6 dk and dv over each head of the GQA group one tile
    of ``bq`` queries at a time (1 on the FMA pipes, a tensor-core
    product's tile in bfloat16), p and ds rounded as the kernels round
    them.  ``skip_tile`` plants a fault: rows past that key tile (of ``bk``
    keys) do not see its keys."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if skip_tile is not None:
        pos = torch.arange(s)
        keep = keep & ~((pos[None, :] // bk == skip_tile) & (pos[:, None] >= (skip_tile + 1) * bk))
    scale = softmax_scale(d)
    qs = (q.float() * scale).to(q.dtype).float()
    kf, vf = (t.repeat_interleave(g, 2).float() for t in (k, v))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, kf) - lse.permute(0, 2, 1)[..., None])
    p = torch.where(keep, p, torch.zeros(()))
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do.float(), vf) - delta.permute(0, 2, 1)[..., None])
    dsr, pr = ds.to(q.dtype).float(), p.to(q.dtype).float()
    acc = torch.zeros(b, h, s, d)
    for j in range(0, s, bk_dq):
        t = slice(j, j + bk_dq)
        acc = acc + torch.einsum("bhqk,bkhd->bhqd", dsr[..., t], kf[:, t])
    dq = (acc.to(q.dtype).float() * scale).to(q.dtype).transpose(1, 2)
    dk = torch.zeros(b, s, k.shape[2], d)
    dv = torch.zeros_like(dk)
    for hh in range(h):
        for i in range(0, s, bq):
            t = slice(i, i + bq)
            dk[:, :, hh // g] += torch.einsum("bik,bid->bkd", dsr[:, hh, t], qs[:, t, hh])
            dv[:, :, hh // g] += torch.einsum("bik,bid->bkd", pr[:, hh, t], do.float()[:, t, hh])
    return dq, dk.to(k.dtype), dv.to(k.dtype)


# (s, h, kv_heads, d, dtype, window, q_offset, B6's query tile, B5's key
# tile): one batch row of the training step's shapes (head_dim 64 and the
# demo's 16), a window, GQA, a query offset with an lse cotangent, a
# sequence that ends inside a tile, and every head dim in bfloat16.  The
# tiles are 1 on the FMA pipes (float32) and a tensor-core product's in
# bfloat16: B6 64 queries (32 at head_dim 128), B5 64 keys
ORDER_CASES = [
    (1024, 2, 2, 64, torch.bfloat16, 0, 0, 64, 64),
    (1024, 2, 2, 64, torch.float32, 0, 0, 1, 1),
    (1024, 4, 2, 16, torch.float32, 0, 0, 1, 1),
    (1024, 2, 2, 64, torch.bfloat16, 256, 0, 64, 64),
    (512, 2, 1, 64, torch.float32, 128, 512, 1, 1),
    (512, 2, 2, 128, torch.bfloat16, 0, 0, 32, 64),
    (512, 8, 2, 64, torch.bfloat16, 0, 0, 64, 64),
    (512, 2, 1, 16, torch.bfloat16, 128, 512, 64, 64),
    (1000, 2, 2, 64, torch.bfloat16, 0, 0, 64, 64),
    (512, 4, 2, 32, torch.bfloat16, 0, 0, 64, 64),
    (512, 4, 1, 128, torch.bfloat16, 200, 0, 32, 64),
    (512, 2, 2, 64, torch.bfloat16, 128, 512, 64, 64),
    (512, 2, 2, 8, torch.bfloat16, 0, 0, 64, 64),
]


def _order_inputs(case):
    s, h, kvh, d, dtype, window, q_offset = case[:7]
    rng = np.random.default_rng(s + d + h)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(dtype)
                   for sh in ((1, s, h, d), (1, s, kvh, d), (1, s, kvh, d), (1, s, h, d)))
    from tpulab_torch.ops.cuda.attention import flash_attention_plain

    o, lse = flash_attention_plain(q, k, v, True, window, q_offset)
    dlse = torch.from_numpy(rng.standard_normal(lse.shape, dtype=np.float32)) if q_offset else None
    keep = visible(s, True, window, q_offset, "cpu")
    delta = bwd_delta(o, do, dlse)
    return (q, k, v, do, lse, delta, keep), flash_bwd_plain_masked(q, k, v, do, lse, delta, keep)


@pytest.mark.parametrize("case", ORDER_CASES)
def test_grad_tolerance_admits_the_kernels_sums(case):
    args, want = _order_inputs(case)
    for g, w in zip(_kernel_order(*args, bq=case[7], bk_dq=case[8]), want):
        assert grad_over_tolerance(g, w) <= 1


@pytest.mark.parametrize("case,tile", [(ORDER_CASES[0], 8), (ORDER_CASES[0], 14),
                                       (ORDER_CASES[1], 14), (ORDER_CASES[2], 8),
                                       (ORDER_CASES[5], 6), (ORDER_CASES[6], 6),
                                       (ORDER_CASES[8], 9), (ORDER_CASES[9], 5),
                                       (ORDER_CASES[10], 5), (ORDER_CASES[12], 5)])
def test_grad_tolerance_rejects_a_skipped_key_tile(case, tile):
    args, want = _order_inputs(case)
    for g, w in zip(_kernel_order(*args, skip_tile=tile, bq=case[7], bk_dq=case[8]), want):
        assert grad_over_tolerance(g, w) > 10


def test_visible_mask_is_the_forward_mask():
    keep = visible(10, True, 3, 2, "cpu")
    q_pos = 2 + np.arange(10)[:, None]
    k_pos = np.arange(10)[None, :]
    assert np.array_equal(keep.numpy(), (k_pos <= q_pos) & (k_pos > q_pos - 3))
    assert visible(10, False, 0, 0, "cpu") is None
    assert math.isclose(softmax_scale(64), 0.125)


@pytest.mark.parametrize("window", [0, 8])
def test_dense_attention_grads_match_tpulab(window):
    """The dense path below 1024 tokens (``attention_reference``) runs under
    autograd: its gradient equals jax.grad of tpulab's, f32 rtol = atol =
    1e-5 (the same formula, summed in other orders)."""
    from tpulab.parallel.ring import attention_reference as jax_dense

    from tpulab_torch.parallel.ring import attention_reference

    q, k, v, do, _ = _arrays(window + 3, s=48)
    want = jax.grad(lambda *a: jnp.sum(jax_dense(*a, causal=True, window=window) * do),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = attention_reference(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
