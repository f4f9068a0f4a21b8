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
kernels' orders of summation (float32 B5 one key tile and B6 one query
tile of three-pass TF32 products at a time, bfloat16 one tensor-core
product's tile at a time), rejects float32 B5 and B6 with one TF32 pass
in place of three, and rejects a backward that skips one key tile.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.ops.pallas.attention import flash_attention as jax_flash
from tpulab.ops.pallas.attention import flash_attention_with_lse as jax_flash_lse

from tpulab_torch.ops.cuda._build import MAX_SHARED
from tpulab_torch.ops.cuda.attention import (
    HEAD_DIMS,
    bwd_delta,
    flash_attention_bwd_plain,
    flash_attention_with_lse,
    flash_bwd_plain_masked,
    grad_over_tolerance,
    key_tile,
    softmax_scale,
    tf32_shared_bytes,
    visible,
)
from tpulab_torch.runtime import fpenv

from test_torch_flash import tf32_product

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
    """The port's gradient through the autograd Function, on torch's two
    intra-op threads; also checks it is exactly the plain backward (the
    CPU path)."""
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


def test_torch_pool_rounds_to_nearest():
    """ROADMAP C7: both of torch's intra-op threads round to nearest here
    (the arithmetic probe of ``tpulab_torch.runtime.fpenv``)."""
    assert torch.get_num_threads() == 2
    assert fpenv.probe_modes() == {fpenv.FE_TONEAREST}


def test_port_chooses_mkl_vml_on_one_thread_first(monkeypatch):
    """ROADMAP C9: the port's CPU entry calls each VML-backed function once
    on the calling thread, at 8 elements (one thread), before any parallel
    call can race on MKL's lazy choice of code; once per process."""
    calls = []
    monkeypatch.setattr(fpenv, "_VML_FUNCTIONS", tuple(
        (lambda fn: lambda x: calls.append((fn.__name__, x.numel(), x.dtype)) or fn(x))(fn)
        for fn in fpenv._VML_FUNCTIONS))
    fpenv.init_vml.cache_clear()
    try:
        fpenv.ensure_nearest()
        fpenv.ensure_nearest()
        made = list(calls)
    finally:
        fpenv.init_vml.cache_clear()
    assert {"exp", "log", "tanh", "sin", "cos"} <= {c[0] for c in made}
    assert len(made) == 2 * len(fpenv._VML_FUNCTIONS)  # float32 and float64, once
    assert all(n == 8 for _, n, _ in made)


@pytest.mark.parametrize("mode", [fpenv.FE_TOWARDZERO, fpenv.FE_UPWARD])
def test_port_is_immune_to_a_pool_thread_off_nearest(mode):
    """C7's fault, planted: every thread of torch's pool set to round toward
    zero (or upward) before the port's backward.  The probe sees it, and
    the port's CPU entry resets the pool, so the gradient is bit-equal to
    the one computed at nearest."""
    arrays = _arrays(16, d=16)
    clean = _torch_grads(*arrays, causal=True)
    try:
        fpenv.set_pool_rounding(mode)
        assert fpenv.probe_modes() == {mode if mode == fpenv.FE_UPWARD else fpenv.FE_TOWARDZERO}
        got = _torch_grads(*arrays, causal=True)
    finally:
        fpenv.set_pool_rounding(fpenv.FE_TONEAREST)
    for a, b in zip(got, clean):
        assert torch.equal(a, b)


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


def _kernel_order(q, k, v, do, lse, delta, keep, skip_tile=None, bk=64, bq=1, bk_dq=1,
                  products="f32"):
    """The kernels' sums in PyTorch, every product formed as ``products``
    says (:func:`test_torch_flash.tf32_product`), p and ds rounded as the
    kernels round them: the scores S and dP once for both; B5 accumulates
    dq one tile of ``bk_dq`` keys at a time, each tile's dS K added in f32;
    B6 dk and dv over each head of the GQA group one tile of ``bq`` queries
    at a time (a tensor-core product's tile), P^T do and dS^T q' per tile.
    ``skip_tile`` plants a fault: rows past that key tile (of ``bk`` keys)
    do not see its keys."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if skip_tile is not None:
        pos = torch.arange(s)
        keep = keep & ~((pos[None, :] // bk == skip_tile) & (pos[:, None] >= (skip_tile + 1) * bk))
    scale = softmax_scale(d)
    qs = (q.float() * scale).to(q.dtype).float()
    kf, vf = (t.repeat_interleave(g, 2).float() for t in (k, v))
    lse_t, delta_t = (t.permute(0, 2, 1)[..., None] for t in (lse, delta))

    def p_ds(scores, dps):
        p = torch.where(keep, torch.exp(scores - lse_t), torch.zeros(()))
        ds = p * (dps - delta_t)
        return p.to(q.dtype).float(), ds.to(q.dtype).float()

    heads = lambda x: x.transpose(1, 2)  # (b, s, h, d) -> (b, h, s, d)
    pr, dsr = p_ds(tf32_product(heads(qs), heads(kf).transpose(-1, -2), products),
                   tf32_product(heads(do.float()), heads(vf).transpose(-1, -2), products))
    # B5: dq one key tile at a time
    acc = torch.zeros(b, h, s, d)
    for j in range(0, s, bk_dq):
        t = slice(j, j + bk_dq)
        acc = acc + tf32_product(dsr[..., t], heads(kf)[:, :, t], products)
    dq = (acc.to(q.dtype).float() * scale).to(q.dtype).transpose(1, 2)
    # B6: dk and dv one query tile at a time
    dk = torch.zeros(b, s, k.shape[2], d)
    dv = torch.zeros_like(dk)
    for hh in range(h):
        for i in range(0, s, bq):
            t = slice(i, i + bq)
            dk[:, :, hh // g] += tf32_product(dsr[:, hh, t].transpose(-1, -2), qs[:, t, hh],
                                              products)
            dv[:, :, hh // g] += tf32_product(pr[:, hh, t].transpose(-1, -2),
                                              do.float()[:, t, hh], products)
    return dq, dk.to(k.dtype), dv.to(k.dtype)


# (s, h, kv_heads, d, dtype, window, q_offset, B6's query tile, B5's key
# tile, the products): one batch row of the training step's shapes (head_dim
# 64 and the demo's 16), a window, GQA, a query offset with an lse cotangent,
# a sequence that ends inside a tile, and every head dim in bfloat16.  The
# tiles and products are the kernels': in float32 B5 and B6 run three TF32
# passes (``"tf32x3"``), B5 over B4's key tiles (64 keys, 32 from head_dim
# 64 on: ``key_tile``), B6 over 64 queries (32 at head_dim 128); in
# bfloat16 B6 sums 64 queries (32 at head_dim 128) and B5 64 keys, their
# products exact in f32
ORDER_CASES = [
    (1024, 2, 2, 64, torch.bfloat16, 0, 0, 64, 64, "f32"),
    (1024, 2, 2, 64, torch.float32, 0, 0, 64, 32, "tf32x3"),
    (1024, 4, 2, 16, torch.float32, 0, 0, 64, 64, "tf32x3"),
    (1024, 2, 2, 64, torch.bfloat16, 256, 0, 64, 64, "f32"),
    (512, 2, 1, 64, torch.float32, 128, 512, 64, 32, "tf32x3"),
    (512, 2, 2, 128, torch.bfloat16, 0, 0, 32, 64, "f32"),
    (512, 8, 2, 64, torch.bfloat16, 0, 0, 64, 64, "f32"),
    (512, 2, 1, 16, torch.bfloat16, 128, 512, 64, 64, "f32"),
    (1000, 2, 2, 64, torch.bfloat16, 0, 0, 64, 64, "f32"),
    (512, 4, 2, 32, torch.bfloat16, 0, 0, 64, 64, "f32"),
    (512, 4, 1, 128, torch.bfloat16, 200, 0, 32, 64, "f32"),
    (512, 2, 2, 64, torch.bfloat16, 128, 512, 64, 64, "f32"),
    (512, 2, 2, 8, torch.bfloat16, 0, 0, 64, 64, "f32"),
    (1024, 4, 4, 128, torch.float32, 0, 0, 32, 32, "tf32x3"),
    (2048, 2, 2, 64, torch.float32, 256, 0, 64, 32, "tf32x3"),
]
F32_ORDER_CASES = [c for c in ORDER_CASES if c[4] == torch.float32]


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
    assert case[8] == key_tile(case[3], case[4])  # B5 walks B4's key tiles
    args, want = _order_inputs(case)
    for g, w in zip(_kernel_order(*args, bq=case[7], bk_dq=case[8], products=case[9]), want):
        assert grad_over_tolerance(g, w) <= 1


@pytest.mark.parametrize("case", F32_ORDER_CASES)
def test_grad_tolerance_rejects_one_tf32_pass(case):
    """float32 B5 and B6 with one TF32 pass per product in place of three:
    ``grad_tolerance`` rejects their dq and dk by more than 10x and dv by
    more than 1x (dv's operands, p and do, carry no cancelling sum)."""
    args, want = _order_inputs(case)
    dq, dk, dv = _kernel_order(*args, bq=case[7], bk_dq=case[8], products="tf32")
    assert grad_over_tolerance(dq, want[0]) > 10
    assert grad_over_tolerance(dk, want[1]) > 10
    assert grad_over_tolerance(dv, want[2]) > 1


@pytest.mark.parametrize("d,want", [(8, 82_944), (16, 82_944), (32, 82_944), (64, 115_712),
                                    (128, 230_400)])
def test_float32_dq_shared_memory(d, want):
    """float32 B5's block: 1024 bytes of alignment, the q' and do parts (64
    rows each) and the K and V parts of B4's key tile with the next raw
    tile, each row 128 bytes a 32 head dims; within what a block may take."""
    assert d in HEAD_DIMS
    rows = 4 * 64 + 6 * key_tile(d, torch.float32)
    assert tf32_shared_bytes(d, "flash_dq") == 1024 + rows * 128 * max(1, d // 32) == want
    assert want <= MAX_SHARED


@pytest.mark.parametrize("case,tile", [(ORDER_CASES[0], 8), (ORDER_CASES[0], 14),
                                       (ORDER_CASES[1], 14), (ORDER_CASES[2], 8),
                                       (ORDER_CASES[5], 6), (ORDER_CASES[6], 6),
                                       (ORDER_CASES[8], 9), (ORDER_CASES[9], 5),
                                       (ORDER_CASES[10], 5), (ORDER_CASES[12], 5)])
def test_grad_tolerance_rejects_a_skipped_key_tile(case, tile):
    args, want = _order_inputs(case)
    for g, w in zip(_kernel_order(*args, skip_tile=tile, bq=case[7], bk_dq=case[8],
                                  products=case[9]), want):
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
