"""tpulab_torch's flash forward (kernel B4's wrapper; on the CPU its plain
version) held against tpulab's Pallas flash attention in interpret mode.

Inputs are made from a seed with numpy and fed to both.  Tolerances:

* float32: rtol = atol = 2e-5, as ``tests/test_flash.py`` holds the Pallas
  kernel to the dense oracle: the two sum the same products in another
  order, and exp and log differ by an ulp between XLA and PyTorch.
* bfloat16: compared in float32, element by element, within
  ``o_tolerance``: two bf16 ulps of the element plus two of its row's
  largest magnitude.  Both round p to bf16 before P.V and o to bf16 at the
  end, from f32 values that differ by f32 rounding, so an element can land
  on the neighbouring bf16 value, and a p-rounding moves it by a fraction
  of the row's ulp.  The same limit holds kernel B4 to its plain version on
  the card; the last tests here show that it admits B4's tile-by-tile
  recurrence and rejects that recurrence with one key tile skipped.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.ops.pallas.attention import flash_attention as jax_flash
from tpulab.ops.pallas.attention import flash_attention_with_lse as jax_flash_lse

from tpulab_torch.ops.cuda.attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_with_lse,
    o_tolerance,
    over_tolerance,
    softmax_scale,
)

torch.set_num_threads(2)

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b=2, s=128, h=4, d=32, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or h
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


def _jax(fn, arrays, dtype=jnp.float32, **kw):
    out = fn(*(jnp.asarray(a, dtype) for a in arrays), **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(x, np.float32) for x in out)
    return np.asarray(out, np.float32)


def _torch(fn, arrays, dtype=torch.float32, **kw):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in arrays), **kw)
    if isinstance(out, tuple):
        return tuple(x.float().numpy() for x in out)
    return out.float().numpy()


@pytest.mark.parametrize("causal,s", [(True, 128), (False, 128), (True, 100),
                                      (True, 20), (True, 5), (False, 100)])
def test_flash_matches_tpulab(causal, s):
    qkv = _qkv(s, s=s)
    want_o, want_lse = _jax(jax_flash_lse, qkv, causal=causal)
    got_o, got_lse = _torch(flash_attention_with_lse, qkv, causal=causal)
    np.testing.assert_allclose(got_o, want_o, **F32_TOL)
    np.testing.assert_allclose(got_lse, want_lse, **F32_TOL)
    np.testing.assert_array_equal(_torch(flash_attention, qkv, causal=causal), got_o)


@pytest.mark.parametrize("window", [64, 100, 17, 256])
def test_flash_window_matches_tpulab(window):
    qkv = _qkv(window, s=160)
    want_o, want_lse = _jax(jax_flash_lse, qkv, window=window)
    got_o, got_lse = _torch(flash_attention_with_lse, qkv, window=window)
    np.testing.assert_allclose(got_o, want_o, **F32_TOL)
    np.testing.assert_allclose(got_lse, want_lse, **F32_TOL)


@pytest.mark.parametrize("q_offset,window", [(128, 100), (40, 0), (64, 32)])
def test_flash_q_offset_matches_tpulab(q_offset, window):
    """Rows past the window's reach see no key: o = 0 and lse = -inf."""
    qkv = _qkv(q_offset, s=64)
    kw = dict(q_offset=q_offset, window=window)
    want_o, want_lse = _jax(jax_flash_lse, qkv, **kw)
    got_o, got_lse = _torch(flash_attention_with_lse, qkv, **kw)
    dead = np.isneginf(want_lse)
    if window:
        rows = np.arange(64) + q_offset - window + 1 > 63  # first visible key past the end
        assert dead.any() and np.array_equal(dead, np.broadcast_to(rows[None, :, None], dead.shape))
    else:
        assert not dead.any()
    np.testing.assert_array_equal(np.isneginf(got_lse), dead)
    assert np.all(got_o[np.broadcast_to(dead[..., None], got_o.shape)] == 0)
    np.testing.assert_allclose(got_o, want_o, **F32_TOL)
    np.testing.assert_allclose(got_lse[~dead], want_lse[~dead], **F32_TOL)


@pytest.mark.parametrize("kvh,window", [(2, 0), (1, 0), (2, 48)])
def test_flash_gqa_equals_repeated_call(kvh, window):
    q, k, v = _qkv(kvh, s=96, h=4, kvh=kvh)
    g = 4 // kvh
    k_rep, v_rep = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    got = _torch(flash_attention_with_lse, (q, k, v), window=window)
    rep = _torch(flash_attention_with_lse, (q, k_rep, v_rep), window=window)
    for a, b in zip(got, rep):
        np.testing.assert_array_equal(a, b)
    want_o, want_lse = _jax(jax_flash_lse, (q, k_rep, v_rep), window=window)
    np.testing.assert_allclose(got[0], want_o, **F32_TOL)
    np.testing.assert_allclose(got[1], want_lse, **F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40)])
def test_flash_bf16_matches_tpulab(causal, window):
    qkv = _qkv(7, s=128)
    want_o, want_lse = _jax(jax_flash_lse, qkv, jnp.bfloat16, causal=causal, window=window)
    o, lse = flash_attention_with_lse(*(torch.from_numpy(a).to(torch.bfloat16) for a in qkv),
                                      causal=causal, window=window)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    tol = o_tolerance(torch.from_numpy(want_o).to(torch.bfloat16)).numpy()
    assert np.all(np.abs(o.float().numpy() - want_o) <= tol)
    # lse stays f32 from the same bf16 inputs: f32 tolerance
    np.testing.assert_allclose(lse.numpy(), want_lse, **F32_TOL)


REFUSALS = [
    (dict(causal=False, window=8), 128, NotImplementedError),
    (dict(window=-1), 128, ValueError),
    (dict(causal=False, q_offset=4), 128, ValueError),
    (dict(q_offset=-1), 128, ValueError),
    (dict(q_offset=8), 5, NotImplementedError),   # the JAX wrapper pads s=5
    (dict(causal=False), 5, NotImplementedError),
    (dict(causal=False, q_offset=4), 5, ValueError),
]


@pytest.mark.parametrize("kw,s,exc", REFUSALS)
def test_flash_refuses_what_tpulab_refuses(kw, s, exc):
    qkv = _qkv(0, b=1, s=s, h=2, d=8)
    with pytest.raises(exc):
        _jax(jax_flash, qkv, **kw)
    before = flash_attention_with_lse.launches
    with pytest.raises(exc):
        _torch(flash_attention, qkv, **kw)
    assert flash_attention_with_lse.launches == before


@pytest.mark.parametrize("what", ["head_dim", "dtype", "requires_grad", "kv_heads"])
def test_flash_refuses_what_the_kernel_cannot_take(what):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, b=1, s=16, h=4, d=16))
    if what == "head_dim":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
        exc = ValueError
    elif what == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        exc = ValueError
    elif what == "requires_grad":  # first-order gradients run (B5, B6); a second is refused
        q.requires_grad_(True)
        gq = torch.autograd.grad(flash_attention(q, k, v).sum(), q, create_graph=True)[0]
        with pytest.raises(RuntimeError):
            gq.sum().backward()
        return
    else:
        k, v = k[:, :, :3], v[:, :, :3]
        exc = ValueError
    with pytest.raises(exc):
        flash_attention(q, k, v)


def test_flash_plain_is_the_cpu_path():
    qkv = [torch.from_numpy(a) for a in _qkv(3, s=64)]
    o, lse = flash_attention_with_lse(*qkv, window=20)
    po, plse = flash_attention_plain(*qkv, True, 20, 0)
    assert torch.equal(o, po) and torch.equal(lse, plse)


def _tiled_recurrence(q, k, v, causal=True, window=0, q_offset=0, skip_tile=None, bk=64):
    """Kernel B4's recurrence in PyTorch: key tiles of ``bk`` in order, a
    running max, p rounded to v's dtype at that max, f32 accumulator and
    denominator rescaled at each tile.  ``skip_tile`` plants a fault: rows
    past that tile do not see its keys."""
    b, s, h, d = q.shape
    qs = (q.float() * softmax_scale(d)).to(q.dtype).float().transpose(1, 2)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    q_pos = q_offset + torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), -math.inf)
    l, acc = torch.zeros(b, h, s, 1), torch.zeros(b, h, s, d)
    for k0 in range(0, s, bk):
        k_pos = torch.arange(k0, min(k0 + bk, s))[None, :]
        keep = torch.ones(s, k_pos.shape[1], dtype=torch.bool)
        if causal:
            keep = k_pos <= q_pos
            if window:
                keep = keep & (k_pos > q_pos - window)
        if skip_tile is not None and k0 == skip_tile * bk:
            keep = keep & (q_pos < k0 + bk)
        sc = (qs @ kf[:, :, k0:k0 + bk].transpose(-1, -2)).masked_fill(~keep, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        live = m_new > -math.inf
        m_ref = torch.where(live, m_new, torch.zeros_like(m_new))
        alpha = torch.where(live, torch.exp(m - m_ref), torch.ones_like(m))
        p = torch.exp(sc - m_ref)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, k0:k0 + bk]
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    o = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)), torch.zeros_like(acc))
    return o.transpose(1, 2).to(q.dtype)


# (b, s, h, d, dtype, window, q_offset, key tile): the serving and demo
# prefills (one batch row of each), a window and a query offset at 4096,
# head_dim 128.  The key tile is the kernel's: float32 runs on the FMA
# kernel (64 keys, 32 at head_dim 128), bfloat16 on the tensor-core kernel
# (64 keys at every head dim)
TILED_CASES = [
    (1, 1024, 8, 64, torch.bfloat16, 0, 0, 64),
    (1, 1024, 8, 16, torch.float32, 0, 0, 64),
    (1, 1024, 8, 16, torch.bfloat16, 0, 0, 64),
    (1, 4096, 2, 64, torch.bfloat16, 256, 0, 64),
    (1, 4096, 2, 64, torch.bfloat16, 1024, 4096, 64),
    (1, 1024, 4, 128, torch.float32, 0, 0, 32),
    (1, 1024, 4, 128, torch.bfloat16, 0, 0, 64),
]


def _seeded(case):
    b, s, h, d, dtype = case[:5]
    rng = np.random.default_rng(s + d)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("case", TILED_CASES)
def test_o_tolerance_admits_the_kernels_recurrence(case):
    q, k, v = _seeded(case)
    window, q_offset, bk = case[5:]
    want = flash_attention_plain(q, k, v, True, window, q_offset)[0]
    assert over_tolerance(_tiled_recurrence(q, k, v, True, window, q_offset, bk=bk), want) <= 1


@pytest.mark.parametrize("case,tile", [(TILED_CASES[0], 8), (TILED_CASES[0], 14),
                                       (TILED_CASES[1], 14), (TILED_CASES[2], 14),
                                       (TILED_CASES[3], 62), (TILED_CASES[4], 62),
                                       (TILED_CASES[5], 28), (TILED_CASES[6], 14)])
def test_o_tolerance_rejects_a_skipped_key_tile(case, tile):
    q, k, v = _seeded(case)
    window, q_offset, bk = case[5:]
    want = flash_attention_plain(q, k, v, True, window, q_offset)[0]
    got = _tiled_recurrence(q, k, v, True, window, q_offset, tile, bk)
    assert over_tolerance(got, want) > 10
