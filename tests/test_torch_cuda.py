"""tpulab_torch's CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA card and skip without one.  The file imports
neither JAX nor ``tpulab``, so on a machine without JAX it runs alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tpulab_torch.ops.cuda import _build
from tpulab_torch.ops.cuda.attention import (
    HEAD_DIMS,
    bwd_delta,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_with_lse,
    grad_over_tolerance,
    over_tolerance,
)
from tpulab_torch.ops.cuda.classify import (
    classify_u32,
    classify_u32_plain,
    pack_stats,
    screen_plain,
    stage_screen,
)
from tpulab_torch.ops.cuda.elementwise import OPS, binary, binary_plain
from tpulab_torch.ops.cuda.stencil import roberts_u32, roberts_u32_plain
from tpulab_torch.ops.mahalanobis import class_statistics
from tpulab_torch.ops.roberts import pack_rgba

torch.set_num_threads(1)

SPECIALS = [float("nan"), -float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1.0, -2.5]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    # the plain versions' f32 products must be f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])


@pytest.mark.cuda
def test_library_builds_and_loads(cuda_device):
    lib = _build.load_library()
    assert lib.tl_error_string(0).decode() == "no error"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 5), (1, 1), (1, 5), (3, 3), (17, 31), (731, 1013)])
@pytest.mark.parametrize("launch", [None, (32, 32, 16, 16), (2, 2, 16, 16), (16, 16, 1024, 1024)])
def test_roberts_kernel_matches_plain(cuda_device, shape, launch):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape + (4,), np.uint8)
    u = pack_rgba(img).to(cuda_device)
    before = roberts_u32.launches
    out = roberts_u32(u, launch)
    torch.cuda.synchronize()
    assert roberts_u32.launches == before + 1
    assert torch.equal(out, roberts_u32_plain(u))


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("launch", [None, (1, 32), (7, 1024)])
def test_elementwise_kernel_matches_plain(cuda_device, op, dtype, launch):
    rng = np.random.default_rng(3)
    a = rng.standard_normal(100_003) * np.exp2(rng.integers(-40, 40, 100_003))
    b = rng.standard_normal(100_003) * np.exp2(rng.integers(-40, 40, 100_003))
    if op in ("minimum", "maximum"):
        sa, sb = np.meshgrid(SPECIALS, SPECIALS)
        a, b = np.concatenate([a, sa.ravel()]), np.concatenate([b, sb.ravel()])
    ta = torch.from_numpy(a).to(cuda_device, dtype)
    tb = torch.from_numpy(b).to(cuda_device, dtype)
    before = binary.launches
    out = binary(op, ta, tb, launch)
    torch.cuda.synchronize()
    assert binary.launches == before + 1
    assert torch.equal(_bits(out), _bits(binary_plain(op, ta, tb)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nc", [1, 2, 7, 32])
@pytest.mark.parametrize("launch", [None, (1, 32), (256, 256)])
def test_classify_kernel_matches_plain(cuda_device, dtype, nc, launch):
    rng = np.random.default_rng(nc)
    h, w = 300, 517
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    npts = 1 if nc == 1 else 6  # nc == 1: a degenerate class, every label 255
    classes = [np.stack([rng.integers(0, w, npts), rng.integers(0, h, npts)], axis=1)
               for _ in range(nc)]
    stats = class_statistics(img, classes)
    u = pack_rgba(img).to(cuda_device)
    s = pack_stats(stats.mean, stats.inv_cov, dtype, cuda_device)
    before = classify_u32.launches
    out = classify_u32(u, s, launch, stage_screen(stats.mean, stats.inv_cov, dtype))
    torch.cuda.synchronize()
    assert classify_u32.launches == before + 1
    assert torch.equal(out, classify_u32_plain(u, s))


def _colours(cuda_device):
    """2^16 colours (r, g, (r + g) mod 256), half on the plane the near-tie
    pairs of ``chip_smoke.b3_class_sets`` bisect; alpha from a seed."""
    r, g = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    alpha = np.random.default_rng(0).integers(0, 256, r.shape)
    px = np.stack([r, g, (r + g) & 255, alpha], -1).astype(np.uint8)
    return pack_rgba(px).to(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(chip_smoke.b3_class_sets()))
@pytest.mark.parametrize("launch", [None, (1, 32), (7, 999)])
def test_classify_float64_screen_keeps_the_fold_labels(cuda_device, name, launch):
    mean, inv_cov = chip_smoke.b3_class_sets()[name]
    u = _colours(cuda_device)
    s = pack_stats(mean, inv_cov, torch.float64, cuda_device)
    screen = stage_screen(mean, inv_cov, torch.float64)
    out = classify_u32(u, s, launch, screen)
    torch.cuda.synchronize()
    assert torch.equal(out, classify_u32_plain(u, s))
    assert torch.equal(out, screen_plain(u, screen)[1])


@pytest.mark.cuda
def test_classify_zeroed_margins_lose_near_ties(cuda_device):
    # planted fault: with every margin and flag zeroed the screen alone
    # decides most near ties, and the labels must differ from the fold's
    mean, inv_cov = chip_smoke.b3_class_sets()["symmetric"]
    u = _colours(cuda_device)
    s = pack_stats(mean, inv_cov, torch.float64, cuda_device)
    faulted = chip_smoke.faulted_screen(stage_screen(mean, inv_cov, torch.float64), 0.0)
    out = classify_u32(u, s, None, faulted)
    torch.cuda.synchronize()
    assert not torch.equal(out, classify_u32_plain(u, s))
    assert torch.equal(out, screen_plain(u, faulted)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["symmetric", "twin_1e-9", "nan", "extreme_ic"])
def test_classify_float32_labels_unchanged(cuda_device, name):
    mean, inv_cov = chip_smoke.b3_class_sets()[name]
    u = _colours(cuda_device)
    s = pack_stats(mean, inv_cov, torch.float32, cuda_device)
    out = classify_u32(u, s, None, stage_screen(mean, inv_cov, torch.float32))
    torch.cuda.synchronize()
    assert torch.equal(out, classify_u32_plain(u, s))


@pytest.mark.cuda
def test_classify_refuses_a_missing_or_foreign_screen(cuda_device):
    mean, inv_cov = chip_smoke.b3_class_sets()["nan"]
    u = _colours(cuda_device)
    s = pack_stats(mean, inv_cov, torch.float64, cuda_device)
    before = classify_u32.launches
    with pytest.raises(ValueError):
        classify_u32(u, s)
    with pytest.raises(ValueError):
        classify_u32(u, s, None, stage_screen(mean, inv_cov, torch.float32))
    with pytest.raises(ValueError):
        classify_u32(u, s, None, stage_screen(mean[:2], inv_cov[:2], torch.float64))
    assert classify_u32.launches == before


# B1's quads of 4 pixels and strips of 4 rows: widths 4k + 1, 2, 3 take the
# scalar path; heights straddle the strip; 1 x N, N x 1 and 1 x 1 are edges
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (1, 130), (130, 1), (3, 5), (4, 6), (5, 7),
                                   (8, 129), (9, 128), (33, 258), (65, 1027), (257, 4096)])
@pytest.mark.parametrize("launch", [None, (33, 3, 5, 7), (1, 1, 1, 1), (64, 1, 3, 2),
                                    (32, 32, 16, 16)])
def test_roberts_quads_and_strips_match_plain(cuda_device, shape, launch):
    img = np.random.default_rng(shape[0] * 7 + shape[1]).integers(0, 256, shape + (4,), np.uint8)
    u = pack_rgba(img).to(cuda_device)
    out = roberts_u32(u, launch)
    torch.cuda.synchronize()
    assert torch.equal(out, roberts_u32_plain(u))


@pytest.mark.cuda
def test_roberts_reads_a_misaligned_plane(cuda_device):
    # a contiguous view one pixel into its storage: w % 4 == 0 but the rows
    # are not 16-byte aligned, so the kernel must take the scalar path
    img = np.random.default_rng(11).integers(0, 256, (41, 64, 4), np.uint8)
    flat = pack_rgba(img).to(cuda_device).flatten()
    u = flat[1:].narrow(0, 0, 40 * 64).view(40, 64)
    assert u.is_contiguous() and u.data_ptr() % 16 != 0
    out = roberts_u32(u)
    torch.cuda.synchronize()
    assert torch.equal(out, roberts_u32_plain(u))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_geometry_before_launch(cuda_device):
    u = torch.zeros(4, 4, dtype=torch.int32, device=cuda_device)
    before = roberts_u32.launches
    with pytest.raises(ValueError):
        roberts_u32(u, (64, 32, 1, 1))
    assert roberts_u32.launches == before


# B4 flash forward: (b, s, h, kv_heads, causal, window, q_offset)
FLASH_CASES = [
    (2, 128, 4, 4, True, 0, 0),
    (2, 128, 4, 4, False, 0, 0),
    (1, 100, 4, 4, True, 0, 0),
    (2, 20, 2, 2, True, 0, 0),
    (1, 5, 2, 2, True, 0, 0),
    (1, 300, 4, 4, True, 64, 0),
    (1, 300, 4, 4, True, 17, 0),
    (1, 300, 4, 4, True, 256, 0),
    (1, 64, 4, 4, True, 100, 128),   # rows past the window's reach: o = 0, lse = -inf
    (1, 128, 4, 4, True, 0, 40),
    (2, 200, 8, 2, True, 0, 0),     # GQA
    (1, 1030, 2, 1, True, 0, 0),
    (1, 2048, 2, 2, True, 300, 1024),
    (1, 33, 4, 1, True, 0, 0),      # under one tile, GQA group of 4
    (1, 65, 2, 2, True, 0, 0),      # one past a 64-key tile
    (2, 129, 8, 2, True, 0, 0),     # one past two tiles, GQA group of 4
    (1, 129, 4, 4, True, 40, 100),  # ragged, a window, rows past its reach (o = 0)
]


def _flash_inputs(case, d, dtype, device):
    b, s, h, kvh = case[:4]
    rng = np.random.default_rng(s * d + h)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def _assert_flash_close(got, want, dtype):
    """o element by element within ``o_tolerance``: f32 rtol = atol = 2e-5
    (sums in another order); bf16 two bf16 ulps of the element plus two of
    its row's largest |o| (p and o round to bf16 from f32 values that
    differ by f32 rounding).  lse stays f32: rtol = atol = 2e-5."""
    (o, lse), (wo, wlse) = got, want
    assert o.dtype == wo.dtype == dtype
    dead = torch.isneginf(wlse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert torch.all(o.float()[dead] == 0)
    assert over_tolerance(o, wo) <= 1
    torch.testing.assert_close(lse[~dead], wlse[~dead], rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, dtype, d, case):
    q, k, v = _flash_inputs(case, d, dtype, cuda_device)
    causal, window, q_offset = case[4:]
    before = flash_attention_with_lse.launches
    got = flash_attention_with_lse(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_with_lse.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _assert_flash_close(got, flash_attention_plain(q, k, v, causal, window, q_offset), dtype)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs(cuda_device):
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 96, 3, 4, 32)).astype(np.float32)).to(cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = flash_attention_with_lse(q, k, v, window=24)
    want = flash_attention_with_lse(q.contiguous(), k.contiguous(), v.contiguous(), window=24)
    _assert_flash_close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "misaligned"])
def test_flash_bf16_kernels_read_strided_and_misaligned_inputs(cuda_device, layout):
    """The tensor-core kernels copy 16-byte chunks: a strided view whose
    rows stay 16-byte aligned is read in place, a view that starts 2 bytes
    off is copied first; both give the bits of the contiguous call."""
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 96, 4, 32
    if layout == "strided":
        qkv = torch.from_numpy(rng.standard_normal((b, s, 4, h, d)).astype(np.float32))
        qkv = qkv.to(cuda_device, torch.bfloat16)
        q, k, v, do = (qkv[:, :, i] for i in range(4))
    else:
        flat = torch.from_numpy(rng.standard_normal(4 * b * s * h * d + 1).astype(np.float32))
        flat = flat.to(cuda_device, torch.bfloat16)[1:]
        q, k, v, do = (flat[i * b * s * h * d:(i + 1) * b * s * h * d].view(b, s, h, d)
                       for i in range(4))
        assert q.data_ptr() % 16
    assert not q.is_contiguous() or q.data_ptr() % 16
    dense = [t.clone(memory_format=torch.contiguous_format) for t in (q, k, v, do)]
    got = flash_attention_with_lse(q, k, v, window=24)
    want = flash_attention_with_lse(*dense[:3], window=24)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    delta = bwd_delta(want[0], dense[3], None)
    got_dq = flash_attention_bwd_dq(q, k, v, do, want[1], delta, window=24)
    want_dq = flash_attention_bwd_dq(*dense, want[1], delta, window=24)
    assert torch.equal(got_dq, want_dq)
    got_kv = flash_attention_bwd_dkv(q, k, v, do, want[1], delta, window=24)
    want_kv = flash_attention_bwd_dkv(*dense, want[1], delta, window=24)
    assert all(torch.equal(g, w) for g, w in zip(got_kv, want_kv))


@pytest.mark.cuda
def test_flash_bf16_kernels_run_on_tensor_cores(cuda_device):
    """The built library's SASS (cuobjdump): every bfloat16 B4, B5 and B6
    instance holds wgmma (HGMMA); every float32 B4, B5 and B6 instance holds
    wgmma for its score products and mma.sync (HMMA) for the products over
    keys or queries, three TF32 passes each; no flash instance is left on
    the FMA pipes alone."""
    sass = _build.kernel_sass(_build.build())
    tc = {name: _build.tensor_core_opcodes(text) for name, text in sass.items()}
    wgmma = [n for n in tc if any(k in n for k in ("flash_fwd_wgmma_kernel",
                                                   "flash_dq_wgmma_kernel",
                                                   "flash_dkv_wgmma_kernel"))]
    tf32 = [n for n in tc if any(k in n for k in ("flash_fwd_tf32_kernel",
                                                  "flash_dq_tf32_kernel",
                                                  "flash_dkv_tf32_kernel"))]
    assert len(wgmma) == 3 * len(HEAD_DIMS)
    assert len(tf32) == 3 * len(HEAD_DIMS)
    assert all(tc[n] == ["HGMMA"] for n in wgmma)
    assert all(tc[n] == ["HGMMA", "HMMA"] for n in tf32)
    assert not [n for n in tc if "flash" in n and not tc[n]]


@pytest.mark.cuda
def test_flash_gqa_equals_repeated_call_on_card(cuda_device):
    q, k, v = _flash_inputs((2, 256, 8, 2), 64, torch.bfloat16, cuda_device)
    got = flash_attention_with_lse(q, k, v)
    rep = flash_attention_with_lse(q, k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2))
    assert torch.equal(got[0], rep[0]) and torch.equal(got[1], rep[1])


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["head_dim", "dtype", "requires_grad"])
def test_flash_kernel_refuses_before_launch(cuda_device, what):
    q, k, v = _flash_inputs((1, 64, 2, 2), 32, torch.float32, cuda_device)
    if what == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif what == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:  # the autograd path makes the same checks before B4 launches
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
        q.requires_grad_(True)
    before = flash_attention_with_lse.launches
    with pytest.raises(ValueError):
        flash_attention_with_lse(q, k, v)
    assert flash_attention_with_lse.launches == before


def _bwd_inputs(case, d, dtype, device):
    """q, k, v, o, lse from the plain forward, and cotangents do, dlse
    (dlse only with a query offset, as ring attention gives it)."""
    q, k, v = _flash_inputs(case, d, dtype, device)
    causal, window, q_offset = case[4:]
    o, lse = flash_attention_plain(q, k, v, causal, window, q_offset)
    rng = np.random.default_rng(d + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(device, dtype)
    dlse = None
    if q_offset:
        dlse = torch.from_numpy(rng.standard_normal(lse.shape).astype(np.float32)).to(device)
    return q, k, v, o, lse, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_kernels_match_plain(cuda_device, dtype, d, case):
    """B5 (dq) and B6 (dk, dv) element by element within grad_tolerance of
    the plain backward: f32 2e-5 of the element, of its row's and of its
    (batch, head)'s largest magnitude (sums in another order, rows that
    cancel); bf16 two bf16 ulps of the element and two of its row's largest
    magnitude (p and ds round to bf16 from f32 values that differ by f32
    rounding), plus the same 2e-5 of the head's."""
    q, k, v, o, lse, do, dlse = _bwd_inputs(case, d, dtype, cuda_device)
    kw = dict(zip(("causal", "window", "q_offset"), case[4:]))
    delta = bwd_delta(o, do, dlse)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, **kw)
    for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.dtype == dtype and got.shape == w.shape, name
        assert torch.isfinite(got.float()).all(), name
        assert grad_over_tolerance(got, w) <= 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_bwd_dq_bf16_takes_b4_lse(cuda_device, d):
    """bfloat16 B5 fed the lse that B4 computed on the card (the training
    path's lse), with GQA, a window and a query offset whose last rows see
    no key, and an lse cotangent: within grad_tolerance of the plain dq on
    the same lse, and 0 on the rows that see no key.  B5 forms its scores
    with B4's own product, the scores that lse came from."""
    case = (2, 192, 8, 2, True, 96, 128)
    q, k, v = _flash_inputs(case, d, torch.bfloat16, cuda_device)
    kw = dict(zip(("causal", "window", "q_offset"), case[4:]))
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    rng = np.random.default_rng(d + 2)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda_device,
                                                                            torch.bfloat16)
    dlse = torch.from_numpy(rng.standard_normal(lse.shape).astype(np.float32)).to(cuda_device)
    dead = torch.isneginf(lse)
    assert dead.any() and not dead.all()
    delta = bwd_delta(o, do, torch.where(dead, 0.0, dlse))
    before = flash_attention_bwd_dq.launches
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == before + 1
    want = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    assert dq.dtype == torch.bfloat16 and torch.isfinite(dq.float()).all()
    assert torch.all(dq.float()[dead] == 0)
    assert grad_over_tolerance(dq, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_bwd_dq_f32_takes_b4_lse(cuda_device, d):
    """float32 B5 fed the lse that B4 computed on the card, with GQA, a
    window, a query offset whose last rows see no key with an lse
    cotangent, and a sequence that ends inside a key tile (200 keys: 3 tiles
    of 64 and 8, 6 of 32 and 8): within grad_tolerance of the plain dq on
    the same lse, and 0 on the rows that see no key.  B5 forms its scores
    with B4's three-pass product over B4's key tiles."""
    case = (2, 200, 8, 2, True, 96, 128)
    q, k, v = _flash_inputs(case, d, torch.float32, cuda_device)
    kw = dict(zip(("causal", "window", "q_offset"), case[4:]))
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    rng = np.random.default_rng(d + 3)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(cuda_device)
    dlse = torch.from_numpy(rng.standard_normal(lse.shape).astype(np.float32)).to(cuda_device)
    dead = torch.isneginf(lse)
    assert dead.any() and not dead.all()
    delta = bwd_delta(o, do, torch.where(dead, 0.0, dlse))
    before = flash_attention_bwd_dq.launches
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == before + 1
    want = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    assert dq.dtype == torch.float32 and torch.isfinite(dq).all()
    assert torch.all(dq[dead] == 0)
    assert grad_over_tolerance(dq, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_runs_b4_b5_b6(cuda_device, dtype):
    q, k, v, _, _, do, dlse = _bwd_inputs((2, 256, 8, 2, True, 0, 0), 64, dtype, cuda_device)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = [f.launches for f in (flash_attention_with_lse, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    o, lse = flash_attention_with_lse(q, k, v)
    dlse = torch.randn(lse.shape, device=cuda_device, generator=torch.Generator(
        cuda_device).manual_seed(0))
    got = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    torch.cuda.synchronize()
    after = [f.launches for f in (flash_attention_with_lse, flash_attention_bwd_dq,
                                  flash_attention_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                                     lse.detach(), do, dlse)
    for g, w in zip(got, want):
        assert grad_over_tolerance(g, w) <= 1
    with pytest.raises(RuntimeError):  # no second-order gradient
        gq = torch.autograd.grad(flash_attention_with_lse(q, k, v)[0].sum(), q,
                                 create_graph=True)[0]
        gq.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches_per_layer(cuda_device, remat):
    """One step of a flash labformer launches B5 and B6 once per layer, and
    B4 once per layer, twice with remat (the backward recomputes each
    block); serving under inference_mode launches no backward kernel."""
    from tpulab_torch.models.generate import generate
    from tpulab_torch.models.labformer import LabformerConfig, init_train_state

    cfg = LabformerConfig(d_model=64, n_heads=4, n_layers=3, d_ff=128, max_seq=64,
                          attn_impl="flash", remat=remat)
    model, state, step = init_train_state(cfg, None, seed=0, device=cuda_device)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 65)).astype(np.int32)
    kernels = (flash_attention_with_lse, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [f.launches for f in kernels]
    loss = float(step(model, state, tokens)[2])
    assert np.isfinite(loss)
    assert [f.launches - b for f, b in zip(kernels, before)] == [3 * (1 + remat), 3, 3]
    before = [f.launches for f in kernels]
    generate(model, tokens[:, :8], steps=2, temperature=0.0)
    assert [f.launches - b for f, b in zip(kernels[1:], before[1:])] == [0, 0]


# ------------------------------------------------------------ B7, paged decode


def _paged_inputs(S, M, bs, h, kvh, d, dtype, int8, seed, device):
    """q, pools (int8: quantized by the engine's recipe) and each slot's
    table over distinct pool blocks (block 0 stays TRASH)."""
    from tpulab_torch.models.paged import _kv_quant

    rng = np.random.default_rng(seed)
    P = S * M + 1
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(device)
    q = mk(S, 1, h, d).to(dtype)
    kf, vf = mk(P, bs, kvh, d), mk(P, bs, kvh, d)
    kp, vp = (_kv_quant(kf), _kv_quant(vf)) if int8 else (kf.to(dtype), vf.to(dtype))
    tables = torch.from_numpy(1 + rng.permutation(S * M).reshape(S, M).astype(np.int32))
    return q, kp, vp, tables.to(device)


#: ragged lengths: 0, 1, block edges, the full table (M = 8 blocks of 16)
PAGED_LENGTHS = [0, 1, 15, 16, 17, 64, 100, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("h,kvh", [(8, 2), (24, 2), (8, 8), (4, 1)])
@pytest.mark.parametrize("window", [0, 5, 40])
def test_paged_kernel_matches_plain(cuda_device, dtype, int8, h, kvh, window):
    """B7 against its plain version, element by element within
    ``paged_over_tolerance`` (f32 ``2e-5 + 2e-5 |want|``; bf16
    ``attention.o_tolerance``); a length-0 slot is NaN in both.  GQA groups
    of 4, 12, 1 and 4 query heads."""
    from tpulab_torch.ops.cuda.paged import (
        paged_attend_kernel,
        paged_attend_plain,
        paged_over_tolerance,
    )

    q, kp, vp, tables = _paged_inputs(8, 8, 16, h, kvh, 64, dtype, int8, h + window,
                                      cuda_device)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=cuda_device)
    before = paged_attend_kernel.launches
    got = paged_attend_kernel(q, kp, vp, tables, lengths, 16, window)
    torch.cuda.synchronize()
    assert paged_attend_kernel.launches == before + 1
    want = paged_attend_plain(q, kp, vp, tables, lengths, 16, window)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isnan(got[0]).all()) and not bool(torch.isnan(got[1:]).any())
    assert paged_over_tolerance(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_kernel_head_dims_and_block_sizes(cuda_device, d, bs):
    from tpulab_torch.ops.cuda.paged import (
        paged_attend_kernel,
        paged_attend_plain,
        paged_over_tolerance,
    )

    q, kp, vp, tables = _paged_inputs(4, 6, bs, 8, 2, d, torch.bfloat16, False, d, cuda_device)
    lengths = torch.tensor([1, bs, 3 * bs + 1, 6 * bs], dtype=torch.int32, device=cuda_device)
    got = paged_attend_kernel(q, kp, vp, tables, lengths, bs, 0)
    torch.cuda.synchronize()
    assert paged_over_tolerance(got, paged_attend_plain(q, kp, vp, tables, lengths, bs)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
def test_paged_tolerance_rejects_a_skipped_block(cuda_device, int8):
    """The limit B7 is held to rejects the plain version over each slot's
    table with one live block left out."""
    from tpulab_torch.ops.cuda.paged import (
        paged_attend_kernel,
        paged_attend_plain,
        paged_over_tolerance,
    )

    q, kp, vp, tables = _paged_inputs(8, 64, 16, 8, 2, 64, torch.bfloat16, int8, 3, cuda_device)
    lengths = torch.full((8,), 1024, dtype=torch.int32, device=cuda_device)
    got = paged_attend_kernel(q, kp, vp, tables, lengths, 16, 0)
    want = paged_attend_plain(q, kp, vp, tables, lengths, 16, 0)
    assert paged_over_tolerance(got, want) <= 1
    j = 30
    cut = torch.cat([tables[:, :j], tables[:, j + 1:], torch.zeros_like(tables[:, :1])], 1)
    skipped = paged_attend_plain(q, kp, vp, cut, lengths - 16, 16, 0)
    assert paged_over_tolerance(skipped, want) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("window", [0, 100, 256, 600])
def test_paged_kernel_split_edges_match_plain(cuda_device, dtype, int8, window):
    """32 slots of 2048 positions: 8 splits of 256 (4 chunks each).
    Lengths one short of, at and one past each of the first split edges;
    windows shorter than a span, of one span, and across two split edges."""
    from tpulab_torch.ops.cuda.paged import (
        paged_attend_kernel,
        paged_attend_plain,
        paged_over_tolerance,
        split_plan,
    )

    splits, span = split_plan(32, 2, 2048, 64)
    assert (splits, span) == (8, 256)
    q, kp, vp, tables = _paged_inputs(32, 128, 16, 8, 2, 64, dtype, int8, window, cuda_device)
    edges = [e * span + o for e in (1, 2, 3) for o in (-1, 0, 1)]
    lengths = torch.tensor((edges + [0, 1, 2047, 2048, 17, 449, 600]) * 2, dtype=torch.int32,
                           device=cuda_device)
    before = paged_attend_kernel.launches
    got = paged_attend_kernel(q, kp, vp, tables, lengths, 16, window)
    torch.cuda.synchronize()
    assert paged_attend_kernel.launches == before + 1
    want = paged_attend_plain(q, kp, vp, tables, lengths, 16, window)
    dead = lengths == 0
    assert bool(torch.isnan(got[dead]).all()) and not bool(torch.isnan(got[~dead]).any())
    assert paged_over_tolerance(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("S,M,d", [(2, 4, 64), (8, 16, 64), (32, 128, 64), (4, 64, 128),
                                   (4, 96, 8)])
def test_paged_kernel_split_plans_match_plain(cuda_device, S, M, d):
    """One split; splits of one chunk (the paged bench's shape); splits of
    several chunks (32 x 2048); head dims 128 and 8."""
    from tpulab_torch.ops.cuda.paged import (
        paged_attend_kernel,
        paged_attend_plain,
        paged_over_tolerance,
    )

    q, kp, vp, tables = _paged_inputs(S, M, 16, 8, 2, d, torch.bfloat16, False, S + d,
                                      cuda_device)
    rng = np.random.default_rng(S)
    lengths = torch.from_numpy(rng.integers(1, M * 16 + 1, S).astype(np.int32)).to(cuda_device)
    got = paged_attend_kernel(q, kp, vp, tables, lengths, 16, 0)
    torch.cuda.synchronize()
    assert paged_over_tolerance(got, paged_attend_plain(q, kp, vp, tables, lengths, 16)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
def test_paged_kernel_repeats_its_bits(cuda_device, int8):
    """Three calls give the same bits, and so does a fourth after a call at
    another shape: the merge runs in split order, the tickets reset
    themselves, and the cached workspace is not disturbed."""
    from tpulab_torch.ops.cuda.paged import paged_attend_kernel

    args = (*_paged_inputs(32, 128, 16, 8, 2, 64, torch.bfloat16, int8, 9, cuda_device),
            torch.full((32,), 2000, dtype=torch.int32, device=cuda_device), 16, 0)
    other = (*_paged_inputs(8, 16, 16, 8, 2, 64, torch.bfloat16, int8, 10, cuda_device),
             torch.full((8,), 200, dtype=torch.int32, device=cuda_device), 16, 0)
    runs = [paged_attend_kernel(*args) for _ in range(3)]
    paged_attend_kernel(*other)
    runs.append(paged_attend_kernel(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(r), _bits(runs[0])) for r in runs[1:])


@pytest.mark.cuda
def test_paged_kernel_call_does_not_sync(cuda_device):
    """A call, its first at this shape included, reads nothing back to the
    host (the lengths stay on the card) and launches one kernel."""
    from tpulab_torch.ops.cuda.paged import paged_attend_kernel

    q, kp, vp, tables = _paged_inputs(16, 40, 16, 8, 2, 64, torch.bfloat16, False, 11,
                                      cuda_device)
    lengths = torch.arange(16, dtype=torch.int32, device=cuda_device) * 40
    torch.cuda.synchronize()
    before = paged_attend_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        paged_attend_kernel(q, kp, vp, tables, lengths, 16, 0)
        paged_attend_kernel(q, kp, vp, tables, lengths, 16, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert paged_attend_kernel.launches == before + 2


@pytest.mark.cuda
def test_paged_kernel_refuses_before_launch(cuda_device):
    from tpulab_torch.ops.cuda.paged import paged_attend_kernel

    q, kp, vp, tables = _paged_inputs(2, 4, 16, 8, 2, 64, torch.float32, False, 0, cuda_device)
    lengths = torch.tensor([3, 9], dtype=torch.int32, device=cuda_device)
    narrow = [t[..., :48].contiguous() for t in (q, kp, vp)]
    before = paged_attend_kernel.launches
    for args in ((*narrow, tables, lengths, 16),               # head_dim 48
                 (q.to(torch.float16), kp, vp, tables, lengths, 16),
                 (q, kp, vp, tables, lengths.cpu(), 16),
                 (q, kp, vp, tables, lengths, 8)):              # block size
        with pytest.raises(ValueError):
            paged_attend_kernel(*args)
    assert paged_attend_kernel.launches == before


@pytest.mark.cuda
def test_paged_engine_pallas_streams_equal_gather(cuda_device):
    """A small f32 labformer, sharpened by 60 steps of the port's trainer on
    the card, serves the same greedy streams through B7 as through the
    gather path, with B7 launched once per layer per tick."""
    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.models.paged import PagedEngine
    from tpulab_torch.ops.cuda.paged import paged_attend_kernel

    cfg = LabformerConfig(d_model=64, n_heads=8, n_kv_heads=2, n_layers=2, d_ff=128,
                          max_seq=128)
    model, state, step = init_train_state(cfg, None, seed=0, device=cuda_device)
    tok = np.tile(np.arange(33, dtype=np.int32) % 7, (8, 1))
    for _ in range(60):
        step(model, state, tok)
    prompts = [(np.arange(p) % 7).astype(np.int32) for p in (3, 9, 17, 30, 5)]
    outs = {}
    for attn, kv in (("gather", "native"), ("pallas", "native"), ("gather", "int8"),
                     ("pallas", "int8")):
        eng = PagedEngine(model, cfg, slots=3, n_blocks=32, block_size=8, max_seq=64,
                          attn=attn, kv_dtype=kv, prefill_chunk=8)
        before = paged_attend_kernel.launches
        rids = [eng.submit(p, max_new=12) for p in prompts]
        got = eng.run()
        launched = paged_attend_kernel.launches - before
        assert launched == (eng.counters["ticks"] * cfg.n_layers if attn == "pallas" else 0)
        outs[attn, kv] = [got[r] for r in rids]
        assert len(eng.free) + len({b for bl in eng.prefix_cache.values() for b in bl}) == 31
    for kv in ("native", "int8"):
        for a, b in zip(outs["gather", kv], outs["pallas", kv]):
            assert np.array_equal(a, b), (kv, a, b)


# ------------------------------------------------- lab5, hw2 and the harness


def _lab5_file(tmp_path, name, values):
    from tpulab_torch.io import save_typed_array

    path = str(tmp_path / name)
    save_typed_array(path, values)
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("elem", ["int", "uchar", "float"])
@pytest.mark.parametrize("task", ["sum", "min", "max", "prod"])
def test_lab5_reductions_on_card_match_cpu(cuda_device, tmp_path, elem, task):
    from tpulab_torch.labs import lab5

    rng = np.random.default_rng(len(elem) * 10 + len(task))
    n = 1 << 20
    values = {"int": rng.integers(-10000, 10000, n).astype(np.int32),
              "uchar": rng.integers(0, 256, n).astype(np.uint8),
              "float": (1 + rng.normal(scale=1e-3, size=n)).astype(np.float32) if task == "prod"
              else rng.normal(scale=100.0, size=n).astype(np.float32)}[elem]
    text = _lab5_file(tmp_path, f"{elem}{n}", values) + "\n"
    card = lab5.run(text, backend="cuda", task=task, warmup=0, reps=1).splitlines()
    cpu = lab5.run(text, backend="cpu", task=task, warmup=0, reps=1).splitlines()
    assert card[0].startswith("CUDA execution time:")
    if elem == "float" and task == "sum":
        assert abs(float(card[1]) - float(cpu[1])) <= 2 * chip_smoke.sum_tolerance(values)
    elif elem == "float" and task == "prod":
        exact = float(np.prod(values.astype(np.float64)))
        for got in (card[1], cpu[1]):
            assert abs(float(got) / exact - 1) <= chip_smoke.prod_tolerance(n)
    else:
        assert card[1] == cpu[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name,want", [("specials", ("nan", "nan")),
                                       ("zeros_min", ("-0.000000e+00", "3.000000e+00")),
                                       ("zeros_max", ("-3.000000e+00", "0.000000e+00"))])
def test_lab5_min_max_of_signed_zeros_and_nans_on_card(cuda_device, tmp_path, name, want):
    """-0.0 is the min of {0.0, -0.0} and +0.0 the max, as in tpulab."""
    from tpulab_torch.labs import lab5

    values = {"specials": chip_smoke.special_floats(),
              "zeros_min": np.array([0.0, 3.0, -0.0, 0.0], np.float32),
              "zeros_max": np.array([-0.0, -3.0, 0.0, -0.0], np.float32)}[name]
    text = _lab5_file(tmp_path, f"float_{name}", values) + "\n"
    for task, value in zip(("min", "max"), want):
        card = lab5.run(text, backend="cuda", task=task, warmup=0, reps=1).splitlines()[1]
        assert card == value
        assert card == lab5.run(text, backend="cpu", task=task, warmup=0, reps=1).splitlines()[1]


@pytest.mark.cuda
@pytest.mark.parametrize("elem,n", [("float", 1 << 20), ("int", 1 << 20), ("uchar", 1 << 20),
                                    ("float", 15), ("float", 3000)])
def test_lab5_sort_on_card_is_byte_equal_to_cpu(cuda_device, tmp_path, elem, n):
    from pathlib import Path

    from tpulab_torch.labs import lab5

    rng = np.random.default_rng(n)
    if elem == "float":
        values = rng.normal(scale=100.0, size=n).astype(np.float32)
        specials = chip_smoke.special_floats()
        k = min(n // specials.size, 64) * specials.size
        values[rng.choice(n, size=k, replace=False)] = np.tile(specials, k // specials.size)
    else:
        values = rng.integers(0, 256, n).astype(np.uint8) if elem == "uchar" else \
            rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    path = _lab5_file(tmp_path, f"{elem}{n}", values)
    for side in ("cuda", "cpu"):
        lab5.run(f"{path}\n{path}_{side}\n", backend=side, task="sort", warmup=0, reps=1)
    assert Path(path + "_cuda").read_bytes() == Path(path + "_cpu").read_bytes()


@pytest.mark.cuda
def test_hw2_on_card_is_byte_equal_to_cpu(cuda_device):
    from tpulab_torch.io import protocol
    from tpulab_torch.labs import hw2

    vals = np.random.default_rng(2).normal(scale=1e3, size=1 << 18).astype(np.float32)
    vals[::1000] = -0.0
    text = protocol.format_hw2_input(vals)
    card = hw2.run(text, backend="cuda", timing=True, warmup=0, reps=5)
    first, payload = card.split("\n", 1)
    assert first.startswith("CUDA execution time:")
    assert payload == hw2.run(text, backend="cpu")


@pytest.mark.cuda
def test_harness_golden_sweep_on_card_with_cpu_ref(cuda_device, tmp_path):
    import csv
    import os

    from tpulab_torch.harness.run import main as harness_main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = harness_main(["--lab", "lab2", "--cpu-ref", "--k-times", "4",
                       "--kernel-sizes", "[[[32, 32], [16, 16]], [[8, 8], [4, 4]]]",
                       "--artifact-dir", str(tmp_path),
                       "--dir_to_data", os.path.join(root, "data/lab2/data"),
                       "--dir_to_data_out", str(tmp_path / "out"),
                       "--dir_to_data_out_gt", os.path.join(root, "data/lab2/data_out_gt")])
    assert rc == 0
    with open(tmp_path / "runs_tpulab_torch_lab2.csv") as f:
        runs = list(csv.DictReader(f))
    assert len(runs) == 4 * 2 + 4 and all(r["verified"] == "True" for r in runs)
    assert {r["device_reported"] for r in runs if r["device"] == "CUDA"} == {"CUDA"}
    assert {r["device_reported"] for r in runs if r["device"] == "CPU"} == {"CPU"}
    assert (tmp_path / "stats_tpulab_torch_lab2.csv").is_file()


# ------------------------------------------------- speculative decoding


@pytest.fixture(scope="module")
def small_on_card():
    """The shared small labformer trained on the card (chip_smoke's phase 9
    model) with its int8 draft."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    model, cfg, _ = chip_smoke.train_small(dict(small_train_steps=80), dev)
    return model, cfg, chip_smoke.int8_draft(model.to_numpy(), cfg, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["pallas", "gather"])
def test_speculative_engine_streams_on_card(cuda_device, small_on_card, attn):
    """Slots mixing "lookup", "draft", off and sampled requests: every
    stream equal to the engine without speculation, one host wait per
    verify tick, no other host sync, B7 on every plain tick under pallas."""
    from tpulab_torch.ops.cuda.paged import paged_attend_kernel

    model, cfg, draft = small_on_card
    sizes = dict(daemon_slots=4, daemon_blocks=128, daemon_max_seq=512, daemon_chunk=32)
    jobs = chip_smoke.spec_jobs(128)
    paged_attend_kernel.launches = 0
    spec = chip_smoke.spec_engine_wave(model, cfg, draft, sizes, jobs, 4, attn, cuda_device,
                                       sync_debug=True)
    st = spec["stats"]
    plain_ticks = st["ticks"] - st["verify_passes"]
    assert paged_attend_kernel.launches == (plain_ticks * cfg.n_layers if attn == "pallas" else 0)
    assert st["verify_passes"] > 0 and plain_ticks > 0
    assert spec["spec_fetches"] == st["verify_passes"] and not spec["sync_warnings"]
    ref = chip_smoke.spec_engine_wave(model, cfg, None, sizes, jobs, 0, attn, cuda_device)
    for a, b in zip(spec["streams"], ref["streams"]):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_speculative_generate_on_card(cuda_device, small_on_card):
    from tpulab_torch.models.generate import generate
    from tpulab_torch.models.speculative import prompt_lookup_generate, speculative_generate

    model, _, draft = small_on_card
    prompt = np.tile(chip_smoke.cycle(5), (2, 1))
    want = generate(model, prompt, 24, temperature=0.0)
    got, acc = speculative_generate(draft, model, prompt, steps=24, k=4)
    assert np.array_equal(got, want) and acc > 2.0
    got, _ = prompt_lookup_generate(model, prompt, steps=24, k=4)
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_flash_kernel_long_context_tail(cuda_device):
    """B4 at (1, 32768, 8, 64) bf16, the bench's flash row, on its last 256
    query rows (every key) against its plain version."""
    row = chip_smoke.flash_row((1, 8, 32768, 64), torch.bfloat16, cuda_device, 1, 1, seed=13,
                               first_row=32768 - 256)
    assert row["err_over_tolerance"] <= 1 and row["rows_held"] == [32512, 32768]


# ------------------------------------------------- the cache tier and scheduler


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
def test_block_read_and_restore_on_card(cuda_device, int8):
    """The spill tier's legs on card pools: blocks read back in one copy
    equal the pool, written elsewhere and read again they are unchanged,
    with no call that synchronizes."""
    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params
    from tpulab_torch.models.paged import PagedEngine

    cfg = LabformerConfig(d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128,
                          dtype=torch.bfloat16)
    model = Labformer.from_numpy(init_params(cfg, seed=0), cfg, cuda_device)
    eng = PagedEngine(model, cfg, slots=1, n_blocks=12, block_size=16, max_seq=64,
                      kv_dtype="int8" if int8 else "native")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for pool in (eng.kpool, eng.vpool):
        for t in (pool if int8 else (pool,)):
            t.copy_((torch.randn(t.shape, generator=gen, device=cuda_device) * 50).to(t.dtype))
    with chip_smoke.watch_syncs(cuda_device) as syncs:
        kp, vp = eng._read_blocks([3, 7, 5])
        eng._write_blocks([1, 2, 9], kp, vp)
        kp2, vp2 = eng._read_blocks([1, 2, 9])
    assert not syncs and eng.kv_fetches == 2
    for got, want in zip(kp2 + vp2, kp + vp):
        for a, b in zip(got if int8 else (got,), want if int8 else (want,)):
            assert torch.equal(a, b)
    for i, b in enumerate((3, 7, 5)):
        for a, pool in ((kp[i], eng.kpool), (vp[i], eng.vpool)):
            for x, t in zip(a if int8 else (a,), pool if int8 else (pool,)):
                assert torch.equal(x, t[:, b].cpu())


@pytest.mark.cuda
def test_cache_tier_on_card(cuda_device, small_on_card):
    """chip_smoke's phase 10b on the card: preempted greedy and sampled
    requests, the spill round trip and the handoff, each stream bit-equal to
    its uninterrupted run."""
    model, cfg, _ = small_on_card
    out = chip_smoke.check_cache_small((model, cfg), cuda_device, "test")
    assert out["preempt_greedy"] == out["preempt_sampled"] == "bit-equal"
    assert out["handoff"]["blocks"] == 5 and out["spill"]["spill_hits"] >= 1


# ------------------------------------------------------------ the checkpoint lifecycle


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["resume", "recover"])
def test_resume_and_recover_are_bit_equal_on_card(cuda_device, tmp_path, mode):
    """The trainer's demo labformer at seq 1024 on the card: 6 steps with
    snapshots every 3, resumed after 3 or rolled back from a fault at 4,
    print the same losses and end on the same snapshot bits as a straight
    run; B4, B5 and B6 launch once per layer of every dispatched step."""
    from tpulab_torch import train as ttrain

    kernels = (flash_attention_with_lse, flash_attention_bwd_dq, flash_attention_bwd_dkv)

    def run(steps, d, **kw):
        out = []
        before = [f.launches for f in kernels]
        ttrain.train(steps=steps, batch=1, seq=1024, ckpt_dir=str(tmp_path / d), save_every=3,
                     log=out.append, **kw)
        n = chip_smoke.dispatches(out)
        assert [f.launches - b for f, b in zip(kernels, before)] == [4 * n] * 3
        return chip_smoke.train_lines(out), out

    want, _ = run(6, "straight")
    if mode == "resume":
        first, _ = run(3, "other")
        rest, out = run(6, "other", resume=True)
        assert "[train] resumed from step 3" in out and first + rest == want
    else:
        got, out = run(6, "other", recover=1, inject_fault=(4,))
        assert any(ln.startswith("[recover]") for ln in out)
        assert chip_smoke.first_seen(got) == want
    assert chip_smoke.snapshot_equal(tmp_path / "straight", tmp_path / "other", 6)


@pytest.mark.cuda
def test_loader_library_is_built_from_the_checkout(cuda_device):
    from tpulab_torch.io import loader as tloader

    lib = tloader.build()
    assert lib.parent.parent == _build.BUILD_ROOT and lib.parent.name.startswith("loader-")
    assert tloader.SOURCE == chip_smoke.ROOT / "native" / "loader" / "tpulab_loader.cpp"
    assert "native/lib" not in str(lib)
    tloader._load()


@pytest.mark.cuda
def test_generate_ckpt_dir_with_a_bpe_sidecar_launches_b4(cuda_device, tmp_path):
    """``generate --ckpt-dir`` on a checkpoint whose sidecar names a BPE
    table: a prompt of >= 1024 tokens prefills through B4, once per layer."""
    from tpulab_torch import ckpt
    from tpulab_torch.io.bpe import train_bpe
    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    corpus = chip_smoke.lifecycle_corpus(tmp_path, 200_000, 2)
    text = b"".join(p.read_bytes() for p in sorted(corpus.iterdir()))
    tok = train_bpe(text[:50_000], 300)
    tok.save(str(tmp_path / "tok.json"))
    cfg = LabformerConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128, vocab=tok.vocab,
                          max_seq=4096)
    ckpt.save(str(tmp_path / "ck"), 5, Labformer.from_numpy(init_params(cfg, 0), cfg, "cpu"))
    ckpt.write_sidecar(str(tmp_path / "ck"), cfg, str(tmp_path / "tok.json"))
    prompt = chip_smoke.bpe_prompt(tok, corpus, 1024)
    out, launches = chip_smoke.cli_generate(
        {"life_gen_steps": 4}, cuda_device, "cuda", tmp_path / "ck", prompt,
        len(tok.encode(prompt.encode())), cfg.n_layers, "test")
    assert "[generate] loaded checkpoint step 5" in out and launches["flash_fwd"] == 2


# ------------------------------------------------------------ the rest of training and generation


def _beam_model(device, dtype):
    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    cfg = LabformerConfig(d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=2048,
                          dtype=dtype)
    return Labformer.from_numpy(init_params(cfg, seed=0), cfg, device)


@pytest.mark.cuda
def test_beam_search_on_card_matches_the_cpu(cuda_device):
    """f32 beam search over a 1024-token prompt on the card (B4 once per
    layer of its prefill) against the port's CPU run: equal beams and
    totals within chip_smoke's limit until the CPU's first near tie."""
    from tpulab_torch.models.beam import beam_search

    prompt = np.random.default_rng(3).integers(0, 256, 1024).astype(np.int32)
    traces = {"cpu": {}, "cuda": {}}
    beam_search(_beam_model("cpu", torch.float32), prompt, steps=16, beams=4,
                trace=traces["cpu"])
    before = flash_attention_with_lse.launches
    seq, score = beam_search(_beam_model(cuda_device, torch.float32), prompt, steps=16,
                             beams=4, trace=traces["cuda"])
    assert flash_attention_with_lse.launches - before == 2
    assert chip_smoke.beam_equal_until_gap(traces["cpu"], traces["cuda"], "test") >= 1
    assert seq.shape == (16,) and np.isfinite(score)


@pytest.mark.cuda
def test_beam_search_width_one_is_greedy_on_card(cuda_device):
    from tpulab_torch.models.beam import beam_search
    from tpulab_torch.models.generate import generate

    model = _beam_model(cuda_device, torch.bfloat16)
    prompt = np.random.default_rng(4).integers(0, 256, 1024).astype(np.int32)
    seq, _ = beam_search(model, prompt, steps=24, beams=1)
    want = generate(model, prompt[None, :], steps=24, temperature=0.0)[0]
    np.testing.assert_array_equal(seq, want)


@pytest.mark.cuda
def test_labvision_step_on_card_matches_the_cpu(cuda_device):
    """Three f32 labvision steps (cuDNN convolutions, none of B1-B7) within
    chip_smoke's loss limit of the CPU's."""
    from tpulab_torch.models import labvision as tlv

    cfg = tlv.LabvisionConfig(n_classes=8, img_size=32, channels=(16, 32, 64),
                              dtype=torch.float32)
    losses = {}
    for dev in ("cpu", cuda_device):
        model, state, step = tlv.init_train_state(cfg, seed=0, device=dev)
        rng = np.random.default_rng(1)
        losses[str(dev)] = [float(step(model, state, *tlv.synth_batch(cfg, 16, rng))[2])
                            for _ in range(3)]
    np.testing.assert_allclose(losses[str(cuda_device)], losses["cpu"],
                               rtol=chip_smoke.TRAIN_LOSS_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_lion_and_adafactor_on_card_match_the_cpu(cuda_device, name):
    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.train import batches, build_optimizer

    cfg = LabformerConfig(d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=1024,
                          dtype=torch.float32)
    batch_at = batches(256, 1, 1024, 0)
    losses = {}
    for dev in ("cpu", cuda_device):
        opt = build_optimizer(lr=3e-4, steps=3, optimizer=name)
        model, state, step = init_train_state(cfg, None, seed=0, optimizer=opt, device=dev)
        losses[str(dev)] = [float(step(model, state, batch_at(i))[2]) for i in range(3)]
    np.testing.assert_allclose(losses[str(cuda_device)], losses["cpu"],
                               rtol=chip_smoke.TRAIN_LOSS_RTOL)


@pytest.mark.cuda
def test_remat_dots_is_bit_equal_to_none_on_card(cuda_device):
    """bf16 at s1024 (B4-B6): remat "dots" and "none" give the losses and
    gradients of no remat, bit for bit; both run B4 again in the backward."""
    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.train import batches

    tokens = batches(256, 2, 1024, 0)(0)
    runs = {}
    for name, kw in (("off", {}), ("none", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = LabformerConfig(d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=1024,
                              dtype=torch.bfloat16, **kw)
        model, _, _ = init_train_state(cfg, None, seed=0, device=cuda_device)
        before = flash_attention_with_lse.launches
        loss = model.loss_fn(tokens)
        loss.backward()
        b4 = flash_attention_with_lse.launches - before
        runs[name] = (loss.detach(), [p.grad.clone() for _, ts in model.trainable_leaves()
                                      for p in ts], b4)
    assert runs["off"][2] == 2 and runs["none"][2] == runs["dots"][2] == 4
    for name in ("none", "dots"):
        assert torch.equal(runs[name][0], runs["off"][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[name][1], runs["off"][1])), name


@pytest.mark.cuda
def test_beam_search_loop_does_not_sync(cuda_device):
    """The search's prefill and step loop run without a host read (the
    backtrack reads once, after it): no call the CUDA runtime flags as
    synchronizing."""
    from tpulab_torch.models.beam import _search

    model = _beam_model(cuda_device, torch.bfloat16)
    prompt = model.tokens(np.random.default_rng(5).integers(0, 256, (1, 1024)))
    _search(model, prompt, 8, 4)  # warm-up: the first call builds and caches
    torch.cuda.synchronize()
    with chip_smoke.watch_syncs(cuda_device) as syncs:
        _search(model, prompt, 16, 4)
    assert not syncs, syncs[0]


# ------------------------------------------- fused steps a call, the mesh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_step_k_is_bit_equal_to_k_steps_on_card(cuda_device, dtype):
    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.train import batches

    cfg = LabformerConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=128,
                          attn_impl="flash", dtype=dtype)
    batch_at = batches(cfg.vocab, 2, 128, 3)
    block = np.stack([batch_at(j) for j in range(4)])
    m1, s1, step = init_train_state(cfg, seed=1, device=cuda_device)
    m4, s4, step4 = init_train_state(cfg, seed=1, device=cuda_device)
    singles = torch.stack([step(m1, s1, block[j])[2] for j in range(4)])
    flash = flash_attention_with_lse
    flash.launches = 0
    losses = step4.step_k(m4, s4, block)[2]
    assert flash.launches == 4 * cfg.n_layers
    assert torch.equal(_bits(losses), _bits(singles))
    for (name, a), (_, b) in zip(m1.trainable_leaves(), m4.trainable_leaves()):
        for x, y in zip(a, b):
            assert torch.equal(_bits(x.detach()), _bits(y.detach())), name


@pytest.fixture(scope="module")
def nccl_of_one():
    """This process as an NCCL group of one rank (``make_mesh`` makes it)."""
    import torch.distributed as dist

    from tpulab_torch.parallel import mesh as pmesh

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    yield pmesh.make_mesh(axes=("x",), backend="cuda")
    pmesh._MESHES.clear()
    pmesh._IMPLICIT_GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
def test_an_nccl_group_of_one_refuses_the_cpu(cuda_device, nccl_of_one):
    from tpulab_torch.parallel import distributed_reduce
    from tpulab_torch.parallel.mesh import cpu_test_mesh

    refused = "backend 'cpu' asks for cpu, but this process's group is nccl on cuda"
    with pytest.raises(ValueError, match=refused):
        cpu_test_mesh({"x": 1})
    with pytest.raises(ValueError, match=refused):
        distributed_reduce(np.arange(8.0), backend="cpu")
    assert distributed_reduce(np.arange(8.0)).device.type == "cuda"


@pytest.mark.cuda
def test_sharded_functions_over_an_nccl_group_of_one(cuda_device, nccl_of_one):
    import torch.distributed as dist

    from tpulab_torch.ops.mahalanobis import classify
    from tpulab_torch.ops.reduction import reduce_op
    from tpulab_torch.ops.roberts import roberts_edges
    from tpulab_torch.ops.sortops import sort_op
    from tpulab_torch.parallel import (all_gather_op, classify_sharded, distributed_mean,
                                       distributed_reduce, distributed_sort, reduce_scatter_op,
                                       roberts_sharded)

    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    rng = np.random.default_rng(0)
    ints = rng.integers(-10000, 10000, 4097).astype(np.int32)
    floats = rng.normal(scale=100.0, size=4097).astype(np.float32)
    for vals in (ints, floats):
        for op in ("sum", "min", "max"):
            got = distributed_reduce(vals, op)
            assert got.device.type == "cuda"
            want = reduce_op(vals, op, backend="cuda")
            assert _bits(got.reshape(1)).cpu().equal(_bits(want.reshape(1)).cpu()), op
    np.testing.assert_allclose(float(distributed_mean(floats.astype(np.float64))),
                               floats.astype(np.float64).mean(), rtol=1e-12)
    assert all_gather_op(floats).cpu().numpy().tobytes() == floats.tobytes()
    mat = floats[:4096].reshape(1, 4096)
    assert reduce_scatter_op(mat).cpu().numpy().tobytes() == mat[0].tobytes()
    img = rng.integers(0, 256, (257, 131, 4), dtype=np.uint8)
    roberts_u32.launches = 0
    assert roberts_sharded(img).tobytes() == roberts_edges(img, backend="cuda").tobytes()
    assert roberts_u32.launches == 2  # the shard's, then the single-device path's
    classes = [np.stack([rng.integers(0, 131, 8), rng.integers(0, 257, 8)], 1) for _ in range(5)]
    stats = class_statistics(img, classes)
    for dtype in ("float64", "float32"):
        assert classify_sharded(img, stats, compute_dtype=dtype).tobytes() == classify(
            img, stats, backend="cuda", compute_dtype=dtype).tobytes()
    assert distributed_sort(floats).tobytes() == sort_op(floats, backend="cuda").cpu().numpy(
    ).tobytes()


@pytest.mark.cuda
def test_sequence_parallel_flash_over_an_nccl_group_of_one(cuda_device, nccl_of_one):
    """At world size 1 the flash ring and Ulysses run the one whole-sequence
    B4 call, byte for byte; the zigzag merges three calls, within
    ``o_tolerance``."""
    from tpulab_torch.parallel import ring_attention, ulysses_attention, zigzag_ring_attention

    q, k, v = chip_smoke.sp_inputs((1, 4096, 8, 64), torch.bfloat16, cuda_device, seed=1)
    whole = flash_attention_with_lse(q, k, v, causal=True)[0]
    for fn, calls in ((ring_attention, 1), (ulysses_attention, 1), (zigzag_ring_attention, 3)):
        flash_attention_with_lse.launches = 0
        o = fn(q, k, v, local_impl="flash")
        assert flash_attention_with_lse.launches == calls, fn.__name__
        if calls == 1:
            assert torch.equal(_bits(o), _bits(whole)), fn.__name__
        else:
            assert over_tolerance(o, whole) <= 1.0


@pytest.mark.cuda
def test_ring_bodies_for_eight_ranks_in_one_process_on_card(cuda_device):
    """The flash ring for p = 8 in one process: bf16 within ``o_tolerance``
    of one whole-sequence B4 call (8 diagonal and 28 earlier blocks: 36
    launches); its f32 q, k and v gradients within ``grad_tolerance`` of
    the whole-sequence backward."""
    from tpulab_torch.parallel.ring import ring_attention_in_process

    q, k, v = chip_smoke.sp_inputs((1, 8192, 8, 64), torch.bfloat16, cuda_device, seed=2)
    flash_attention_with_lse.launches = 0
    o = ring_attention_in_process(q, k, v, 8, local_impl="flash")
    assert flash_attention_with_lse.launches == 36
    assert over_tolerance(o, flash_attention_with_lse(q, k, v, causal=True)[0]) <= 1.0
    q, k, v, do = chip_smoke.sp_inputs((1, 2048, 8, 64), torch.float32, cuda_device, seed=3,
                                       n=4)

    def grads(fn):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        (fn(*ts) * do).sum().backward()
        return [t.grad for t in ts]

    got = grads(lambda *ts: ring_attention_in_process(*ts, 8, local_impl="flash"))
    want = grads(lambda *ts: flash_attention_with_lse(*ts, causal=True)[0])
    for g, w in zip(got, want):
        assert grad_over_tolerance(g, w) <= 1.0
