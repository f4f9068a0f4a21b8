"""tpulab_torch's CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA card and skip without one.  The file imports
neither JAX nor ``tpulab``, so on a machine without JAX it runs alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpulab_torch.ops.cuda import _build
from tpulab_torch.ops.cuda.attention import (
    HEAD_DIMS,
    flash_attention_plain,
    flash_attention_with_lse,
    over_tolerance,
)
from tpulab_torch.ops.cuda.classify import classify_u32, classify_u32_plain, pack_stats
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
    out = classify_u32(u, s, launch)
    torch.cuda.synchronize()
    assert classify_u32.launches == before + 1
    assert torch.equal(out, classify_u32_plain(u, s))


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
def test_flash_gqa_equals_repeated_call_on_card(cuda_device):
    q, k, v = _flash_inputs((2, 256, 8, 2), 64, torch.bfloat16, cuda_device)
    got = flash_attention_with_lse(q, k, v)
    rep = flash_attention_with_lse(q, k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2))
    assert torch.equal(got[0], rep[0]) and torch.equal(got[1], rep[1])


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["head_dim", "dtype", "requires_grad"])
def test_flash_kernel_refuses_before_launch(cuda_device, what):
    q, k, v = _flash_inputs((1, 64, 2, 2), 32, torch.float32, cuda_device)
    exc = ValueError
    if what == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif what == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q.requires_grad_(True)
        exc = NotImplementedError
    before = flash_attention_with_lse.launches
    with pytest.raises(exc):
        flash_attention_with_lse(q, k, v)
    assert flash_attention_with_lse.launches == before
