"""tpulab_torch's CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA card and skip without one.  The file imports
neither JAX nor ``tpulab``, so on a machine without JAX it runs alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpulab_torch.ops.cuda import _build
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
