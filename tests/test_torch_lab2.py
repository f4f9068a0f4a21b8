"""tpulab_torch lab2 (kernel B1, Roberts) held byte-equal against tpulab."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpulab.io import load_image as jax_load_image
from tpulab.ops.pallas.stencil import roberts_pallas
from tpulab.ops.roberts import roberts_edges as jax_roberts_edges
from tpulab.runtime.timing import parse_timing_device, parse_timing_line

from tpulab_torch.io import load_image, protocol, save_image
from tpulab_torch.labs import lab2
from tpulab_torch.ops.cuda.stencil import roberts_u32
from tpulab_torch.ops.roberts import pack_rgba, roberts_edges, unpack_rgba

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLDENS = ["grad_3x3", "noise_4x4", "rings_16x16", "spot_1x5"]


@pytest.mark.parametrize("name", GOLDENS)
def test_committed_goldens(name):
    img = load_image(str(REPO / f"data/lab2/data/{name}.txt"))
    expect = load_image(str(REPO / f"data/lab2/data_out_gt/{name}.txt"))
    np.testing.assert_array_equal(roberts_edges(img, backend="cpu"), expect)


def test_showcase_pair():
    show = REPO / "data/lab2/showcase"
    img = load_image(str(show / "cityline_512.data"))
    expect = load_image(str(show / "cityline_512_roberts.data"))
    np.testing.assert_array_equal(roberts_edges(img, backend="cpu"), expect)


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (3, 3), (17, 31), (64, 129), (200, 100)])
def test_random_images_match_both_tpulab_paths(shape):
    img = np.random.default_rng(shape[0] * 1000 + shape[1]).integers(
        0, 256, shape + (4,), np.uint8)
    out = roberts_edges(img, backend="cpu")
    np.testing.assert_array_equal(out, np.asarray(jax_roberts_edges(img)))
    np.testing.assert_array_equal(out, np.asarray(roberts_pallas(img, interpret=True)))


# 2x2 neighbourhoods (00, 10, 01, 11 in (x, y) order, RGB) where the JAX
# package's two Roberts paths disagree: roberts_pallas forms the magnitude
# as sqrtf(fma(gx, gx, gy*gy)), XLA's roberts_edges as
# sqrtf(fma(gy, gy, gx*gx)).  The port follows the Pallas kernel it
# replaces.  Found by searching 4M random neighbourhoods.
DIVERGENT_QUADS = [
    ([208, 129, 222], [17, 245, 179], [125, 234, 208], [26, 16, 89]),   # 138 vs 139
    ([18, 44, 223], [61, 169, 94], [23, 79, 199], [71, 255, 231]),      # 149 vs 150
]


def test_magnitude_contraction_follows_the_pallas_kernel():
    img = np.zeros((2, 4 * len(DIVERGENT_QUADS), 4), np.uint8)
    img[..., 3] = 255
    for i, (p00, p10, p01, p11) in enumerate(DIVERGENT_QUADS):
        x = 4 * i
        img[0, x, :3], img[0, x + 1, :3], img[1, x, :3], img[1, x + 1, :3] = p00, p10, p01, p11
    out = roberts_edges(img, backend="cpu")
    np.testing.assert_array_equal(out, np.asarray(roberts_pallas(img, interpret=True)))
    xla = np.asarray(jax_roberts_edges(img))
    for i in range(len(DIVERGENT_QUADS)):
        assert int(xla[0, 4 * i, 0]) == int(out[0, 4 * i, 0]) + 1


def test_alpha_preserved_and_gray():
    img = np.random.default_rng(5).integers(0, 256, (9, 7, 4), np.uint8)
    out = roberts_edges(img, backend="cpu")
    np.testing.assert_array_equal(out[..., 3], img[..., 3])
    assert (out[..., 0] == out[..., 1]).all() and (out[..., 1] == out[..., 2]).all()


@pytest.mark.parametrize("shape", [(0, 0), (0, 5), (4, 0)])
def test_empty_image(shape):
    img = np.zeros(shape + (4,), np.uint8)
    assert roberts_edges(img, backend="cpu").shape == shape + (4,)


def test_pack_roundtrip():
    img = np.random.default_rng(6).integers(0, 256, (5, 3, 4), np.uint8)
    u = pack_rgba(img)
    assert u.dtype == torch.int32 and tuple(u.shape) == (5, 3)
    np.testing.assert_array_equal(unpack_rgba(u), img)


def test_end_to_end_golden(tmp_path):
    src = str(REPO / "data/lab2/data/rings_16x16.txt")
    inp, out = str(tmp_path / "in.data"), str(tmp_path / "out.data")
    save_image(inp, load_image(src))
    stdout = lab2.run(protocol.format_lab2_input(inp, out), backend="cpu", warmup=0, reps=1)
    assert parse_timing_device(stdout) == "CPU" and parse_timing_line(stdout) is not None
    np.testing.assert_array_equal(
        jax_load_image(out), jax_load_image(str(REPO / "data/lab2/data_out_gt/rings_16x16.txt")))


def test_sweep_mode_prints_finished(tmp_path):
    img = np.random.default_rng(8).integers(0, 256, (3, 3, 4), np.uint8)
    inp, out = str(tmp_path / "in.data"), str(tmp_path / "out.data")
    save_image(inp, img)
    text = protocol.format_lab2_input(inp, out, launch=(32, 32, 16, 16))
    lines = lab2.run(text, sweep=True, backend="cpu", warmup=0, reps=1).splitlines()
    assert parse_timing_device(lines[0]) == "CPU" and parse_timing_line(lines[0]) is not None
    assert lines[1] == "FINISHED!" and len(lines) == 2
    np.testing.assert_array_equal(load_image(out), np.asarray(jax_roberts_edges(img)))


@pytest.mark.parametrize("launch", [(32, 33, 1, 1), (2048, 1, 1, 1), (16, 16, 0, 4),
                                    (16, 16, 4, 65536)])
def test_refused_geometry_raises_before_launch(launch):
    u = pack_rgba(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        roberts_u32(u, launch)


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        roberts_u32(torch.zeros(4, 4, dtype=torch.int64))
    with pytest.raises(ValueError):
        roberts_u32(torch.zeros(4, 4, 2, dtype=torch.int32))


def test_refuses_planes_past_32_bit_indices():
    # the kernel indexes pixels in 32 bits; the wrapper refuses before any launch
    u = torch.empty((2**16, 2**15), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="fewer than"):
        roberts_u32(u)
