"""tpulab_torch lab3 (kernel B3, Mahalanobis classify) held against tpulab."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.harness.processors.lab3 import PINNED_CLASS_POINTS
from tpulab.io import load_image as jax_load_image
from tpulab.ops import mahalanobis as jax_mahalanobis
from tpulab.ops.pallas.classify import classify_labels_pallas
from tpulab.runtime.timing import parse_timing_device, parse_timing_line

from tpulab_torch.io import load_image, protocol, save_image
from tpulab_torch.labs import lab3
from tpulab_torch.ops.cuda.classify import classify_u32, pack_stats
from tpulab_torch.ops.mahalanobis import class_statistics, classify
from tpulab_torch.ops.roberts import pack_rgba

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _random_case(seed, h, w, nc, npts=6):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    classes = [np.stack([rng.integers(0, w, npts), rng.integers(0, h, npts)], axis=1)
               for _ in range(nc)]
    return img, classes


@pytest.mark.parametrize("name", ["blobs_8x8", "checker_6x6"])
def test_committed_goldens_end_to_end(name, tmp_path):
    img = load_image(str(REPO / f"data/lab3/data/{name}.txt"))
    inp, out = str(tmp_path / "in.data"), str(tmp_path / "out.data")
    save_image(inp, img)
    text = protocol.format_lab3_input(inp, out, PINNED_CLASS_POINTS[name])
    stdout = lab3.run(text, backend="cpu", warmup=0, reps=1)
    assert parse_timing_device(stdout) == "CPU" and parse_timing_line(stdout) is not None
    np.testing.assert_array_equal(
        jax_load_image(out), jax_load_image(str(REPO / f"data/lab3/data_out_gt/{name}.txt")))


@pytest.mark.parametrize("seed,nc", [(0, 2), (1, 4), (2, 7)])
def test_statistics_identical_to_tpulab(seed, nc):
    img, classes = _random_case(seed, 16, 16, nc, npts=1 + seed)
    mine = class_statistics(img, classes)
    ref = jax_mahalanobis.class_statistics(img, classes)
    np.testing.assert_array_equal(mine.mean, ref.mean)
    np.testing.assert_array_equal(mine.inv_cov, ref.inv_cov)  # NaN where degenerate


@pytest.mark.parametrize("seed,nc", [(1, 2), (2, 3), (3, 5), (4, 7)])
def test_float64_labels_equal_tpulab(seed, nc):
    img, classes = _random_case(seed, 96, 128, nc)
    stats = class_statistics(img, classes)
    out = classify(img, stats, backend="cpu")
    ref = np.asarray(jax_mahalanobis.classify(img, jax_mahalanobis.class_statistics(img, classes),
                                              backend="cpu"))
    np.testing.assert_array_equal(out, ref)  # labels in alpha, RGB untouched


@pytest.mark.parametrize("seed,nc", [(5, 2), (6, 4), (7, 6)])
def test_float32_labels_equal_pallas_kernel(seed, nc):
    # The port forms the f32 distances with the fused multiply-adds XLA:CPU
    # forms from the Pallas kernel's body, so no near-tie allowance is needed.
    img, classes = _random_case(seed, 64, 96, nc)
    stats = class_statistics(img, classes)
    out = classify(img, stats, backend="cpu", compute_dtype="float32")
    ref = np.asarray(classify_labels_pallas(
        img, jnp.asarray(stats.mean, jnp.float32), jnp.asarray(stats.inv_cov, jnp.float32),
        interpret=True))
    np.testing.assert_array_equal(out[..., 3], ref)
    np.testing.assert_array_equal(out[..., :3], img[..., :3])


def test_all_classes_degenerate_gives_alpha_255_like_the_xla_path():
    # ROADMAP C2: two single-point classes have NaN inverse covariances; no
    # distance is < inf, so the label stays -1 (alpha 255) as in tpulab's
    # XLA path and the C oracle.  The Pallas kernel starts at 0 instead.
    img = np.random.default_rng(9).integers(0, 256, (8, 8, 4), np.uint8)
    classes = [np.array([[0, 0]]), np.array([[3, 5]])]
    stats = class_statistics(img, classes)
    for dtype in ("float64", "float32"):
        out = classify(img, stats, backend="cpu", compute_dtype=dtype)
        assert (out[..., 3] == 255).all()
    ref = np.asarray(jax_mahalanobis.classify(
        img, jax_mahalanobis.class_statistics(img, classes), backend="cpu", use_pallas=False))
    assert (ref[..., 3] == 255).all()
    pallas = np.asarray(classify_labels_pallas(
        img, jnp.asarray(stats.mean, jnp.float32), jnp.asarray(stats.inv_cov, jnp.float32),
        interpret=True))
    assert (pallas == 0).all()


def test_degenerate_class_never_wins():
    img = np.random.default_rng(10).integers(0, 256, (6, 6, 4), np.uint8)
    normal = np.stack([np.arange(5), np.arange(5)[::-1]], axis=1)
    stats = class_statistics(img, [np.array([[0, 0]]), normal])
    out = classify(img, stats, backend="cpu")
    assert (out[..., 3] == 1).all()


def test_sweep_prefix(tmp_path):
    img = np.random.default_rng(12).integers(0, 256, (5, 4, 4), np.uint8)
    inp, out = str(tmp_path / "in.data"), str(tmp_path / "out.data")
    save_image(inp, img)
    classes = [np.array([[0, 0], [1, 1], [2, 3]]), np.array([[3, 4], [2, 2], [0, 4]])]
    text = protocol.format_lab3_input(inp, out, classes, launch=(256, 256))
    stdout = lab3.run(text, sweep=True, backend="cpu", warmup=0, reps=1)
    assert parse_timing_line(stdout) is not None
    ref = np.asarray(jax_mahalanobis.classify(
        img, jax_mahalanobis.class_statistics(img, classes), backend="cpu"))
    np.testing.assert_array_equal(load_image(out), ref)


@pytest.mark.parametrize("launch", [(1, 1025), (0, 256), (2**31, 1)])
def test_refused_geometry_raises_before_launch(launch):
    u = pack_rgba(np.zeros((4, 4, 4), np.uint8))
    stats = pack_stats(np.zeros((1, 3)), np.eye(3)[None], torch.float64, u.device)
    with pytest.raises(ValueError):
        classify_u32(u, stats, launch)


def test_wrapper_checks_statistics():
    u = pack_rgba(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        classify_u32(u, torch.zeros(2, 9, dtype=torch.float64))
    with pytest.raises(ValueError):
        classify_u32(u, torch.zeros(33, 12, dtype=torch.float64))
    with pytest.raises(ValueError):
        classify_u32(u, torch.zeros(2, 12, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        pack_stats(np.zeros((33, 3)), np.zeros((33, 3, 3)), torch.float64, u.device)
    with pytest.raises(ValueError):
        classify(np.zeros((2, 2, 4), np.uint8), class_statistics(
            np.zeros((2, 2, 4), np.uint8), [np.array([[0, 0], [1, 1]])]),
            backend="cpu", compute_dtype="float16")
