"""Kernel B3's float64 screen (``csrc/classify.cu``) in plain PyTorch.

``screen_plain`` repeats the kernel's screen and recheck: float32
distances against the staged margins and flags, then the reference's
double fold over the candidates.  On 2^16 colours against class sets that
attack the margin, the float64 argmin must always be a candidate, and the
screened labels must equal the plain version's and tpulab's.  The colours
are (r, g, (r + g) mod 256): every (r, g) pair once, half of them on the
plane b = r + g that the near-tie pairs bisect.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.ops import mahalanobis as jax_mahalanobis

import chip_smoke
from tpulab_torch.ops.cuda.classify import (
    MARGIN_SCALE,
    MAX_CLASSES,
    Screen,
    classify_u32_plain,
    pack_stats,
    screen_plain,
    stage_screen,
)
from tpulab_torch.ops.mahalanobis import class_statistics
from tpulab_torch.ops.roberts import pack_rgba

torch.set_num_threads(2)


def _pixels() -> np.ndarray:
    r, g = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    alpha = np.random.default_rng(0).integers(0, 256, r.shape)
    return np.stack([r, g, (r + g) & 255, alpha], -1).astype(np.uint8)


PIXELS = _pixels()
ON_PLANE = PIXELS[..., 2].astype(int) == PIXELS[..., 0].astype(int) + PIXELS[..., 1]


def _class_sets() -> dict:
    sets = chip_smoke.b3_class_sets()
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (64, 64, 4), np.uint8)
    stats = class_statistics(img, [np.stack([rng.integers(0, 64, 16), rng.integers(0, 64, 16)], 1)
                                   for _ in range(MAX_CLASSES)])
    sets["random32"] = (stats.mean, stats.inv_cov)
    return sets


SETS = _class_sets()


@pytest.fixture(scope="module")
def u():
    return pack_rgba(PIXELS)


_PLAIN = {}


def _plain(u, name):
    """``classify_u32_plain`` in float64 of set ``name`` (computed once)."""
    if name not in _PLAIN:
        mean, inv_cov = SETS[name]
        _PLAIN[name] = classify_u32_plain(u, pack_stats(mean, inv_cov, torch.float64, u.device))
    return _PLAIN[name]


def _labels(packed: torch.Tensor) -> np.ndarray:
    return ((packed >> 24) & 0xFF).numpy().astype(np.uint8)


@pytest.mark.parametrize("contracted", [True, False])
@pytest.mark.parametrize("name", sorted(SETS))
def test_float64_argmin_is_always_a_candidate(u, name, contracted):
    mean, inv_cov = SETS[name]
    cand, got = screen_plain(u, stage_screen(mean, inv_cov, torch.float64), contracted)
    want = _plain(u, name)
    label = (want >> 24) & 0xFF
    winner = label != 255
    assert (((cand >> label.clamp(max=MAX_CLASSES - 1).long()) & 1) == 1)[winner].all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(SETS))
def test_screened_labels_equal_plain_and_tpulab(u, name):
    mean, inv_cov = SETS[name]
    _, got = screen_plain(u, stage_screen(mean, inv_cov, torch.float64))
    assert torch.equal(got, _plain(u, name))
    ref = np.asarray(jax_mahalanobis.classify_labels(
        jnp.asarray(PIXELS), jnp.asarray(mean), jnp.asarray(inv_cov), compute_dtype=jnp.float64))
    mine = _labels(got).reshape(ref.shape)
    if name != "symmetric":
        np.testing.assert_array_equal(mine, ref)
        return
    # ROADMAP C3: tpulab's float64 path is contracted by XLA:CPU, the
    # reference's C order is not, so the two break a tie of real arithmetic
    # differently.  Off the plane they agree; on it both pick one class of
    # the tied pair.
    np.testing.assert_array_equal(mine[~ON_PLANE], ref[~ON_PLANE])
    np.testing.assert_array_equal(mine[ON_PLANE] // 2, ref[ON_PLANE] // 2)


@pytest.mark.parametrize("scale", [2.0**-20, 0.0])
def test_shrunk_margins_miss_the_near_ties(u, scale):
    # planted fault: the screen with its margins cut must lose the float64
    # argmin on the near-tie set, so the margins are what keeps the labels
    mean, inv_cov = SETS["symmetric"]
    screen = stage_screen(mean, inv_cov, torch.float64)
    _, got = screen_plain(u, chip_smoke.faulted_screen(screen, scale))
    differs = got != _plain(u, "symmetric")
    assert differs.any()
    assert bool(differs.reshape(ON_PLANE.shape)[~ON_PLANE].logical_not().all())


def test_random_classes_leave_about_one_candidate(u):
    mean, inv_cov = SETS["random32"]
    cand, _ = screen_plain(u, stage_screen(mean, inv_cov, torch.float64))
    counts = sum(((cand >> c) & 1) for c in range(MAX_CLASSES))
    assert counts.min() >= 1
    assert float(counts.double().mean()) < 1.3


def test_stage_screen_flags_what_float32_cannot_bound():
    mean, inv_cov = SETS["extreme_ic"]
    assert stage_screen(mean, inv_cov, torch.float64).recheck.tolist() == [
        True, True, False, False]  # 1e30, 1e-30: outside [2^-60, 2^60]; cond 1e12 is not
    mean, inv_cov = SETS["nan"]
    screen = stage_screen(mean, inv_cov, torch.float64)
    assert screen.recheck.tolist() == [False, True, False]
    assert np.isnan(screen.rows32[1]).all() and not np.isnan(screen.rows32[[0, 2]]).any()
    huge = np.full((1, 3), 1e18)  # in range, but A_c = 3e36 > 2^120
    assert stage_screen(huge, np.eye(3)[None], torch.float64).recheck.tolist() == [True]
    tiny = np.array([[1e-30, 5.0, 5.0]])  # a nonzero mean below 2^-60
    assert stage_screen(tiny, np.eye(3)[None], torch.float64).recheck.tolist() == [True]
    assert stage_screen(np.zeros((1, 3)), np.eye(3)[None], torch.float64).recheck.tolist() == [
        False]


def test_margin_is_rounded_up_from_the_float64_bound():
    mean, inv_cov = SETS["random32"]
    screen = stage_screen(mean, inv_cov, torch.float64)
    m = np.maximum(np.abs(mean), np.abs(255.0 - mean))
    bound = np.einsum("cj,cji,ci->c", m, np.abs(inv_cov), m)
    assert (screen.margin.astype(np.float64) >= bound * MARGIN_SCALE).all()
    assert (screen.margin.astype(np.float64) <= bound * MARGIN_SCALE * (1 + 2.0**-20)).all()
    np.testing.assert_array_equal(screen.rows32, screen.rows64.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_screen_param_packs_the_c_struct(dtype):
    mean, inv_cov = SETS["nan"]
    screen = stage_screen(mean, inv_cov, dtype)
    assert isinstance(screen, Screen) and screen.dtype == dtype and screen.nc == 3
    raw = screen.param
    assert len(raw) == 4744  # sizeof(Params) in csrc/classify.cu
    rows64 = np.frombuffer(raw[:3072], np.float64).reshape(MAX_CLASSES, 12)
    rows32 = np.frombuffer(raw[3072:4608], np.float32).reshape(MAX_CLASSES, 12)
    margin = np.frombuffer(raw[4608:4736], np.float32)
    bits, nc = np.frombuffer(raw[4736:], np.uint32)
    np.testing.assert_array_equal(rows64[:3], screen.rows64)
    np.testing.assert_array_equal(rows32[:3], screen.rows32)
    assert not rows64[3:].any() and not rows32[3:].any() and not margin[3:].any()
    assert nc == 3
    if dtype == torch.float64:
        assert bits == 0b010 and (margin[[0, 2]] > 0).all()
    else:  # the float32 instance ends at the screen: true rows, no margin, no flag
        assert bits == 0 and not margin.any()
        assert np.isnan(rows32[1, 3:]).all() and not np.isnan(rows32[1, :3]).any()
    faulted = chip_smoke.faulted_screen(screen, 0.0)
    assert not faulted.margin.any() and not faulted.recheck.any()
    assert faulted.param[4736:4740] == b"\0\0\0\0"


def test_screen_plain_refuses_a_float32_screen(u):
    mean, inv_cov = SETS["identical"]
    with pytest.raises(ValueError):
        screen_plain(u, stage_screen(mean, inv_cov, torch.float32))
