"""The port's multi-device tier (``tpulab_torch.parallel``) over 2 and 4 gloo
ranks on the CPU, held against ``tpulab.parallel`` on the conftest's
8-device CPU mesh in this process: the cases of ``tests/test_parallel.py``.

Each world size is one :class:`~tpulab_torch.parallel.mesh.RankPool`,
spawned once for the module; every case calls a sharded function on every
rank with the same full array and reads rank 0's result.  The ranks import
this module to find the rank-side helpers below, so it imports neither
JAX nor ``tpulab`` at its top: the ``J`` fixture does.

Bars: bytes for the halo stencil, classify, the sort, gathers and integer
reductions, min and max; float sums within twice ``gamma_{n-1} *
sum|x|`` (u the dtype's unit roundoff; any two orders of n - 1 additions
differ by at most that: Higham (4.4)), float products within ``2 n u`` relative, float64
means within 1e-12 and reduce-scatter column sums within 1e-5 relative
(rank order against XLA's).
"""

import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tpulab_torch.ops.mahalanobis import class_statistics, classify
from tpulab_torch.ops.roberts import roberts_edges
from tpulab_torch.ops.reduction import reduce_op
from tpulab_torch.parallel import (RankPool, all_gather_op, best_factorization,
                                   classify_sharded, distributed_mean, distributed_reduce,
                                   distributed_sort, launch, make_mesh, parse_mesh_spec,
                                   reduce_scatter_op, roberts_sharded)
from tpulab_torch.parallel.mesh import device_type_count, mesh_shape

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def J():
    """tpulab's side: its sharded functions and a mesh of each world size."""
    import jax.numpy as jnp
    from tpulab import parallel
    from tpulab.ops.mahalanobis import class_statistics as jstats

    return types.SimpleNamespace(p=parallel, jnp=jnp, stats=jstats,
                                 mesh={n: parallel.make_mesh({"x": n}) for n in WORLDS})


@pytest.fixture(scope="module")
def pools():
    made = {}

    def pool(n):
        if n not in made:
            made[n] = RankPool(n, "cpu")
        return made[n]

    try:
        yield pool
    finally:
        for pool in made.values():
            pool.close()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def float_sum_bound(values: np.ndarray) -> float:
    u, k = np.finfo(values.dtype).eps / 2, values.size - 1
    return 2 * k * u / (1 - k * u) * float(np.abs(values.astype(np.float64)).sum())


# ------------------------------------------------------------ rank side


def _loaded_reference_modules():
    return sorted(m for m in sys.modules
                  if m in ("jax", "tpulab") or m.startswith(("jax.", "tpulab.")))


def _layouts():
    """The meshes a 4-rank world makes, and the refusals."""
    out = {"dp_tp": mesh_shape(make_mesh({"dp": 2, "tp": 2})),
           "x": mesh_shape(make_mesh(n_devices=4)),
           "default": mesh_shape(make_mesh(axes=("x",)))}
    for name, kw in (("short", dict(axis_sizes={"x": 2})),
                     ("over", dict(axis_sizes={"x": device_type_count("cpu") + 1}))):
        try:
            make_mesh(**kw)
        except ValueError as e:
            out[name] = str(e)
    return out


def _mesh_on(backend):
    """A mesh made in a launched gloo rank on ``backend``: its shape, or
    the refusal."""
    try:
        return mesh_shape(make_mesh(axes=("x",), backend=backend))
    except ValueError as e:
        return str(e)


def _fail_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise KeyError("planted")
    return "rank 0"


def _die_on_rank_1():
    import os

    import torch.distributed as dist

    if dist.get_rank() == 1:
        os._exit(3)
    return "rank 0"


# ------------------------------------------------------------ mesh


@pytest.mark.parametrize("n,axes", [(8, ("dp", "tp")), (8, ("x",)), (12, ("a", "b", "c")),
                                    (1, ("dp", "tp")), (6, ("dp", "sp", "tp")), (7, ("x", "y"))])
def test_factorization_equals_tpulabs(J, n, axes):
    assert best_factorization(n, axes) == J.p.best_factorization(n, axes)


@pytest.mark.parametrize("spec", ["2x4", "1x1", "8X1", "", "8", "2x", "x4", "2x4x2", "axb",
                                  "2.5x4", "0x4", "2x-1"])
def test_parse_mesh_spec_equals_tpulabs(J, spec):
    try:
        want = J.p.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_mesh_spec(spec) == want


def test_mesh_layouts_and_refusals(pools):
    got = pools(4).run(_layouts)
    assert got["dp_tp"] == {"dp": 2, "tp": 2}
    assert got["x"] == got["default"] == {"x": 4}
    assert "launch 2 ranks" in got["short"]
    n = device_type_count("cpu")
    assert got["over"] == f"need {n + 1} devices, have {n} (cpu)"


def test_make_mesh_above_the_count_raises_naming_it():
    n = device_type_count("cpu")
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n} \\(cpu\\)"):
        make_mesh({"x": n + 1}, backend="cpu")
    with pytest.raises(ValueError, match=f"have {n} \\(cpu\\)"):
        RankPool(n + 1, "cpu")


def test_rank_pool_and_launch_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        RankPool(2)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        launch(_fail_on_rank_1, 2)


def test_a_launched_gloo_rank_refuses_the_card(pools):
    assert pools(2).run(_mesh_on, None) == pools(2).run(_mesh_on, "cpu") == {"x": 2}
    assert pools(2).run(_mesh_on, "cuda") == (
        "backend 'cuda' asks for cuda, but this process's group is gloo on cpu")


_GROUP_OF_ONE = """
import numpy as np
from tpulab_torch.parallel import distributed_reduce, make_mesh
x = np.arange(8.0)
print(float(distributed_reduce(x, backend="cpu")))
for ask in ({}, {"backend": "cuda"}):
    try:
        make_mesh(**ask)
    except ValueError as e:
        print(e)
try:
    distributed_reduce(x)
except ValueError as e:
    print(e)
print(float(distributed_reduce(x, backend="cpu")))
"""


def test_a_gloo_group_of_one_then_the_card_raises():
    """After an unlaunched CPU call has made a gloo group of one, a call
    that asks for the card (by default or by name) raises; it does not run
    on the group's CPU."""
    out = subprocess.run([sys.executable, "-c", _GROUP_OF_ONE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    refused = "backend {} asks for cuda, but this process's group is gloo on cpu"
    assert out.stdout.splitlines() == ["28.0", refused.format("None"), refused.format("'cuda'"),
                                       refused.format("None"), "28.0"]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_neither_jax_nor_tpulab(pools, world):
    assert pools(world).run(_loaded_reference_modules) == []


def test_a_failing_or_dying_rank_fails_the_call():
    with RankPool(2, "cpu") as pool:
        with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*KeyError: 'planted'"):
            pool.run(_fail_on_rank_1)
    with RankPool(2, "cpu") as pool:
        with pytest.raises(RuntimeError, match="rank 1 of 2 died \\(exit code 3\\)"):
            pool.run(_die_on_rank_1)


# ------------------------------------------------------------ collectives


REDUCE_CASES = [(dtype, op) for dtype in ("int32", "uint8", "float32", "float64")
                for op in ("sum", "min", "max", "prod")]


def _reduce_input(dtype: str, op: str, rng) -> np.ndarray:
    if dtype in ("int32", "uint8"):
        return rng.integers(1, 5, size=37).astype(dtype)
    if op == "prod":
        return rng.uniform(0.5, 1.5, size=61).astype(dtype)
    return rng.normal(scale=100.0, size=64).astype(dtype)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype,op", REDUCE_CASES)
def test_reduce_equals_tpulabs(J, pools, rng, world, dtype, op):
    vals = _reduce_input(dtype, op, rng)
    got = pools(world).run(distributed_reduce, vals, op)
    want = np.asarray(J.p.distributed_reduce(vals, op, mesh=J.mesh[world]))
    assert got.dim() == 0 and got.numpy().dtype == want.dtype
    if dtype in ("int32", "uint8") or op in ("min", "max"):
        assert got.numpy().tobytes() == want.tobytes()
    elif op == "sum":
        assert abs(float(got) - float(want)) <= float_sum_bound(vals)
    else:
        assert abs(float(got) / float(want) - 1) <= 2 * vals.size * np.finfo(dtype).eps


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_equals_the_single_device_reduce(pools, world):
    vals = np.array([0, 9, 8, 7, 6, 5, 4, 3, 2, 1], np.int32)  # the lab5 fixture pattern
    assert int(pools(world).run(distributed_reduce, vals, "sum")) == int(
        reduce_op(vals, "sum", backend="cpu")) == 45


def test_reduce_refuses_an_unknown_op(pools):
    with pytest.raises(RuntimeError, match="unknown reduction 'median'"):
        pools(2).run(distributed_reduce, np.arange(4), "median")


@pytest.mark.parametrize("world", WORLDS)
def test_mean_equals_tpulabs(J, pools, rng, world):
    vals = rng.normal(size=19)
    got = float(pools(world).run(distributed_mean, vals))
    np.testing.assert_allclose(got, vals.mean(), rtol=1e-12)
    np.testing.assert_allclose(got, float(J.p.distributed_mean(vals, mesh=J.mesh[world])),
                               rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_and_reduce_scatter_equal_tpulabs(J, pools, rng, world):
    vals = rng.normal(size=16).astype(np.float32)
    got = pools(world).run(all_gather_op, vals)
    assert got.numpy().tobytes() == vals.tobytes()
    assert got.numpy().tobytes() == np.asarray(
        J.p.all_gather_op(vals, mesh=J.mesh[world])).tobytes()
    mat = rng.normal(size=(world, 8)).astype(np.float32)
    got = pools(world).run(reduce_scatter_op, mat).numpy()
    np.testing.assert_allclose(got, mat.sum(axis=0), rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(J.p.reduce_scatter_op(mat, mesh=J.mesh[world])),
                               rtol=1e-5)


def test_gather_and_scatter_refuse_bad_shapes(pools):
    with pytest.raises(RuntimeError, match="not divisible by mesh axis 2"):
        pools(2).run(all_gather_op, np.arange(5, dtype=np.float32))


# ------------------------------------------------------------ halo stencil


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("shape", [(16, 16), (37, 23), (5, 9), (8, 128), (3, 7), (1, 5), (4, 6)])
def test_halo_stencil_equals_tpulabs_and_the_single_device(J, pools, rng, world, shape):
    # heights below, at and above the world size, and not divisible by it
    img = rng.integers(0, 256, size=(*shape, 4)).astype(np.uint8)
    got = pools(world).run(roberts_sharded, img)
    assert got.tobytes() == roberts_edges(img, backend="cpu").tobytes()
    assert got.tobytes() == J.p.roberts_sharded(img, mesh=J.mesh[world]).tobytes()


# ------------------------------------------------------------ sort


SORT_CASES = {
    "float10": lambda rng: rng.normal(size=10).astype(np.float32),
    "float64": lambda rng: rng.normal(size=64).astype(np.float32),
    "float1000": lambda rng: rng.normal(size=1000).astype(np.float32),
    "float1021": lambda rng: rng.normal(size=1021).astype(np.float32),
    "int_duplicates": lambda rng: rng.integers(0, 10, size=200).astype(np.int32),
    "uint8_fixture": lambda rng: np.array([1, 2, 3, 1, 2, 3, 1, 2, 3, 4], np.uint8),
    "sorted": lambda rng: np.arange(100, dtype=np.float64),
    "reversed": lambda rng: np.arange(100, dtype=np.float64)[::-1].copy(),
    "inf_and_negatives": lambda rng: np.array([1.0, np.inf, -3.0, 2.0, -np.inf, 0.0] * 5,
                                              np.float32),
    "finfo_max": lambda rng: np.array([np.finfo(np.float32).max, 0.0, -1.0] * 4, np.float32),
    "int64_extremes": lambda rng: np.array([np.iinfo(np.int64).max - 1, -5, 0, 7] * 3,
                                           np.int64),
}


def _nans_and_zeros(rng):
    vals = rng.normal(size=37).astype(np.float32)
    vals[[3, 17, 30]] = np.nan
    vals[5] = np.float32(np.frombuffer(np.uint32(0xFFC00001).tobytes(), np.float32)[0])
    vals[[8, 9]] = [-0.0, 0.0]
    return vals


SORT_CASES["nan_last_and_signed_zeros"] = _nans_and_zeros


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(SORT_CASES))
def test_sort_equals_tpulabs(J, pools, world, name):
    vals = SORT_CASES[name](np.random.default_rng(1))
    got = pools(world).run(distributed_sort, vals)
    want = J.p.distributed_sort(vals, mesh=J.mesh[world])
    assert got.dtype == vals.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got, np.sort(vals))  # NaNs last, as np.sort


def test_sort_refuses_what_no_backend_carries(pools):
    with pytest.raises(RuntimeError, match="gloo backend has no collectives on torch.int16"):
        pools(2).run(distributed_sort, np.arange(8, dtype=np.int16))


# ------------------------------------------------------------ classify


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("shape,nc", [((32, 16), 2), ((37, 19), 5)])
def test_classify_equals_tpulabs_and_the_single_device(J, pools, world, shape, nc):
    rng = np.random.default_rng(nc)
    img = rng.integers(0, 256, size=(*shape, 4)).astype(np.uint8)
    classes = [np.stack([rng.integers(0, shape[1], 6), rng.integers(0, shape[0], 6)], 1)
               for _ in range(nc)]
    got = pools(world).run(classify_sharded, img, class_statistics(img, classes))
    assert got.tobytes() == classify(img, class_statistics(img, classes), backend="cpu",
                                     compute_dtype="float32").tobytes()
    want = J.p.classify_sharded(img, J.stats(img, classes), mesh=J.mesh[world],
                                compute_dtype=J.jnp.float32)
    assert got.tobytes() == want.tobytes()


def test_chip_smoke_phase13_rehearses_on_the_cpu():
    """chip_smoke.py's phase 13 at a tiny size over two gloo ranks: every
    check of the phase runs (reductions, the sharded functions' bytes
    against the single-device path, ``lab5 --mesh 2`` through the CLI)."""
    import chip_smoke

    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(mesh_reduce_n=1000, mesh_roberts_side=37, mesh_classify_side=29,
                mesh_classify_nc=4, mesh_sort_n=1001, mesh_cpu_ranks=2)
    out = chip_smoke.run_mesh_path(tiny, torch.device("cpu"), "cpu", "cpu")
    assert out["world_size"] == 2 and len(out["reduce"]) == 16
    assert not out["lab5_mesh2"]["engaged"]
    # the CPU runs the plain versions, which count no launch
    assert out["roberts"]["launches"] == {"roberts": 0, "classify": 0}
