"""tpulab_torch's lab5, hw1 and hw2 (binfmt, reductions, sort, the quadratic
solver and the three CLIs) held against tpulab on the same seeded inputs.

float32 sums are the one inexact answer: torch and XLA add in other
orders.  Any order of n - 1 additions of x_1..x_n errs from the exact sum
by at most gamma_{n-1} * sum|x_i| (gamma_k = k u / (1 - k u), u = 2^-24;
Higham, Accuracy and Stability of Numerical Algorithms, (4.4)), so two
such sums differ by at most twice that.  :func:`float_sum_bound` is that
limit; ``test_float_sum_bound_rejects_a_dropped_element`` shows that it
rejects a sum that leaves out the largest element.
"""

import io
import contextlib
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpulab.io import load_typed_array as jax_load
from tpulab.io import save_typed_array as jax_save
from tpulab.labs import hw1 as jax_hw1
from tpulab.labs import hw2 as jax_hw2
from tpulab.labs import lab5 as jax_lab5
from tpulab.ops.quadratic import solve_batch as jax_solve_batch
from tpulab.ops.reduction import reduce_op as jax_reduce_op
from tpulab.ops.sortops import sort_op as jax_sort_op
from tpulab.runtime.timing import parse_timing_device, parse_timing_line

from tpulab_torch.cli.main import main as cli_main
from tpulab_torch.io import load_typed_array, save_typed_array
from tpulab_torch.labs import get_workload, hw1, hw2, lab5
from tpulab_torch.ops.quadratic import solve_batch, solve_scalar
from tpulab_torch.ops.reduction import REDUCERS, reduce_op
from tpulab_torch.ops.sortops import sort_op
from tpulab_torch.runtime import device as devmod

torch.set_num_threads(2)

U = 2.0 ** -24
DTYPES = {"int": np.int32, "uchar": np.uint8, "float": np.float32}


def float_sum_bound(values: np.ndarray) -> float:
    """Largest gap between two float32 sums of ``values`` in any orders."""
    k = values.size - 1
    gamma = k * U / (1 - k * U)
    return 2 * gamma * float(np.abs(values.astype(np.float64)).sum())


def _values(elem: str, n: int, seed: int) -> np.ndarray:
    """The lab5 harness processor's synthesis (normal(scale=100) floats,
    bytes, ints in [-10000, 10000))."""
    rng = np.random.default_rng(seed)
    if elem == "float":
        return rng.normal(scale=100.0, size=n).astype(np.float32)
    if elem == "uchar":
        return rng.integers(0, 256, size=n).astype(np.uint8)
    return rng.integers(-10000, 10000, size=n).astype(np.int32)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


# ----------------------------------------------------------------- binfmt


@pytest.mark.parametrize("elem", sorted(DTYPES))
def test_binfmt_files_are_byte_equal_both_ways(elem, tmp_path):
    values = _values(elem, 1000, 1)
    mine, theirs = tmp_path / f"{elem}_port", tmp_path / f"{elem}_jax"
    save_typed_array(str(mine), values)
    jax_save(str(theirs), values)
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_bytes()[:4] == struct.pack("<i", 1000)
    np.testing.assert_array_equal(jax_load(str(mine)), values)
    np.testing.assert_array_equal(load_typed_array(str(theirs)), values)
    assert load_typed_array(str(theirs)).dtype == values.dtype


# ------------------------------------------------------------- reductions


@pytest.mark.parametrize("op", REDUCERS)
@pytest.mark.parametrize("elem", sorted(DTYPES))
def test_reductions_match_tpulab(op, elem):
    values = _values(elem, 2048, 2)
    if op == "prod" and elem == "float":
        values = (1 + values / 1e4).astype(np.float32)  # keep the product finite
    got = reduce_op(values, op, backend="cpu").numpy()
    want = np.asarray(jax_reduce_op(values, op, backend="cpu"))
    assert got.dtype == want.dtype  # int64 for every integer type, float32 for floats
    if elem != "float":
        assert int(got) == int(want)
    elif op == "sum":
        assert abs(float(got) - float(want)) <= float_sum_bound(values)
    elif op == "prod":
        np.testing.assert_allclose(got, want, rtol=4 * values.size * U)
    else:
        assert _bits(got) == _bits(want)


def test_integer_sums_and_products_wrap_at_64_bits():
    big = np.full(4, 2**31 - 1, np.int32)
    for op in ("sum", "prod"):
        got = reduce_op(big, op, backend="cpu").numpy()
        assert int(got) == int(np.asarray(jax_reduce_op(big, op, backend="cpu")))


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("vals", [[0.0, -0.0], [-0.0, 0.0], [-0.0, -0.0], [0.0, 0.0],
                                  [1.0, -0.0, 0.0, 2.0], [-3.0, 0.0, -0.0],
                                  [0.0, float("nan"), -0.0], [-0.0, 5.0, -1.0]])
def test_min_max_of_signed_zeros_and_nan_are_tpulab_bytes(op, vals):
    x = np.array(vals, np.float32)
    got = reduce_op(x, op, backend="cpu").numpy()
    want = np.asarray(jax_reduce_op(x, op, backend="cpu"))
    assert np.isnan(got) == np.isnan(want)
    if not np.isnan(want):
        assert _bits(got) == _bits(want)
    assert f"{float(got):.6e}" == f"{float(want):.6e}"


def test_float_sum_bound_rejects_a_dropped_element():
    values = _values("float", 2048, 3)
    bound = float_sum_bound(values)
    want = float(np.asarray(jax_reduce_op(values, "sum", backend="cpu")))
    dropped = np.delete(values, np.argmax(np.abs(values)))
    faulty = float(reduce_op(dropped, "sum", backend="cpu"))
    assert abs(faulty - want) > bound
    assert abs(float(reduce_op(values, "sum", backend="cpu")) - want) <= bound


# -------------------------------------------------------------------- sort


def _special_floats() -> np.ndarray:
    """+-0 in both orders, NaNs of distinct payloads and signs, infinities."""
    bits = np.array([0x40400000, 0x80000000, 0x00000000, 0x7FC00001, 0x80000000,
                     0xFFC00002, 0x3F800000, 0x7F800003, 0xFF800000, 0x00000000,
                     0x7F800000, 0x7FC00004, 0xBF800000, 0x80000000, 0xFFFFFFFF],
                    np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("case", ["specials", "specials_tiled", "normal", "uint8", "int32"])
def test_sort_is_tpulab_bit_for_bit(case):
    rng = np.random.default_rng(4)
    values = {
        "specials": _special_floats(),
        "specials_tiled": np.concatenate([_special_floats(),
                                          rng.normal(size=300).astype(np.float32)] * 3),
        "normal": rng.normal(size=5000).astype(np.float32),
        "uint8": rng.integers(0, 256, 3000).astype(np.uint8),
        "int32": rng.integers(-2**31, 2**31 - 1, 3000).astype(np.int32),
    }[case]
    got = sort_op(values, backend="cpu").numpy()
    want = np.asarray(jax_sort_op(values, backend="cpu"))
    assert got.dtype == want.dtype == values.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------- quadratic


def _check_rows(coeffs, exact):
    status, roots = solve_batch(torch.from_numpy(coeffs))
    status, roots = status.numpy(), roots.numpy()
    jstatus, jroots = (np.asarray(a) for a in jax_solve_batch(jnp.asarray(coeffs)))
    both_nan = np.isnan(roots) & np.isnan(jroots)
    assert (np.isnan(roots) == np.isnan(jroots)).all() or not exact
    if exact:
        np.testing.assert_array_equal(status, jstatus)
        assert ((_bits(roots) == _bits(jroots)) | both_nan).all()
    return status, roots, jstatus, jroots


def test_solve_batch_is_tpulab_where_the_discriminant_is_exact():
    """Integer coefficients of at most 1000: b*b and 4ac are exact in
    float32, so every rounding of the discriminant is the same and the
    rows must be bit-equal, degenerate ones included."""
    rng = np.random.default_rng(5)
    coeffs = rng.integers(-1000, 1001, (20000, 3)).astype(np.float32)
    coeffs[::7, 0] = 0
    coeffs[::11, 1] = 0
    coeffs[::13, 2] = 0
    coeffs[::17] = 0
    coeffs[1::19, 1] = 2 * coeffs[1::19, 0]  # b^2 = 4ac: one double root
    coeffs[1::19, 2] = coeffs[1::19, 0]
    status, _, _, _ = _check_rows(coeffs, exact=True)
    assert set(np.unique(status)) == {0, 1, 2, 3, 4}


def test_solve_batch_is_solve_scalar_and_near_tpulab_on_real_coefficients():
    """Real coefficients: each row says what ``solve_scalar`` says of it, and
    tpulab's row lies within one rounding of the discriminant: XLA fuses
    b*b - 4ac into one FMA, so its d differs by at most half an ulp of b*b
    plus half an ulp of 4ac (E below), its sqrt by at most sqrt(E), its
    roots by sqrt(E) / |2a| plus three roundings of the root."""
    rng = np.random.default_rng(6)
    coeffs = rng.uniform(-100, 100, (4000, 3)).astype(np.float32)
    status, roots, jstatus, jroots = _check_rows(coeffs, exact=False)
    for i in range(0, len(coeffs), 37):
        line = solve_scalar(*coeffs[i])
        if status[i] == 0:
            assert line == f"{roots[i, 0]:.6f} {roots[i, 1]:.6f}"
        elif status[i] == 2:
            assert line == "imaginary"
    a, b, c = (coeffs[:, j].astype(np.float64) for j in range(3))
    err_d = U * (b * b + np.abs(4 * a * c))
    clear = np.abs(b * b - 4 * a * c) > 2 * err_d
    np.testing.assert_array_equal(status[clear], jstatus[clear])
    two = clear & (status == 0)
    limit = np.sqrt(err_d) / np.abs(2 * a) + 3 * 2 * U * np.abs(jroots).max(axis=1)
    gap = np.abs(roots.astype(np.float64) - jroots).max(axis=1)
    assert (gap[two] <= limit[two]).all()


# ------------------------------------------------------------------ the CLIs


def _cli(argv, text):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        import sys
        old, sys.stdin = sys.stdin, io.StringIO(text)
        try:
            assert cli_main(argv) == 0
        finally:
            sys.stdin = old
    return out.getvalue()


@pytest.fixture
def fixtures(tmp_path):
    """The reference's lab5 fixtures as ROADMAP A5 states them: int10 holds
    0..9 (sum 45), uchar10 1 2 3 1 2 3 1 2 3 4 (sum 22), float10 0..9 (max 9.0)."""
    files = {
        "int10": np.array([0, 9, 8, 7, 6, 5, 4, 3, 2, 1], np.int32),
        "uchar10": np.array([1, 2, 3, 1, 2, 3, 1, 2, 3, 4], np.uint8),
        "float10": np.arange(10, dtype=np.float32)[::-1].copy(),
    }
    for name, values in files.items():
        save_typed_array(str(tmp_path / name), values)
    return tmp_path


@pytest.mark.parametrize("name,task,want", [("int10", "sum", "45"), ("uchar10", "sum", "22"),
                                            ("float10", "max", f"{9.0:.6e}"),
                                            ("int10", "prod", "0"), ("uchar10", "min", "1")])
def test_lab5_cli_on_the_reference_fixtures(fixtures, name, task, want):
    path = str(fixtures / name)
    out = _cli(["run", "lab5", "--backend", "cpu", "--task", task, "--reps", "1"], path + "\n")
    first, value = out.splitlines()
    assert parse_timing_device(first) == "CPU" and parse_timing_line(first) is not None
    assert value == want
    theirs = jax_lab5.run(path + "\n", backend="cpu", task=task, warmup=0, reps=1)
    assert theirs.splitlines()[1] == value


@pytest.mark.parametrize("elem", sorted(DTYPES))
@pytest.mark.parametrize("task", ["sum", "min", "max", "sort"])
def test_lab5_run_matches_tpulab(elem, task, tmp_path):
    values = _values(elem, 3000, 7)
    if elem == "float":
        values[::97] = -0.0
        values[5::101] = 0.0
    path = str(tmp_path / f"{elem}3000")
    save_typed_array(path, values)
    text = f"{path}\n{path}_port\n" if task == "sort" else f"{path}\n"
    mine = lab5.run(text, backend="cpu", task=task, warmup=0, reps=1)
    theirs = jax_lab5.run(text.replace("_port", "_jax"), backend="cpu", task=task,
                          warmup=0, reps=1)
    assert parse_timing_device(mine) == "CPU"
    if task == "sort":
        assert Path(path + "_port").read_bytes() == Path(path + "_jax").read_bytes()
    elif elem == "float" and task == "sum":
        gap = abs(float(mine.splitlines()[1]) - float(theirs.splitlines()[1]))
        assert gap <= float_sum_bound(values) + 1e-6 * abs(float(theirs.splitlines()[1]))
    else:
        assert mine.splitlines()[1] == theirs.splitlines()[1]


def test_lab5_sort_of_signed_zeros_and_nan_payloads_is_byte_equal(tmp_path):
    path = str(tmp_path / "float15")
    save_typed_array(path, _special_floats())
    lab5.run(f"{path}\n{path}_port\n", backend="cpu", task="sort", warmup=0, reps=1)
    jax_lab5.run(f"{path}\n{path}_jax\n", backend="cpu", task="sort", warmup=0, reps=1)
    assert Path(path + "_port").read_bytes() == Path(path + "_jax").read_bytes()


def test_lab5_mesh_engages_only_with_the_devices_and_equals_tpulab(fixtures, monkeypatch,
                                                                    tmp_path):
    """``--mesh N`` engages only where ``device_count >= N > 1``; where it
    engages, the output equals ``tpulab``'s ``lab5.run(..., mesh=N)``."""
    text = str(fixtures / "int10") + "\n"
    # one CPU device: --mesh 2 cannot engage, and runs as tpulab's would on one device
    assert lab5.run(text, backend="cpu", mesh=2, warmup=0, reps=1).splitlines()[1] == "45"
    # four: --mesh 2 engages two gloo ranks, and equals tpulab's lab5 on a mesh of two
    # of its eight CPU devices (the reduction, the sorted file's bytes)
    monkeypatch.setattr(lab5, "device_count", lambda device: 4)
    for name, task in (("int10", "sum"), ("uchar10", "prod")):
        text = str(fixtures / name) + "\n"
        mine = lab5.run(text, backend="cpu", task=task, mesh=2, warmup=0, reps=1)
        theirs = jax_lab5.run(text, backend="cpu", task=task, mesh=2, warmup=0, reps=1)
        assert parse_timing_device(mine) == "CPU"
        assert mine.splitlines()[1] == theirs.splitlines()[1]
    path = str(tmp_path / "float15")
    save_typed_array(path, _special_floats())
    lab5.run(f"{path}\n{path}_port\n", backend="cpu", task="sort", mesh=2, warmup=0, reps=1)
    jax_lab5.run(f"{path}\n{path}_jax\n", backend="cpu", task="sort", mesh=2, warmup=0, reps=1)
    assert Path(path + "_port").read_bytes() == Path(path + "_jax").read_bytes()
    text = str(fixtures / "int10") + "\n"
    assert lab5.run(text, backend="cpu", mesh=1, warmup=0, reps=1).splitlines()[1] == "45"
    assert devmod.device_count(torch.device("cpu")) == 1


def test_lab5_unknown_task(fixtures):
    with pytest.raises(ValueError):
        lab5.run(str(fixtures / "int10") + "\n", backend="cpu", task="median")


HW1_CASES = ["0 0 0", "0 0 5", "0 2 -4", "1 -3 2", "1 2 1", "1 0 1", "2.5 -7.25 1e-3"]


@pytest.mark.parametrize("text", HW1_CASES)
def test_hw1_cli_strings_equal_tpulab(text):
    mine = _cli(["run", "hw1", "--backend", "cpu"], text + "\n")
    assert mine == jax_hw1.run(text + "\n", backend="cpu")
    timed = hw1.run(text + "\n", backend="cpu", timing=True).splitlines()
    assert parse_timing_device(timed[0]) == "CPU"
    assert timed[1:] == mine.splitlines()


@pytest.mark.parametrize("timing", [False, True])
def test_hw2_cli_equals_tpulab(timing):
    rng = np.random.default_rng(8)
    vals = np.concatenate([rng.normal(size=500).astype(np.float32), [0.0, -0.0, 0.0]])
    text = f"{len(vals)}\n" + " ".join(repr(float(v)) for v in vals) + "\n"
    argv = ["run", "hw2", "--backend", "cpu"] + (["--timing", "--reps", "1"] if timing else [])
    mine = _cli(argv, text)
    theirs = jax_hw2.run(text, backend="cpu", timing=timing, warmup=0, reps=1)
    if timing:
        assert parse_timing_device(mine) == "CPU"
        mine, theirs = mine.split("\n", 1)[1], theirs.split("\n", 1)[1]
    assert mine == theirs
    assert " 0.000000e+00 -0.000000e+00 0.000000e+00 " in mine  # +-0 in input order


@pytest.mark.parametrize("name", ["lab5", "hw1", "hw2"])
def test_new_workloads_resolve(name):
    assert get_workload(name).run.__module__ == f"tpulab_torch.labs.{name}"
