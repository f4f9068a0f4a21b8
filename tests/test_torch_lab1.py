"""tpulab_torch lab1 (kernel B2, elementwise) held against tpulab."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.io import protocol as jax_protocol
from tpulab.labs import lab1 as jax_lab1
from tpulab.ops.pallas.elementwise import pallas_binary
from tpulab.runtime.timing import parse_timing_device, parse_timing_line

from tpulab_torch.io import protocol
from tpulab_torch.labs import lab1
from tpulab_torch.ops.cuda.elementwise import OPS, binary
from tpulab_torch.ops.elementwise import stage_vector

torch.set_num_threads(1)

JNP_OPS = {
    "subtract": jnp.subtract,
    "add": jnp.add,
    "multiply": jnp.multiply,
    "minimum": jnp.minimum,
    "maximum": jnp.maximum,
}
SPECIALS = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -2.5]


def _operands(n, with_specials, seed):
    """Random operands over a wide exponent range; with ``with_specials``
    also every pairing of NaN (both signs), signed zero and infinity."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n))
    b = rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n))
    b[::7] = a[::7]  # exact ties
    if with_specials:
        sa, sb = np.meshgrid(SPECIALS, SPECIALS)
        a, b = np.concatenate([a, sa.ravel()]), np.concatenate([b, sb.ravel()])
    return a, b


def _payload(stdout):
    first, payload = stdout.split("\n", 1)
    assert parse_timing_line(first) is not None
    return first, payload


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_payload_string_equal_to_tpulab(dtype):
    rng = np.random.default_rng(11)
    a = np.concatenate([rng.uniform(-1e100, 1e100, 300), [1e100, -1e100, 0.0, 1.5]])
    b = np.concatenate([rng.uniform(-1e100, 1e100, 300), [-1e100, 1e100, -0.0, 0.25]])
    if dtype != "float64":  # keep float32/bfloat16 finite
        a, b = a * 1e-98, b * 1e-98
    text = protocol.format_lab1_input(a, b)
    first, mine = _payload(lab1.run(text, backend="cpu", dtype=dtype, warmup=0, reps=1))
    _, ref = _payload(jax_lab1.run(text, backend="cpu", dtype=dtype, warmup=0, reps=1))
    assert parse_timing_device(first) == "CPU"
    assert mine == ref


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_byte_equal_to_pallas_kernel(op, dtype):
    special = op in ("minimum", "maximum")
    a, b = _operands(2000, special, seed=OPS.index(op))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ja, jb = jnp.asarray(a.astype(np.float32)).astype(jdt), jnp.asarray(b.astype(np.float32)).astype(jdt)
    ref = np.asarray(pallas_binary(ja, jb, JNP_OPS[op], interpret=True))
    bits, tbits, tdt = ((np.int32, torch.int32, torch.float32) if dtype == "float32"
                        else (np.int16, torch.int16, torch.bfloat16))
    # hand the port the same bits (the two frameworks round NaN to bf16 differently)
    ta = torch.from_numpy(np.asarray(ja).view(bits).copy()).view(tdt)
    tb = torch.from_numpy(np.asarray(jb).view(bits).copy()).view(tdt)
    out = binary(op, ta, tb)
    np.testing.assert_array_equal(out.view(tbits).numpy(), ref.view(bits))


@pytest.mark.parametrize("op", OPS)
def test_float64_ops_byte_equal_to_xla(op):
    a, b = _operands(2000, op in ("minimum", "maximum"), seed=20 + OPS.index(op))
    ref = np.asarray(JNP_OPS[op](jnp.asarray(a), jnp.asarray(b)))
    out = binary(op, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out.view(np.uint64), ref.view(np.uint64))


def test_bfloat16_staging_rounds_through_float32():
    v = np.array([1.0 + 2**-8 + 2**-30, 3.14159, -1e-3])
    mine = stage_vector(v, "bfloat16", torch.device("cpu")).float().numpy()
    ref = np.asarray(jnp.asarray(v.astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(mine, ref)


def test_sweep_prefix_and_payload_format():
    out = lab1.run("1 32\n1\n2.0\n0.5\n", sweep=True, backend="cpu", warmup=0, reps=1)
    first, payload = _payload(out)
    assert payload == "1.5000000000e+00 "
    ref = jax_protocol.format_vector_10e(np.array([1.5]))
    assert payload == ref


@pytest.mark.parametrize("launch", [(1, 1025), (0, 32), (2**31, 32)])
def test_refused_geometry_raises_before_launch(launch):
    a = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError):
        binary("subtract", a, a, launch)


def test_wrapper_checks_its_operands():
    a = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError):
        binary("subtract", a, a.float())
    with pytest.raises(ValueError):
        binary("divide", a, a)
    with pytest.raises(ValueError):
        binary("add", a.to(torch.int64), a.to(torch.int64))
