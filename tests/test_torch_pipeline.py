"""The port's GPipe pipeline (``tpulab_torch.parallel.pipeline``) over 1, 2
and 4 gloo ranks on the CPU, held against ``tpulab.parallel.pipeline`` on
a ``pp`` mesh of the same size from the conftest's 8 CPU devices: the
cases of ``tests/test_pipeline.py``, the training step with the port's
``sgd(0.1)`` against ``tpulab``'s with ``optax.sgd(0.1)``.

Each world size is one :class:`~tpulab_torch.parallel.mesh.RankPool`,
spawned once for the module.  The ranks import this module, so it imports
neither JAX nor ``tpulab`` at its top: the ``J`` fixture does.  Bars
(``tests/test_pipeline.py``'s): outputs rtol 1e-5, atol 1e-6; gradients
and parameters rtol 1e-4, atol 1e-5; losses rtol 1e-5.
"""

import re
import types

import numpy as np
import pytest
import torch

from tpulab_torch import optim
from tpulab_torch.parallel import RankPool, make_pipeline_train_step, pipeline_apply

torch.set_num_threads(2)

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def J():
    """tpulab's side: its pipeline module, ``jax``, optax and a ``pp`` mesh
    of each size."""
    import jax
    import jax.numpy as jnp
    import optax
    from tpulab import parallel
    from tpulab.parallel import pipeline

    def layer(x, p):
        return jnp.tanh(x @ p["w"] + p["b"])

    return types.SimpleNamespace(pipe=pipeline, jax=jax, jnp=jnp, optax=optax, layer=layer,
                                 mesh={n: parallel.make_mesh({"pp": n}) for n in (1, 2, 4)})


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


def params(seed: int, n_layers: int, d: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_layers, d, d)) * 0.5).astype(np.float32),
            "b": (rng.standard_normal((n_layers, d)) * 0.1).astype(np.float32)}


def sequential(J, p, x):
    def step(a, layer):
        return J.layer(a, layer), None

    return J.jax.lax.scan(step, J.jnp.asarray(x), p)[0]


# ------------------------------------------------------------ rank side


def mlp_layer(x, layer):
    return torch.tanh(x @ layer["w"] + layer["b"])


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def _apply(p, x, n_micro, grads=False):
    """Rank side: ``pipeline_apply`` over every rank; with ``grads``, the
    output and the parameters' gradients of sum(out * out)."""
    if not grads:
        return pipeline_apply(mlp_layer, p, x, n_micro=n_micro)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out = pipeline_apply(mlp_layer, p, x, n_micro=n_micro)
    (out * out).sum().backward()
    return out.detach(), {k: v.grad for k, v in p.items()}


def _train(p, x, y, steps, n_micro):
    """Rank side: ``steps`` pipeline train steps with ``sgd(0.1)``; the
    losses and the final parameters."""
    from torch.utils import _pytree as pytree

    opt = optim.sgd(0.1)
    step = make_pipeline_train_step(mlp_layer, mse, opt, n_micro=n_micro)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    state = opt.init(pytree.tree_leaves(p))
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, x, y)
        losses.append(float(loss))
    return losses, p


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("stages,n_micro", [(2, 2), (4, 4), (4, 1), (1, 2)])
def test_pipeline_equals_tpulab_and_the_sequential_stack(J, pools, stages, n_micro):
    p = params(stages, n_layers=max(2 * stages, 3), d=16)
    x = np.random.default_rng(10 + stages).standard_normal((8, 16)).astype(np.float32)
    got = pools(stages).run(_apply, p, x, n_micro).numpy()
    want = np.asarray(J.pipe.pipeline_apply(J.layer, p, x, mesh=J.mesh[stages],
                                            n_micro=n_micro))
    np.testing.assert_allclose(got, want, **OUT_TOL)
    np.testing.assert_allclose(got, np.asarray(sequential(J, p, x)), **OUT_TOL)


@pytest.mark.parametrize("stages,n_layers,batch,n_micro", [(4, 6, 4, 4), (2, 2, 5, 4)])
def test_refusals_equal_tpulabs(J, pools, stages, n_layers, batch, n_micro):
    p = params(0, n_layers=n_layers, d=8)
    x = np.zeros((batch, 8), np.float32)
    with pytest.raises(ValueError) as want:
        J.pipe.pipeline_apply(J.layer, p, x, mesh=J.mesh[stages], n_micro=n_micro)
    with pytest.raises(RuntimeError, match=re.escape(f"ValueError: {want.value}")):
        pools(stages).run(_apply, p, x, n_micro)


# ------------------------------------------------------------ backward


@pytest.mark.parametrize("stages,n_micro", [(2, 2), (4, 4)])
def test_gradients_equal_tpulab(J, pools, stages, n_micro):
    """Each rank's parameter gradients are the single-device ones, gathered
    from the stages, not ``stages`` times them."""
    p = params(20 + stages, n_layers=2 * stages, d=16)
    x = np.random.default_rng(30).standard_normal((8, 16)).astype(np.float32)
    out, got = pools(stages).run(_apply, p, x, n_micro, True)

    def loss(q):
        out = J.pipe.pipeline_apply(J.layer, q, x, mesh=J.mesh[stages], n_micro=n_micro)
        return J.jnp.sum(out * out)

    want = J.jax.grad(loss)({k: J.jnp.asarray(v) for k, v in p.items()})
    seq = J.jax.grad(lambda q: J.jnp.sum(sequential(J, q, x) ** 2))(
        {k: J.jnp.asarray(v) for k, v in p.items()})
    for key in ("w", "b"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **PARAM_TOL)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(seq[key]), **PARAM_TOL)


def test_train_step_equals_tpulabs_with_optax_sgd(J, pools):
    d, steps = 8, 3
    p0 = params(40, n_layers=4, d=d)
    rng = np.random.default_rng(41)
    x, y = (rng.standard_normal((8, d)).astype(np.float32) for _ in range(2))
    losses, got = pools(2).run(_train, p0, x, y, steps, 2)

    opt = J.optax.sgd(0.1)
    step = J.pipe.make_pipeline_train_step(
        J.layer, lambda out, tgt: J.jnp.mean((out - tgt) ** 2), opt, mesh=J.mesh[2], n_micro=2)
    p = {k: J.jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(p)
    want = []
    for _ in range(steps):
        p, state, loss = step(p, state, x, y)
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for key in ("w", "b"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(p[key]), **PARAM_TOL)


def test_chip_smoke_phase14_rehearses_on_the_cpu():
    """chip_smoke.py's phase 14 at a tiny size: 14a over two gloo ranks,
    14b for 8 ranks in this process, with every check of the phase (the
    stale block rejected by both limits); the CPU runs B4-B6's plain
    versions, which count no launch."""
    import chip_smoke

    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(sp_shape=(1, 256, 8, 8), sp_grad_shape=(1, 128, 8, 8), sp_windows=(32, 40),
                sp_reps=1, sp_dtype="float32",
                sp_moe={"experts": 8, "k": 2, "d": 16, "ff": 32, "tokens": 64},
                sp_pipe={"layers": 8, "d": 16, "n_micro": 4, "batch": 16})
    out = chip_smoke.run_sp_path(tiny, torch.device("cpu"), "cpu", "cpu")
    assert out["world_size"] == out["sharded"]["world_size"] == 2
    assert set(out["in_process"]["forward"]) == {
        "ring", "zigzag", "ulysses", "ring_window_32", "ring_window_40",
        "stale_block_over_tolerance"}
    assert out["in_process"]["forward"]["stale_block_over_tolerance"] > 1
    assert list(out["in_process"]["backward"]) == ["float32"]
    assert all(row["launches"] == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
               for row in out["in_process"]["backward"]["float32"].values()
               if "launches" in row)


def test_chip_smoke_phase_14b_bfloat16_gradients_rehearsed_on_cpu():
    """Phase 14b's gradients in bfloat16 at a tiny size: each run within
    ``BF16_SUM_GRAD_LIMIT`` of ``grad_tolerance``, the run whose partials
    sum in float32 recorded beside it (not for Ulysses, which sums none),
    and the stale block over every limit."""
    import chip_smoke

    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(sp_grad_shape=(1, 128, 8, 8), sp_windows=(32, 40), sp_reps=1,
                sp_dtype="bfloat16")
    out = chip_smoke.sp_gradients_in_process(tiny, torch.device("cpu"), "cpu")
    assert list(out) == ["float32", "bfloat16"]
    rows = out["bfloat16"]
    assert set(rows) == {"ring", "zigzag", "ulysses", "ring_window_32", "ring_window_40",
                         "stale_block_over_tolerance"}
    for name, row in rows.items():
        if name == "stale_block_over_tolerance":
            assert max(row.values()) > chip_smoke.BF16_SUM_GRAD_LIMIT
            continue
        assert max(row["over_tolerance"].values()) <= chip_smoke.BF16_SUM_GRAD_LIMIT
        assert ("f32_sums_over_tolerance" in row) == (name != "ulysses")
