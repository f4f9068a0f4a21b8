"""The port's expert parallelism (``tpulab_torch.parallel.moe``) over 2 and
4 gloo ranks on the CPU, held against ``tpulab.parallel.moe`` on a mesh of
the same size from the conftest's 8 CPU devices: the cases of
``tests/test_moe.py``, with the fused ``("dp", "sp")`` axis, overflow,
top-2 and the gradients of every input.

Each world size is one :class:`~tpulab_torch.parallel.mesh.RankPool`,
spawned once for the module.  The ranks import this module, so it imports
neither JAX nor ``tpulab`` at its top: the ``J`` fixture does.  Bars
(``tests/test_moe.py``'s): rtol 1e-5, atol 1e-6; gradients rtol 2e-4,
atol 2e-4.
"""

import re
import types

import numpy as np
import pytest
import torch

from tpulab_torch.parallel import RankPool, make_mesh, switch_moe, switch_moe_reference
from tpulab_torch.parallel import moe as M

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
LAYOUTS = {"ep2": {"ep": 2}, "ep4": {"ep": 4}, "dp2sp2": {"dp": 2, "sp": 2}}


@pytest.fixture(scope="module")
def J():
    """tpulab's side: its moe module, ``jax`` and a mesh of each layout."""
    import jax
    import jax.numpy as jnp
    from tpulab import parallel
    from tpulab.parallel import moe

    return types.SimpleNamespace(moe=moe, jax=jax, jnp=jnp,
                                 mesh={n: parallel.make_mesh(s) for n, s in LAYOUTS.items()})


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


def setup(seed: int, n=64, d=16, e=8, ff=32):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=0.5: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return mk(n, d), mk(d, e, sc=0.1), mk(e, d, ff), mk(e, ff, d)


def axis_of(layout: str):
    sizes = LAYOUTS[layout]
    return next(iter(sizes)) if len(sizes) == 1 else tuple(sizes)


def jax_moe(J, layout, args, kw, dy=None):
    mesh = J.mesh[layout]
    fn = lambda *a: J.moe.switch_moe(*a, mesh=mesh, axis=axis_of(layout), **kw)  # noqa: E731
    if dy is None:
        return np.asarray(fn(*args))
    g = J.jax.grad(lambda *a: J.jnp.sum(fn(*a) * dy), argnums=(0, 1, 2, 3))(
        *(J.jnp.asarray(a) for a in args))
    return tuple(np.asarray(x) for x in g)


# ------------------------------------------------------------ rank side


def _moe(layout, args, kw, dy=None):
    """Rank side: the port's ``switch_moe`` on the full arrays over the
    layout's mesh; with ``dy``, its output and the gradients of every
    input of sum(y * dy)."""
    mesh = make_mesh(LAYOUTS[layout])
    if dy is None:
        return switch_moe(*args, mesh=mesh, axis=axis_of(layout), **kw)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = switch_moe(*ts, mesh=mesh, axis=axis_of(layout), **kw)
    (y * torch.from_numpy(dy)).sum().backward()
    return (y.detach(), *(t.grad for t in ts))


def _moe_default_mesh(args, kw):
    return switch_moe(*args, **kw)


# ------------------------------------------------------------ dispatch


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [1, 2])
def test_full_capacity_equals_tpulab_and_the_oracle(J, pools, layout, k):
    args = setup(1)
    kw = dict(capacity_factor=8.0, k=k)  # cf = E: nothing drops
    got = pools(4 if layout != "ep2" else 2).run(_moe, layout, args, kw).numpy()
    np.testing.assert_allclose(got, jax_moe(J, layout, args, kw), **TOL)
    want = switch_moe_reference(*args, k=k, backend="cpu").cpu().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_overflow_drops_to_zero_as_tpulab(J, pools, k):
    """capacity_factor 0.25: rows over capacity are zero; what is kept
    equals ``tpulab``'s (top-2: a token may keep one of its two experts)."""
    args = setup(2)
    kw = dict(capacity_factor=0.25, k=k)
    got = pools(4).run(_moe, "ep4", args, kw).numpy()
    want = jax_moe(J, "ep4", args, kw)
    full = switch_moe_reference(*args, k=k, backend="cpu").cpu().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(np.all(got == 0, axis=-1), np.all(want == 0, axis=-1))
    assert np.all(np.isfinite(got)) and not np.allclose(got, full, atol=1e-5)
    if k == 1:
        assert np.all(got == 0, axis=-1).any()


def test_default_mesh_is_every_rank_over_ep(J, pools):
    args = setup(3)
    got = pools(2).run(_moe_default_mesh, args, dict(capacity_factor=8.0)).numpy()
    np.testing.assert_allclose(got, jax_moe(J, "ep2", args, dict(capacity_factor=8.0)), **TOL)


@pytest.mark.parametrize("layout,k,cf", [("ep2", 1, 8.0), ("dp2sp2", 2, 8.0),
                                         ("ep4", 2, 0.5)])
def test_gradients_equal_tpulab(J, pools, layout, k, cf):
    """Gradients of the tokens, the router and both expert weights: each
    rank's is the single-device one, not p times it."""
    args = setup(4)
    dy = np.random.default_rng(5).standard_normal((64, 16)).astype(np.float32)
    kw = dict(capacity_factor=cf, k=k)
    got = pools(4 if layout != "ep2" else 2).run(_moe, layout, args, kw, dy)
    np.testing.assert_allclose(got[0].numpy(), jax_moe(J, layout, args, kw), **TOL)
    for name, g, w in zip(("x", "router_w", "w1", "w2"), got[1:],
                          jax_moe(J, layout, args, kw, dy)):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)


REFUSALS = [(dict(k=9), {}), (dict(k=0), {}), ({}, dict(e=6)), ({}, dict(n=30))]


@pytest.mark.parametrize("kw,shape", REFUSALS)
def test_refusals_equal_tpulabs(J, pools, kw, shape):
    args = setup(6, **shape)
    with pytest.raises(ValueError) as want:
        jax_moe(J, "ep4", args, kw)
    with pytest.raises(RuntimeError, match=re.escape(f"ValueError: {want.value}")):
        pools(4).run(_moe, "ep4", args, kw)


# ------------------------------------------------------------ single process


def test_dispatch_capacity_equals_tpulab(J):
    for cf in (0.25, 1.0, 1.25, 2.0, 8.0):
        for k in (1, 2, 3):
            for n_local in (1, 7, 16, 64):
                for e in (4, 8):
                    assert M.dispatch_capacity(cf, k, n_local, e) == \
                        J.moe.dispatch_capacity(cf, k, n_local, e)


def test_combine_weights_and_the_oracle_equal_tpulab(J):
    x, rw, w1, w2 = setup(7)
    for k in (1, 2, 3):
        got = switch_moe_reference(x, rw, w1, w2, k=k, backend="cpu").cpu().numpy()
        np.testing.assert_allclose(got, np.asarray(J.moe.switch_moe_reference(x, rw, w1, w2, k=k)),
                                   **TOL)
    # planted exact ties: equal gates route to the lower expert id
    gate = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]],
                    np.float32)
    for k in (1, 2, 3):
        got = M.combine_weights(torch.from_numpy(gate), k, torch.float32).numpy()
        want = np.asarray(J.moe.combine_weights(J.jnp.asarray(gate), k, J.jnp.float32))
        assert got.tobytes() == want.tobytes(), k


def test_oracle_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Host arrays and CPU tensors alike go to the card by default: with
    no card visible the oracle raises, and ``backend="cpu"`` runs it."""
    args = setup(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for inputs in (args, [torch.from_numpy(a) for a in args]):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            switch_moe_reference(*inputs)
        assert switch_moe_reference(*inputs, backend="cpu").device.type == "cpu"
