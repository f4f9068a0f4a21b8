"""The port's mesh training (``tpulab_torch.models.sharded`` through
``labformer.make_train_step(cfg, mesh)`` and ``train(mesh_devices=N)``)
over 2 and 4 gloo ranks on the CPU, held against ``tpulab`` on a mesh of
the same shape from the conftest's 8 CPU devices, on the same seeded
inputs.

Each world size is one :class:`~tpulab_torch.parallel.mesh.RankPool` for
the module (``shared_pool``, which ``train`` reuses); every case calls a
function on every rank and reads rank 0's result.  The ranks import this
module, so it imports neither JAX nor ``tpulab`` at its top: the ``J``
fixture does.

Bars: forwards within ``tests/test_labformer.py``'s mesh limits (rtol
2e-4, atol 2e-4); each training step's loss within 2e-5 of ``tpulab``'s;
first-step gradients within 1e-5 of each leaf's largest ``|tpulab|``; the
MoE router loss and expert loads within 1e-6.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from tpulab_torch.models import labformer as LF
from tpulab_torch.parallel.mesh import cpu_test_mesh, shared_pool

torch.set_num_threads(2)

TINY = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = 2e-5
GRAD_REL = 1e-5
AUX_TOL = 1e-6


def tokens_of(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


# ------------------------------------------------------------ rank functions


def rank_forward(axes: dict, cfg_kw: dict, tokens: np.ndarray) -> np.ndarray:
    cfg = LF.LabformerConfig(**cfg_kw)
    mesh = cpu_test_mesh(axes)
    model = LF.Labformer.from_numpy(LF.init_params(cfg, 0), cfg, mesh=mesh)
    with torch.no_grad():
        return model(tokens).numpy()


def rank_steps(axes: dict, cfg_kw: dict, batches: list, zero1=False, zero2=False,
               accum=1, loads=False) -> dict:
    """Steps of ``batches``: each loss, the first step's whole gradient tree,
    the whole parameters after, and (``loads``) the MoE statistics of the
    first batch before the step."""
    cfg = LF.LabformerConfig(**cfg_kw)
    mesh = cpu_test_mesh(axes)
    model, state, step = LF.init_train_state(cfg, mesh, seed=0, zero1=zero1, zero2=zero2,
                                             accum=accum)
    out = {"losses": []}
    if loads:
        with torch.no_grad():
            _, auxes, load = model._forward_scan(batches[0][:, :-1])
        out["aux"], out["load"] = float(auxes.mean()), load.numpy()
    if not (zero1 or zero2 or accum > 1):
        out["grads"] = flat_tree(LF.mesh_grads(model, batches[0]))
    for tok in batches:
        model, state, loss = step(model, state, tok)
        out["losses"].append(float(loss))
    out["params"] = flat_tree(LF.gather_params(model))
    out["moments"] = moment_sizes(model, state, step)
    return out


def flat_tree(tree: dict) -> dict:
    out = {k: v.numpy() for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks/{k}": v.numpy() for k, v in tree["blocks"].items()})
    return out


def moment_sizes(model, state, step) -> dict:
    """Per leaf, the elements this rank keeps of adam's first moment."""
    zv = step.zero_view(model)
    mu = state[0]["mu"]
    out, i = {}, 0
    for path, _, mode, arg in zv.items:
        k = arg if mode == "layers" else _
        out[path] = sum(t.numel() for t in mu[i:i + k])
        i += k
    return out


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def J():
    """tpulab's side: labformer, train, jax and its CPU test mesh."""
    import jax
    from tpulab.models import labformer
    from tpulab.parallel.mesh import cpu_test_mesh as jmesh
    from tpulab import train as jtrain

    from tpulab.parallel.mesh import make_mesh

    def mesh_of(n):  # the mesh tpulab's train(mesh_devices=n) builds
        return make_mesh(n_devices=n, axes=("dp", "sp", "tp", "pp"))

    return types.SimpleNamespace(lf=labformer, jax=jax, mesh=jmesh, train=jtrain,
                                 mesh_of=mesh_of)


def jax_forward(J, axes, cfg_kw, tokens):
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = J.lf.LabformerConfig(**cfg_kw)
    mesh = J.mesh(axes)
    params = J.lf.shard_params(J.lf.init_params(cfg, seed=0), cfg, mesh)
    tok = J.jax.device_put(tokens, NamedSharding(mesh, J.lf._restrict(P("dp", None), mesh)))
    return np.asarray(J.jax.jit(lambda p, t: J.lf.forward(p, t, cfg, mesh=mesh))(params, tok))


FORWARDS = {
    "dp2sp2-ring": ({"dp": 2, "sp": 2}, {}),
    "dp2sp2-zigzag": ({"dp": 2, "sp": 2}, {"sp_impl": "zigzag"}),
    "dp2sp2-ulysses": ({"dp": 2, "sp": 2}, {"sp_impl": "ulysses"}),
    "tp2pp2": ({"tp": 2, "pp": 2}, {}),
    "dp2tp2-gqa": ({"dp": 2, "tp": 2}, {"n_kv_heads": 2}),
    "tp2-gqa1": ({"tp": 2}, {"n_kv_heads": 1}),
    "sp2-ring-window": ({"sp": 2}, {"attn_window": 5}),
    "sp2-ulysses-window": ({"sp": 2}, {"sp_impl": "ulysses", "attn_window": 5}),
    "dp2sp2-ring-flash": ({"dp": 2, "sp": 2}, {"attn_impl": "flash"}),
}


@pytest.mark.parametrize("case", sorted(FORWARDS))
def test_forward_matches_tpulab(J, case):
    axes, kw = FORWARDS[case]
    cfg_kw = {**TINY, **kw}
    tokens = tokens_of(256, 4, 32, seed=3)
    world = int(np.prod(list(axes.values())))
    got = shared_pool(world, "cpu").run(rank_forward, axes, cfg_kw, tokens)
    want = jax_forward(J, axes, cfg_kw, tokens)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def rank_refusal(axes: dict, cfg_kw: dict, tokens: np.ndarray) -> str:
    try:
        rank_forward(axes, cfg_kw, tokens)
    except NotImplementedError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("case", ["zigzag-window", "ulysses-heads"])
def test_sp_refusals_match_tpulab(J, case):
    """tpulab's refusals on the sp path, with its messages: a window under
    zigzag (NotImplementedError), and Ulysses' local heads over sp."""
    if case == "zigzag-window":
        axes, kw, exc = {"sp": 2}, {"sp_impl": "zigzag", "attn_window": 5}, NotImplementedError
    else:
        axes, kw, exc = {"sp": 2, "tp": 2}, {"sp_impl": "ulysses", "n_heads": 2,
                                             "d_model": 32}, ValueError
    cfg_kw = {**TINY, **kw}
    tokens = tokens_of(256, 2, 32, seed=4)
    with pytest.raises(exc) as jerr:
        jax_forward(J, axes, cfg_kw, tokens)
    with pytest.raises(RuntimeError) as terr:
        shared_pool(int(np.prod(list(axes.values()))), "cpu").run(rank_forward, axes,
                                                                 cfg_kw, tokens)
    assert exc.__name__ in str(terr.value)
    assert str(jerr.value).split(":")[0] in str(terr.value)


# ------------------------------------------------------------ training


def jax_steps(J, axes, cfg_kw, batches, loads=False) -> dict:
    """tpulab's side of :func:`rank_steps` on the same mesh shape."""
    jax = J.jax
    cfg = J.lf.LabformerConfig(**cfg_kw)
    mesh = J.mesh(axes)
    params, state, step = J.lf.init_train_state(cfg, mesh, seed=0)
    out = {"losses": []}
    if loads:
        inputs = batches[0][:, :-1]
        out["aux"] = float(jax.jit(lambda p, t: J.lf.forward_with_aux(p, t, cfg, mesh)[1])(
            params, inputs))
        out["load"] = np.asarray(jax.jit(lambda p, t: J.lf.expert_load(p, t, cfg, mesh))(
            params, inputs))
    grads = jax.jit(jax.grad(lambda p, t: J.lf.loss_fn(p, t, cfg, mesh)))(params, batches[0])
    out["grads"] = {k: np.asarray(v) for k, v in flat_jax(grads).items()}
    for tok in batches:
        params, state, loss = step(params, state, tok)
        out["losses"].append(float(loss))
    out["params"] = {k: np.asarray(v) for k, v in flat_jax(params).items()}
    return out


def flat_jax(tree: dict) -> dict:
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks/{k}": v for k, v in tree["blocks"].items()})
    return out


def assert_training_matches(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_TOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got["grads"][k] - w).max())
        assert err <= GRAD_REL * max(scale, 1e-30), (k, err, scale)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=1e-4, err_msg=k)


def train_batches(b=4, s=32, n=3):
    from tpulab_torch.train import batches

    at = batches(256, b, s, 0)
    return [at(i) for i in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_steps_match_tpulab(J, n):
    """Three f32 steps on the mesh ``train(mesh_devices=n)`` builds (n=2:
    pp=2; n=4: tp=2, pp=2): each loss, the first step's gradients and
    the parameters after against ``tpulab``'s ``init_train_state`` step on
    the same mesh."""
    from tpulab_torch.train import mesh_sizes

    axes = mesh_sizes(n, zero1=False)
    assert axes == dict(J.mesh_of(n).shape)
    batches = train_batches()
    got = shared_pool(n, "cpu").run(rank_steps, axes, TINY, batches)
    assert_training_matches(got, jax_steps(J, axes, TINY, batches))


def test_dispatch_moe_matches_tpulab(J):
    """Top-2 dispatch MoE (E=4, capacity factor 2: tokens can drop) over
    {dp: 2, sp: 2}: steps, gradients, the router loss and the expert
    loads against ``tpulab``'s."""
    axes = {"dp": 2, "sp": 2}
    kw = {**TINY, "n_experts": 4, "moe_top_k": 2, "moe_impl": "dispatch"}
    batches = train_batches()
    got = shared_pool(4, "cpu").run(rank_steps, axes, kw, batches, loads=True)
    want = jax_steps(J, axes, kw, batches, loads=True)
    assert abs(got["aux"] - want["aux"]) <= AUX_TOL
    np.testing.assert_allclose(got["load"], want["load"], rtol=0, atol=AUX_TOL)
    assert_training_matches(got, want)


def test_sp_gqa_steps_match_tpulab(J):
    """sp (zigzag) with dp, tp with GQA kv_heads % tp != 0, and Ulysses
    with tp under remat (the recomputed blocks post their exchanges
    again): steps against ``tpulab``'s on the same meshes."""
    batches = train_batches(b=4, s=32, n=2)
    for axes, kw in (({"dp": 2, "sp": 2}, {"sp_impl": "zigzag"}),
                     ({"tp": 2}, {"n_kv_heads": 1}),
                     ({"sp": 2, "tp": 2}, {"sp_impl": "ulysses", "remat": True})):
        cfg_kw = {**TINY, **kw}
        world = int(np.prod(list(axes.values())))
        got = shared_pool(world, "cpu").run(rank_steps, axes, cfg_kw, batches)
        assert_training_matches(got, jax_steps(J, axes, cfg_kw, batches))
