"""adafactor on a mesh where a leaf is split, against ``tpulab``: the
port's statistics over the global leaf (``optim.leaf_splits``, filled by
``sharded.ZeroView.splits``), ``train(mesh_devices=N, opt_name=
"adafactor")``, the keyed statistics in mesh snapshots, and the refusal
under ZeRO.

The config is wide enough that adafactor factors its second moment
(``d_model`` 128, ``d_ff`` 256: ``blocks/wq`` is (2, 128, 128)); the mesh
tests' ``TINY`` widths factor no leaf.  On ``{"tp": 2}`` a rank holds
``wq`` as (2, 128, 64), which a decision on the local shape would not
factor.

Bars: each loss within 2e-5 of ``tpulab``'s (``tests/test_torch_mesh_loop.py``);
gathered updates, parameters and factored statistics fed the same seeded
gradients as optax within ``tests/test_torch_optim_rest.py``'s ulp rule
(4 ulp of the value + 4 ulp of the leaf's largest magnitude, float32).

Ranks come from ``shared_pool`` and import this module, so it imports
neither JAX nor ``tpulab`` at its top: the ``J`` fixture does.
"""

import shutil
import types

import numpy as np
import pytest
import torch

from tpulab_torch import ckpt, optim
from tpulab_torch.models import labformer as LF
from tpulab_torch.models import sharded
from tpulab_torch.parallel.mesh import cpu_test_mesh, shared_pool

torch.set_num_threads(2)

CFG = dict(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=32)
LOSS_TOL = 2e-5
ULPS = 4
SEEDED_LR = 3e-3
SEEDED_STEPS = 3


def _quiet(*a, **k):
    pass


def _paths(tree: dict) -> dict:
    """``{path: array}`` with the port's leaf paths (``blocks/wq``, ``embed``)."""
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks/{k}": v for k, v in tree.get("blocks", {}).items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _ulp_check(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ulp = np.spacing(np.abs(want)) + np.spacing(np.float32(np.abs(want).max()))
    bad = np.abs(got.astype(np.float64) - want) > ULPS * ulp
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} beyond {ULPS} ulps"


@pytest.fixture(scope="module")
def J():
    import jax
    import optax
    from tpulab import train as jtrain
    from tpulab.models import labformer
    from tpulab.parallel.mesh import cpu_test_mesh as jmesh

    return types.SimpleNamespace(jax=jax, optax=optax, lf=labformer, train=jtrain, mesh=jmesh)


def train_batches(n=3):
    from tpulab_torch.train import batches

    at = batches(256, 4, 32, 0)
    return [at(i) for i in range(n)]


# ------------------------------------------------------------ rank functions


def rank_adafactor_steps(axes: dict, cfg_kw: dict, batches: list) -> list:
    """``optim.adafactor(1e-3)`` steps of ``init_train_state`` on ``axes``:
    each loss."""
    cfg = LF.LabformerConfig(**cfg_kw)
    model, state, step = LF.init_train_state(cfg, cpu_test_mesh(axes), seed=0,
                                             optimizer=optim.adafactor(1e-3))
    losses = []
    for tok in batches:
        model, state, loss = step(model, state, tok)
        losses.append(float(loss))
    return losses


def _whole_leaves(model, flat) -> dict:
    """The whole leaves (numpy, by path) of a flat list of this rank's parts."""
    out, i = {}, 0
    for path, ts in model.trainable_leaves():
        part = flat[i:i + len(ts)]
        i += len(ts)
        local = torch.stack(part) if path.startswith("blocks/") else part[0]
        out[path] = model.plan.gather(path, local).numpy()
    return out


def rank_seeded_adafactor(axes: dict, cfg_kw: dict, grads: list,
                          local_statistics: bool = False) -> dict:
    """The trainer's adafactor stack fed this rank's part of each whole
    seeded gradient tree: the whole updates of each step, the whole
    parameters after, and (unless ``local_statistics``) the gathered keyed
    statistics with this rank's shapes.  ``local_statistics`` takes every
    statistic over the rank's part of each leaf (no ``leaf_splits``): the
    fault the test must catch."""
    from tpulab_torch.train import build_optimizer

    cfg = LF.LabformerConfig(**cfg_kw)
    model = LF.Labformer.from_numpy(LF.init_params(cfg, 3), cfg, trainable=True,
                                    mesh=cpu_test_mesh(axes))
    opt = build_optimizer(lr=SEEDED_LR, steps=len(grads), optimizer="adafactor")
    zv = sharded.ZeroView(model, False)
    splits = None if local_statistics else zv.splits
    flat = LF._flat(model)
    with optim.leaf_splits(splits, sharded.sum_over):
        state = opt.init(flat, zv.leaves())
    out = {"updates": []}
    for whole in grads:
        local = []
        for path, ts in model.trainable_leaves():
            part = model.plan.take(path, torch.from_numpy(whole[path]))
            local += list(part.unbind(0)) if path.startswith("blocks/") else [part]
        with torch.no_grad(), optim.leaf_splits(splits, sharded.sum_over):
            updates = opt.update(local, state, flat)
            optim.apply_updates(flat, updates)
        out["updates"].append(_whole_leaves(model, updates))
    out["params"] = _paths(LF.gather_params(model))
    if not local_statistics:
        factored = sharded.gather_opt_state(model, state, zv)[0][0]
        out["state"] = {k: {p: t.numpy() for p, t in factored[k].items()} for k in optim.KEYED}
        out["local_shapes"] = {k: {p: tuple(t.shape) for p, t in state[0][0][k].items()}
                               for k in optim.KEYED}
    return out


# ------------------------------------------------------------ tpulab's side


def jax_adafactor_steps(J, axes: dict, cfg_kw: dict, batches: list) -> list:
    cfg = J.lf.LabformerConfig(**cfg_kw)
    params, state, step = J.lf.init_train_state(cfg, J.mesh(axes), seed=0,
                                                optimizer=J.optax.adafactor(1e-3))
    losses = []
    for tok in batches:
        params, state, loss = step(params, state, tok)
        losses.append(float(loss))
    return losses


def jax_seeded_adafactor(J, cfg_kw: dict, grads: list) -> dict:
    """optax's side of :func:`rank_seeded_adafactor` on one device (GSPMD
    keeps the one-device arithmetic)."""
    jnp = J.jax.numpy
    cfg = J.lf.LabformerConfig(**cfg_kw)
    params = J.jax.tree_util.tree_map(jnp.asarray, J.lf.init_params(cfg, seed=3))
    opt = J.train.build_optimizer(lr=SEEDED_LR, steps=len(grads), optimizer="adafactor")
    state = opt.init(params)
    out = {"updates": []}
    for whole in grads:
        tree = {k: jnp.asarray(v) for k, v in whole.items() if not k.startswith("blocks/")}
        tree["blocks"] = {k[7:]: jnp.asarray(v) for k, v in whole.items()
                          if k.startswith("blocks/")}
        updates, state = opt.update(tree, state, params)
        params = J.optax.apply_updates(params, updates)
        out["updates"].append(_paths(updates))
    out["params"] = _paths(params)
    factored = next(s for s in J.jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, "v_row")) if hasattr(s, "v_row"))
    out["state"] = {k: _paths(getattr(factored, k)) for k in optim.KEYED}
    return out


def seeded_grads(cfg_kw: dict, n: int) -> list:
    shapes = _paths(LF.init_params(LF.LabformerConfig(**cfg_kw), 3))
    rng = np.random.default_rng(100)
    return [{p: (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
             for p, a in sorted(shapes.items())} for _ in range(n)]


def assert_seeded_close(got: dict, want: dict) -> None:
    for i, (g, w) in enumerate(zip(got["updates"], want["updates"])):
        assert set(g) == set(w)
        for path in w:
            _ulp_check(g[path], w[path], f"step {i} update {path}")
    for path, w in want["params"].items():
        _ulp_check(got["params"][path], w, f"parameter {path}")


# ------------------------------------------------------------ train(mesh_devices=N)


@pytest.mark.parametrize("n", [2, 4])
def test_train_adafactor_on_mesh_matches_tpulab(J, n):
    """``train(mesh_devices=n, opt_name="adafactor")`` (n=2: pp=2; n=4:
    tp=pp=2), 3 f32 steps: the final loss within 2e-5 of ``tpulab``'s and
    of the port's one-device run, the same step lines."""
    from tpulab_torch.train import train

    kw = dict(steps=3, batch=4, seq=32, mesh_devices=n, opt_name="adafactor")
    tout, jout = [], []
    tstep, tloss = train(**kw, cfg=LF.LabformerConfig(**CFG), log=tout.append, device="cpu")
    jstep, jloss = J.train.train(**kw, cfg=J.lf.LabformerConfig(**CFG), log=jout.append)
    _, single = train(**{**kw, "mesh_devices": 0}, cfg=LF.LabformerConfig(**CFG), log=_quiet,
                      device="cpu")
    assert tstep == jstep == 3
    assert abs(tloss - jloss) <= LOSS_TOL, (tloss, jloss)
    assert abs(tloss - single) <= LOSS_TOL, (tloss, single)

    def steps(lines):
        return [ln.split()[:5] for ln in lines if ln.startswith("[train] step")]

    assert steps(tout) == steps(jout)


STEP_MESHES = {
    "tp2": ({"tp": 2}, {}),
    "dp2-moe-dense": ({"dp": 2}, {"n_experts": 4}),
    "dp2-moe-dispatch": ({"dp": 2}, {"n_experts": 4, "moe_impl": "dispatch"}),
    "sp2-moe": ({"sp": 2}, {"n_experts": 4}),
}


@pytest.mark.parametrize("case", sorted(STEP_MESHES))
def test_adafactor_steps_match_tpulab(J, case):
    """``init_train_state(optimizer=adafactor(1e-3))`` and its step on
    ``{"tp": 2}`` (heads and d_ff split), and with 4 experts over dp or sp
    (the expert axis split): 3 f32 losses within 2e-5 of ``tpulab``'s on
    the same mesh."""
    axes, kw = STEP_MESHES[case]
    cfg_kw = {**CFG, **kw}
    batches = train_batches()
    world = int(np.prod(list(axes.values())))
    got = shared_pool(world, "cpu").run(rank_adafactor_steps, axes, cfg_kw, batches)
    want = jax_adafactor_steps(J, axes, cfg_kw, batches)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)


# ------------------------------------------------------------ the statistics


@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 2, "pp": 2}], ids=["tp2", "tp2pp2"])
def test_gathered_statistics_match_optax(J, axes):
    """The same seeded gradients through the port's adafactor on the mesh
    and optax's on one device: each step's updates, the parameters after
    and the gathered ``v_row``/``v_col``/``v`` within the ulp rule.  The
    factoring follows the global shape: ``blocks/wq`` is factored, though
    a rank's (2, 128, 64) part alone would not be."""
    grads = seeded_grads(CFG, SEEDED_STEPS)
    world = int(np.prod(list(axes.values())))
    got = shared_pool(world, "cpu").run(rank_seeded_adafactor, axes, CFG, grads)
    want = jax_seeded_adafactor(J, CFG, grads)
    assert_seeded_close(got, want)
    for kind in optim.KEYED:
        assert set(got["state"][kind]), kind
        for path, t in got["state"][kind].items():
            _ulp_check(t, want["state"][kind][path], f"{kind} {path}")
    wq = got["local_shapes"]["v_row"]["blocks/wq"]
    local_wq = (2 // axes.get("pp", 1), 128, 64)
    assert optim._factored_dims(local_wq, 128) is None
    assert optim._factored_dims((2, 128, 128), 128) is not None
    # this rank's part of the global row statistic: wq's columns are
    # reduced, its layers split over pp
    assert wq == (2 // axes.get("pp", 1), 128)
    assert got["local_shapes"]["v_col"]["blocks/wq"] == (2 // axes.get("pp", 1), 64)


def test_local_statistics_fail_the_check(J):
    """Statistics taken over each rank's part of a leaf (factoring decided
    on the local shape, means and RMS over the shard) give other updates:
    the check above catches them, as it catches per-layer statistics
    (``tests/test_torch_optim_rest.py``)."""
    grads = seeded_grads(CFG, SEEDED_STEPS)
    got = shared_pool(2, "cpu").run(rank_seeded_adafactor, {"tp": 2}, CFG, grads, True)
    want = jax_seeded_adafactor(J, CFG, grads)
    with pytest.raises(AssertionError):
        assert_seeded_close(got, want)


# ------------------------------------------------------------ snapshots


def _snapshot_statistics(d, step: int) -> dict:
    state = torch.load(f"{d}/{step}/{ckpt.STATE_FILE}", weights_only=True)["opt_state"]
    factored = state[0][0]
    return {k: {p: t.numpy() for p, t in factored[k].items()} for k in optim.KEYED}


def test_mesh4_snapshot_resumes_on_one_device(J, tmp_path):
    """A mesh-4 (tp=pp=2) adafactor snapshot of step 2 holds the one-device
    layout of the keyed statistics (the shapes of a one-device snapshot of
    step 2, their values within the ulp rule), and resumed on one device
    to step 4 gives the uninterrupted one-device run's loss bit for bit,
    within 2e-5 of ``tpulab``'s uninterrupted run."""
    from tpulab_torch.train import train

    kw = dict(batch=4, seq=32, opt_name="adafactor", log=_quiet, device="cpu")
    cfg = LF.LabformerConfig(**CFG)
    mesh, one = str(tmp_path / "mesh"), str(tmp_path / "one")
    train(steps=2, cfg=cfg, mesh_devices=4, ckpt_dir=mesh, save_every=2, **kw)
    train(steps=2, cfg=cfg, ckpt_dir=one, save_every=2, **kw)
    got, want = _snapshot_statistics(mesh, 2), _snapshot_statistics(one, 2)
    for kind in optim.KEYED:
        assert set(got[kind]) == set(want[kind]), kind
        for path, t in want[kind].items():
            _ulp_check(got[kind][path], t, f"snapshot {kind} {path}")
    _, resumed = train(steps=4, cfg=cfg, ckpt_dir=mesh, save_every=4, resume=True, **kw)
    _, straight = train(steps=4, cfg=cfg, **kw)
    _, jstraight = J.train.train(steps=4, batch=4, seq=32, cfg=J.lf.LabformerConfig(**CFG),
                                 opt_name="adafactor", log=_quiet)
    assert resumed == straight, (resumed, straight)
    assert abs(resumed - jstraight) <= LOSS_TOL, (resumed, jstraight)


def test_single_snapshot_resumes_on_mesh4(tmp_path):
    """And back: a one-device adafactor snapshot of step 2 resumes on a mesh
    of 4, each rank taking its part of every keyed statistic, to the
    uninterrupted one-device run's loss; a mesh-4 snapshot resumes on a
    mesh of 4 to the uninterrupted mesh-4 run's loss, bit for bit."""
    from tpulab_torch.train import train

    kw = dict(batch=4, seq=32, opt_name="adafactor", log=_quiet, device="cpu")
    cfg = LF.LabformerConfig(**CFG)
    one, mesh = str(tmp_path / "one"), str(tmp_path / "mesh")
    train(steps=2, cfg=cfg, ckpt_dir=one, save_every=2, **kw)
    _, resumed = train(steps=4, cfg=cfg, mesh_devices=4, ckpt_dir=one, save_every=4,
                       resume=True, **kw)
    _, straight = train(steps=4, cfg=cfg, **kw)
    assert abs(resumed - straight) <= LOSS_TOL, (resumed, straight)
    train(steps=4, cfg=cfg, mesh_devices=4, ckpt_dir=mesh, save_every=2, **kw)
    _, mesh_straight = train(steps=4, cfg=cfg, mesh_devices=4, **kw)
    shutil.rmtree(f"{mesh}/4")
    _, mesh_resumed = train(steps=4, cfg=cfg, mesh_devices=4, ckpt_dir=mesh, save_every=4,
                            resume=True, **kw)
    assert mesh_resumed == mesh_straight, (mesh_resumed, mesh_straight)


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("zero", ["zero1", "zero2"])
def test_adafactor_under_zero_is_refused_by_both(J, zero):
    """``train(mesh_devices=4, opt_name="adafactor", zero1/zero2=True)``
    (dp = 2): ``tpulab`` fails in ``device_put`` (its ZeRO placement shards
    adafactor's factored statistics by the parameter's shape) with a
    ``ValueError``; the port raises one too, before any step."""
    from tpulab_torch.train import train

    kw = dict(steps=1, batch=4, seq=32, mesh_devices=4, opt_name="adafactor", **{zero: True})
    with pytest.raises(ValueError):
        J.train.train(**kw, cfg=J.lf.LabformerConfig(**CFG), log=_quiet)
    lines = []
    with pytest.raises(ValueError, match="tpulab's ZeRO placement"):
        train(**kw, cfg=LF.LabformerConfig(**CFG), log=lines.append, device="cpu")
    assert not [ln for ln in lines if ln.startswith("[train] step")]


def test_make_train_step_refuses_adafactor_under_zero():
    """The step's own refusal, on a dp mesh under ZeRO-1; lion and adafactor
    without ZeRO pass it."""
    mesh = {"dp": 2, "tp": 2}
    with pytest.raises(ValueError, match="tpulab's ZeRO placement"):
        LF.make_train_step(LF.LabformerConfig(**CFG), mesh, optim.adafactor(1e-3), zero1=True)
    LF._refuse_mesh_options(LF.LabformerConfig(**CFG), mesh, False, False, optim.adafactor(1e-3))
    LF._refuse_mesh_options(LF.LabformerConfig(**CFG), mesh, True, False, optim.lion(1e-3))


# ------------------------------------------------------------ chip_smoke


def test_chip_smoke_phase15g_rehearses_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 15g at widths that factor, on the CPU: adafactor
    through ``train(mesh_devices=1)`` bit-equal to one device (losses and
    snapshots), the mesh's snapshot resumed on one device bit-equal, and
    the step ms of both printed."""
    import chip_smoke

    sizes = dict(chip_smoke.FULL_SIZES)
    sizes.update(train=dict(d_model=128, n_heads=4, n_layers=4, d_ff=256), mesh_ada_layers=2,
                 mesh_batch=2, mesh_seq=32, mesh_rounds=1)
    out = chip_smoke.mesh_adafactor(sizes, torch.device("cpu"), "cpu", "cpu", tmp_path)
    assert len(out["steps"]) == sizes["mesh_steps"]
    assert out["resumed_loss"] == out["final_loss"]
    assert out["one_ms"] > 0 and out["mesh_ms"] > 0
