"""ZeRO-1/2 in the port's mesh trainer (``tpulab_torch.models.sharded.
ZeroView`` through ``labformer.init_train_state(..., zero1/zero2)``), over
2 and 4 gloo ranks: the cases of ``tests/test_zero1.py``.

The spec choice is held to ``tpulab``'s ``_zero1_spec`` on the same shapes;
the rest is held as ``tpulab``'s tests hold it: each dp rank keeps 1/dp
of every moment leaf that has an axis divisible by dp, and ZeRO-1 and
ZeRO-2 train to the replicated optimizer's losses and parameters within
``atol=1e-5`` (with ``accum = 2`` too).  The ranks import this module, so
it imports neither JAX nor ``tpulab`` at its top.
"""

import numpy as np
import pytest
import torch

from tpulab_torch.models import labformer as LF
from tpulab_torch.models import sharded
from tpulab_torch.parallel.mesh import cpu_test_mesh, shared_pool

torch.set_num_threads(2)

SMALL = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64)
ATOL = 1e-5


def _tokens(vocab, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)


# ------------------------------------------------------------ rank functions


def rank_moments(axes: dict, cfg_kw: dict, steps: int, zero1=False, zero2=False) -> list:
    """After ``steps`` steps: per trainable leaf, (path, whole shape, the
    elements of adam's mu this rank keeps, the shapes of its mu tensors,
    the shapes of the leaf's own ZeRO view)."""
    cfg = LF.LabformerConfig(**cfg_kw)
    model, state, step = LF.init_train_state(cfg, cpu_test_mesh(axes), seed=0,
                                             zero1=zero1, zero2=zero2)
    for i in range(steps):
        model, state, loss = step(model, state, _tokens(cfg.vocab, 8, 33, seed=i))
        assert np.isfinite(float(loss))
    zv = step.zero_view(model)
    mu = state[0]["mu"]
    plan = model.plan
    leaves = dict(model.trainable_leaves())
    out, i = [], 0
    for path, n, mode, arg in zv.items:
        k = arg if mode == "layers" else n
        ts = leaves[path]
        local = ((len(ts),) if path.startswith("blocks/") else ()) + tuple(ts[0].shape)
        own = [tuple(t.shape) for t in zv.view([p for p in LF._flat(model)])[i:i + k]]
        out.append((path, plan.global_shape(path, local), sum(t.numel() for t in mu[i:i + k]),
                    [tuple(t.shape) for t in mu[i:i + k]], own, mode))
        i += k
    return out


def rank_train(axes: dict, cfg_kw: dict, batches: list, zero1=False, zero2=False,
               accum=1) -> dict:
    cfg = LF.LabformerConfig(**cfg_kw)
    model, state, step = LF.init_train_state(cfg, cpu_test_mesh(axes), seed=0, zero1=zero1,
                                             zero2=zero2, accum=accum)
    losses = []
    for tok in batches:
        model, state, loss = step(model, state, tok)
        losses.append(float(loss))
    tree = LF.gather_params(model)
    flat = {k: v.numpy() for k, v in tree.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v.numpy() for k, v in tree["blocks"].items()})
    return {"losses": losses, "params": flat}


def _world(axes):
    return int(np.prod(list(axes.values())))


def _run(fn, axes, *args, **kw):
    return shared_pool(_world(axes), "cpu").run(fn, axes, *args, **kw)


def _sliced_every_splittable(rows, dp):
    n_sliced = 0
    for path, shape, mine, _, _, _ in rows:
        whole = int(np.prod(shape))
        if any(d % dp == 0 and d >= dp for d in shape):
            assert mine * dp == whole, (path, shape, mine)
            n_sliced += 1
        else:
            assert mine == whole, (path, shape, mine)
    assert n_sliced > 0


# ------------------------------------------------------------ the cases


def test_zero1_spec_matches_tpulab():
    """The port's spec choice is ``tpulab``'s ``_zero1_spec`` on the same
    shapes and specs: dp on the first free divisible axis, the next one
    where that does not divide, unchanged where dp is used already."""
    from jax.sharding import PartitionSpec as P

    from tpulab.models.labformer import _zero1_spec as jspec
    from tpulab.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": 4, "tp": 2})
    sizes = {"dp": 4, "tp": 2}
    cases = [((2, 8, 16), ("pp", None, "tp")), ((2, 6, 16), (None, None, None)),
             ((2, 8, 16), (None, ("dp", "sp"), None)), ((4, 8), (None, "tp")),
             ((3,), (None,)), ((2, 4, 3, 8), ("pp", ("dp", "sp"), None, "tp"))]
    for shape, spec in cases:
        want = tuple(jspec(shape, P(*spec), mesh))
        got = sharded._zero1_spec(shape, spec, sizes)
        norm = lambda s: tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e  # noqa: E731
                               for e in s)
        pad = lambda s, n: tuple(s) + (None,) * (n - len(s))  # noqa: E731
        assert pad(norm(got), len(shape)) == pad(norm(want), len(shape)), (shape, spec)
    assert sharded._zero1_spec((2, 8, 16), ("pp", None, "tp"), sizes) == (None, "dp", "tp")
    assert sharded._zero1_spec((2, 6, 16), (None, None, None), sizes) == (None, None, "dp")


def test_zero1_moments_are_dp_sharded():
    _sliced_every_splittable(_run(rank_moments, {"dp": 4}, SMALL, 0, zero1=True), 4)


def test_zero1_state_stays_sharded_across_steps():
    _sliced_every_splittable(_run(rank_moments, {"dp": 4}, SMALL, 2, zero1=True), 4)


def test_zero2_implies_zero1_sharded_state():
    rows = _run(rank_moments, {"dp": 4}, SMALL, 0, zero2=True)
    assert any(mode is not None for *_, mode in rows), "zero2 did not shard the optimizer state"
    _sliced_every_splittable(rows, 4)


def test_zero1_layouts_survive_shape_collision():
    """d_ff == d_model: wq/wk/wv/w1 and wo/w2 share a shape with their tp
    layouts transposed; every moment tensor has its own leaf's view."""
    kw = {**SMALL, "d_ff": 32}
    rows = _run(rank_moments, {"dp": 2, "tp": 2}, kw, 1, zero1=True)
    assert len(rows) == 10  # 8 block leaves, embed, final_norm
    for path, _, _, mu_shapes, own, _ in rows:
        assert mu_shapes == own, (path, mu_shapes, own)


def _batches(n=2, batch=8):
    return [_tokens(256, batch, 33, seed=i) for i in range(n)]


@pytest.mark.parametrize("zero", ["zero1", "zero2"])
def test_zero_matches_replicated_training(zero):
    """Two steps (the sharded-state feedback cycle) equal replicated
    training within tpulab's atol 1e-5, losses and parameters."""
    axes, batches = {"dp": 4}, _batches()
    rep = _run(rank_train, axes, SMALL, batches)
    got = _run(rank_train, axes, SMALL, batches, **{zero: True})
    np.testing.assert_allclose(got["losses"], rep["losses"], rtol=0, atol=ATOL)
    for k, v in rep["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=ATOL, err_msg=k)


def test_zero2_with_grad_accumulation():
    """The gradients reduce-scattered per microbatch and summed: accum=2
    equals zero2 on the whole batch."""
    axes, batches = {"dp": 4}, _batches(n=1)
    acc = _run(rank_train, axes, SMALL, batches, zero2=True, accum=2)
    full = _run(rank_train, axes, SMALL, batches, zero2=True)
    np.testing.assert_allclose(acc["losses"], full["losses"], rtol=0, atol=ATOL)
    for k, v in full["params"].items():
        np.testing.assert_allclose(acc["params"][k], v, rtol=0, atol=ATOL, err_msg=k)


def test_zero1_noop_without_dp_axis():
    out = _run(rank_train, {"tp": 2}, SMALL, _batches(n=1, batch=4), zero1=True)
    assert np.isfinite(out["losses"][0])


def test_zero1_with_moe_dispatch():
    """The expert axis already uses dp: its moments stay whole on their
    (dp, sp) shard, the dense leaves are sliced, and the step runs."""
    kw = {**SMALL, "n_experts": 8, "moe_impl": "dispatch"}
    rows = _run(rank_moments, {"dp": 2, "sp": 2}, kw, 1, zero1=True)
    modes = {path: mode for path, *_, mode in rows}
    assert modes["blocks/w1"] is None and modes["blocks/w2"] is None
    assert modes["blocks/wq"] is not None and modes["embed"] is not None


def test_zero1_refuses_meshless_labvision_and_lora():
    """tpulab's refusals with its messages: no mesh, labvision, a mesh with
    no factor of 2 for dp, and LoRA."""
    from tpulab_torch.train import mesh_sizes, train

    with pytest.raises(ValueError, match="mesh"):
        train(steps=1, zero1=True, mesh_devices=0, device="cpu")
    with pytest.raises(ValueError, match="labformer"):
        train(steps=1, zero1=True, mesh_devices=8, model="labvision", device="cpu")
    with pytest.raises(ValueError, match="zero1 needs a mesh with dp > 1"):
        mesh_sizes(3, zero1=True)
    assert mesh_sizes(4, zero1=True) == {"dp": 2, "sp": 1, "tp": 2, "pp": 1}
    with pytest.raises(ValueError, match="pointless"):
        LF.make_train_step(LF.LabformerConfig(**SMALL, lora_rank=2), None, zero1=True)
