"""tpulab_torch's lion and adafactor (``tpulab_torch/optim.py``) held against
optax, which ``tpulab``'s trainer builds them from, on the CPU.

The same seeded gradients go through both optimizers for 5 steps, leaf by
leaf; each side applies its own updates to its own copy of the same
parameters.  The config has leaves whose two largest axes reach 128
(``blocks/wq`` (2, 128, 128), ``blocks/w1`` (2, 128, 256), ``embed`` (256,
128)), so adafactor's factored second moment runs, and stacked ``(L, ...)``
leaves, whose block statistics (the factored means, the clipping RMS, the
parameter scale) optax takes over the whole leaf.  Tolerances, with their
reasons:

* updates and parameters: ``|got - want| <= 4 ulp(want) + 4 ulp(max|want|)``
  of the leaf in float32.  XLA and PyTorch sum a leaf's mean in other
  orders, XLA:CPU may contract a multiply-add, and optax's ``t ** -0.8``
  and ``x ** -0.5`` are XLA's power, the port's numpy's ``powf`` and
  ``rsqrt``.  Taking adafactor's statistics per layer instead of per leaf
  moves the updates far past that (checked below).
* ``train(opt_name=...)``'s losses: rtol 2e-6, as ``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpulab import train as jtrain
from tpulab.models import labformer as jlf

from tpulab_torch import optim
from tpulab_torch import train as ttrain
from tpulab_torch.models import labformer as tlf

torch.set_num_threads(2)

CFG = dict(d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq=32)
ULPS = 4
STEPS = 5


def _ulp_check(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    ulp = np.spacing(np.abs(want)) + np.spacing(np.float32(np.abs(want).max()))
    bad = np.abs(got.astype(np.float64) - want) > ULPS * ulp
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} beyond {ULPS} ulps"


def _tree_paths(tree):
    """``{path: array}`` with the port's leaf paths (``blocks/wq``, ``embed``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out["/".join(p.key for p in path)] = np.asarray(leaf)
    return out


def _seeded_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32), params)


def _port_model(params_np, cfg):
    return tlf.Labformer.from_numpy(params_np, cfg, "cpu", trainable=True)


def _flat_tree(model, tree):
    """A tpulab-shaped tree as the port's flat tensor list (per layer)."""
    paths = _tree_paths(tree)
    out = []
    for name, ts in model.trainable_leaves():
        leaf = torch.from_numpy(np.array(paths[name]))
        out.extend(leaf.unbind(0) if name.startswith("blocks/") else [leaf])
    return out


def _unflat(model, flat):
    out, i = {}, 0
    for name, ts in model.trainable_leaves():
        n = len(ts)
        chunk = [t.detach().numpy() for t in flat[i:i + n]]
        out[name] = np.stack(chunk) if name.startswith("blocks/") else chunk[0]
        i += n
    return out


def _run_both(name, leaves=True, lr=3e-3):
    """Per step: (the port's updates, optax's) by leaf path, and the
    parameters after the last step, each side's own."""
    jcfg, tcfg = jlf.LabformerConfig(**CFG), tlf.LabformerConfig(**CFG)
    params = jax.tree_util.tree_map(np.asarray, jlf.init_params(jcfg, seed=3))
    jopt = jtrain.build_optimizer(lr=lr, steps=STEPS, optimizer=name)
    topt = ttrain.build_optimizer(lr=lr, steps=STEPS, optimizer=name)
    model = _port_model(tlf.init_params(tcfg, seed=3), tcfg)
    flat = tlf._flat(model)
    tstate = topt.init(flat, tlf._leaf_sizes(model) if leaves else None)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    steps = []
    for step in range(STEPS):
        grads = _seeded_grads(params, 100 + step)
        jup, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup = topt.update(_flat_tree(model, grads), tstate, flat)
        optim.apply_updates(flat, tup)
        steps.append((_unflat(model, tup), _tree_paths(jup)))
    return steps, _unflat(model, flat), _tree_paths(jparams)


def _close(steps, tparams, jparams):
    for i, (got, want) in enumerate(steps):
        assert set(got) == set(want)
        for path in want:
            _ulp_check(got[path], want[path], f"step {i} update {path}")
    for path in jparams:
        _ulp_check(tparams[path], jparams[path], f"parameter {path}")


@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_updates_match_optax_leaf_by_leaf(name):
    steps, tparams, jparams = _run_both(name)
    _close(steps, tparams, jparams)
    # the step moved every leaf
    assert all(np.abs(u).max() > 0 for u in steps[-1][0].values())


def test_adafactor_factors_the_stacked_leaves():
    """The factored path ran where optax's does, decided on the stacked
    shape: row and column means for the wide leaves, a full moment for the
    norms (their stacked shape (2, 128) has a second axis of 2)."""
    model = _port_model(tlf.init_params(tlf.LabformerConfig(**CFG), seed=3),
                        tlf.LabformerConfig(**CFG))
    state = optim.adafactor(1e-3).init(tlf._flat(model), tlf._leaf_sizes(model))[0]
    assert set(state["v_row"]) == {"blocks/wq", "blocks/wk", "blocks/wv", "blocks/wo",
                                   "blocks/w1", "blocks/w2", "embed"}
    assert tuple(state["v_row"]["blocks/w1"].shape) == (2, 128)
    assert tuple(state["v_col"]["blocks/w1"].shape) == (2, 256)
    assert set(state["v"]) == {"blocks/ln1", "blocks/ln2", "final_norm"}
    jstate = optax.adafactor(learning_rate=1e-3).init(
        jlf.init_params(jlf.LabformerConfig(**CFG), seed=3))
    jrow = _tree_paths(jstate[0].v_row)
    for path, t in state["v_row"].items():
        assert tuple(t.shape) == jrow[path].shape, path


def test_adafactor_per_layer_statistics_fail_the_check():
    """Statistics taken per layer tensor (``leaves=None``) instead of per
    stacked leaf give other numbers: the check above would catch it."""
    steps, tparams, jparams = _run_both("adafactor", leaves=False)
    with pytest.raises(AssertionError):
        _close(steps, tparams, jparams)


@pytest.mark.parametrize("name", ["adamw", "lion", "adafactor", "sgd"])
def test_train_losses_match_tpulab(name):
    kw = dict(steps=4, batch=2, seq=16, seed=2, lr=1e-3, opt_name=name,
              cfg=None, eval_every=2)
    small = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=16)
    tout, jout = [], []
    tstep, tloss = ttrain.train(**{**kw, "cfg": tlf.LabformerConfig(**small)},
                                log=tout.append, device="cpu")
    jstep, jloss = jtrain.train(**{**kw, "cfg": jlf.LabformerConfig(**small)},
                                log=jout.append)
    assert tstep == jstep == 4
    np.testing.assert_allclose(tloss, jloss, rtol=2e-6)

    def losses(lines):
        return [float(ln.split()[4]) for ln in lines if ln.startswith(("[train] step", "[eval]"))]

    np.testing.assert_allclose(losses(tout), losses(jout), rtol=1e-4)  # 4 printed decimals
    assert len(losses(tout)) == 4 + 2
