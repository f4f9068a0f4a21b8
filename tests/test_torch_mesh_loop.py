"""The port's mesh trainer end to end: ``train(mesh_devices=N)`` against
``tpulab``'s (its losses, labvision's dp), snapshots resumed across
topologies (``tests/test_train.py``'s elastic cases, within their 1e-4),
``dryrun_train_step`` in every rank of a gloo pool, and ``chip_smoke.py``'s
phase 15 rehearsed at a tiny size.  Pools are ``shared_pool``'s, which
``train`` reuses; the ranks import this module, so it imports neither JAX
nor ``tpulab`` at its top.
"""

import numpy as np
import pytest
import torch

from tpulab_torch.models import labformer as LF
from tpulab_torch.parallel.mesh import shared_pool

torch.set_num_threads(2)

TINY = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
LOSS_TOL = 2e-5


@pytest.fixture(scope="module")
def J():
    import types

    from tpulab import train as jtrain
    from tpulab.models import labformer

    return types.SimpleNamespace(lf=labformer, train=jtrain)


def _quiet(*a, **k):
    pass


def loss_lines(lines):
    return [ln for ln in lines if ln.startswith("[train] step")]


RUNS = {"mesh2": (2, {}), "mesh4": (4, {}),
        "mesh4-zero1-sgd-clip": (4, dict(zero1=True, opt_name="sgd", lr=10.0,
                                         clip_norm=0.05))}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_train_mesh_devices_matches_tpulab(J, case):
    """``train(mesh_devices=n)`` end to end against ``tpulab``'s: the final
    loss within 2e-5, the same step lines; with ZeRO-1 (dp = 2 taken from
    pp), sgd with momentum and a global-norm clip that binds (each update
    scales with the norm, whose sum counts each element once across the
    shards and the ZeRO slices: a norm off by sqrt(2) moves the final
    loss by ~1e-2 at this learning rate)."""
    from tpulab_torch.train import train

    n, kw = RUNS[case]
    tcfg = LF.LabformerConfig(**TINY)
    jcfg = J.lf.LabformerConfig(**TINY)
    tout, jout = [], []
    tstep, tloss = train(steps=3, batch=4, seq=32, cfg=tcfg, mesh_devices=n, log=tout.append,
                         device="cpu", **kw)
    jstep, jloss = J.train.train(steps=3, batch=4, seq=32, cfg=jcfg, mesh_devices=n,
                                 log=jout.append, **kw)
    assert tstep == jstep == 3
    assert abs(tloss - jloss) <= LOSS_TOL
    assert [ln.split()[:5] for ln in loss_lines(tout)] == \
        [ln.split()[:5] for ln in loss_lines(jout)]


def test_steps_per_call_and_accum_on_the_mesh(J):
    """``--steps-per-call 2`` and ``--accum 2`` on a mesh of 2 (pp = 2):
    the fused blocks give the K=1 loop's lines and final loss exactly,
    and both match ``tpulab``'s run with the same flags within 2e-5."""
    from tpulab_torch.train import train

    kw = dict(steps=4, batch=4, seq=32, mesh_devices=2, accum=2)
    fused, plain, jout = [], [], []
    _, fused_loss = train(**kw, cfg=LF.LabformerConfig(**TINY), steps_per_call=2,
                          log=fused.append, device="cpu")
    _, plain_loss = train(**kw, cfg=LF.LabformerConfig(**TINY), log=plain.append, device="cpu")
    _, jloss = J.train.train(**kw, cfg=J.lf.LabformerConfig(**TINY), steps_per_call=2,
                             log=jout.append)
    assert fused_loss == plain_loss
    assert [ln.split()[:5] for ln in loss_lines(fused)] == \
        [ln.split()[:5] for ln in loss_lines(plain)]
    assert abs(fused_loss - jloss) <= LOSS_TOL


def test_labvision_dp_matches_tpulab(J):
    """labvision over a dp mesh of 2: the batch split, the gradients summed;
    the loss against ``tpulab``'s ``train(model="labvision",
    mesh_devices=2)``."""
    from tpulab.models.labvision import LabvisionConfig as JV

    from tpulab_torch.models.labvision import LabvisionConfig as TV
    from tpulab_torch.train import train

    kw = dict(n_classes=4, img_size=16, channels=(8, 16))
    loop = dict(model="labvision", steps=3, batch=8, mesh_devices=2)
    _, tloss = train(**loop, cfg=TV(**kw), log=_quiet, device="cpu")
    _, jloss = J.train.train(**loop, cfg=JV(**kw), log=_quiet)
    _, single = train(**{**loop, "mesh_devices": 0}, cfg=TV(**kw), log=_quiet, device="cpu")
    assert abs(tloss - jloss) <= LOSS_TOL
    assert abs(tloss - single) <= LOSS_TOL


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_train_step_in_every_rank(n):
    """The port's ``dryrun_train_step`` (``__graft_entry__``'s oracle) in
    every rank of a gloo pool: its own assertions pass."""
    assert shared_pool(n, "cpu").run(LF.dryrun_train_step, n, "cpu") is None


# ------------------------------------------------------------ elastic resume


def test_mesh_snapshot_resumes_on_one_device(tmp_path):
    """A snapshot written on a mesh of 4 (tp=2, pp=2) restores and goes on
    on one device to the uninterrupted run's loss (``tests/test_train.py``'s
    elastic case, its 1e-4)."""
    from tpulab_torch.train import train

    cfg = LF.LabformerConfig(**TINY)
    d = str(tmp_path / "elastic")
    train(steps=4, batch=4, seq=32, cfg=cfg, mesh_devices=4, ckpt_dir=d, save_every=4,
          log=_quiet, device="cpu")
    _, resumed = train(steps=8, batch=4, seq=32, cfg=cfg, ckpt_dir=d, save_every=8,
                       resume=True, log=_quiet, device="cpu")
    _, straight = train(steps=8, batch=4, seq=32, cfg=cfg, log=_quiet, device="cpu")
    assert abs(resumed - straight) < 1e-4, (resumed, straight)


def test_single_snapshot_resumes_on_mesh(tmp_path):
    """And back: a one-device snapshot resumes on a mesh of 4 under ZeRO-1
    (its moments resliced over dp = 2)."""
    from tpulab_torch.train import train

    cfg = LF.LabformerConfig(**TINY)
    d = str(tmp_path / "elastic2")
    train(steps=4, batch=4, seq=32, cfg=cfg, ckpt_dir=d, save_every=4, log=_quiet,
          device="cpu")
    _, resumed = train(steps=8, batch=4, seq=32, cfg=cfg, mesh_devices=4, zero1=True,
                       ckpt_dir=d, save_every=8, resume=True, log=_quiet, device="cpu")
    _, straight = train(steps=8, batch=4, seq=32, cfg=cfg, log=_quiet, device="cpu")
    assert abs(resumed - straight) < 1e-4, (resumed, straight)


def test_chip_smoke_phase15_rehearses_on_the_cpu():
    """chip_smoke.py's phase 15 at a tiny size on the CPU: 15a's mesh of one
    bit-equal to one device (losses and snapshots), 15b's dispatch MoE
    against a gloo rank with its dropped share, 15c's resume bit-equal,
    15d's refusals; 15e prints that it did not run."""
    import chip_smoke

    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(train=dict(d_model=32, n_heads=4, n_layers=2, d_ff=64), mesh_batch=2,
                mesh_seq=32, mesh_rounds=1, mesh_moe_batch=2, mesh_moe_seq=32)
    out = chip_smoke.run_mesh_train(tiny, torch.device("cpu"), "cpu", "cpu")
    assert len(out["a"]["steps"]) == tiny["mesh_steps"]
    assert out["b"]["dropped_share_layer0"] > 0
    assert out["c"]["final_loss"] == out["a"]["final_loss"]
    assert out["e"].startswith("15e not run")
