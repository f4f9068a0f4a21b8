"""Fused ``steps_per_call`` blocks: ``step.step_k`` and the trainer's block
plan, held bit-equal to the port's own K=1 loop and against tpulab's
``train(steps_per_call=K)`` on the CPU.

Bars, with their reasons: the port's K=4 against its K=1, bit for bit
(the K steps of a block are the same step, in order, and the plan ends a
block at every boundary); against tpulab, the tolerances of
``tests/test_torch_train.py`` (losses rtol 2e-6, parameters atol 2e-5:
XLA and PyTorch sum in other orders), and the plan and the counters line
equal.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from tpulab import train as jtrain
from tpulab.models import generate as jgen
from tpulab.models import labformer as jlf

from tpulab_torch import ckpt
from tpulab_torch import train as ttrain
from tpulab_torch.models import generate as tgen
from tpulab_torch.models import labformer as tlf

torch.set_num_threads(2)

BASE = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
LOSS_RTOL = 2e-6
PARAM_ATOL = 2e-5


def _quiet(*a, **k):
    pass


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bit_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(_bits(a), _bits(b)), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _state(d, step):
    return torch.load(os.path.join(d, str(step), ckpt.STATE_FILE), weights_only=True)


def _run(steps, d=None, log=None, attn="dense", **kw):
    """The port's loop on the CPU at the tiny size; its ``[train] step``
    lines without their times."""
    out = []
    ttrain.train(steps=steps, batch=4, seq=24, ckpt_dir=d, log=out.append, device="cpu",
                 cfg=tlf.LabformerConfig(**BASE, attn_impl=attn), **kw)
    if log is not None:
        log.extend(out)
    return [ln.split(" (")[0] for ln in out if ln.startswith("[train] step")]


@pytest.mark.parametrize("attn,accum", [("dense", 1), ("flash", 1), ("dense", 2)])
def test_step_k_is_bit_equal_to_k_steps(attn, accum):
    cfg = tlf.LabformerConfig(**BASE, attn_impl=attn)
    batch_at = ttrain.batches(256, 4, 24, 3)
    block = np.stack([batch_at(j) for j in range(4)])
    m1, s1, step = tlf.init_train_state(cfg, seed=1, accum=accum, device="cpu")
    m4, s4, step4 = tlf.init_train_state(cfg, seed=1, accum=accum, device="cpu")
    singles = []
    for j in range(4):
        m1, s1, loss = step(m1, s1, block[j])
        singles.append(loss)
    m4, s4, losses = step4.step_k(m4, s4, block)
    assert losses.shape == (4,) and losses.dtype == torch.float32
    assert torch.equal(_bits(losses), _bits(torch.stack(singles)))
    _assert_bit_equal(m4.to_tree(), m1.to_tree())
    _assert_bit_equal(s4, s1)


@pytest.mark.parametrize("overlap", [0, 1])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_k4_loop_is_bit_equal_to_k1(tmp_path, attn, overlap):
    kw = dict(eval_every=5, save_every=7, overlap=overlap, seed=2, attn=attn)
    logs = {1: [], 4: []}
    got = {k: _run(14, str(tmp_path / f"k{k}"), logs[k], steps_per_call=k, **kw)
           for k in (1, 4)}
    assert got[4] == got[1] and len(got[1]) == 14
    evals = [[ln for ln in logs[k] if ln.startswith("[eval]")] for k in (1, 4)]
    assert evals[0] == evals[1] and len(evals[0]) == 2
    _assert_bit_equal(_state(str(tmp_path / "k4"), 14), _state(str(tmp_path / "k1"), 14))
    fused = [ln for ln in logs[4] if ln.startswith("[train] counters")][0]
    # blocks [0,4) [7,11); 4, 5, 6 and 11-13 as K=1 calls
    assert f"dispatches=8 fused_calls=2" in fused and "steps_per_call=4" in fused


def _plans(monkeypatch):
    """Record each package's dispatches as block lengths: the port's by
    wrapping its step, tpulab's by the token uploads its loop makes
    (one ``device_put`` a dispatch: ``(batch, seq+1)`` or ``(K, batch,
    seq+1)``)."""
    plans = {"port": [], "tpulab": []}
    real_init = tlf.init_train_state

    def init(*a, **k):
        model, state, step = real_init(*a, **k)

        def one(m, s, tokens):
            plans["port"].append(1)
            return step(m, s, tokens)

        def fused(m, s, block):
            plans["port"].append(len(block))
            return step.step_k(m, s, block)

        one.step_k = fused
        return model, state, one

    monkeypatch.setattr(tlf, "init_train_state", init)
    real_put = jax.device_put

    def put(x, *a, **k):
        if isinstance(x, np.ndarray) and x.dtype == np.int32 and x.shape[-2:] == (4, 25):
            plans["tpulab"].append(x.shape[0] if x.ndim == 3 else 1)
        return real_put(x, *a, **k)

    monkeypatch.setattr(jax, "device_put", put)
    return plans


PLAN_CASES = {
    # eval and save boundaries inside blocks, and a tail shorter than K
    "boundaries": dict(steps=17, eval_every=6, save_every=5),
    # a fault inside a would-be block, rolled back to the snapshot at 8
    "fault_recover": dict(steps=16, save_every=4, recover=1, inject_fault=(10,)),
    # a fault on the first step of a block, and one at the very end
    "fault_edges": dict(steps=12, save_every=4, recover=2, inject_fault=(4, 11)),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_block_plan_equals_tpulabs(tmp_path, monkeypatch, name):
    kw = PLAN_CASES[name]
    plans = _plans(monkeypatch)
    tlog, jlog = [], []
    ttrain.train(batch=4, seq=24, ckpt_dir=str(tmp_path / "t"), steps_per_call=4,
                 cfg=tlf.LabformerConfig(**BASE), log=tlog.append, device="cpu", **kw)
    jtrain.train(batch=4, seq=24, ckpt_dir=str(tmp_path / "j"), steps_per_call=4,
                 cfg=jlf.LabformerConfig(**BASE), log=jlog.append, **kw)
    assert plans["port"] == plans["tpulab"] and 4 in plans["port"]
    lines = [[ln for ln in log if ln.startswith(("[fault]", "[recover]", "[train] counters"))]
             for log in (tlog, jlog)]
    assert lines[0] == lines[1]


def test_resume_across_a_k_boundary_is_bit_equal(tmp_path):
    d1, d2 = str(tmp_path / "interrupted"), str(tmp_path / "straight")
    log = []
    # 6 steps: a block [0, 4), then 4 and 5 alone; the resumed run's block
    # [6, 10) starts where the snapshot is, then 10 and 11 alone
    first = _run(6, d1, save_every=6, steps_per_call=4, seed=4)
    rest = _run(12, d1, log, save_every=6, steps_per_call=4, resume=True, seed=4)
    assert "[train] resumed from step 6" in log
    straight = _run(12, d2, save_every=6, seed=4)
    assert first + rest == straight
    _assert_bit_equal(_state(d1, 12), _state(d2, 12))


def test_recover_across_a_k_boundary_is_bit_equal(tmp_path):
    d1, d2 = str(tmp_path / "rec"), str(tmp_path / "clean")
    log = []
    # after the block [0, 4), steps 4 to 7 run as K=1 calls (the unfired
    # fault at 6, the save at 8); the rollback to the snapshot at 4 replays
    # [4, 8) as one block, the fault having fired, then [8, 12)
    got = _run(12, d1, log, save_every=4, recover=1, inject_fault=(6,), steps_per_call=4,
               overlap=1, seed=4)
    want = _run(12, d2, save_every=4, seed=4)
    assert "[recover] non-finite loss at step 6: rolling back to snapshot 4 (1/1)" in log
    assert [ln for i, ln in enumerate(got) if ln not in got[:i]] == want
    _assert_bit_equal(_state(d1, 12), _state(d2, 12))


def test_k4_loop_matches_tpulab(tmp_path):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    kw = dict(steps=9, batch=4, seq=24, save_every=9, eval_every=3, seed=1, steps_per_call=4)
    jlog, tlog = [], []
    jstep, jloss = jtrain.train(cfg=jlf.LabformerConfig(**BASE, attn_impl="flash"),
                                ckpt_dir=jd, log=jlog.append, **kw)
    tstep, tloss = ttrain.train(cfg=tlf.LabformerConfig(**BASE, attn_impl="flash"),
                                ckpt_dir=td, log=tlog.append, device="cpu", **kw)
    assert jstep == tstep == 9
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    keep = ("[train] step", "[eval]")
    jl, tl = ([ln for ln in log if ln.startswith(keep)] for log in (jlog, tlog))
    assert len(jl) == len(tl) == 12
    for a, b in zip(tl, jl):
        assert a.split()[:4] == b.split()[:4]
        np.testing.assert_allclose(float(a.split()[4]), float(b.split()[4]), rtol=1e-4)
    counters = [[ln for ln in log if ln.startswith("[train] counters")] for log in (tlog, jlog)]
    assert counters[0] == counters[1]
    cfg = tlf.LabformerConfig(**BASE, attn_impl="flash")
    want, _ = jgen.load_params(jlf.LabformerConfig(**BASE, attn_impl="flash"), jd)
    got, _ = tgen.load_params(cfg, td)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        g = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(keys))


def test_counters_line_equals_tpulabs_cli():
    from tpulab.cli.main import main as jax_cli

    from tpulab_torch.cli.main import main as torch_cli

    argv = ["train", "--steps", "10", "--batch", "2", "--seq", "16", "--eval-every", "5",
            "--steps-per-call", "4", "--seed", "3"]
    outs = []
    for cli, extra in ((jax_cli, []), (torch_cli, ["--backend", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli(argv + extra) == 0
        outs.append(buf.getvalue().splitlines())
    lines = [[ln for ln in out if ln.startswith("[train] counters")] for out in outs]
    assert lines[0] == lines[1] == [
        "[train] counters dispatches=4 fused_calls=2 host_syncs=2 steps_per_call=4 overlap=1"]
    fields = [[[w.split("=")[0] for w in ln.split()] for ln in out
               if ln.startswith("[train] metrics")] for out in outs]
    assert fields[0] == fields[1] and len(fields[0]) == 3


def test_refusals_match_tpulabs():
    for kw in (dict(steps_per_call=0), dict(steps_per_call=4, model="labvision")):
        with pytest.raises(ValueError) as want:
            jtrain.train(steps=1, batch=2, seq=8, log=_quiet, **kw)
        with pytest.raises(ValueError) as got:
            ttrain.train(steps=1, batch=2, seq=8, log=_quiet, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_chip_smoke_phase6g_rehearses_on_the_cpu():
    """chip_smoke.py's phase 6g at a tiny size on the CPU: every check of the
    phase runs (lines, snapshots, counters and the plan, the timing turns)."""
    import chip_smoke

    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(train=dict(d_model=32, n_heads=4, n_layers=2, d_ff=64), train_batch=2,
                train_seq=16, fused_rounds=1)
    out = chip_smoke.run_fused_steps(tiny, torch.device("cpu"), "cpu")
    assert out["plan"] == [4, 1, 1, 4, 1, 1]
    assert "dispatches=6 fused_calls=2" in out["counters"]["k4"]
    assert len(out["timing"]["k1_step_ms_runs"]) == len(out["timing"]["k4_step_ms_runs"]) == 2
