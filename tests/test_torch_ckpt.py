"""The port's checkpoint format and the trainer's checkpoint lifecycle:
save, resume, recover, retention and init-from, held bit-equal to the
port's own uninterrupted runs, and against tpulab on the sidecar, on the
parameters after the same steps, on init-from and on ``generate
--ckpt-dir``.

Tolerances against tpulab, with their reasons: parameters after N steps
within ``PARAM_ATOL`` = 2e-5 and losses within rtol 2e-6, as
``tests/test_torch_train.py`` states them (XLA and PyTorch sum in other
orders); the port against itself (resume, recover) bit for bit.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpulab import train as jtrain
from tpulab.models import generate as jgen
from tpulab.models import labformer as jlf

from tpulab_torch import ckpt
from tpulab_torch import train as ttrain
from tpulab_torch.models import generate as tgen
from tpulab_torch.models import labformer as tlf

torch.set_num_threads(2)

BASE = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
TINY = tlf.LabformerConfig(**BASE)
PARAM_ATOL = 2e-5
LOSS_RTOL = 2e-6


def _quiet(*a, **k):
    pass


def _run(steps, d=None, log=None, **kw):
    """The port's loop on the CPU at the tiny size; its ``[train] step``
    lines without their times."""
    out = []
    kw.setdefault("cfg", TINY)
    ttrain.train(steps=steps, batch=4, seq=24, ckpt_dir=d, log=out.append, device="cpu",
                 **kw)
    if log is not None:
        log.extend(out)
    return [ln.split(" (")[0] for ln in out if ln.startswith("[train] step")]


def _state(d, step):
    return torch.load(os.path.join(d, str(step), ckpt.STATE_FILE), weights_only=True)


def _assert_bit_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), path
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


#: name -> extra train arguments; "flash" puts B4-B6's plain versions on the path
RESUME_CASES = {
    "dense": dict(cfg=tlf.LabformerConfig(**BASE, attn_impl="dense")),
    "flash": dict(cfg=tlf.LabformerConfig(**BASE, attn_impl="flash")),
    # the schedule spans the whole run's 10 steps in both halves
    "cosine_warmup_clip": dict(optimizer=ttrain.build_optimizer(
        lr=1e-3, steps=10, warmup_steps=3, schedule="cosine", clip_norm=0.5)),
    "sgd_overlap0": dict(lr=0.05, opt_name="sgd", overlap=0),
    "lora": dict(cfg=tlf.LabformerConfig(**BASE, lora_rank=4, attn_impl="flash")),
}


@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_resume_is_bit_equal_to_uninterrupted(tmp_path, name):
    kw = RESUME_CASES[name]
    d1, d2 = str(tmp_path / "interrupted"), str(tmp_path / "straight")
    first = _run(5, d1, save_every=5, **kw)
    log = []
    rest = _run(10, d1, log, save_every=5, resume=True, **kw)
    assert "[train] resumed from step 5" in log
    straight = _run(10, d2, save_every=5, **kw)
    assert first + rest == straight
    _assert_bit_equal(_state(d1, 10), _state(d2, 10))


def test_recover_is_bit_equal_to_fault_free(tmp_path):
    d1, d2 = str(tmp_path / "rec"), str(tmp_path / "clean")
    log = []
    got = _run(10, d1, log, save_every=5, recover=2, inject_fault=(7,))
    want = _run(10, d2, save_every=5)
    assert "[fault] injected non-finite loss at step 7" in log
    assert "[recover] non-finite loss at step 7: rolling back to snapshot 5 (1/2)" in log
    assert sum("[fault]" in ln for ln in log) == 1  # once a step: the replay is clean
    # steps 5 and 6 print twice (before the fault and in the replay)
    assert [ln for i, ln in enumerate(got) if ln not in got[:i]] == want
    _assert_bit_equal(_state(d1, 10), _state(d2, 10))


def test_recover_with_the_native_loader_replays_the_stream(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        (data / f"f{i}.bin").write_bytes(rng.integers(0, 256, 4000).astype(np.uint8).tobytes())
    d1, d2 = str(tmp_path / "rec"), str(tmp_path / "clean")
    got = _run(8, d1, save_every=4, recover=1, inject_fault=(6,), data_dir=str(data))
    want = _run(8, d2, save_every=4, data_dir=str(data))
    assert [ln for i, ln in enumerate(got) if ln not in got[:i]] == want
    _assert_bit_equal(_state(d1, 8), _state(d2, 8))


def test_recover_budget_exhaustion_fails_fast(tmp_path):
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _run(10, str(tmp_path / "rec"), save_every=5, recover=1, inject_fault=(6, 7))


def test_fault_before_any_snapshot_fails_fast(tmp_path):
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _run(10, str(tmp_path / "rec"), save_every=50, recover=3, inject_fault=(2,))


def test_resume_refuses_changed_config_and_tolerates_pre_field_sidecar(tmp_path):
    d = str(tmp_path / "ck")
    _run(4, d, save_every=4)
    changed = dataclasses.replace(TINY, attn_window=8)
    with pytest.raises(ValueError, match="resume config mismatch"):
        _run(8, d, save_every=4, resume=True, cfg=changed)
    sc = os.path.join(d, ckpt.SIDECAR)
    with open(sc) as f:
        sidecar = json.load(f)
    sidecar["config"].pop("attn_window")  # a sidecar from before the field
    with open(sc, "w") as f:
        json.dump(sidecar, f)
    _run(8, d, save_every=4, resume=True)
    with pytest.raises(ValueError, match="not recorded"):
        _run(12, d, save_every=4, resume=True, cfg=changed)


def test_fresh_run_clears_a_stale_directory(tmp_path):
    d = str(tmp_path / "ck")
    _run(6, d, save_every=3)
    (tmp_path / "ck" / "stale.txt").write_text("x")
    log = []
    _run(4, d, log, save_every=2)
    assert not any("resumed" in ln for ln in log)
    assert ckpt.snapshot_steps(d) == [2, 4] and not (tmp_path / "ck" / "stale.txt").exists()


def test_retention_keeps_three_and_ignores_tmp_directories(tmp_path):
    d = str(tmp_path / "ck")
    _run(10, d, save_every=2)
    assert ckpt.snapshot_steps(d) == [6, 8, 10]
    junk = tmp_path / "ck" / "12.tmp"
    junk.mkdir()
    (junk / "state.pt").write_bytes(b"partial")
    assert ckpt.latest_step(d) == 10
    log = []
    _run(12, d, log, save_every=2, resume=True)
    assert "[train] resumed from step 10" in log
    assert ckpt.snapshot_steps(d) == [8, 10, 12]
    meta = json.loads((tmp_path / "ck" / "12" / ckpt.META_FILE).read_text())
    assert meta["format"] == ckpt.FORMAT and meta["step"] == 12
    assert meta["leaves"]["params/blocks/wq"] == {"dtype": "float32", "shape": [2, 32, 32]}
    assert meta["leaves"]["opt_state/0/mu/blocks/wq"]["shape"] == [2, 32, 32]


def test_restore_is_in_place_and_keeps_the_counters(tmp_path):
    d = str(tmp_path / "ck")
    model, state, step = tlf.init_train_state(TINY, None, seed=1, device="cpu")
    batch_at = ttrain.batches(256, 2, 16, 0)
    for i in range(3):
        step(model, state, batch_at(i))
    ckpt.save(d, 3, model, state)
    saved = json.loads(json.dumps(state, default=lambda t: None))
    params = list(model.parameters())
    mu = state[0]["mu"]
    step(model, state, batch_at(3))
    ckpt.restore(d, 3, model, state)
    assert list(model.parameters()) == params and state[0]["mu"] is mu
    assert state[0]["count"] == 3 and state[2]["count"] == 3 and saved[0]["count"] == 3
    other = tlf.init_train_state(TINY, None, seed=1, device="cpu",
                                 optimizer=ttrain.build_optimizer(lr=0.1, steps=4,
                                                                  optimizer="sgd"))
    with pytest.raises(ValueError, match="optimizer state"):
        ckpt.restore(d, 3, other[0], other[1])


def test_orbax_and_foreign_directories_refuse(tmp_path):
    orbax = tmp_path / "orbax" / "5"
    orbax.mkdir(parents=True)
    (orbax / ckpt.ORBAX_MARKER).write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        ckpt.latest_step(str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="orbax"):
        tgen.load_params(TINY, str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="orbax"):
        _run(2, str(tmp_path / "orbax"), resume=True)
    (tmp_path / "other" / "3").mkdir(parents=True)
    with pytest.raises(ValueError, match="not a tpulab_torch-ckpt-v1 snapshot"):
        ckpt.latest_step(str(tmp_path / "other"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        tgen.load_params(TINY, str(tmp_path / "empty"))


# ------------------------------------------------------------ against tpulab


def test_sidecar_json_equals_tpulab(tmp_path):
    from tpulab_torch.io.bpe import train_bpe

    tok = str(tmp_path / "tok.json")
    train_bpe(b"abcabcabd abcabd " * 40, 300).save(tok)
    jcfg = jlf.LabformerConfig(**BASE, attn_window=8, dtype=jnp.bfloat16)
    tcfg = tgen.cfg_from_dict(jlf.cfg_to_dict(jcfg))
    for name, kw in (("plain", {}), ("bpe", dict(tokenizer=tok))):
        jd, td = tmp_path / f"j_{name}", tmp_path / f"t_{name}"
        jtrain.train(steps=0, batch=2, seq=16, cfg=jcfg, ckpt_dir=str(jd), log=_quiet)
        ckpt.write_sidecar(str(td), tcfg, kw.get("tokenizer"))
        if kw:  # tpulab's trainer copies it in the same way
            import shutil

            shutil.copyfile(tok, jd / "tokenizer.json")
            sidecar = json.loads((jd / ckpt.SIDECAR).read_text())
            sidecar["tokenizer"] = "tokenizer.json"
            (jd / ckpt.SIDECAR).write_text(json.dumps(sidecar, indent=2))
        assert (td / ckpt.SIDECAR).read_bytes() == (jd / ckpt.SIDECAR).read_bytes()
        merges = None if not kw else train_bpe(b"abcabcabd abcabd " * 40, 300).merges
        cfg, t = tgen.load_sidecar(str(jd))  # the port reads tpulab's
        assert cfg == tcfg and (t.merges if t else None) == merges
        cfg, t = jgen.load_sidecar(str(td))  # and tpulab the port's
        assert jlf.cfg_to_dict(cfg) == jlf.cfg_to_dict(jcfg)
        assert (t.merges if t else None) == merges


def test_params_after_steps_match_tpulab_checkpoint(tmp_path):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jcfg = jlf.LabformerConfig(**BASE, attn_impl="flash")
    # seed 1, as test_torch_train.py's step tests: at seed 0 one element of
    # blocks/wv (of 2048) lands 4.7e-5 apart after 4 steps, dense or flash,
    # where adam divides a near-zero gradient's rounding by its own size
    jtrain.train(steps=4, batch=4, seq=24, cfg=jcfg, ckpt_dir=jd, save_every=4, seed=1,
                 log=_quiet)
    _run(4, td, save_every=4, cfg=tlf.LabformerConfig(**BASE, attn_impl="flash"), seed=1)
    want, jstep = jgen.load_params(jcfg, jd)
    got, tstep = tgen.load_params(tlf.LabformerConfig(**BASE, attn_impl="flash"), td)
    assert jstep == tstep == 4
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        g = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(keys))


def _write_orbax(params, d, step):
    """A tpulab snapshot of ``params`` as its trainer and distill lay it out."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(d))
    mgr.save(step, args=ocp.args.Composite(state=ocp.args.StandardSave(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)})))
    mgr.wait_until_finished()
    mgr.close()


def write_both(params, jcfg, jdir, tdir, step=7):
    """The same numpy weights as a tpulab (orbax) and a port checkpoint,
    each with its package's sidecar."""
    tcfg = tgen.cfg_from_dict(jlf.cfg_to_dict(jcfg))
    _write_orbax(params, jdir, step)
    with open(os.path.join(jdir, ckpt.SIDECAR), "w") as f:
        json.dump({"model": "labformer", "config": jlf.cfg_to_dict(jcfg)}, f, indent=2)
    ckpt.save(str(tdir), step, tlf.Labformer.from_numpy(params, tcfg, "cpu"))
    ckpt.write_sidecar(str(tdir), tcfg)
    return tcfg


def test_init_from_matches_tpulab_and_keeps_the_base(tmp_path):
    jcfg = jlf.LabformerConfig(**BASE)
    params = jax.device_get(jlf.init_params(dataclasses.replace(jcfg), seed=9))
    write_both(params, jcfg, tmp_path / "j", tmp_path / "t")
    lcfg = dict(**BASE, lora_rank=4, attn_impl="flash")
    jout, tout = [], []
    jtrain.train(steps=3, batch=4, seq=24, cfg=jlf.LabformerConfig(**lcfg),
                 init_from=str(tmp_path / "j"), log=jout.append, ckpt_dir=str(tmp_path / "jl"),
                 save_every=3)
    _run(3, str(tmp_path / "tl"), tout, cfg=tlf.LabformerConfig(**lcfg),
         init_from=str(tmp_path / "t"), save_every=3)
    jl = [float(ln.split()[4]) for ln in jout if ln.startswith("[train] step")]
    tl = [float(ln.split()[4]) for ln in tout if ln.startswith("[train] step")]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)  # 4 printed decimals
    after = _state(str(tmp_path / "tl"), 3)["params"]
    for key, leaf in after.items():
        if "_lora_" in key:
            continue
        name = key.removeprefix("blocks/")
        src = params["blocks"][name] if key.startswith("blocks/") else params[key]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(src), err_msg=key)
    assert not torch.equal(after["blocks/wq_lora_b"], torch.zeros_like(after["blocks/wq_lora_b"]))


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("lora", [0, 4])
def test_generate_ckpt_dir_streams_equal_tpulab(tmp_path, trained_small, trained_small_cfg,
                                                lora):
    from tpulab_torch.cli.main import main as cli_main

    params, jcfg = trained_small, trained_small_cfg
    if lora:
        # adapters that change the output: B random, so the merge matters
        jcfg = dataclasses.replace(jcfg, lora_rank=lora, lora_alpha=8.0)
        rng = np.random.default_rng(0)
        blocks = dict(params["blocks"])
        L, d = jcfg.n_layers, jcfg.d_model
        for w in ("wq", "wv"):
            blocks[f"{w}_lora_a"] = (rng.standard_normal((L, d, lora)) * 0.1).astype(np.float32)
            blocks[f"{w}_lora_b"] = (rng.standard_normal((L, lora, d)) * 0.1).astype(np.float32)
        params = {**params, "blocks": blocks}
    write_both(params, jcfg, tmp_path / "j", tmp_path / "t")
    argv = ["--prompt", "abcabc", "--steps", "16", "--temperature", "0"]
    rc_j, want = _cli(jgen.main, [*argv, "--ckpt-dir", str(tmp_path / "j")])
    rc_t, got = _cli(cli_main, ["generate", "--backend", "cpu", *argv, "--ckpt-dir",
                                str(tmp_path / "t")])
    assert rc_j == rc_t == 0 and got == want
    assert "[generate] loaded checkpoint step 7" in got
    assert ("[generate] merged LoRA adapters (rank 4)" in got) == bool(lora)


def test_chip_smoke_lifecycle_phase_rehearsed_on_cpu(tmp_path):
    """chip_smoke.py's phase 11 at tiny sizes on the CPU (the plain
    versions): every check of the card's run, at a d32 model."""
    import chip_smoke

    sizes = dict(chip_smoke.FULL_SIZES)
    sizes.update(life_corpus_bytes=60_000, life_files=3, life_vocab=300,
                 life=dict(d_model=32, n_heads=4, n_layers=2, d_ff=64), life_batch=2,
                 life_seq=32, life_steps=6, life_save_every=3, life_fault=4, life_bpe_steps=3,
                 life_eval_batches=2, life_prompt_tokens=64, life_gen_steps=4, life_lora_rank=2,
                 life_lora_steps=2, life_student_layers=1, life_distill_steps=2,
                 life_distill_seq=32, life_distill_batch=2, life_cli_seq=32, life_cli_batch=2)
    out = chip_smoke.run_lifecycle_path(sizes, torch.device("cpu"), "cpu", "cpu", tmp_path)
    assert out["byte_flagship"]["bit_equal"] and out["byte_flagship"]["dispatches"] == {
        "straight": 6, "interrupted": 3, "resumed": 3, "recovered": 9}
    assert out["checkpoint"]["snapshot_bytes"] > 0 and out["tokenizer"]["vocab"] == 300
    assert not (tmp_path / "lifecycle").exists()
