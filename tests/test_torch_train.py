"""tpulab_torch's training step, loop and CLI held against tpulab's on the CPU.

Both packages start from the same ``init_params`` seed (bit-equal) and take
the same batches (``batches``, bit-equal) for several steps in float32, with
flash attention on the port's plain backward and on tpulab's Pallas kernels
in interpret mode.  Tolerances, with their reasons:

* losses: rtol 2e-6.  XLA and PyTorch sum the matmuls, the softmax and the
  mean in other orders, and XLA:CPU contracts multiply-adds (measured: at
  most 2.6e-7 over 5 steps of every config here).
* gradients, leaf by leaf at every step: ``|g - want| <= 1e-4 * |want| +
  1e-5 * max|want|`` of the leaf: the same f32 reorderings, carried
  through every layer's backward, and for GQA the port sums dk and dv
  over each head group inside B6 where JAX sums after ``repeat_kv``.
* parameters after every step: atol 2e-5.  adamw's update is about
  ``lr * sign(g)`` (lr 3e-4), so a gradient that differs by rounding moves
  a parameter by a small fraction of lr (measured: at most 1.4e-6, MoE).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab import train as jtrain
from tpulab.models import labformer as jlf

from tpulab_torch import train as ttrain
from tpulab_torch.models import labformer as tlf

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
LOSS_RTOL = 2e-6
PARAM_ATOL = 2e-5

#: name -> (config, build_optimizer arguments, accum)
CASES = {
    "dense": (dict(attn_impl="dense"), {}, 1),
    "flash": (dict(attn_impl="flash"), {}, 1),
    "gqa_window_flash": (dict(attn_impl="flash", n_kv_heads=2, attn_window=8), {}, 1),
    "sgd": (dict(attn_impl="dense"), dict(lr=0.05, optimizer="sgd"), 1),
    "cosine_warmup_clip": (dict(attn_impl="flash"),
                           dict(lr=1e-3, warmup_steps=2, schedule="cosine", clip_norm=0.5), 1),
    "accum2": (dict(attn_impl="dense"), {}, 2),
    "moe_top1": (dict(n_experts=4, moe_top_k=1), {}, 1),
    "lora": (dict(lora_rank=4, attn_impl="flash"), {}, 1),
    "remat": (dict(remat=True, attn_impl="flash"), {}, 1),
}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _jax_grads(jcfg, accum):
    """tpulab's gradient of its loss as its train step takes it."""
    if jcfg.lora_rank:
        def grads(params, tokens):
            lora, base = jlf._split_lora(params)
            return jlf._accum_value_and_grad(
                lambda lt, t: jlf.loss_fn(jlf._join_lora(base, lt), t, jcfg), lora, tokens,
                accum)[1]
    else:
        def grads(params, tokens):
            return jlf._accum_value_and_grad(
                lambda p, t: jlf.loss_fn(p, t, jcfg), params, tokens, accum)[1]
    return jax.jit(grads)


def _assert_trees_close(got, want, check):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, path
        check(np.asarray(g, np.float64), w, str(path))


def _grad_check(g, w, path):
    limit = 1e-4 * np.abs(w) + 1e-5 * np.abs(w).max()
    assert np.all(np.abs(g - w) <= limit), path


def _param_check(g, w, path):
    np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL, err_msg=path)


def _run_both(name, steps=5, batch=4, seq=24):
    ckw, okw, accum = CASES[name]
    jcfg, tcfg = jlf.LabformerConfig(**BASE, **ckw), tlf.LabformerConfig(**BASE, **ckw)
    jopt = jtrain.build_optimizer(steps=steps, **okw) if okw else None
    topt = ttrain.build_optimizer(steps=steps, **okw) if okw else None
    params, opt_state, jstep = jlf.init_train_state(jcfg, None, seed=1, optimizer=jopt,
                                                    accum=accum)
    model, tstate, tstep = tlf.init_train_state(tcfg, None, seed=1, optimizer=topt,
                                                accum=accum, device="cpu")
    jgrads = _jax_grads(jcfg, accum)
    batch_at = ttrain.batches(256, batch, seq, 3)
    jbatch_at = jtrain.batches(256, batch, seq, 3)
    losses = []
    for step in range(steps):
        tokens = batch_at(step)
        np.testing.assert_array_equal(tokens, jbatch_at(step))
        want_grads = jgrads(params, jnp.asarray(tokens))
        model, tstate, tloss = tstep(model, tstate, tokens)
        params, opt_state, jloss = jstep(params, opt_state, jnp.asarray(tokens))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
        _assert_trees_close(model.to_numpy(grads=True), want_grads, _grad_check)
        _assert_trees_close(model.to_numpy(), params, _param_check)
        losses.append(float(tloss))
    return model, losses, params


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_tpulab(name):
    model, losses, _ = _run_both(name)
    assert all(np.isfinite(losses))
    if CASES[name][0].get("lora_rank"):
        assert {n for n, _ in model.trainable_leaves()} == {
            "blocks/wq_lora_a", "blocks/wq_lora_b", "blocks/wv_lora_a", "blocks/wv_lora_b"}


def test_lora_leaves_base_weights_bit_unchanged():
    ckw = dict(lora_rank=4, attn_impl="flash")
    cfg = tlf.LabformerConfig(**BASE, **ckw)
    before = tlf.init_params(cfg, seed=1)
    model, _, _ = _run_both("lora", steps=2)
    after = model.to_numpy()
    for name, leaf in after["blocks"].items():
        want = before["blocks"][name].numpy()
        if "_lora_" in name:  # trained (the A leaves by weight decay at first)
            assert not np.array_equal(leaf, want), name
        else:
            np.testing.assert_array_equal(leaf, want, err_msg=name)
    for name in ("embed", "final_norm"):
        np.testing.assert_array_equal(after[name], before[name].numpy())


def test_remat_equals_no_remat():
    """Rematerialization recomputes each block in the backward: the same
    losses, gradients and parameters, bit for bit."""
    runs = []
    for remat in (False, True):
        cfg = tlf.LabformerConfig(**BASE, attn_impl="flash", remat=remat)
        model, state, step = tlf.init_train_state(cfg, None, seed=2, device="cpu")
        batch_at = ttrain.batches(256, 2, 20, 4)
        losses = [float(step(model, state, batch_at(s))[2]) for s in range(3)]
        runs.append((losses, model.to_numpy(grads=True), model.to_numpy()))
    assert runs[0][0] == runs[1][0]
    for a, b in ((runs[0][1], runs[1][1]), (runs[0][2], runs[1][2])):
        for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_optimizer_refusals_and_schedules():
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.build_optimizer(lr=1e-3, steps=5, optimizer="adam")
    with pytest.raises(ValueError):
        ttrain.build_optimizer(lr=1e-3, steps=5, schedule="linear")
    import optax

    from tpulab_torch import optim

    for ours, theirs in (
        (optim.linear_schedule(0.0, 1e-3, 4), optax.linear_schedule(0.0, 1e-3, 4)),
        (optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 7),
         optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 7)),
    ):
        for count in range(10):
            assert np.float32(ours(count)) == np.float32(theirs(jnp.int32(count)))


def test_mesh_options_refuse():
    cfg = tlf.LabformerConfig(**BASE)
    for kw in (dict(zero1=True), dict(zero2=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="A12"):
            tlf.make_train_step(cfg, **kw)


# ------------------------------------------------------------ the loop and the CLI

LOOP = dict(steps=4, batch=2, seq=32, eval_every=2, seed=5)


def _lines(text):
    """The comparable lines: [train] step/[eval]/counters/metrics and the
    JSON."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("[train] step", "[eval]", "[train] counters",
                              "[train] metrics", "{"))]


def _numbers(line):
    """A line's words, and its loss-like numbers as floats."""
    if line.startswith("{"):
        d = json.loads(line)
        return [d["final_step"]], [d["loss"]]
    words = line.replace("(", " ").split()
    if line.startswith("[train] step"):  # [train] step S loss L (T ms)
        return words[:4], [float(words[4])]
    if line.startswith("[eval]"):
        return words[:4], [float(words[4])]
    if line.startswith("[train] metrics"):  # host times: the field names only
        return [w.split("=")[0] for w in words], []
    return words, []


def _assert_same_lines(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        gw, gv = _numbers(g)
        ww, wv = _numbers(w)
        assert gw == ww, (g, w)
        np.testing.assert_allclose(gv, wv, rtol=1e-4, err_msg=g)  # 4 printed decimals


def test_train_cli_matches_tpulab_cli(capsys):
    from tpulab.cli.main import main as jax_cli

    argv = ["--steps", "4", "--batch", "2", "--seq", "32", "--eval-every", "2", "--seed", "5",
            "--clip-norm", "1.0", "--lr", "1e-3"]
    assert jax_cli(["train", *argv]) == 0
    want = _lines(capsys.readouterr().out)
    res = subprocess.run([sys.executable, "-m", "tpulab_torch", "train", "--backend", "cpu",
                          *argv], capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-2000:]
    got = _lines(res.stdout)
    assert len(got) == len(res.stdout.splitlines())  # no other line
    _assert_same_lines(got, want)


def test_train_loop_matches_tpulab_and_overlap_is_equal():
    logs = {}
    for overlap in (0, 1):
        out = []
        step, loss = ttrain.train(**LOOP, overlap=overlap, log=out.append, device="cpu")
        assert step == 4 and np.isfinite(loss)
        logs[overlap] = (out, loss)
    jout = []
    jstep, jloss = jtrain.train(**LOOP, overlap=1, log=jout.append)
    _assert_same_lines(_lines("\n".join(logs[1][0])), _lines("\n".join(jout)))
    np.testing.assert_allclose(logs[1][1], jloss, rtol=LOSS_RTOL)
    # overlap only moves when losses are read: the same values, bit for bit
    assert logs[0][1] == logs[1][1]
    strip = [[ln.split(" (")[0] for ln in logs[o][0]
              if not ln.startswith(("[train] counters", "[train] metrics"))] for o in (0, 1)]
    assert strip[0] == strip[1]
    counters = [[ln for ln in logs[o][0] if ln.startswith("[train] counters")] for o in (0, 1)]
    assert counters[0][-1].endswith("host_syncs=0 steps_per_call=1 overlap=0")
    assert counters[1][-1].endswith("host_syncs=2 steps_per_call=1 overlap=1")


def test_inject_fault_fails_fast():
    out = []
    with pytest.raises(FloatingPointError, match="step 1"):
        ttrain.train(steps=3, batch=2, seq=16, inject_fault=(1,), log=out.append, device="cpu")
    assert "[fault] injected non-finite loss at step 1" in out


UNPORTED = [
    dict(mesh_devices=4), dict(zero1=True), dict(zero2=True),
    dict(moe_impl="dispatch", experts=4),
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: "-".join(kw))
def test_unported_arguments_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        ttrain.train(steps=1, batch=2, seq=8, log=lambda _: None, device="cpu", **kw)


def _validation_case(name, tmp_path):
    """(train arguments, exception, message) of one refusal, with the files
    it needs made under ``tmp_path``."""
    (tmp_path / "empty").mkdir(exist_ok=True)
    bad_tok = tmp_path / "bad_tok.json"
    bad_tok.write_text(json.dumps({"format": "sentencepiece", "vocab": 256, "merges": []}))
    tok = tmp_path / "tok.json"
    from tpulab_torch.io.bpe import train_bpe

    train_bpe(b"abcabcabcabd " * 50, 300).save(str(tok))
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    (data / "a.txt").write_bytes(b"abcabcabcabd " * 50)
    return {
        "recover_without_ckpt_dir": (dict(recover=1), ValueError, "--recover rolls back"),
        "init_from_with_resume": (dict(init_from=str(tmp_path / "empty"), resume=True,
                                       ckpt_dir=str(tmp_path / "ck")),
                                  ValueError, "mutually exclusive"),
        "init_from_empty_dir": (dict(init_from=str(tmp_path / "empty")), FileNotFoundError,
                                "no checkpoint found"),
        "data_dir_without_files": (dict(data_dir=str(tmp_path / "empty")), RuntimeError,
                                   "no files under"),
        "tokenizer_wrong_format": (dict(tokenizer=str(bad_tok), data_dir=str(data)),
                                   ValueError, "not a tpulab-bpe-v1 tokenizer file"),
        "vocab_below_tokenizer": (dict(tokenizer=str(tok), data_dir=str(data), cfg="small"),
                                  ValueError, "silently clamp"),
        "tokenizer_without_data_dir": (dict(tokenizer=str(tok)), ValueError,
                                       "--tokenizer encodes a corpus"),
    }[name]


def _foreign_snapshots(tmp_path):
    """Each package's snapshot given to the other's ``load_params``: the
    formats are not interchangeable, and each side refuses (the port names
    orbax; tpulab finds no item it knows)."""
    from tpulab.models.generate import load_params as jload_params

    from tpulab_torch.models.generate import load_params as tload_params

    jcfg = jlf.LabformerConfig(**BASE)
    jtrain.train(steps=2, batch=2, seq=8, cfg=jcfg, ckpt_dir=str(tmp_path / "j"),
                 save_every=2, log=lambda _: None)
    ttrain.train(steps=2, batch=2, seq=8, cfg=tlf.LabformerConfig(**BASE),
                 ckpt_dir=str(tmp_path / "t"), save_every=2, log=lambda _: None, device="cpu")
    with pytest.raises(ValueError, match="holds an orbax checkpoint"):
        tload_params(tlf.LabformerConfig(**BASE), str(tmp_path / "j"))
    with pytest.raises(KeyError, match="not found in the checkpoint"):
        jload_params(jcfg, str(tmp_path / "t"))


@pytest.mark.parametrize("name", ["recover_without_ckpt_dir", "init_from_with_resume",
                                  "init_from_empty_dir", "data_dir_without_files",
                                  "tokenizer_wrong_format", "vocab_below_tokenizer",
                                  "tokenizer_without_data_dir", "foreign_snapshot"])
def test_ported_arguments_validate_as_tpulab(tmp_path, name):
    """What ``train`` refuses, each refused as ``tpulab``'s trainer refuses
    it: the same exception with the same message; and a snapshot of the
    other package refused by each ``load_params``."""
    if name == "foreign_snapshot":
        return _foreign_snapshots(tmp_path)
    kw, exc, match = _validation_case(name, tmp_path)
    for fn, cfg_mod, extra in ((jtrain.train, jlf, {}), (ttrain.train, tlf, dict(device="cpu"))):
        args = dict(kw)
        if args.get("cfg") == "small":
            args["cfg"] = cfg_mod.LabformerConfig(**BASE)  # vocab 256 < the table's 300
        with pytest.raises(exc, match=match):
            fn(steps=1, batch=2, seq=8, log=lambda _: None, **args, **extra)


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="--backend cpu"):
        ttrain.train(steps=1, batch=2, seq=8, log=lambda _: None)
