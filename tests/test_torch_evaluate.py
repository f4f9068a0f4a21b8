"""``tpulab_torch eval`` against ``tpulab eval`` on checkpoints both
packages wrote from the same numpy weights: byte corpus, BPE corpus, the
synthetic stream and a LoRA checkpoint.

Tolerances, with their reasons: every report key equal but the three
numbers, which differ by summation order only (XLA and PyTorch reduce the
matmuls and the softmax in other orders).  The report rounds them (loss and bits per byte to 4 decimals,
perplexity to 3), so each may differ by one unit of its last printed
decimal and no more.
"""

import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from tpulab import evaluate as jeval
from tpulab.io.bpe import train_bpe as jtrain_bpe
from tpulab.models import labformer as jlf

from tpulab_torch import ckpt
from tpulab_torch import evaluate as teval
from tpulab_torch.models import generate as tgen
from tpulab_torch.models import labformer as tlf

from test_torch_ckpt import write_both

torch.set_num_threads(2)

CFG = jlf.LabformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64)
LAST_DECIMAL = {"loss_nats_per_token": 1e-4, "bits_per_byte": 1e-4, "perplexity": 1e-3}


def _assert_reports_match(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "ckpt_dir":
            continue
        if k in LAST_DECIMAL:
            assert abs(got[k] - w) <= LAST_DECIMAL[k] * 1.0001, (k, got[k], w)
        else:
            assert got[k] == w, k


def _corpus(d, seed=0):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 7)).astype(np.uint8))
             for _ in range(60)]
    d.mkdir()
    for i in range(2):
        idx = rng.integers(0, 60, 700)
        (d / f"p{i}.txt").write_bytes(b" ".join(words[j] for j in idx))
    return d


@pytest.fixture
def both(tmp_path):
    params = jax.device_get(jlf.init_params(CFG, seed=4))
    write_both(params, CFG, tmp_path / "j", tmp_path / "t")
    return tmp_path, params


@pytest.mark.parametrize("data", [False, True], ids=["synthetic", "bytes"])
def test_eval_equals_tpulab(both, data):
    tmp, _ = both
    corpus = str(_corpus(tmp / "data")) if data else None
    kw = dict(batches=3, batch=2, seq=48, seed=1)
    want = jeval.evaluate(str(tmp / "j"), corpus, **kw)
    got = teval.evaluate(str(tmp / "t"), corpus, **kw, device="cpu")
    _assert_reports_match(got, want)
    assert got["step"] == 7 and got["tokens"] == 3 * 2 * 48


def test_eval_bpe_and_lora_equal_tpulab(tmp_path):
    corpus = _corpus(tmp_path / "data", seed=2)
    from tpulab.io.bpe import corpus_from_dir

    tok = jtrain_bpe(corpus_from_dir(str(corpus)), 300)
    jcfg = dataclasses.replace(CFG, vocab=tok.vocab, lora_rank=2, lora_alpha=4.0)
    params = jax.device_get(jlf.init_params(jcfg, seed=5))
    rng = np.random.default_rng(1)
    params["blocks"]["wq_lora_b"] = (rng.standard_normal((2, 2, 32)) * 0.2).astype(np.float32)
    write_both(params, jcfg, tmp_path / "j", tmp_path / "t")
    for d in ("j", "t"):
        tok.save(str(tmp_path / d / "tokenizer.json"))
        sc = json.loads((tmp_path / d / ckpt.SIDECAR).read_text())
        sc["tokenizer"] = "tokenizer.json"
        (tmp_path / d / ckpt.SIDECAR).write_text(json.dumps(sc, indent=2))
    kw = dict(batches=2, batch=2, seq=32, seed=3, limit_bytes=4000)
    want = jeval.evaluate(str(tmp_path / "j"), str(corpus), **kw)
    got = teval.evaluate(str(tmp_path / "t"), str(corpus), **kw, device="cpu")
    _assert_reports_match(got, want)
    assert got["tokenizer_vocab"] == tok.vocab and got["corpus_truncated_at_limit"] is True
    for mod, d, extra in ((jeval, "j", {}), (teval, "t", dict(device="cpu"))):
        with pytest.raises(ValueError, match="BPE checkpoint needs --data-dir"):
            mod.evaluate(str(tmp_path / d), None, **extra)


def test_eval_cli_equals_tpulab(both):
    from tpulab_torch.cli.main import main as cli_main

    tmp, _ = both
    outs = []
    for main, pre, d in ((jeval.main, [], "j"), (cli_main, ["eval", "--backend", "cpu"], "t")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([*pre, "--ckpt-dir", str(tmp / d), "--batches", "2", "--batch", "2",
                         "--seq", "32"]) == 0
        outs.append(json.loads(buf.getvalue()))
    _assert_reports_match(outs[1], outs[0])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        (tmp / "none").mkdir()
        cli_main(["eval", "--backend", "cpu", "--ckpt-dir", str(tmp / "none")])


def test_eval_reads_the_trainers_snapshot_and_stream(tmp_path):
    """A port training run's snapshot evaluates on the trainer's own
    held-out stream to its last logged val_loss (same windows, same
    weights; the report's 4 decimals)."""
    from tpulab_torch import train as ttrain

    cfg = tlf.cfg_from_dict(jlf.cfg_to_dict(CFG))
    out = []
    ttrain.train(steps=4, batch=2, seq=32, eval_every=4, eval_batches=3, cfg=cfg, seed=0,
                 ckpt_dir=str(tmp_path / "ck"), save_every=4, log=out.append, device="cpu")
    val = float([ln for ln in out if ln.startswith("[eval]")][-1].split()[-1])
    rep = teval.evaluate(str(tmp_path / "ck"), batches=3, batch=2, seq=32, seed=0,
                         device="cpu")
    assert rep["step"] == 4 and abs(rep["loss_nats_per_token"] - val) <= 1e-4
    params, step = tgen.load_params(cfg, str(tmp_path / "ck"))
    assert step == 4 and params["blocks"]["wq"].shape == (2, 32, 32)
