"""tpulab_torch's generation path held against tpulab's on the CPU.

Greedy streams are held token for token.  Sampled streams are not: the
port draws from a ``torch.Generator`` where ``tpulab`` draws from
``jax.random``, so the sampler is held to its distribution (a chi-square
bound below).  Logit tolerances: float32 rtol = atol = 1e-4 (the cached
decode sums in another order than the full forward; XLA and PyTorch order
their matmul sums differently).
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.models import generate as jgen
from tpulab.models import labformer as jlf

from tpulab_torch.cli.main import main as cli_main
from tpulab_torch.models import generate as tgen
from tpulab_torch.models import labformer as tlf
from tpulab_torch.models.labformer import Labformer

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPTS = np.array([[0, 1, 2, 3, 4, 5, 6, 0, 1, 2],
                    [3, 4, 5, 6, 0, 1, 2, 3, 4, 5]], np.int32)


def _port_cfg(jcfg, **kw):
    """The port's config of a tpulab config, through the sidecar JSON."""
    return tlf.cfg_from_dict(jlf.cfg_to_dict(dataclasses.replace(jcfg, **kw)))


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("extra", [{}, dict(repetition_penalty=1.3), dict(stop_token=3)],
                         ids=["plain", "penalty", "stop"])
def test_greedy_tokens_equal_tpulab(trained_small, trained_small_cfg, impl, extra):
    jcfg = dataclasses.replace(trained_small_cfg, attn_impl=impl)
    want = jgen.generate(trained_small, PROMPTS, jcfg, steps=12, temperature=0.0, **extra)
    model = Labformer.from_numpy(trained_small, _port_cfg(jcfg), "cpu")
    got = tgen.generate(model, PROMPTS, steps=12, temperature=0.0, **extra)
    assert got.dtype == np.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)
    if "stop_token" in extra:
        assert (got == 3).any()


@pytest.mark.parametrize("kw", [dict(attn_impl="dense"), dict(attn_impl="flash"),
                                dict(n_kv_heads=2, attn_impl="flash"),
                                dict(attn_window=6, attn_impl="flash"),
                                dict(n_experts=4, moe_top_k=2)],
                         ids=["dense", "flash", "gqa", "window", "moe"])
def test_prefill_and_decode_logits_equal_full_forward(kw):
    cfg = tlf.LabformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64, **kw)
    model = Labformer.from_numpy(tlf.init_params(cfg, seed=2), cfg, "cpu")
    seq = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 20)))
    p = 8
    with torch.inference_mode():
        full = model(seq)
        logits, kc, vc = tgen._prefill(model, seq[:, :p], seq.shape[1])
        assert kc.shape == (2, 2, 20, cfg.kv_heads, 8)
        assert torch.all(kc[:, :, p:] == 0) and torch.all(vc[:, :, p:] == 0)
        np.testing.assert_allclose(logits.numpy(), full[:, p - 1].numpy(), **F32_TOL)
        for pos in range(p, seq.shape[1]):
            logits, kc, vc = tgen._forward_step(model, seq[:, pos], kc, vc, pos)
            np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **F32_TOL)


def test_decode_matches_tpulab_forward_step(trained_small, trained_small_cfg):
    """One prefill and one cached step against tpulab's, int8 weights too."""
    from tpulab.models import quant as jquant
    from tpulab_torch.models import quant as tquant

    cfg = _port_cfg(trained_small_cfg)
    prompt = PROMPTS[:, :8]
    for quantize in (False, True):
        jparams, tparams = trained_small, trained_small
        if quantize:  # each package's own quantizer over the same weights
            jparams = jquant.quantize_decode_params(trained_small, trained_small_cfg)
            tparams = tquant.quantize_decode_params(
                Labformer.from_numpy(trained_small, cfg, "cpu").to_numpy(), cfg)
            for name in ("wq", "w2"):
                np.testing.assert_array_equal(tparams["blocks"][name].q.numpy(),
                                              np.asarray(jparams["blocks"][name].q))
                np.testing.assert_array_equal(tparams["blocks"][name].s.numpy(),
                                              np.asarray(jparams["blocks"][name].s))
        model = Labformer.from_numpy(tparams, cfg, "cpu")
        want, jkc, jvc = jgen._prefill(jparams, jnp.asarray(prompt), trained_small_cfg, 16)
        with torch.inference_mode():
            got, kc, vc = tgen._prefill(model, torch.from_numpy(prompt).long(), 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), **F32_TOL)
        tok = np.array([6, 0], np.int32)
        want, _, _ = jgen._forward_step(jparams, jnp.asarray(tok), jkc, jvc, 8, trained_small_cfg)
        with torch.inference_mode():
            got, _, _ = tgen._forward_step(model, torch.from_numpy(tok).long(), kc, vc, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _logits(seed, shape=(4, 64)):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9), (7, 0.5),
                                         (0, 0.0), (100, 0.95)])
def test_filter_logits_equals_tpulab(top_k, top_p):
    x = _logits(top_k + int(top_p * 10))
    want = np.asarray(jgen._filter_logits(jnp.asarray(x), top_k, top_p))
    got = tgen._filter_logits(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tgen._filter_logits(torch.from_numpy(x), -1, 1.0)


@pytest.mark.parametrize("penalty", [1.3, 0.7])
def test_repetition_penalty_equals_tpulab(penalty):
    x = _logits(9)
    seen = np.random.default_rng(10).random(x.shape) < 0.3
    want = np.asarray(jgen.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(seen), penalty))
    got = tgen.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(seen), penalty)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                                     (1.3, 0, 0.8)])
def test_sampler_fits_filtered_softmax(temperature, top_k, top_p):
    """20000 seeded draws against the filtered softmax.  The bound is the
    chi-square quantile at 1 - 1e-6 (Wilson-Hilferty), so a right sampler
    fails it once in a million seeds."""
    n, vocab = 20000, 12
    row = torch.from_numpy(_logits(5, (1, vocab))[0])
    logits = row.expand(n, vocab).contiguous()
    gen = torch.Generator().manual_seed(0)
    seen = torch.zeros_like(logits, dtype=torch.bool)
    draws = tgen._sample(logits, gen, seen, temperature, top_k, top_p, 1.0)
    probs = torch.softmax(tgen._filter_logits(row[None] / temperature, top_k, top_p), -1)[0]
    counts = np.bincount(draws.numpy(), minlength=vocab)
    live = probs.numpy() > 0
    assert counts[~live].sum() == 0
    expected = n * probs.numpy()[live]
    chi2 = float(((counts[live] - expected) ** 2 / expected).sum())
    dof = int(live.sum()) - 1
    z = 4.753  # standard normal quantile at 1 - 1e-6
    bound = dof * (1 - 2 / (9 * dof) + z * np.sqrt(2 / (9 * dof))) ** 3
    assert chi2 < bound, (chi2, bound, dof)
    assert torch.equal(draws, tgen._sample(logits, torch.Generator().manual_seed(0), seen,
                                           temperature, top_k, top_p, 1.0))


def test_sampled_generate_is_seeded(trained_small, trained_small_cfg):
    model = Labformer.from_numpy(trained_small, _port_cfg(trained_small_cfg), "cpu")
    a = tgen.generate(model, PROMPTS, steps=6, temperature=1.0, seed=1, top_k=20)
    b = tgen.generate(model, PROMPTS, steps=6, temperature=1.0, seed=1, top_k=20)
    assert np.array_equal(a, b) and a.shape == (2, 6) and a.min() >= 0 and a.max() < 256
    with pytest.raises(ValueError, match="merge_lora"):
        cfg = tlf.LabformerConfig(d_model=32, n_heads=4, n_layers=1, d_ff=64, lora_rank=2)
        tgen.generate(Labformer.from_numpy(tlf.init_params(cfg), cfg, "cpu"), PROMPTS, steps=2)


def test_load_sidecar_reads_tpulab_config(tmp_path):
    jcfg = jlf.LabformerConfig(d_model=64, n_heads=4, n_layers=3, d_ff=96, attn_window=16,
                               dtype=jnp.bfloat16)
    assert tgen.load_sidecar(None) == (None, None)
    assert tgen.load_sidecar(str(tmp_path)) == (None, None)
    sidecar = {"config": jlf.cfg_to_dict(jcfg)}
    (tmp_path / "tpulab_config.json").write_text(json.dumps(sidecar))
    cfg, tok = tgen.load_sidecar(str(tmp_path))
    assert cfg == _port_cfg(jcfg) and cfg.dtype == torch.bfloat16 and tok is None
    from tpulab.io.bpe import train_bpe

    train_bpe(b"abcabcabd " * 30, 280).save(str(tmp_path / "t.json"))
    (tmp_path / "tpulab_config.json").write_text(json.dumps({**sidecar, "tokenizer": "t.json"}))
    cfg, tok = tgen.load_sidecar(str(tmp_path))
    want = jgen.load_sidecar(str(tmp_path))[1]
    assert cfg == _port_cfg(jcfg) and tok.vocab == want.vocab and tok.merges == want.merges


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [["--prompt", "hello", "--steps", "8", "--temperature", "0"],
                                  ["--prompt", "abc", "--steps", "12", "--temperature", "0",
                                   "--repetition-penalty", "1.2", "--seed", "3"]])
def test_cli_generate_prints_prompt_and_output(argv):
    rc, got = _run(cli_main, ["generate", "--backend", "cpu", *argv])
    assert rc == 0
    rc_j, want = _run(jgen.main, argv)
    assert rc_j == 0 and got == want
    prompt = argv[1]
    assert got.startswith(prompt) and got.endswith("\n")


def test_python_m_tpulab_torch_generate_prints_prompt_and_output():
    root = pathlib.Path(__file__).resolve().parents[1]
    argv = ["--prompt", "hello", "--steps", "8", "--temperature", "0"]
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-m", "tpulab_torch", "generate", "--backend", "cpu",
                          *argv], capture_output=True, text=True, cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == _run(jgen.main, argv)[1]


def test_cli_generate_stop_byte_and_card_rule():
    """The demo model's greedy bytes equal tpulab's; the stop byte is kept
    and ends the output; without a card and without --backend cpu the CLI
    raises."""
    jcfg, tcfg = jgen.demo_config(), tgen.demo_config()
    prompt = np.frombuffer(b"hi", np.uint8)[None].astype(np.int32)
    want = jgen.generate(jlf.init_params(jcfg, seed=0), prompt, jcfg, steps=40, temperature=0.0)
    got = tgen.generate(Labformer.from_numpy(tlf.init_params(tcfg, seed=0), tcfg, "cpu"),
                        prompt, steps=40, temperature=0.0)
    np.testing.assert_array_equal(got, want)
    stop = int(got[0, -1])  # a byte that first appears mid-stream
    assert 0 < list(got[0]).index(stop) < 39
    argv = ["--prompt", "hi", "--steps", "40", "--temperature", "0", "--stop-byte", str(stop)]
    rc, out = _run(cli_main, ["generate", "--backend", "cpu", *argv])
    assert rc == 0
    _, want_out = _run(jgen.main, argv)
    assert out == want_out
    kept = bytes(int(t) for t in got[0, : list(got[0]).index(stop) + 1])
    assert out == "hi" + kept.decode("utf-8", errors="replace") + "\n"
    with pytest.raises(SystemExit):
        cli_main(["generate", "--backend", "cpu", "--stop-byte", "300"])
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default backend runs")
    with pytest.raises(RuntimeError, match="--backend cpu"):
        cli_main(["generate", "--steps", "2"])
