"""tpulab_torch's speculative decoding held against tpulab's on the CPU
(the port-vs-tpulab rerun of ``tests/test_speculative.py``).

Greedy streams are held token for token, and ``mean_accepted`` exactly:
acceptance depends on the tokens alone.  The windowed forward is held to
sequential single-token steps within float32 rtol = atol = 1e-5, the
bound ``tests/test_speculative.py`` holds ``tpulab``'s to (the window's
matmuls sum in another order than the single steps'); stale cache past
the window must change no bit.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tpulab.models import generate as jgen
from tpulab.models import labformer as jlf
from tpulab.models import quant as jquant
from tpulab.models import speculative as jspec

from tpulab_torch.cli.main import main as cli_main
from tpulab_torch.models import generate as tgen
from tpulab_torch.models import labformer as tlf
from tpulab_torch.models import quant as tquant
from tpulab_torch.models import speculative as tspec
from tpulab_torch.models.labformer import Labformer

torch.set_num_threads(2)

WINDOW_TOL = dict(rtol=1e-5, atol=1e-5)
CYCLE5 = np.tile(np.arange(5, dtype=np.int32) % 7, (2, 1))
REP = np.tile(np.arange(7, dtype=np.int32), 3)[None, :]


def _port_cfg(jcfg):
    return tlf.cfg_from_dict(jlf.cfg_to_dict(jcfg))


def _model(params, jcfg):
    return Labformer.from_numpy(params, _port_cfg(jcfg), "cpu")


def _int8(params, jcfg):
    """Each package's own quantizer over the same weights."""
    cfg = _port_cfg(jcfg)
    tree = Labformer.from_numpy(params, cfg, "cpu").to_numpy()
    return (jquant.quantize_decode_params(params, jcfg),
            Labformer.from_numpy(tquant.quantize_decode_params(tree, cfg), cfg, "cpu"))


def _prompt(seed, b=2, p=5):
    return np.random.default_rng(seed).integers(0, 256, (b, p)).astype(np.int32)


@pytest.fixture(scope="module")
def cfg(trained_small_cfg):
    return trained_small_cfg


def test_window_matches_sequential_steps(cfg):
    """One (b, w) window pass equals w single-token steps, per-row
    positions too (the engine's draft caches), and equals tpulab's."""
    params = jlf.init_params(cfg, seed=0)
    model = _model(params, cfg)
    toks = _prompt(1, 2, 4)
    jkc, jvc = jgen.init_kv_cache(cfg, 2, 32)
    want, _, _ = jgen._forward_window(params, toks, jkc, jvc, 0, cfg)
    with torch.inference_mode():
        kc, vc = tgen.init_kv_cache(model.cfg, 2, 32, torch.device("cpu"))
        win, _, _ = tgen._forward_window(model, torch.from_numpy(toks).long(), kc, vc, 0)
        np.testing.assert_allclose(win.numpy(), np.asarray(want), **WINDOW_TOL)
        kc2, vc2 = tgen.init_kv_cache(model.cfg, 2, 32, torch.device("cpu"))
        kc3, vc3 = tgen.init_kv_cache(model.cfg, 2, 32, torch.device("cpu"))
        for i in range(4):
            tok = torch.from_numpy(toks[:, i]).long()
            step, _, _ = tgen._forward_step(model, tok, kc2, vc2, i)
            np.testing.assert_allclose(win[:, i].numpy(), step.numpy(), **WINDOW_TOL)
            per_row, _, _ = tgen._forward_step(model, tok, kc3, vc3, torch.tensor([i, i]))
            np.testing.assert_array_equal(per_row.numpy(), step.numpy())
        np.testing.assert_array_equal(kc3.numpy(), kc2.numpy())


def test_per_row_positions_equal_one_row_at_a_time(cfg):
    """Rows at different positions: each row's logits and cache writes
    equal that row decoded alone at its own scalar position."""
    model = _model(jlf.init_params(cfg, seed=0), cfg)
    rng = np.random.default_rng(2)
    with torch.inference_mode():
        kc, vc = tgen.init_kv_cache(model.cfg, 2, 32, torch.device("cpu"))
        kc.copy_(torch.from_numpy(rng.standard_normal(kc.shape).astype(np.float32)))
        vc.copy_(torch.from_numpy(rng.standard_normal(vc.shape).astype(np.float32)))
        ref_k, ref_v = kc.clone(), vc.clone()
        toks = torch.from_numpy(_prompt(3, 2, 3)).long()
        pos = torch.tensor([4, 9])
        got, _, _ = tgen._forward_window(model, toks, kc, vc, pos)
        for r in range(2):
            kr, vr = ref_k[:, r:r + 1].clone(), ref_v[:, r:r + 1].clone()
            want, _, _ = tgen._forward_window(model, toks[r:r + 1], kr, vr, int(pos[r]))
            np.testing.assert_allclose(got[r].numpy(), want[0].numpy(), **WINDOW_TOL)
            np.testing.assert_array_equal(kc[:, r].numpy(), kr[:, 0].numpy())


def test_stale_cache_is_masked(cfg):
    """K/V garbage past the window changes no bit: the no-rollback rule."""
    model = _model(jlf.init_params(cfg, seed=0), cfg)
    toks = torch.from_numpy(_prompt(4, 1, 3)).long()
    with torch.inference_mode():
        kc, vc = tgen.init_kv_cache(model.cfg, 1, 32, torch.device("cpu"))
        clean, _, _ = tgen._forward_window(model, toks, kc.clone(), vc.clone(), 0)
        kc[:, :, 10:] = 99.0
        vc[:, :, 10:] = -7.0
        dirty, _, _ = tgen._forward_window(model, toks, kc, vc, 0)
        dirty_rows, _, _ = tgen._forward_window(model, toks, kc, vc, torch.tensor([0]))
    np.testing.assert_array_equal(clean.numpy(), dirty.numpy())
    np.testing.assert_array_equal(clean.numpy(), dirty_rows.numpy())


def test_int8_generate_equals_tpulab(trained_small, cfg):
    """The int8 tree (tpulab's labformer_decode_int8 and the draft of the
    speculative paths): greedy tokens equal generate_jit's on its tree."""
    jdraft, tdraft = _int8(trained_small, cfg)
    import jax

    want = jgen.generate_jit(jdraft, CYCLE5, jax.random.PRNGKey(0), cfg, 16, 0.0)
    got = tgen.generate(tdraft, CYCLE5, steps=16, temperature=0.0)
    np.testing.assert_array_equal(got, np.asarray(want))


def _both(draft, tdraft, dcfg, target, tcfg, prompt, steps, k):
    want, want_acc = jspec.speculative_generate(draft, dcfg, target, tcfg, prompt,
                                                steps=steps, k=k)
    got, acc = tspec.speculative_generate(tdraft, _model(target, tcfg), prompt,
                                          steps=steps, k=k)
    return want, want_acc, got, acc


@pytest.mark.parametrize("kind", ["perfect", "adversarial", "int8", "smaller"])
def test_speculative_equals_tpulab(trained_small, cfg, kind):
    """Each draft gives the target's greedy stream, bit-equal to tpulab's,
    with equal mean_accepted."""
    target, prompt, steps, k = trained_small, CYCLE5, 12, 4
    dcfg = cfg
    if kind == "perfect":
        draft, tdraft = target, _model(target, cfg)
    elif kind == "adversarial":
        target, prompt = jlf.init_params(cfg, seed=0), _prompt(5)
        draft = jlf.init_params(cfg, seed=99)
        tdraft = _model(draft, cfg)
    elif kind == "int8":
        prompt, steps = CYCLE5[:1], 16
        draft, tdraft = _int8(target, cfg)
    else:
        target, prompt, steps, k = jlf.init_params(cfg, seed=0), _prompt(6), 10, 3
        dcfg = jlf.LabformerConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq=128)
        draft = jlf.init_params(dcfg, seed=0)
        tdraft = _model(draft, dcfg)
    want, want_acc, got, acc = _both(draft, tdraft, dcfg, target, cfg, prompt, steps, k)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (prompt.shape[0], steps)
    assert acc == want_acc
    plain = tgen.generate(_model(target, cfg), prompt, steps=steps, temperature=0.0)
    np.testing.assert_array_equal(got, plain)
    if kind == "perfect":
        assert acc == 4.0
    if kind == "int8":
        assert acc > 2.0, acc


def test_vocab_mismatch_rejected(cfg):
    a = tlf.LabformerConfig(vocab=128, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    target = _model(jlf.init_params(cfg), cfg)
    with pytest.raises(ValueError, match="vocab"):
        tspec.speculative_generate(Labformer.from_numpy(tlf.init_params(a), a, "cpu"),
                                   target, np.zeros((1, 3), np.int32), steps=4)


@pytest.mark.parametrize("prompt,steps,k,ngram", [
    (REP, 24, 4, 3),
    (np.random.default_rng(3).integers(0, 7, (1, 11)).astype(np.int32), 12, 3, 4),
    (np.concatenate([REP, REP[:, ::-1]]), 16, 4, 2),
], ids=["repeating", "nonrepetitive", "batch2"])
def test_prompt_lookup_equals_tpulab(trained_small, cfg, prompt, steps, k, ngram):
    """Prompt lookup is lossless: plain greedy's stream, bit-equal to
    tpulab's, with equal mean_accepted."""
    want, want_acc = jspec.prompt_lookup_generate(trained_small, cfg, prompt, steps=steps,
                                                  k=k, ngram=ngram)
    model = _model(trained_small, cfg)
    got, acc = tspec.prompt_lookup_generate(model, prompt, steps=steps, k=k, ngram=ngram)
    np.testing.assert_array_equal(got, want)
    assert acc == want_acc
    np.testing.assert_array_equal(got, tgen.generate(model, prompt, steps=steps,
                                                     temperature=0.0))
    if prompt is REP:
        assert acc > 1.0, acc
    with pytest.raises(ValueError, match="ngram"):
        tspec.prompt_lookup_generate(model, prompt, ngram=0)


def test_lookup_propose_equals_tpulab():
    """On seeded histories of small alphabets (so matches occur), every
    (k, ngram) proposal equals tpulab's."""
    rng = np.random.default_rng(0)
    assert tspec._lookup_propose(np.array([1, 2, 3, 9, 9, 1, 2, 3], np.int32), 3,
                                 3).tolist() == [9, 9, 1]
    assert tspec._lookup_propose(np.array([1, 2, 3, 4], np.int32), 2, 3).tolist() == [4, 4]
    for _ in range(200):
        hist = rng.integers(0, int(rng.integers(2, 6)), int(rng.integers(1, 40))).astype(np.int32)
        k, ngram = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        got = tspec._lookup_propose(hist, k, ngram)
        want = jspec._lookup_propose(hist, k, ngram)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--prompt", "abcabcabcabc", "--steps", "16", "--temperature", "0", "--prompt-lookup"],
    ["--prompt", "hello", "--steps", "10", "--speculative", "--draft-k", "3"],
], ids=["prompt-lookup", "speculative"])
def test_cli_speculative_equals_tpulab(argv):
    """The CLI's text equals tpulab's and plain greedy's; the stderr line
    names the strategy and its acceptance."""
    rc, out, err = _run(cli_main, ["generate", "--backend", "cpu", *argv])
    assert rc == 0
    rc_j, want, want_err = _run(jgen.main, argv)
    assert rc_j == 0 and out == want
    assert err == want_err and err.startswith("[prompt-lookup]" if "--prompt-lookup" in argv
                                              else "[speculative]")
    plain = [a for a in argv if a not in ("--prompt-lookup", "--speculative")]
    plain = plain[:plain.index("--draft-k")] if "--draft-k" in plain else plain
    _, plain_out, _ = _run(cli_main, ["generate", "--backend", "cpu", *plain,
                                      "--temperature", "0"])
    assert out == plain_out


@pytest.mark.parametrize("argv", [
    ["--speculative", "--temperature", "0.5"],
    ["--speculative", "--top-k", "3"],
    ["--speculative", "--stop-byte", "7"],
    ["--prompt-lookup", "--repetition-penalty", "1.2"],
    ["--prompt-lookup", "--speculative"],
    ["--speculative", "--draft-k", "0"],
    ["--prompt-lookup", "--lookup-ngram", "0"],
])
def test_cli_refusals_equal_tpulab(argv):
    """Each sampling flag beside a deterministic strategy is refused with
    tpulab's message."""
    with pytest.raises(SystemExit) as got:
        cli_main(["generate", "--backend", "cpu", "--steps", "2", *argv])
    with pytest.raises(SystemExit) as want:
        jgen.main(["--steps", "2", *argv])
    assert str(got.value) == str(want.value) and str(got.value)
