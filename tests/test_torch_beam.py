"""tpulab_torch's beam search (``tpulab_torch/models/beam.py``), its
``generate --beams`` and the daemon's ``beams`` request, held against
tpulab's on the CPU.

Both sides run ``trained_small`` (the shared sharp-logit model; the port
takes its weights through ``Labformer.from_numpy``) in float32.  Tokens
must be equal and scores within 1e-5: the two packages' decode logits
differ by f32 reorderings of about 1e-6 (``tests/test_torch_generate.py``),
and a score sums ``steps`` log-probabilities.  Ties are planted exactly
(a zeroed model: every continuation scores the same) and must break to
the lower flat index, as ``jax.lax.top_k`` breaks them.
"""

import contextlib
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulab.daemon as jd
import tpulab.models.generate as jgen
from tpulab.models import labformer as jlf
from tpulab.models.beam import beam_search as jbeam

import tpulab_torch.daemon as td
import tpulab_torch.models.generate as tgen
from tpulab_torch.cli.main import main as cli_main
from tpulab_torch.models import labformer as tlf
from tpulab_torch.models.beam import beam_search, top_k

torch.set_num_threads(2)

SCORE_TOL = 1e-5
PROMPTS = [(np.arange(5) % 7), np.array([6, 2, 5, 1]), (np.arange(9) % 7)]


@pytest.fixture(scope="module")
def both(trained_small, trained_small_cfg):
    tcfg = tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))
    return (trained_small, trained_small_cfg,
            tlf.Labformer.from_numpy(trained_small, tcfg, "cpu"))


def _seq_logprob(model, prompt, cont):
    """Total log P(cont | prompt) under the port's full forward, in float64."""
    full = torch.as_tensor(np.concatenate([prompt, cont])[None, :]).long()
    with torch.no_grad():
        lp = torch.log_softmax(model(full).double(), dim=-1)[0]
    p = len(prompt)
    return float(sum(lp[p - 1 + i, int(cont[i])] for i in range(len(cont))))


@pytest.mark.parametrize("beams", [1, 2, 4])
@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_beam_search_matches_tpulab(both, beams, i):
    params, jcfg, model = both
    prompt = PROMPTS[i].astype(np.int32)
    want, wscore = jbeam(params, prompt, jcfg, steps=10, beams=beams)
    got, score = beam_search(model, prompt, steps=10, beams=beams)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (10,)
    assert abs(score - wscore) <= SCORE_TOL, (score, wscore)


def test_beam1_equals_greedy_and_one_step(both):
    _, _, model = both
    prompt = (np.arange(5) % 7).astype(np.int32)
    seq, _ = beam_search(model, prompt, steps=8, beams=1)
    want = tgen.generate(model, prompt[None, :], steps=8, temperature=0.0)[0]
    np.testing.assert_array_equal(seq, want)
    seq, _ = beam_search(model, prompt, steps=1, beams=3)
    np.testing.assert_array_equal(seq, tgen.generate(model, prompt[None, :], steps=1,
                                                     temperature=0.0)[0])


def test_score_is_the_sequences_logprob_and_beats_greedy(both):
    _, _, model = both
    for prompt in PROMPTS:
        prompt = prompt.astype(np.int32)
        seq, score = beam_search(model, prompt, steps=7, beams=4)
        assert abs(score - _seq_logprob(model, prompt, seq)) < 1e-4
        greedy = tgen.generate(model, prompt[None, :], steps=7, temperature=0.0)[0]
        assert score >= _seq_logprob(model, prompt, greedy) - 1e-4


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([1.0, 3.0, 3.0, -1.0, 3.0, 2.0, 2.0, 0.0], np.float32)
    for k in (1, 2, 3, 5, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        v, i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))


def test_planted_exact_ties_follow_tpulab(trained_small_cfg):
    """A zeroed model scores every continuation the same: each step's
    joint top-k is an exact tie, and the lower flat index must win (beam b
    keeps parent 0 and token b), as in tpulab."""
    jparams = jax.tree_util.tree_map(lambda a: np.zeros_like(np.asarray(a)),
                                     jlf.init_params(trained_small_cfg, seed=0))
    tcfg = tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))
    model = tlf.Labformer.from_numpy(jparams, tcfg, "cpu")
    prompt = np.array([3, 1, 4], np.int32)
    for beams in (2, 4):
        want, wscore = jbeam(jparams, prompt, trained_small_cfg, steps=6, beams=beams)
        got, score = beam_search(model, prompt, steps=6, beams=beams)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.zeros(6, np.int32))
        assert score == pytest.approx(wscore, abs=SCORE_TOL)


def test_validation_messages_equal_tpulab(both, trained_small_cfg):
    params, jcfg, model = both
    for kw in (dict(steps=0), dict(steps=4, beams=0), dict(steps=4, beams=257)):
        with pytest.raises(ValueError) as want:
            jbeam(params, np.zeros(3, np.int32), jcfg, **kw)
        with pytest.raises(ValueError) as got:
            beam_search(model, np.zeros(3, np.int32), **kw)
        assert str(got.value) == str(want.value)
    lcfg = tlf.LabformerConfig(**{k: getattr(model.cfg, k) for k in
                                  ("d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
                               lora_rank=2)
    lora = tlf.Labformer.from_numpy(tlf.init_params(lcfg, seed=0), lcfg, "cpu")
    jl = jlf.LabformerConfig(**{k: getattr(jcfg, k) for k in
                                ("d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
                             lora_rank=2)
    with pytest.raises(ValueError) as want:
        jbeam(jlf.init_params(jl, seed=0), np.zeros(3, np.int32), jl, steps=2)
    with pytest.raises(ValueError) as got:
        beam_search(lora, np.zeros(3, np.int32), steps=2)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ generate --beams


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["--prompt", "hello", "--steps", "8", "--beams", "3"],
                                  ["--prompt", "abc", "--steps", "12", "--beams", "1"]])
def test_cli_generate_beams_equals_tpulab(argv):
    rc, got, err = _run(cli_main, ["generate", "--backend", "cpu", *argv])
    rc_j, want, jerr = _run(jgen.main, argv)
    assert rc == rc_j == 0 and got == want
    line = [ln for ln in err.splitlines() if ln.startswith("[beam]")]
    jline = [ln for ln in jerr.splitlines() if ln.startswith("[beam]")]
    assert len(line) == 1 and line[0].split(",")[0] == jline[0].split(",")[0]
    # printed to 3 decimals: the scores' 1e-5 may move the last digit by one
    assert abs(float(line[0].split()[-1]) - float(jline[0].split()[-1])) <= 1.5e-3


@pytest.mark.parametrize("extra", [["--temperature", "0.5"], ["--speculative"],
                                   ["--prompt-lookup"], ["--stop-byte", "3"],
                                   ["--beams", "300", "--temperature", "0"]])
def test_cli_generate_beams_refusals_equal_tpulab(extra):
    argv = ["--prompt", "hi", "--steps", "4", "--beams", "2", *extra]
    msgs = []
    for main in (lambda a: cli_main(["generate", "--backend", "cpu", *a]), jgen.main):
        with pytest.raises(SystemExit) as e:
            _run(main, argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[0]


# ------------------------------------------------------------------ the daemon's beams


@pytest.fixture
def daemons(trained_small, trained_small_cfg, monkeypatch):
    """Both daemons serving ``trained_small`` on the CPU, fleets reset."""
    tcfg = tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))
    monkeypatch.setattr(jgen, "demo_config", lambda: trained_small_cfg)
    monkeypatch.setattr(jgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(tgen, "demo_config", lambda: tcfg)
    monkeypatch.setattr(tgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(td, "BACKEND", "cpu")
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_SERVE_MAX_SEQ", 128)
        monkeypatch.setattr(mod, "_FLEETS", {})
    monkeypatch.setattr(jd, "_ENGINES", {})
    yield tcfg
    for mod in (jd, td):
        deadline = time.monotonic() + 60
        while any(r.stepper_alive for _, f in list(mod._FLEETS.values())
                  for r in f.replicas) and time.monotonic() < deadline:
            time.sleep(0.02)


PROMPT = bytes((np.arange(20) % 7).astype(np.uint8))


def _gen(config):
    return {"lab": "generate", "config": config}, PROMPT


@pytest.mark.parametrize("beams", [1, 2, 4])
def test_daemon_beams_bytes_equal_tpulab(daemons, both, beams):
    _, _, model = both
    got = td.handle_request(*_gen({"steps": 12, "beams": beams}))
    want = jd.handle_request(*_gen({"steps": 12, "beams": beams}))
    assert got == want and len(got) == 12
    seq, _ = beam_search(model, np.frombuffer(PROMPT, np.uint8).astype(np.int32), steps=12,
                         beams=beams)
    assert got == bytes(int(t) & 0xFF for t in seq)
    if beams == 1:  # exactly greedy: the engine's plain stream
        assert got == td.handle_request(*_gen({"steps": 12}))


@pytest.mark.parametrize("config", [
    {"beams": 2, "temperature": 0.5}, {"beams": 2, "stream": True},
    {"beams": 2, "repetition_penalty": 1.2}, {"beams": 2, "speculative": True},
    {"beams": 2, "prompt_lookup": True}, {"beams": 2, "stop_byte": 3}, {"beams": -1},
    {"beams": 300}, {"beams": 2, "steps": 120}])
def test_daemon_beams_refusals_equal_tpulab(daemons, config):
    errs = []
    for mod in (td, jd):
        with pytest.raises(ValueError) as e:
            mod.handle_request(*_gen({"steps": 8, **config}))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
