"""Speculative decoding in tpulab_torch's PagedEngine held against
tpulab's on the CPU (the port-vs-tpulab rerun of ``tests/test_paged_spec.py``).

Both engines get the same weights and requests.  Greedy streams must be
bit identical to tpulab's, and so must the counters (those of
``tests/test_torch_paged_engine.py`` plus ``verify_passes``,
``spec_rounds``, ``spec_accepted`` and ``spec_tokens``).  ``tpulab``
verifies through the gather path and refuses ``spec_k`` beside
``attn="pallas"``; the port allows it (plain ticks through kernel B7, its
plain version here), and its streams are held to tpulab's gather engine.
Sampled streams are the port's own (a counter hash): a sampled slot must
draw the same tokens with and without speculating neighbours.  The verify
window's logits are held to sequential decode steps within rtol = atol =
1e-5, the bound ``tests/test_paged_spec.py`` uses, and to tpulab's within
1e-4, the bound of the port's decode-step test.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.models import generate as jgen
from tpulab.models import labformer as jlf
from tpulab.models import paged as jpaged
from tpulab.models import quant as jquant

from tpulab_torch.models import labformer as tlf
from tpulab_torch.models import paged as tpaged
from tpulab_torch.models import quant as tquant
from tpulab_torch.models.labformer import Labformer

torch.set_num_threads(2)

COUNTERS = ("ticks", "tokens_out", "requests_done", "prefix_hits", "prefix_misses",
            "evictions", "admissions", "prefill_chunks", "stall_ticks", "blocks_retired",
            "host_syncs", "h2d_ticks", "blocks_free", "cache_entries",
            "verify_passes", "spec_rounds", "spec_accepted", "spec_tokens")
REP = np.tile(np.arange(7, dtype=np.int32), 3)  # lookup-friendly period 7
SYS = (np.arange(17) % 7).astype(np.int32)       # 2 full blocks at BS=8


def _cycle(p):
    return (np.arange(p) % 7).astype(np.int32)


def _port_cfg(jcfg):
    return tlf.cfg_from_dict(jlf.cfg_to_dict(jcfg))


@pytest.fixture(scope="module")
def small(trained_small, trained_small_cfg):
    """(tpulab params, cfg, the port's model, tpulab's int8 draft, the
    port's int8 draft), each package quantizing the same weights."""
    cfg = trained_small_cfg
    model = Labformer.from_numpy(trained_small, _port_cfg(cfg), "cpu")
    tdraft = Labformer.from_numpy(tquant.quantize_decode_params(model.to_numpy(), model.cfg),
                                  model.cfg, "cpu")
    return trained_small, cfg, model, jquant.quantize_decode_params(trained_small, cfg), tdraft


def _submit(eng, job, spec):
    return eng.submit(job["prompt"], max_new=job["max_new"],
                      temperature=job.get("temperature", 0.0), seed=job.get("seed", 0),
                      repetition_penalty=job.get("repetition_penalty", 1.0),
                      stop_byte=job.get("stop_byte", -1), spec=job.get("spec", spec))


def _run(eng, jobs, spec="off"):
    rids = [_submit(eng, j, spec) for j in jobs]
    out = eng.run()
    return [out[r] for r in rids], eng.stats()


def _no_leak(eng):
    cached = {b for blocks in eng.prefix_cache.values() for b in blocks}
    assert len(eng.free) + len(cached) == eng.n_usable_blocks
    assert int(eng.block_refs.sum()) == sum(len(b) for b in eng.prefix_cache.values())
    assert np.all(eng.tables == tpaged.TRASH) and eng.inflight_depth == 0


def _compare(small, jobs, spec, attn="gather", draft=False, **kw):
    """Port and tpulab engines over ``jobs``: greedy streams and counters
    equal; the port's outputs and stats."""
    params, cfg, model, jdraft, tdraft = small
    jeng = jpaged.PagedEngine(params, cfg, obs=False, **kw)
    teng = tpaged.PagedEngine(model, model.cfg, attn=attn, **kw)
    if draft:
        jeng.set_draft(jdraft)
        teng.set_draft(tdraft)
    want, jst = _run(jeng, jobs, spec)
    got, tst = _run(teng, jobs, spec)
    for i, (job, a, b) in enumerate(zip(jobs, got, want)):
        if job.get("temperature", 0.0) > 0:
            assert len(a) == len(b), (i, a, b)
        else:
            assert a.dtype == np.int32 and np.array_equal(a, b), (i, a, b)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    _no_leak(teng)
    return got, tst, teng


def test_paged_verify_rows_match_sequential_decode(small):
    """Verify-window logits row j equal a decode step after the window's
    first j tokens (1e-5), and tpulab's verify rows (1e-4)."""
    params, cfg, model, _, _ = small
    toks = np.array([[1, 2, 3, 4], [2, 4, 6, 1]], np.int32)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    n_draft = torch.full((2,), 3)
    kp, vp = tpaged.init_pools(model.cfg, 16, 8, device="cpu")
    with torch.inference_mode():
        vlogits, _, _ = tpaged.paged_verify(model, torch.from_numpy(toks).long(), kp, vp,
                                            tables, lengths, n_draft, model.cfg, 8)
        kp, vp = tpaged.init_pools(model.cfg, 16, 8, device="cpu")
        for j in range(4):
            lg, _, _ = tpaged.paged_decode_step(model, torch.from_numpy(toks[:, j]).long(),
                                                kp, vp, tables, torch.full((2,), j), model.cfg,
                                                8)
            np.testing.assert_allclose(vlogits[:, j].numpy(), lg.numpy(), rtol=1e-5, atol=1e-5)
    jk, jv = jpaged.init_pools(cfg, 16, 8)
    want, _, _ = jpaged.paged_verify(params, jnp.asarray(toks), jk, jv,
                                     jnp.asarray(tables.numpy()), jnp.zeros(2, jnp.int32),
                                     jnp.full(2, 3, jnp.int32), cfg, 8, 4)
    np.testing.assert_allclose(vlogits.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_spec_lookup_lossless_and_fewer_passes(small, attn):
    """On lookup-friendly text: tpulab's stream and counters, and at least
    2x fewer target passes than spec_k=0 with the same stream."""
    _, _, model, _, _ = small
    jobs = [dict(prompt=REP, max_new=24)]
    geo = dict(slots=1, n_blocks=16, block_size=8, max_seq=64)
    (out_s,), st_s, _ = _compare(small, jobs, "lookup", attn, spec_k=4, **geo)
    (out_p,), st_p = _run(tpaged.PagedEngine(model, model.cfg, attn=attn, spec_k=4, **geo),
                          jobs, "off")
    assert np.array_equal(out_s, out_p)
    assert st_s["tokens_out"] == st_p["tokens_out"] == 24 and st_p["ticks"] == 24
    assert 2 * st_s["ticks"] <= st_p["ticks"], st_s
    assert st_s["verify_passes"] == st_s["ticks"] and st_s["spec_rounds"] > 0
    assert st_s["spec_accepted"] / st_s["spec_rounds"] > 1.0
    assert st_s["spec_tokens"] == 24


def _mixed_jobs(ref_stop):
    return [
        dict(prompt=np.concatenate([SYS, [1, 2]]).astype(np.int32), max_new=12),  # miss
        dict(prompt=np.concatenate([SYS, [3]]).astype(np.int32), max_new=10),     # hit
        dict(prompt=REP, max_new=16),                                             # lookup
        dict(prompt=(np.arange(30) % 7).astype(np.int32), max_new=8),             # chunks
        dict(prompt=_cycle(5), max_new=12, temperature=1.5, seed=3),              # sampled
        dict(prompt=_cycle(4), max_new=12, stop_byte=ref_stop),                   # stop
        dict(prompt=_cycle(6), max_new=9, repetition_penalty=4.0),                # penalty
    ]


@pytest.mark.parametrize("spec,attn", [("lookup", "gather"), ("draft", "gather"),
                                       ("lookup", "pallas")])
def test_spec_equals_nonspec_mixed_batch(small, spec, attn):
    """Prefix hits, chunked prefill (the draft's too), a stop byte, a
    penalized and a sampled slot: tpulab's greedy streams and counters,
    and every stream (the sampled one included) equal to spec_k=0's."""
    params, cfg, model, _, tdraft = small
    ref = jgen.generate(params, _cycle(4)[None, :], cfg, steps=12, temperature=0.0)[0]
    jobs = _mixed_jobs(int(ref[3]))
    geo = dict(slots=3, n_blocks=48, block_size=8, max_seq=64, prefill_chunk=8)
    got, st, _ = _compare(small, jobs, spec, attn, draft=spec == "draft", spec_k=4, **geo)
    plain, _ = _run(tpaged.PagedEngine(model, model.cfg, attn=attn, **geo), jobs)
    for i, (a, b) in enumerate(zip(got, plain)):
        assert np.array_equal(a, b), (i, a, b)
    assert st["prefix_hits"] >= 1 and st["spec_rounds"] > 0 and st["spec_accepted"] > 0


def test_spec_draft_mode_lossless_and_accepting(small):
    """The int8 draft beside a plain slot: tpulab's streams, which are
    plain greedy's, and most drafts accepted."""
    params, cfg, _, _, _ = small
    jobs = [dict(prompt=_cycle(5), max_new=16, spec="draft"), dict(prompt=_cycle(9), max_new=8)]
    got, st, _ = _compare(small, jobs, "off", draft=True, slots=2, n_blocks=24, block_size=8,
                          max_seq=64, spec_k=4)
    for job, out in zip(jobs, got):
        want = jgen.generate(params, job["prompt"][None, :], cfg, steps=job["max_new"],
                             temperature=0.0)[0]
        assert np.array_equal(out, want)
    assert st["spec_accepted"] / st["spec_rounds"] > 2.0, st


def test_spec_draft_constructor_and_single_token_prompt(small):
    """The draft through the constructor; a 1-token prompt (no draft
    prefill at all) decodes losslessly."""
    params, cfg, model, jdraft, tdraft = small
    geo = dict(slots=1, n_blocks=16, block_size=8, max_seq=64, spec_k=3)
    teng = tpaged.PagedEngine(model, model.cfg, draft_params=tdraft, **geo)
    jeng = jpaged.PagedEngine(params, cfg, obs=False, draft_params=jdraft, **geo)
    jobs = [dict(prompt=_cycle(1), max_new=8)]
    (got,), tst = _run(teng, jobs, "draft")
    (want,), jst = _run(jeng, jobs, "draft")
    assert np.array_equal(got, want)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    # a parameter tree is placed on the engine's device
    tree = tpaged.PagedEngine(model, model.cfg, draft_params=tquant.quantize_decode_params(
        model.to_numpy(), model.cfg), **geo)
    assert tree.draft.device.type == "cpu" and tree.d_kc.shape[1] == 1


@pytest.fixture(scope="module")
def windowed():
    cfg = jlf.LabformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=128,
                              attn_window=8)
    params, opt, step = jlf.init_train_state(cfg, None, seed=0)
    tok = np.tile(np.arange(33, dtype=np.int32) % 7, (8, 1))
    for _ in range(60):
        params, opt, _ = step(params, opt, tok)
    params = jax.device_get(params)
    return params, cfg, Labformer.from_numpy(params, _port_cfg(cfg), "cpu")


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_spec_with_attention_window(windowed, attn):
    """Sliding window and spec: tpulab's stream and counters, and window
    retirement fires mid-speculation."""
    params, cfg, model = windowed
    geo = dict(slots=1, n_blocks=16, block_size=8, max_seq=64, spec_k=3)
    jeng = jpaged.PagedEngine(params, cfg, obs=False, **geo)
    teng = tpaged.PagedEngine(model, model.cfg, attn=attn, **geo)
    jobs = [dict(prompt=REP, max_new=20)]
    (want,), jst = _run(jeng, jobs, "lookup")
    (got,), tst = _run(teng, jobs, "lookup")
    assert np.array_equal(got, want)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert tst["blocks_retired"] > 0


def test_spec_stop_byte_frees_blocks(small):
    """A stop byte inside a multi-token commit ends the stream right after
    it and recycles every block."""
    params, cfg, _, _, _ = small
    ref = jgen.generate(params, _cycle(4)[None, :], cfg, steps=12, temperature=0.0)[0].tolist()
    stop = ref[3]
    jobs = [dict(prompt=_cycle(4), max_new=12, stop_byte=int(stop))]
    (got,), _, eng = _compare(small, jobs, "lookup", slots=1, n_blocks=16, block_size=8,
                              max_seq=64, spec_k=4)
    assert got.tolist() == ref[:ref.index(stop) + 1]
    assert len(eng.free) == eng.n_usable_blocks - sum(len(b) for b in eng.prefix_cache.values())


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_spec_int8_kv_pool(small, attn):
    """Speculation over int8 KV pools: tpulab's stream and counters, and
    spec_k=0's stream."""
    _, _, model, _, _ = small
    geo = dict(slots=1, n_blocks=16, block_size=8, max_seq=64, kv_dtype="int8")
    jobs = [dict(prompt=REP, max_new=12)]
    (got,), _, _ = _compare(small, jobs, "lookup", attn, spec_k=4, **geo)
    (plain,), _ = _run(tpaged.PagedEngine(model, model.cfg, attn=attn, **geo), jobs)
    assert np.array_equal(got, plain)


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_spec_validation(small):
    """The port refuses what tpulab refuses, with its messages; tpulab's
    refusal of spec_k beside attn="pallas" is the one the port lifts."""
    _, cfg, model, _, _ = small
    params = jlf.init_params(cfg, seed=0)
    geo = dict(slots=1, n_blocks=8, block_size=8, max_seq=32)
    tpl = model.cfg

    def both(build, act=None):
        j = _refusal(lambda: act(build(jpaged.PagedEngine, params, cfg, obs=False))
                     if act else build(jpaged.PagedEngine, params, cfg, obs=False))
        t = _refusal(lambda: act(build(tpaged.PagedEngine, model, tpl))
                     if act else build(tpaged.PagedEngine, model, tpl))
        assert t == j
        return t

    assert "spec_k must be >= 0" in both(lambda E, p, c, **o: E(p, c, spec_k=-1, **o))
    assert "spec_ngram" in both(lambda E, p, c, **o: E(p, c, spec_ngram=0, **o))
    plain = lambda E, p, c, **o: E(p, c, **geo, **o)  # noqa: E731
    spec2 = lambda E, p, c, **o: E(p, c, spec_k=2, **geo, **o)  # noqa: E731
    assert "spec_k > 0" in both(plain, lambda e: e.submit(_cycle(3), max_new=2, spec="lookup"))
    assert "set_draft" in both(spec2, lambda e: e.submit(_cycle(3), max_new=2, spec="draft"))
    assert "spec_k must be in" in both(spec2, lambda e: e.submit(_cycle(3), max_new=2,
                                                                 spec="lookup", spec_k=9))
    assert "expected 'off'" in both(spec2, lambda e: e.submit(_cycle(3), max_new=2,
                                                              spec="ngram"))
    assert "spec_ngram must be >= 0" in both(spec2, lambda e: e.submit(
        _cycle(3), max_new=2, spec="lookup", spec_ngram=-1))
    assert "spec_k=0" in both(plain, lambda e: e.set_draft(params if isinstance(
        e, jpaged.PagedEngine) else model))
    small_cfg = jlf.LabformerConfig(vocab=128, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    tsmall = tlf.LabformerConfig(vocab=128, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    assert "vocabulary" in both(spec2, lambda e: e.set_draft(
        *((jlf.init_params(small_cfg), small_cfg) if isinstance(e, jpaged.PagedEngine)
          else (Labformer.from_numpy(tlf.init_params(tsmall), tsmall, "cpu"),))))
    with pytest.raises(ValueError, match="gather"):
        jpaged.PagedEngine(params, cfg, spec_k=2, attn="pallas")
    eng = tpaged.PagedEngine(model, tpl, spec_k=2, attn="pallas", **geo)
    assert eng.spec_k == 2 and eng.attn == "pallas"


def test_concurrent_spec_clients_interleave(small):
    """Two speculating requests on one engine share the batch (both active
    at once) and each stream equals its solo run and tpulab's solo run.
    tpulab's counterpart drives its daemon's service from two threads; here
    the interleaving is the engine's own, so the test is deterministic."""
    params, cfg, model, _, _ = small
    prompts = [REP, (np.arange(12) % 5).astype(np.int32)]
    geo = dict(slots=2, n_blocks=32, block_size=8, max_seq=64, spec_k=4)
    solo = []
    for pr in prompts:
        j = jpaged.PagedEngine(params, cfg, obs=False, **geo)
        rid = j.submit(pr, max_new=20, spec="lookup")
        solo.append(j.run()[rid])
        (t,), _ = _run(tpaged.PagedEngine(model, model.cfg, **geo),
                       [dict(prompt=pr, max_new=20)], "lookup")
        assert np.array_equal(t, solo[-1])
    eng = tpaged.PagedEngine(model, model.cfg, **geo)
    rids = [eng.submit(pr, max_new=20, spec="lookup") for pr in prompts]
    peak, out = 0, {}
    while eng.pending or eng.inflight_depth or any(r is not None for r in eng.active):
        eng.step()
        peak = max(peak, sum(r is not None for r in eng.active))
    out = eng.run()
    for rid, want in zip(rids, solo):
        assert np.array_equal(out[rid], want)
    assert peak == 2 and eng.stats()["spec_rounds"] > 0


@pytest.mark.parametrize("attn", ["gather", "pallas"])
@pytest.mark.parametrize("spec", ["lookup", "draft"])
def test_sampled_slot_ignores_speculating_neighbours(small, spec, attn):
    """A sampled slot's draws advance once a tick, plain or verify: its
    stream is the same beside speculating neighbours as beside plain ones,
    and seeded (another seed gives another stream)."""
    _, _, model, _, tdraft = small
    geo = dict(slots=3, n_blocks=48, block_size=8, max_seq=64, spec_k=4, prefill_chunk=8)

    def run(neigh_spec, seed=11):
        eng = tpaged.PagedEngine(model, model.cfg, attn=attn, draft_params=tdraft, **geo)
        jobs = [dict(prompt=_cycle(6), max_new=20, temperature=1.2, seed=seed),
                dict(prompt=REP, max_new=18, spec=neigh_spec),
                dict(prompt=(np.arange(20) % 7).astype(np.int32), max_new=14, spec=neigh_spec)]
        out, st = _run(eng, jobs)
        _no_leak(eng)
        return out, st

    (s_spec, *g_spec), st = run(spec)
    (s_plain, *g_plain), st_plain = run("off")
    assert np.array_equal(s_spec, s_plain)
    for a, b in zip(g_spec, g_plain):
        assert np.array_equal(a, b)
    assert st["spec_rounds"] > 0 and st["verify_passes"] > 0
    assert st_plain["spec_rounds"] == st_plain["verify_passes"] == 0
    (s_other, *_), _ = run(spec, seed=12)
    assert not np.array_equal(s_other, s_spec)


def test_one_fetch_per_speculative_tick(small):
    """Every verify tick waits for the device once."""
    _, _, model, _, tdraft = small
    eng = tpaged.PagedEngine(model, model.cfg, slots=3, n_blocks=48, block_size=8, max_seq=64,
                             spec_k=4, draft_params=tdraft)
    jobs = [dict(prompt=REP, max_new=16, spec="lookup"),
            dict(prompt=_cycle(6), max_new=12, spec="draft", repetition_penalty=2.0),
            dict(prompt=_cycle(5), max_new=10, temperature=1.0)]
    _run(eng, jobs)
    assert eng.stats()["verify_passes"] > 0
    assert eng.spec_fetches == eng.stats()["verify_passes"]
