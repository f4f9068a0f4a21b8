"""The PagedEngine's scheduler and handoff in tpulab_torch held against
tpulab's on the CPU: priorities, preemption and ``resubmit``, and the
prefill/decode KV handoff (``handoff_at_boundary``, ``export_handoff``,
``import_handoff``).

Both engines get tpulab's ``trained_small`` and the same requests.  Greedy
streams must be bit identical to tpulab's, and so must the counters of
``tests/test_torch_paged_cache.py`` (with the speculative ones where a
request speculates) and the blocks each release returns.  The scenarios
are those of ``tests/test_faults.py``'s preemption cases, a victim caught
mid interleaved prefill, speculating victims, and the handoff as
``tpulab/bench.py``'s ``handoff_overhead`` row drives it, whose stream must
equal unified serving and whose byte count must equal tpulab's.

Sampled streams are the port's own (a counter hash, not ``jax.random``):
a preempted and resumed sampled request must equal the port's own
uninterrupted run of that seed, bit for bit, and resuming at draw 0
instead of at the tokens already emitted (a planted fault) must change it.
"""

import numpy as np
import pytest
import torch

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
            "host_syncs", "h2d_ticks", "blocks_free", "cache_entries", "cache_bytes",
            "preemptions", "spill_spilled", "spill_prefetched", "spill_hits",
            "spill_host_blocks", "spill_host_bytes", "spill_dropped",
            "verify_passes", "spec_rounds", "spec_accepted", "spec_tokens")
#: tests/test_faults.py's engine: 8 usable blocks of 8 cannot hold a
#: 44-position and a 34-position request at once
PRESSED = dict(slots=2, n_blocks=9, block_size=8, max_seq=64)
ROOMY = dict(slots=2, n_blocks=32, block_size=8, max_seq=64)


def _cycle(p):
    return (np.arange(p) % 7).astype(np.int32)


@pytest.fixture(scope="module")
def small(trained_small, trained_small_cfg):
    """(tpulab params, cfg, the port's model, tpulab's int8 draft, the
    port's int8 draft)."""
    cfg = trained_small_cfg
    model = Labformer.from_numpy(trained_small, tlf.cfg_from_dict(jlf.cfg_to_dict(cfg)), "cpu")
    tdraft = Labformer.from_numpy(tquant.quantize_decode_params(model.to_numpy(), model.cfg),
                                  model.cfg, "cpu")
    return trained_small, cfg, model, jquant.quantize_decode_params(trained_small, cfg), tdraft


def _submit(eng, job):
    return eng.submit(job["prompt"], max_new=job["max_new"],
                      temperature=job.get("temperature", 0.0), seed=job.get("seed", 0),
                      priority=job.get("priority", 0), spec=job.get("spec", "off"))


def _drive(eng, plan, releases=None):
    """Run ``plan`` (("submit", job) | ("step", n)) then ``run()``: the
    streams by submission order.  ``releases`` collects, for each block
    release, the request's id, its table extent and the blocks returned."""
    if releases is not None:
        real = eng._release_blocks

        def spy(s, req):
            extent = eng._blocks_needed(req.total_positions())
            row = [int(b) for b in np.asarray(eng.tables)[s, :extent]]
            releases.append((req.req_id, extent, sum(b != 0 for b in row)))
            real(s, req)
        eng._release_blocks = spy
    rids, out = [], {}
    for op, arg in plan:
        if op == "submit":
            rids.append(_submit(eng, arg))
        else:
            for _ in range(arg):
                eng.step()
    out.update(eng.run())
    return [out[r] for r in rids]


def cached_blocks(eng):
    if eng._radix is not None:
        blocks = list(eng._radix.blocks())
        return set(blocks), len(blocks)
    return ({b for bl in eng.prefix_cache.values() for b in bl},
            sum(len(b) for b in eng.prefix_cache.values()))


def no_leak(eng):
    cached, refs = cached_blocks(eng)
    assert len(eng.free) + len(cached) == eng.n_usable_blocks
    assert sorted(set(eng.free)) == sorted(eng.free) and not cached & set(eng.free)
    assert int(eng.block_refs.sum()) == refs
    assert np.all(eng.tables == tpaged.TRASH) and eng.inflight_depth == 0


def _compare(small, plan, draft=False, attn="gather", **kw):
    """``plan`` through tpulab's engine and the port's: greedy streams, the
    counters and every release equal; (the port's streams, stats, releases)."""
    params, cfg, model, jdraft, tdraft = small
    jeng = jpaged.PagedEngine(params, cfg, obs=False, **kw)
    teng = tpaged.PagedEngine(model, model.cfg, attn=attn, **kw)
    if draft:
        jeng.set_draft(jdraft)
        teng.set_draft(tdraft)
    jrel, trel = [], []
    want, got = _drive(jeng, plan, jrel), _drive(teng, plan, trel)
    jobs = [arg for op, arg in plan if op == "submit"]
    for i, (job, a, b) in enumerate(zip(jobs, got, want)):
        if job.get("temperature", 0.0) > 0:
            assert len(a) == len(b), (i, a, b)
        else:
            assert a.dtype == np.int32 and np.array_equal(a, b), (i, a, b)
    jst, tst = jeng.stats(), teng.stats()
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert trel == jrel
    no_leak(teng)
    return got, tst, trel


def _greedy(small, prompt, steps):
    params, cfg = small[:2]
    return np.asarray(jgen.generate(params, prompt[None, :], cfg, steps=steps,
                                    temperature=0.0)[0])


# ------------------------------------------------------------ preemption


@pytest.mark.parametrize("attn,overlap,interleave", [
    ("gather", 1, True), ("pallas", 1, True), ("gather", 0, True), ("pallas", 1, False)])
def test_preempt_resume_greedy_bit_identical(small, attn, overlap, interleave):
    """A priority-5 arrival evicts the priority-0 slot under pool pressure;
    the victim resumes from its committed prefix.  Both streams, the
    counters and the releases (the resumed request's table extent
    included) equal tpulab's; both streams are plain greedy decoding."""
    plan = [("submit", dict(prompt=_cycle(4), max_new=40)), ("step", 6),
            ("submit", dict(prompt=_cycle(4), max_new=30, priority=5))]
    got, st, rel = _compare(small, plan, attn=attn, overlap=overlap, interleave=interleave,
                            **PRESSED)
    assert st["preemptions"] == 1 and st["admissions"] == 3
    # the victim's first release returns its 6 blocks, the resumed one's
    # extent is its prompt plus the budget left: 6 blocks again
    assert rel[0] == (0, 6, 6) and rel[-1][0] == 0 and rel[-1][1] == 6
    assert np.array_equal(got[0], _greedy(small, _cycle(4), 40))
    assert np.array_equal(got[1], _greedy(small, _cycle(4), 30))


def test_equal_priority_never_preempts(small):
    """FIFO arrivals do not evict each other: the head waits for blocks."""
    plan = [("submit", dict(prompt=_cycle(4), max_new=40)), ("step", 6),
            ("submit", dict(prompt=_cycle(4), max_new=30))]
    got, st, _ = _compare(small, plan, **PRESSED)
    assert st["preemptions"] == 0 and [len(x) for x in got] == [40, 30]


def test_lowest_priority_and_latest_admitted_is_the_victim(small):
    """Three slots full (priorities 1, 0, 0) and no block free: a priority-2
    arrival preempts the lowest priority, and of the two the one admitted
    last (request 2), whose release comes first."""
    plan = [("submit", dict(prompt=_cycle(4), max_new=20, priority=1)),
            ("submit", dict(prompt=_cycle(5), max_new=20, priority=0)), ("step", 2),
            ("submit", dict(prompt=_cycle(6), max_new=20, priority=0)), ("step", 3),
            ("submit", dict(prompt=_cycle(3), max_new=24, priority=2))]
    got, st, rel = _compare(small, plan, slots=3, n_blocks=12, block_size=8, max_seq=64)
    assert st["preemptions"] == 1 and rel[0][0] == 2


def test_victim_preempted_mid_interleaved_prefill(small):
    """The victim is still prefilling (chunks owed, half-written blocks, no
    registered prefix) when the head arrives; it resumes from scratch and
    its stream is tpulab's and plain greedy's."""
    params, cfg, model, _, _ = small
    geo = dict(PRESSED, prefill_chunk=8)
    low = dict(prompt=_cycle(40), max_new=8)
    high = dict(prompt=_cycle(4), max_new=30, priority=5)
    phases = []
    for eng in (jpaged.PagedEngine(params, cfg, obs=False, **geo),
                tpaged.PagedEngine(model, model.cfg, **geo)):
        _submit(eng, low)
        eng.step()
        eng.step()
        phases.append(eng.active[0].phase)
    assert phases == ["prefill", "prefill"]
    plan = [("submit", low), ("step", 2), ("submit", high)]
    got, st, _ = _compare(small, plan, **geo)
    assert st["preemptions"] == 1
    assert np.array_equal(got[0], _greedy(small, _cycle(40), 8))
    assert np.array_equal(got[1], _greedy(small, _cycle(4), 30))


@pytest.mark.parametrize("spec", ["lookup", "draft"])
def test_speculating_victim_resumes(small, spec):
    """The victim speculates (its draft cache rebuilt on resume under
    ``"draft"``); streams and the speculative counters equal tpulab's."""
    plan = [("submit", dict(prompt=_cycle(4), max_new=40, spec=spec)), ("step", 4),
            ("submit", dict(prompt=_cycle(5), max_new=30, priority=5, spec=spec))]
    got, st, _ = _compare(small, plan, draft=spec == "draft", spec_k=4, **PRESSED)
    assert st["preemptions"] == 1 and st["spec_rounds"] > 0
    assert np.array_equal(got[0], _greedy(small, _cycle(4), 40))


# ------------------------------------------------------------ sampled resume


def _sampled_plan(neigh_spec: str):
    return [("submit", dict(prompt=_cycle(4), max_new=40, temperature=2.0, seed=7)),
            ("submit", dict(prompt=_cycle(6), max_new=12, priority=1, spec=neigh_spec)),
            ("step", 8),
            ("submit", dict(prompt=_cycle(5), max_new=30, priority=5, spec=neigh_spec))]


@pytest.mark.parametrize("case", ["plain", "lookup_neighbour", "interleaved", "pallas"])
def test_preempted_sampled_stream_is_its_uninterrupted_run(small, case, monkeypatch):
    """A sampled request preempted after 8+ tokens resumes at draw
    ``len(out)``: its stream equals the port's own uninterrupted run of the
    seed, beside speculating neighbours, through an interleaved re-prefill
    and on B7's path; resuming at draw 0 instead changes it."""
    _, _, model, _, _ = small
    kw = dict(slots=3, n_blocks=10, block_size=8, max_seq=64)
    kw.update({"plain": {}, "lookup_neighbour": dict(spec_k=4),
               "interleaved": dict(prefill_chunk=8), "pallas": dict(attn="pallas")}[case])
    neigh = "lookup" if case == "lookup_neighbour" else "off"

    def run(geo, plan):
        eng = tpaged.PagedEngine(model, model.cfg, **geo)
        return _drive(eng, plan)[0], eng

    base, _ = run(dict(kw, n_blocks=48), _sampled_plan(neigh)[:1])
    got, eng = run(kw, _sampled_plan(neigh))
    assert eng.stats()["preemptions"] == 1
    no_leak(eng)
    assert len(got) == 40 and np.array_equal(got, base)
    if case == "lookup_neighbour":
        assert eng.stats()["spec_rounds"] > 0
    real = tpaged.PagedEngine.resubmit

    def at_zero(self, req, fresh_id=False):  # the planted fault
        rid = real(self, req, fresh_id)
        req.resume_draw = 0
        return rid
    monkeypatch.setattr(tpaged.PagedEngine, "resubmit", at_zero)
    faulted, _ = run(kw, _sampled_plan(neigh))
    assert not np.array_equal(faulted, base)


# ------------------------------------------------------------ resubmit


def test_resubmit_id_rules_and_cancelled(small):
    _, _, model, _, _ = small
    eng = tpaged.PagedEngine(model, model.cfg, **ROOMY)
    a = eng.submit(_cycle(4), max_new=6)
    eng.step()
    req = eng.active[0]
    assert eng.resubmit(_detached(req)) == a  # kept id; the counter moves past it
    assert eng.submit(_cycle(3), max_new=2) == a + 1
    assert eng.resubmit(_detached(req), fresh_id=True) == a + 2
    assert eng.submit(_cycle(3), max_new=2) == a + 3
    far = _detached(req)
    far.req_id = 40
    assert eng.resubmit(far) == 40 and eng.submit(_cycle(3), max_new=2) == 41
    gone = _detached(req)
    gone.cancelled = True
    with pytest.raises(ValueError, match="cancelled"):
        eng.resubmit(gone)


def _detached(req):
    import copy

    return copy.deepcopy(req)


def test_resubmit_folds_emitted_tokens_once(small):
    """Emitted tokens fold into the prompt once (a second resubmit adds
    none); the table extent is prompt plus budget left, as tpulab's."""
    _, _, model, _, _ = small
    eng = tpaged.PagedEngine(model, model.cfg, **ROOMY)
    eng.submit(_cycle(4), max_new=20)
    for _ in range(6):
        eng.step()
    req = eng.active[0]
    n = len(req.out)
    assert n >= 4
    import copy

    r = copy.deepcopy(req)
    eng.resubmit(r)
    assert r.n_resumed == n and len(r.prompt) == 4 + n
    assert r.total_positions() == 4 + 20 and r.resubmits == 1
    eng.resubmit(r)
    assert len(r.prompt) == 4 + n and r.resubmits == 2


# ------------------------------------------------------------ handoff


def _handoff(eng_p, eng_d, prompt, steps):
    """tpulab/bench.py's handoff row: prefill to the boundary, export,
    import, resubmit with a fresh id, run; (stream, bytes, payload)."""
    eng_p.handoff_at_boundary = True
    eng_p.submit(prompt, max_new=steps)
    while not eng_p.handoff_ready:
        eng_p.step()
    (req, payload), = eng_p.export_handoff()
    nbytes = eng_d.import_handoff(payload)
    rid = eng_d.resubmit(req, fresh_id=True)
    return eng_d.run()[rid], nbytes, payload


@pytest.mark.parametrize("attn,kv_dtype,prompt_len,chunk,spill_dtype", [
    ("gather", "native", 41, 0, "native"), ("pallas", "native", 41, 0, "native"),
    ("gather", "int8", 41, 0, "native"), ("pallas", "native", 45, 8, "native"),
    ("gather", "native", 41, 0, "int8"), ("gather", "native", 7, 0, "native")])
def test_handoff_equals_unified_and_tpulab(small, attn, kv_dtype, prompt_len, chunk,
                                           spill_dtype):
    """The handed-off stream equals unified serving and tpulab's handoff;
    the byte count and both engines' counters equal tpulab's.  A prompt of
    a block plus one restores every prefill position; 45 tokens leave a
    tail to recompute and park at the end of an interleaved prefill; 7
    tokens export nothing."""
    params, cfg, model, _, _ = small
    prompt = (np.arange(prompt_len) % 7).astype(np.int32)
    geo = dict(slots=2, n_blocks=32, block_size=8, max_seq=64, kv_dtype=kv_dtype,
               prefill_chunk=chunk, prefix_index="radix", spill_blocks=16,
               spill_dtype=spill_dtype)
    runs = {}
    for name, mk in (("tpulab", lambda: jpaged.PagedEngine(params, cfg, obs=False,
                                                            attn=attn, **geo)),
                     ("port", lambda: tpaged.PagedEngine(model, model.cfg, attn=attn, **geo))):
        eng_p, eng_d = mk(), mk()
        toks, nbytes, payload = _handoff(eng_p, eng_d, prompt, 12)
        unified = mk()
        rid = unified.submit(prompt, max_new=12)
        runs[name] = dict(toks=np.asarray(toks), nbytes=nbytes, n=len(payload), payload=payload,
                          unified=np.asarray(unified.run()[rid]),
                          stats=(eng_p.stats(), eng_d.stats()), engines=(eng_p, eng_d))
    port, ref = runs["port"], runs["tpulab"]
    assert port["nbytes"] == ref["nbytes"] and port["n"] == ref["n"] == (prompt_len - 1) // 8
    assert np.array_equal(port["toks"], ref["toks"])
    if spill_dtype == "native":
        assert np.array_equal(port["toks"], port["unified"])
        assert np.array_equal(port["toks"], ref["unified"])
    for tst, jst in zip(port["stats"], ref["stats"]):
        assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    eng_p, eng_d = port["engines"]
    assert eng_p.stats()["ticks"] == 0 and eng_p.kv_fetches == (1 if port["n"] else 0)
    if spill_dtype == "native":  # each restored block holds its exported payload
        blocks, n = eng_d._radix.lookup(prompt[: port["n"] * 8])
        assert n == port["n"]
        for b, (_, kblk, vblk) in zip(blocks, port["payload"]):
            for pool, blk in ((eng_d.kpool, kblk), (eng_d.vpool, vblk)):
                for t, want in (zip(pool, blk) if kv_dtype == "int8" else ((pool, blk),)):
                    assert torch.equal(t[:, b], want)
    if port["n"] and spill_dtype == "native":
        assert eng_d.stats()["spill_prefetched"] == port["n"]
    no_leak(eng_p)
    no_leak(eng_d)


def test_handoff_payload_is_the_pool_and_cancel_exports_nothing(small):
    """Each exported block is the pool block it names, in the pool's
    representation, keyed by the prompt's digest chain; a request
    cancelled while parked exports an empty payload and frees its slot;
    an engine without a spill tier refuses an import."""
    _, _, model, _, _ = small
    geo = dict(slots=2, n_blocks=32, block_size=8, max_seq=64, prefix_index="radix",
               spill_blocks=16)
    eng = tpaged.PagedEngine(model, model.cfg, **geo)
    eng.handoff_at_boundary = True
    a = eng.submit(_cycle(25), max_new=4)
    b = eng.submit(_cycle(20), max_new=4)
    eng.step()
    assert [r.req_id for _, r in eng.handoff_ready] == [a, b]
    assert all(r.phase == "handoff" for r in eng.active)
    row = [int(x) for x in eng.tables[0, :3]]
    eng.cancel(b)
    out = eng.export_handoff()
    assert [len(p) for _, p in out] == [3, 0] and eng.kv_fetches == 1
    digs = tpaged._chain_digests(_cycle(24).tobytes(), 8 * 4)
    for (dig, kblk, vblk), blk in zip(out[0][1], row):
        assert dig == digs[row.index(blk)]
        assert torch.equal(kblk, eng.kpool[:, blk]) and torch.equal(vblk, eng.vpool[:, blk])
    assert all(r is None for r in eng.active) and eng.run() == {}
    no_leak(eng)
    with pytest.raises(tpaged.EngineConfigError, match="spill_blocks"):
        tpaged.PagedEngine(model, model.cfg, **ROOMY).import_handoff([])
    assert tpaged.PagedEngine(model, model.cfg, **ROOMY).export_handoff() == []
