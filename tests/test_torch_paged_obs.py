"""The PagedEngine's serving hooks held against tpulab's on the CPU.

With ``obs=True`` on both sides, greedy streams and the engine counters
stay bit-equal to ``tpulab.models.paged.PagedEngine``'s, and each
latency histogram (queue wait, prefill, TTFT, ITL, e2e) gains the same
number of observations; the slow-log entries carry tpulab's keys and the
same non-timing fields (rid order aside: each package allocates its own
rids), the journeys the same marks, and ``publish_metrics`` writes the
same gauge names.  ``obs=False`` records nothing.  The fault sites
``paged.step``, ``paged.tick`` and ``paged.drain`` raise at the same hit,
and the ``corrupt_table`` and ``nan_tokens`` tripwires raise the same
errors, as tpulab's.  The steady-state recompile tripwire counts a build
inside a steady step and raises under ``strict()``.
"""

import numpy as np
import pytest
import torch

from tpulab import faults as jfaults
from tpulab import obs as jobs
from tpulab.models import labformer as jlf
from tpulab.models import paged as jpaged

from tpulab_torch import faults as tfaults
from tpulab_torch import obs as tobs
from tpulab_torch.models import labformer as tlf
from tpulab_torch.models import paged as tpaged
from tpulab_torch.models.labformer import Labformer
from tpulab_torch.obs import compilestats as tcs

torch.set_num_threads(2)

HISTS = ("queue_wait_seconds", "prefill_seconds", "ttft_seconds", "itl_seconds",
         "e2e_seconds")
COUNTERS = ("ticks", "tokens_out", "requests_done", "prefix_hits", "prefix_misses",
            "admissions", "prefill_chunks", "stall_ticks", "host_syncs", "h2d_ticks",
            "preemptions", "recompiles", "blocks_free", "cache_entries")
G = dict(slots=3, n_blocks=48, block_size=8, max_seq=64)
#: the slow-log fields that do not depend on a clock (the worst gap's token
#: index does)
UNTIMED = ("tag", "prompt_len", "tokens", "prefill_chunks",
           "preemptions", "resubmits", "replica_first_token", "replica_hops", "migrations",
           "pool", "handoff_ms", "handoff_bytes", "priority", "cancelled")


@pytest.fixture(autouse=True)
def _injectors_off():
    yield
    jfaults.disable()
    tfaults.disable()


@pytest.fixture(scope="module")
def small(trained_small, trained_small_cfg):
    cfg = tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))
    return trained_small, trained_small_cfg, Labformer.from_numpy(trained_small, cfg, "cpu")


def _cycle(p, off=0):
    return ((np.arange(p) + off) % 7).astype(np.int32)


JOBS = [dict(prompt=_cycle(20), max_new=9, tag="a"),
        dict(prompt=_cycle(21), max_new=6, tag="b"),       # prefix hit
        dict(prompt=_cycle(5, 3), max_new=10, stop_byte=4, tag="c"),
        dict(prompt=_cycle(30, 1), max_new=7, tag="d"),
        dict(prompt=_cycle(3, 2), max_new=5, priority=2, tag="e")]


def _counts(reg):
    return {h: reg.get(h).snapshot()["count"] if reg.get(h) else 0 for h in HISTS}


def _run(eng, jobs, rid0):
    ids = [eng.submit(j["prompt"], max_new=j["max_new"], stop_byte=j.get("stop_byte", -1),
                      priority=j.get("priority", 0), rid=rid0 + i, tag=j["tag"])
           for i, j in enumerate(jobs)]
    out = eng.run()
    return [out[i] for i in ids], eng.stats()


@pytest.mark.parametrize("attn,chunk", [("gather", 8), ("pallas", 0)])
def test_obs_on_streams_counters_and_records_equal(small, attn, chunk):
    params, jcfg, model = small
    jeng = jpaged.PagedEngine(params, jcfg, attn=attn, prefill_chunk=chunk, obs=True, **G)
    teng = tpaged.PagedEngine(model, model.cfg, attn=attn, prefill_chunk=chunk, **G)
    assert teng.obs
    j0, t0 = _counts(jobs.REGISTRY), _counts(tobs.REGISTRY)
    jobs.SLOWLOG.clear()
    tobs.SLOWLOG.clear()
    want, jst = _run(jeng, JOBS, 10_000)
    got, tst = _run(teng, JOBS, 20_000)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    jd = {h: c - j0[h] for h, c in _counts(jobs.REGISTRY).items()}
    td = {h: c - t0[h] for h, c in _counts(tobs.REGISTRY).items()}
    assert td == jd and td["e2e_seconds"] == len(JOBS)
    assert td["itl_seconds"] == tst["tokens_out"] - len(JOBS)
    jw = {e["tag"]: e for e in jobs.SLOWLOG.worst()}
    tw = {e["tag"]: e for e in tobs.SLOWLOG.worst()}
    assert set(tw) == set(jw) == {j["tag"] for j in JOBS}
    for tag in tw:
        assert set(tw[tag]) == set(jw[tag])
        assert {k: tw[tag][k] for k in UNTIMED} == {k: jw[tag][k] for k in UNTIMED}, tag
        assert tw[tag]["rid"] - 20_000 == jw[tag]["rid"] - 10_000
    # journeys: the same marks in the same order
    for i in range(len(JOBS)):
        tj, jj = tobs.JOURNEY.snapshot(20_000 + i), jobs.JOURNEY.snapshot(10_000 + i)
        assert tj["completed"] and jj["completed"] and tj["tag"] == jj["tag"]
        assert [p["phase"] for p in tj["phases"]] == [p["phase"] for p in jj["phases"]]
    # publish_metrics: the same gauge names
    jeng.publish_metrics()
    assert teng.publish_metrics() == tst
    names = {f"engine_{k}" for k in jst} | {"engine_hbm_bytes_in_use",
                                             "engine_hbm_bytes_limit", "engine_mfu",
                                             "train_mfu"}
    names |= {f"engine_{k}_shard0" for k in jeng.shard_stats()[0]}
    assert names <= set(jobs.REGISTRY.names()) and names <= set(tobs.REGISTRY.names())
    for k, v in tst.items():
        assert tobs.REGISTRY.get(f"engine_{k}").value == v


def test_obs_off_records_nothing(small):
    _, _, model = small
    eng = tpaged.PagedEngine(model, model.cfg, obs=False, **G)
    before = _counts(tobs.REGISTRY)
    tobs.SLOWLOG.clear()
    rec0 = tobs.TRACER.chrome_trace()["otherData"]["recorded"]
    j0 = tobs.JOURNEY.stats()
    outs, st = _run(eng, JOBS[:3], 30_000)
    assert st["requests_done"] == 3
    assert _counts(tobs.REGISTRY) == before
    assert tobs.SLOWLOG.snapshot()["recorded"] == 0
    assert tobs.TRACER.chrome_trace()["otherData"]["recorded"] == rec0
    assert tobs.JOURNEY.stats() == j0


def _fault_outcome(faults, make, schedule):
    """(exception type name, steps taken, fired) of an engine run under
    ``schedule``."""
    eng = make()
    for j in JOBS[:3]:
        eng.submit(j["prompt"], max_new=j["max_new"])
    steps = 0
    with faults.active(schedule) as inj:
        try:
            for _ in range(200):
                steps += 1
                eng.step()
            err = None
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            err = type(e).__name__
        fired = inj.fired()
    return err, steps, fired


@pytest.mark.parametrize("schedule", [
    [{"site": "paged.step", "kind": "raise", "at": 3}],
    [{"site": "paged.tick", "kind": "raise", "at": 2}],
    [{"site": "paged.drain", "kind": "raise", "at": 4}],
    [{"site": "paged.step@replica1", "kind": "raise", "at": 2}],
    [{"site": "paged.step", "kind": "corrupt_table", "at": 3}],
    [{"site": "paged.drain", "kind": "nan_tokens", "at": 2}],
], ids=["step", "tick", "drain", "scoped", "corrupt_table", "nan_tokens"])
def test_fault_sites_and_tripwires_equal(small, schedule):
    params, jcfg, model = small

    def jmake():
        e = jpaged.PagedEngine(params, jcfg, obs=False, **G)
        e.fault_scope = "replica1"
        return e

    def tmake():
        e = tpaged.PagedEngine(model, model.cfg, **G)
        e.fault_scope = "replica1"
        return e

    want = _fault_outcome(jfaults, jmake, schedule)
    got = _fault_outcome(tfaults, tmake, schedule)
    assert got == want and got[0] is not None
    if schedule[0]["kind"] != "raise":
        assert got[0] == "EngineIntegrityError"


def test_recompile_tripwire(small, monkeypatch):
    """A build inside a steady step counts as a recompile, and raises
    under ``strict()``; builds before the engine is steady do not."""
    _, _, model = small
    real = tpaged.paged_tick
    plan = {"build_at": None, "calls": 0}

    def building_tick(*a, **kw):
        plan["calls"] += 1
        if plan["calls"] in (1, plan["build_at"]):
            tcs.COMPILESTATS.note_build("libtpulab_kernels.so", 0.0)
        return real(*a, **kw)

    monkeypatch.setattr(tpaged, "paged_tick", building_tick)
    eng = tpaged.PagedEngine(model, model.cfg, prefill_chunk=0, **G)
    eng.submit(_cycle(4), max_new=12)
    eng.step()  # the first tick builds: not steady yet, no recompile
    eng.step()
    assert eng.counters["recompiles"] == 0 and eng._steady
    plan["build_at"] = plan["calls"] + 1
    eng.step()
    assert eng.counters["recompiles"] == 1
    plan["build_at"] = plan["calls"] + 1
    with tcs.strict():
        with pytest.raises(tcs.RecompileError):
            eng.step()
    tcs.COMPILESTATS.steady_recompiles -= 2
    assert eng.counters["recompiles"] == 2
