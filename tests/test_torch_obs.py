"""tpulab_torch.obs held against tpulab.obs on the CPU.

The same recorded observations go into a fresh registry of each package
and must render byte-equal Prometheus text (HELP/TYPE lines, bucket
bounds, counts, sums, exemplars) with equal percentiles.  The tracer ring
wraps as tpulab's does and exports the same Chrome trace-event structure
(names, phases, args, recorded and dropped; timestamps are wall clock and
compared only for order).  The slow log keeps the same worst N, the
journey store stitches the same marks into the same waterfalls, the
flight recorder writes a bundle of tpulab's schema, and the compile
ledger keeps tpulab's interface (``seq``, ``names_since``, ``strict``,
``RecompileError``, ``note_steady_recompile``, the snapshot's keys).
"""

import json
import random
import threading

import pytest

import tpulab.obs as jobs
from tpulab.obs import compilestats as jcs
from tpulab.obs import flightrec as jfr
from tpulab.obs import journey as jjourney
from tpulab.obs import registry as jreg
from tpulab.obs import roofline as jroof
from tpulab.obs import slowlog as jslow
from tpulab.obs import tracer as jtracer

import tpulab_torch.obs as tobs
from tpulab_torch.obs import compilestats as tcs
from tpulab_torch.obs import flightrec as tfr
from tpulab_torch.obs import journey as tjourney
from tpulab_torch.obs import registry as treg
from tpulab_torch.obs import roofline as troof
from tpulab_torch.obs import slowlog as tslow
from tpulab_torch.obs import tracer as ttracer


def _feed(reg_mod, seed):
    """One seeded sequence of metric writes into a fresh registry."""
    rng = random.Random(seed)
    reg = reg_mod.Registry()
    hists = [reg.histogram("ttft_seconds", "submit -> first token"),
             reg.histogram("custom_seconds", "custom buckets", buckets=(0.001, 0.01, 0.1, 1.0))]
    c = reg.counter("daemon_shed_requests", "requests shed")
    g = reg.gauge("engine_blocks_free", "free blocks")
    for i in range(400):
        h = rng.choice(hists)
        v = rng.lognormvariate(-5, 2)
        h.observe(v, rid=rng.choice((None, i + 1)))
        if rng.random() < 0.3:
            c.inc(rng.randint(1, 3))
        if rng.random() < 0.2:
            g.set(rng.randint(0, 500))
    return reg, hists


@pytest.mark.parametrize("seed", range(4))
def test_prometheus_text_byte_equal(seed):
    treg_, thists = _feed(treg, seed)
    jreg_, jhists = _feed(jreg, seed)
    assert treg_.render() == jreg_.render()
    assert treg_.snapshot() == jreg_.snapshot()
    for th, jh in zip(thists, jhists):
        for q in (0.5, 0.9, 0.99):
            assert th.percentile(q) == jh.percentile(q)
    assert treg.DEFAULT_BUCKETS == jreg.DEFAULT_BUCKETS
    counts = [0, 3, 5, 0, 2, 1]
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert treg.percentile_from_buckets((1, 2, 4, 8, 16), counts, q) == \
            jreg.percentile_from_buckets((1, 2, 4, 8, 16), counts, q)


def test_registry_refuses_what_tpulab_refuses():
    for mod in (treg, jreg):
        reg = mod.Registry()
        reg.counter("x_total")
        with pytest.raises(Exception):
            reg.gauge("x_total")
        with pytest.raises(Exception):
            reg.counter("bad name")


def _trace_feed(tr_mod, cap, n):
    tr = tr_mod.Tracer(cap)
    for i in range(n):
        if i % 5 == 0:
            with tr.span("engine.host_sync"):
                tr.event("engine.token", i)
        elif i % 5 == 1:
            tr.begin("engine.prefill_chunk", i)
            tr.end("engine.prefill_chunk")
        else:
            tr.event("engine.submit", i, extra=i % 3)
    return tr


@pytest.mark.parametrize("cap,n", [(16, 7), (16, 50), (64, 200), (0, 10)])
def test_tracer_ring_wraparound_and_chrome_json(cap, n):
    td = _trace_feed(ttracer, cap, n).chrome_trace()
    jd = _trace_feed(jtracer, cap, n).chrome_trace()
    assert td["otherData"] == jd["otherData"]
    assert td["displayTimeUnit"] == jd["displayTimeUnit"]

    def shape(d):
        return [(e["name"], e["ph"], e.get("args"), e.get("s")) for e in d["traceEvents"]]

    # events recorded in one nanosecond sort by kind: compare as multisets
    assert sorted(map(repr, shape(td))) == sorted(map(repr, shape(jd)))
    ts = [e["ts"] for e in td["traceEvents"]]
    assert ts == sorted(ts) and (not ts or ts[0] == 0.0)
    json.loads(json.dumps(td))  # serializable as the daemon sends it
    if cap:
        assert len(td["traceEvents"]) == min(cap, td["otherData"]["recorded"])


def test_null_tracer_and_rid_events():
    for mod in (ttracer, jtracer):
        mod.NULL.event("x", 1)
        with mod.NULL.span("y"):
            pass
        assert mod.NULL.chrome_trace()["traceEvents"] == []
    t = _trace_feed(ttracer, 64, 20)
    j = _trace_feed(jtracer, 64, 20)
    assert [(n, a) for _, n, a in t.rid_events(6)] == [(n, a) for _, n, a in j.rid_events(6)]


def _slow_feed(mod, cap, seed):
    log = mod.SlowLog(cap)
    rng = random.Random(seed)
    for rid in range(1, 80):
        log.record({"rid": rid, "tag": f"t{rid % 3}", "e2e_ms": round(rng.uniform(0, 100), 3)})
    return log


@pytest.mark.parametrize("cap", [0, 1, 5, 64])
def test_slowlog_worst_n_and_capacity(cap):
    t, j = _slow_feed(tslow, cap, cap), _slow_feed(jslow, cap, cap)
    assert t.snapshot() == j.snapshot()
    assert t.snapshot(3) == j.snapshot(3)
    assert t.find(7) == j.find(7)
    t.resize(2)
    j.resize(2)
    assert t.snapshot(clear=True) == j.snapshot(clear=True)
    assert t.snapshot() == j.snapshot() and t.recorded == 0


def _journey_feed(mod, cap):
    store = mod.JourneyStore(cap)
    t = 100.0
    for rid in range(1, 12):
        store.mark(rid, "submit", t=t, replica=0, pool="unified", tag=f"load:{rid}")
        store.mark(rid, "admit", t=t + 0.002 * rid, replica=0, pool="unified")
        if rid % 3 == 0:
            store.mark(rid, "migrate", t=t + 0.003 * rid, replica=1, pool="unified")
        store.mark(rid, "prefill_done", t=t + 0.004 * rid, replica=rid % 2, pool="unified")
        if rid % 4:
            store.mark(rid, "retire", t=t + 0.01 * rid, replica=rid % 2, pool="unified")
        t += 0.05
    return store


@pytest.mark.parametrize("cap", [0, 4, 256])
def test_journey_store_equal(cap):
    t, j = _journey_feed(tjourney, cap), _journey_feed(jjourney, cap)
    assert t.stats() == j.stats()
    for rid in range(1, 12):
        assert t.snapshot(rid) == j.snapshot(rid)
    assert t.find_tag("load:9") == j.find_tag("load:9")
    assert t.recent(5) == j.recent(5)
    assert t.recent(5, completed_only=True) == j.recent(5, completed_only=True)
    assert tjourney.PHASES == jjourney.PHASES
    assert tjourney.HANDOFF_PHASES == jjourney.HANDOFF_PHASES


def test_flightrec_bundle_schema(tmp_path):
    class Eng:
        _build_key = ("ckpt", "gather", "native", 32)
        _build_stamp = 3
        replica_index = 1
        fault_scope = "replica1"
        pending, active = [], []

        def stats(self):
            return {"ticks": 4, "tokens_out": 9}

    bundles = {}
    for name, fr, root in (("port", tfr, tmp_path / "t"), ("jax", jfr, tmp_path / "j")):
        fr.configure_flightrec(root)
        try:
            path = fr.record_postmortem("replica_quarantine", engine=Eng(),
                                        err=RuntimeError("boom"), extra={"k": 1})
            assert path is not None and path.parent == root
            bundles[name] = fr.latest_postmortem()
            for _ in range(fr.KEEP + 3):
                fr.record_postmortem("again")
            assert len(fr.list_bundles()) == fr.KEEP
        finally:
            fr.configure_flightrec(None)
    t, j = bundles["port"], bundles["jax"]
    assert set(t) == set(j)
    for key in ("schema", "reason", "error", "engine", "extra"):
        assert t[key] == j[key], key
    assert set(t["trace"]) == set(j["trace"]) and t["alerts"] == []
    assert set(t["faults"]) == set(j["faults"])


def test_compile_ledger_interface():
    cs = tcs.CompileStats()
    c0 = cs.seq()
    cs.note_build("libtpulab_kernels.so", 1.5)
    assert cs.seq() == c0 + 1 and cs.names_since(c0) == ["libtpulab_kernels.so"]
    other = []
    th = threading.Thread(target=lambda: other.append(cs.names_since(c0)))
    th.start()
    th.join(timeout=10)
    assert other == [[]]  # another thread's wire ignores this thread's build
    cs.set_model_flops("paged_tick", 123.0)
    snap = cs.snapshot()
    jsnap = jcs.ProgramStats("x").snapshot()
    assert set(snap["libtpulab_kernels.so"]) == set(jsnap)
    assert snap["libtpulab_kernels.so"]["compiles"] == 1
    assert cs.model_flops("paged_tick") == 123.0 and cs.total_compiles() == 1
    cs.note_steady_recompile(["x"])  # counts, does not raise
    assert cs.steady_recompiles == 1
    led = tcs.COMPILESTATS
    with tcs.strict():
        with pytest.raises(tcs.RecompileError):
            led.note_steady_recompile(["libtpulab_kernels.so"])
    assert not led.strict
    led.steady_recompiles -= 1
    cs.reset()
    assert cs.snapshot() == {} and cs.seq() == 0


def test_roofline_rows_and_gauges():
    reg = treg.Registry()
    got = troof.update_mfu_gauges(registry=reg)
    assert set(got) == {"engine_mfu", "train_mfu"}
    assert reg.get("engine_mfu") is not None and reg.get("train_mfu") is not None
    rows = troof.roofline_rows({"p": {"compiles": 1, "compile_seconds": 0.5, "flops": 1e12,
                                      "bytes_accessed": 1e9, "model_flops": None}},
                               peaks={"peak_tflops": 989.0, "peak_gbps": 3350.0})
    (row,) = rows
    assert row["bound"] == "compute-bound" and row["ceiling_tflops"] == 989.0
    assert troof.classify(1e12, 1e9, {"peak_tflops": 989.0, "peak_gbps": 3350.0}) == \
        jroof.classify(1e12, 1e9, {"peak_tflops": 989.0, "peak_gbps": 3350.0})
    assert troof.classify(1e9, 1e9, {"peak_tflops": 989.0, "peak_gbps": 3350.0})["bound"] == \
        "bandwidth-bound"
    mem = troof.update_device_memory_gauges(4096, registry=reg, device="cpu")
    assert mem == {"engine_hbm_bytes_in_use": 4096, "engine_hbm_bytes_limit": 0}


def test_exports_are_the_ported_subset():
    # the history ring and the alert engine are ported; ``instrument`` wraps
    # a jitted program (XLA compile events) and has no counterpart in the
    # eager port, whose builds go through ``note_build``
    assert set(tobs.__all__) - set(jobs.__all__) == {"note_build"}
    assert set(jobs.__all__) - set(tobs.__all__) == {"instrument"}
