"""tpulab_torch.obs.render and the console, held against tpulab on the CPU.

The same seeded registry renders the same Prometheus text in both
packages; each package's renderer parses it to the same metrics, the
same percentile summary and the same latency table, and renders the
same fleet (unified, elastic, pooled, single-engine, degraded), journey,
slow-log, alert and history surfaces and sparklines, byte for byte.  The
port's console (``python -m tpulab_torch.obs.console``) renders the
frame ``tools/obs_console.py`` renders from the same scrape but for its
clock line, degrades to an ``unavailable`` line per surface, and renders
a live frame (``--once``) from a port daemon serving on a thread.
"""

import importlib.util
import pathlib
import random
import threading
import time

import pytest

from tpulab.obs import registry as jreg
from tpulab.obs import render as jR

from tpulab_torch.obs import console as tcon
from tpulab_torch.obs import registry as treg
from tpulab_torch.obs import render as tR

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _scrape(reg_mod, seed):
    rng = random.Random(seed)
    reg = reg_mod.Registry()
    hists = [reg.histogram(n, n) for n in ("ttft_seconds", "itl_seconds", "e2e_seconds",
                                          "queue_wait_seconds", "prefill_seconds")]
    for i in range(300):
        rng.choice(hists).observe(rng.lognormvariate(-4, 1.5), rid=rng.choice((None, i + 1)))
    for name in ("engine_ticks", "engine_tokens_out", "engine_requests_done",
                 "engine_blocks_used", "engine_blocks_total", "engine_prefill_inflight"):
        reg.gauge(name, name).set(rng.randint(0, 500))
    reg.counter("daemon_scale_outs", "outs").inc(rng.randint(0, 5))
    return reg.render()


FLEETS = [
    None,
    {"replicas": 0, "replica": []},
    {"replicas": 1, "replica": [{"replica": 0, "health": "rebuilding", "dead": True}]},
    {"replicas": 3, "active": 2,
     "autoscale": {"target": 2, "min": 1, "max": 3, "raises": 4, "lowers": 3},
     "brownout": {"level": 2, "rungs": ["hedging_off", "spec_off"], "engages": 5,
                  "releases": 3},
     "replica": [{"replica": 0, "health": "healthy", "pending": 0, "active": 1,
                  "requests_done": 7},
                 {"replica": 1, "health": "suspect", "pending": 2, "active": 1,
                  "requests_done": 3, "draining": True, "parked": 1},
                 {"replica": 2, "health": "retired", "retired": True, "dead": True}]},
    {"replicas": 2, "active": 2,
     "pools": {"prefill": {"min": 1, "max": 2, "autoscale": {"target": 1, "min": 1, "max": 2,
                                                              "raises": 0, "lowers": 0}},
               "decode": {"min": 1, "max": 1, "autoscale": None}},
     "replica": [{"replica": 0, "role": "prefill", "health": "healthy", "pending": 0,
                  "active": 0, "requests_done": 0, "generation": 1, "restarts": 0},
                 {"replica": 1, "role": "decode", "health": "healthy", "pending": 1,
                  "active": 2, "requests_done": 9, "generation": 0, "restarts": 1}]},
]

ALERTS = {"rules": 3, "firing": 1, "pending": 1, "alerts": [
    {"rule": "ttft_burn_fast", "severity": "page", "state": "firing", "value": 20.0,
     "detail": "burning", "fires": 1, "firing_for_s": 12.0},
    {"rule": "kv_occupancy_high", "severity": "warn", "state": "pending", "value": 0.96,
     "detail": "96%", "fires": 0, "active_for_s": 2.5},
    {"rule": "sampler_stale", "severity": "warn", "state": "ok", "value": 0.1,
     "detail": "", "fires": 0},
    {"rule": "recompile_tripwire", "severity": "page", "state": "resolved", "value": 0.0,
     "detail": "", "fires": 2, "resolved_ago_s": 30.0}]}

HISTORY = {"samples": 3, "capacity": 900, "sampler": {"running": True, "interval_s": 1.0},
           "window": {"seconds": 30.0, "rates": {"engine_tokens_out": 12.5},
                      "histograms": {"ttft_seconds": {"count": 1, "p50_ms": 50.0,
                                                      "p90_ms": 50.0, "p99_ms": 50.0}}},
           "series": {"engine_tokens_out": [[-2.0, 1.0], [-1.0, 3.0], [0.0, 5.0]]}}

SLOWLOG = {"recorded": 2, "worst": [
    {"rid": 7, "tag": "t", "e2e_ms": 9.0, "ttft_ms": 1.0, "itl_max_ms": 2.0,
     "itl_max_at_token": 3, "queue_wait_ms": 0.1, "prefill_chunks": 1, "tokens": 8},
    {"rid": 9, "tag": "", "e2e_ms": 19.0, "ttft_ms": 4.0, "itl_max_ms": 3.0,
     "itl_max_at_token": 1, "queue_wait_ms": 0.3, "prefill_chunks": 2, "tokens": 12,
     "pool": "decode", "handoff_ms": 1.25, "handoff_bytes": 4096, "replica_hops": [0, 1],
     "migrations": 1}]}

JOURNEY = {"rid": 9, "tag": "x", "completed": True, "e2e_ms": 19.0, "tokens": 12,
           "pools": ["prefill", "decode"], "dominant": "decode",
           "phases": [{"phase": "queue_wait", "t0_ms": 0.0, "t1_ms": 0.3, "ms": 0.3},
                      {"phase": "prefill", "t0_ms": 0.3, "t1_ms": 4.0, "ms": 3.7,
                       "replica": 0, "pool": "prefill"},
                      {"phase": "handoff_export", "t0_ms": 4.0, "t1_ms": 4.5, "ms": 0.5,
                       "nbytes": 4096},
                      {"phase": "decode", "t0_ms": 4.5, "t1_ms": 19.0, "ms": 14.5,
                       "replica": 1, "pool": "decode"}]}


@pytest.mark.parametrize("seed", range(3))
def test_scrape_summary_equal(seed):
    text = _scrape(treg, seed)
    assert text == _scrape(jreg, seed)
    tm, jm = tR.parse_prometheus(text), jR.parse_prometheus(text)
    assert tm == jm
    assert tR.summarize(tm) == jR.summarize(jm)
    assert tR.format_latency_table(tR.summarize(tm)) == jR.format_latency_table(jR.summarize(jm))
    assert tR.engine_row_from_gauges(tm) == jR.engine_row_from_gauges(jm)
    for name in ("ttft_seconds", "e2e_seconds"):
        for q in (0.5, 0.99):
            assert tR.histogram_percentile(tm[name], q) == jR.histogram_percentile(jm[name], q)
    for fleet in FLEETS:
        assert tR.format_fleet(fleet, tm) == jR.format_fleet(fleet, jm)


@pytest.mark.parametrize("i", range(len(FLEETS)))
def test_fleet_table_equal(i):
    assert tR.format_fleet(FLEETS[i]) == jR.format_fleet(FLEETS[i])


def test_surfaces_equal():
    for all_rules in (False, True):
        assert (tR.format_alerts(ALERTS, all_rules=all_rules)
                == jR.format_alerts(ALERTS, all_rules=all_rules))
    for obj in (None, {}):
        assert tR.format_alerts(obj) == jR.format_alerts(obj)
        assert tR.format_history(obj) == jR.format_history(obj)
        assert tR.format_slowlog(obj) == jR.format_slowlog(obj)
        assert tR.format_journeys(obj) == jR.format_journeys(obj)
    assert tR.format_history(HISTORY) == jR.format_history(HISTORY)
    assert tR.format_slowlog(SLOWLOG) == jR.format_slowlog(SLOWLOG)
    assert tR.format_journey(JOURNEY) == jR.format_journey(JOURNEY)
    assert tR.format_journey(JOURNEY, width=20) == jR.format_journey(JOURNEY, width=20)
    resp = {"journeys": [JOURNEY, {**JOURNEY, "rid": 10, "completed": False}]}
    assert tR.format_journeys(resp) == jR.format_journeys(resp)
    assert "rid=9" in tR.format_slowlog(SLOWLOG) and "handoff=" in tR.format_slowlog(SLOWLOG)


@pytest.mark.parametrize("values,width", [([], 8), ([0, 1, 2, 4], 4), (list(range(100)), 16),
                                          ([3.0] * 5, 10), ([5, -1, 2.5, 0], 32)])
def test_sparkline_equal(values, width):
    assert tR.sparkline(values, width) == jR.sparkline(values, width)
    assert len(tR.sparkline(values, width)) == width


def _ref_console():
    spec = importlib.util.spec_from_file_location("obs_console", ROOT / "tools" / "obs_console.py")
    con = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(con)
    return con


def test_console_frame_equal_to_tools():
    jcon = _ref_console()
    scr = {"metrics": _scrape(treg, 4), "fleet": FLEETS[3], "history": HISTORY,
           "alerts": ALERTS, "slowlog": SLOWLOG, "journeys": {"journeys": [JOURNEY]}}
    for all_rules in (False, True):
        t = tcon.render_frame(scr, all_rules=all_rules, title="s").split("\n", 1)
        j = jcon.render_frame(scr, all_rules=all_rules, title="s").split("\n", 1)
        assert t[1] == j[1] and t[0].startswith("tpulab ops console  s  ")
    bad = {"metrics": None, "errors": ["metrics: x"]}
    assert (tcon.render_frame(bad).split("\n", 1)[1] == jcon.render_frame(bad).split("\n", 1)[1])
    assert "unavailable" in tcon.render_frame(bad) and "scrape errors" in tcon.render_frame(bad)


def test_console_once_against_a_live_daemon(tmp_path, capsys, monkeypatch):
    import tpulab_torch.daemon as td

    monkeypatch.setattr(td, "BACKEND", "cpu")
    sock = str(tmp_path / "c.sock")
    stop = threading.Event()
    th = threading.Thread(target=td.serve, args=(sock,),
                          kwargs={"stop_event": stop}, daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 30
        while not pathlib.Path(sock).exists() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert tcon.main(["--socket", sock, "--once", "--all-rules"]) == 0
    finally:
        stop.set()
        th.join(timeout=30)
    out = capsys.readouterr().out
    for needle in ("tpulab ops console", "sampler_stale", "history:"):
        assert needle in out, needle
    assert "scrape errors" not in out
