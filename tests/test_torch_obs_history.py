"""tpulab_torch.obs.history held against tpulab.obs.history on the CPU.

The same seeded metric writes go into a fresh registry of each package,
sampled at the same explicit times into each package's ``MetricsHistory``;
every window must give equal counter deltas and rates, histogram window
counts and percentiles, gauge endpoints, ``fraction_le`` shares and
rate series, and the ``history`` report (the daemon request's body) must
be equal but for its wall-clock age.  Counter resets, a ring that wraps
and a window older than the ring behave alike.  ``counts_delta`` and
``fraction_le`` agree on seeded vectors.  The ``Sampler`` thread starts,
ticks and stops.  Both daemons answer the ``history`` request with the
same keys after the same sampler ticks, and the port's windowed shed
check reads the ring while the sampler is live, as tpulab's does.
"""

import json
import random
import time

import numpy as np
import pytest

import tpulab.daemon as jd
from tpulab.obs import history as jhist
from tpulab.obs import registry as jreg

import tpulab_torch.daemon as td
import tpulab_torch.models.paged  # noqa: F401 — registers queue_wait_seconds
from tpulab_torch.obs import history as thist
from tpulab_torch.obs import registry as treg

BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)


def _drive(reg_mod, hist_mod, seed, capacity=64, reset_at=None):
    """A seeded run: each step writes metrics, then samples at t=step."""
    rng = random.Random(seed)
    reg = reg_mod.Registry()
    h = reg.histogram("ttft_seconds", "ttft", buckets=BUCKETS)
    c = reg.counter("engine_tokens_out", "tokens")
    g = reg.gauge("engine_blocks_used", "blocks")
    ring = hist_mod.MetricsHistory(capacity)
    for step in range(80):
        if reset_at is not None and step == reset_at:
            # a registry cleared mid-run: the new counts ARE the delta
            reg = reg_mod.Registry()
            h = reg.histogram("ttft_seconds", "ttft", buckets=BUCKETS)
            c = reg.counter("engine_tokens_out", "tokens")
            g = reg.gauge("engine_blocks_used", "blocks")
        for _ in range(rng.randint(0, 6)):
            h.observe(rng.lognormvariate(-4, 1.5))
        c.inc(rng.randint(0, 40))
        g.set(rng.randint(0, 128))
        ring.sample(reg, now=float(step) * 0.5)
    return ring


def _window_row(w):
    if w is None:
        return None
    return (w.duration_s, w.delta("engine_tokens_out"), w.rate("engine_tokens_out"),
            w.count("ttft_seconds"),
            [w.percentile("ttft_seconds", q) for q in (0.5, 0.9, 0.99)],
            w.gauge("engine_blocks_used"), w.fraction_le("ttft_seconds", 0.01),
            w.has("engine_tokens_out"), w.has("missing"))


@pytest.mark.parametrize("seed,capacity,reset_at", [
    (0, 64, None), (1, 16, None), (2, 64, 30), (3, 7, 50)])
def test_windows_equal(seed, capacity, reset_at):
    jr = _drive(jreg, jhist, seed, capacity, reset_at)
    tr = _drive(treg, thist, seed, capacity, reset_at)
    assert tr.samples == jr.samples and tr.total_samples == jr.total_samples
    for seconds in (0.5, 3.0, 10.0, 30.0, 1e6):
        assert _window_row(tr.window(seconds)) == _window_row(jr.window(seconds)), seconds
    for name in ("engine_tokens_out", "ttft_seconds", "engine_blocks_used"):
        for rate in (False, True):
            assert (tr.series(name, 8.0, rate=rate)
                    == jr.series(name, 8.0, rate=rate)), (name, rate)
    for rep in ((jr, tr),):
        jrep = rep[0].report(12.0, series=["engine_tokens_out"])
        trep = rep[1].report(12.0, series=["engine_tokens_out"])
        jrep.pop("age_s"), trep.pop("age_s")
        assert trep == jrep


def test_window_edges_equal():
    for hist_mod, reg_mod in ((jhist, jreg), (thist, treg)):
        ring = hist_mod.MetricsHistory(4)
        assert ring.window(10.0) is None and ring.latest() is None
    jr, tr = jhist.MetricsHistory(4), thist.MetricsHistory(4)
    jreg_, treg_ = jreg.Registry(), treg.Registry()
    for reg in (jreg_, treg_):
        reg.counter("c", "c").inc(3)
    jr.sample(jreg_, now=1.0), tr.sample(treg_, now=1.0)
    # one sample: a since-start view on both sides
    assert _window_row(tr.window(5.0)) == _window_row(jr.window(5.0))
    live_j = jr.window(5.0, end=(2.0, jreg_.snapshot()))
    live_t = tr.window(5.0, end=(2.0, treg_.snapshot()))
    assert (live_t.t0, live_t.t1, live_t.delta("c")) == (live_j.t0, live_j.t1, live_j.delta("c"))
    with pytest.raises(ValueError):
        thist.MetricsHistory(0)


@pytest.mark.parametrize("seed", range(6))
def test_counts_delta_and_fraction_le_equal(seed):
    rng = np.random.default_rng(seed)
    old = [int(x) for x in np.cumsum(rng.integers(0, 9, 8))]
    new = [o + int(d) for o, d in zip(old, rng.integers(-2, 9, 8))]
    for pair in ((new, old), (new, None), (old, new)):
        assert thist.counts_delta(*pair) == jhist.counts_delta(*pair)
    counts = [int(x) for x in rng.integers(0, 20, len(BUCKETS) + 1)]
    for x in (0.0005, 0.003, 0.05, 0.7, 2.0):
        assert thist.fraction_le(BUCKETS, counts, x) == jhist.fraction_le(BUCKETS, counts, x)
    for pair in ((5.0, 2.0), (1.0, 4.0), (3.0, None)):
        assert thist.value_delta(*pair) == jhist.value_delta(*pair)


def test_sampler_thread_ticks_and_stops():
    reg = treg.Registry()
    c = reg.counter("n", "n")
    ring = thist.MetricsHistory(32)
    seen = []
    s = thist.Sampler(ring, 0.02, on_sample=lambda: seen.append(ring.samples),
                      before_sample=lambda: c.inc(), registry=reg).start()
    try:
        deadline = time.monotonic() + 10
        while len(seen) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.running and len(seen) >= 3 and s.errors == 0
    finally:
        s.stop()
    assert not s.running and ring.interval_s == 0.02
    assert ring.latest()[1]["n"]["value"] >= 3
    with pytest.raises(ValueError):
        thist.Sampler(ring, 0)


@pytest.fixture
def rings(monkeypatch):
    """Each daemon's process-global ring, emptied, and no sampler."""
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_SAMPLER", None)
        mod._obs.HISTORY.clear()
    yield
    for mod in (jd, td):
        mod.stop_sampler()
        mod._obs.HISTORY.clear()


def test_history_request_equal_keys(rings):
    for mod in (jd, td):
        for _ in range(3):
            mod._obs.HISTORY.sample()
            mod._sampler_tick()
    bodies = [json.loads(mod.handle_request(
        {"lab": "history", "config": {"seconds": 30, "series": ["engine_ticks"]}}, b""))
        for mod in (td, jd)]
    assert set(bodies[0]) == set(bodies[1])
    assert set(bodies[0]["window"]) == set(bodies[1]["window"])
    assert bodies[0]["samples"] == bodies[1]["samples"] == 3
    assert bodies[0]["sampler"] == bodies[1]["sampler"] == {
        "running": False, "interval_s": None, "errors": 0}
    for mod in (td, jd):
        with pytest.raises(ValueError, match="seconds must be > 0"):
            mod.handle_request({"lab": "history", "config": {"seconds": 0}}, b"")
        with pytest.raises(ValueError, match="series must be a list"):
            mod.handle_request({"lab": "history", "config": {"series": "x"}}, b"")


def test_shed_reads_the_ring_while_the_sampler_is_live(rings, monkeypatch):
    """The windowed branch of ``_shed_check``: with a live sampler the
    queue-wait p99 is the ring's window (tpulab's), a stale or stopped
    sampler falls back to the two-mark estimate."""
    h = td._obs.REGISTRY.get("queue_wait_seconds")
    assert h is not None
    assert not td._sampler_active()
    s = td.start_sampler(interval_s=60.0, capacity=16)
    try:
        assert s is not None and s.running
        td._obs.HISTORY.sample()
        assert td._sampler_active()
        for _ in range(50):
            h.observe(3.0)
        got = td._ADMISSION._queue_wait_p99_ms()
        w = td._obs.HISTORY.window(td.QUEUE_WAIT_WINDOW_S,
                                   end=(time.monotonic(), {"queue_wait_seconds": h.snapshot()}))
        assert got == w.percentile("queue_wait_seconds", 0.99) * 1e3 > 1000.0
        # a ring whose newest sample is older than 5 intervals is stale
        monkeypatch.setattr(td._obs.HISTORY, "age_s", lambda now=None: 1e9)
        assert not td._sampler_active()
    finally:
        td.stop_sampler()
    assert td._SAMPLER is None and td.start_sampler(interval_s=0) is None
