"""tpulab_torch.loadgen held against tpulab.loadgen on the CPU.

For every built-in spec at several seeds the port builds a trace whose
JSON bytes equal tpulab's (same arrival process, sizes, classes, texts
and follow-up turns), the save/load round trip keeps those bytes, and
``summarize`` folds the same per-request outcomes into the same goodput
report.  The replay client itself is driven against the port's daemon in
``tests/test_torch_daemon_wire.py``.
"""

import random
from dataclasses import replace

import pytest

from tpulab import loadgen as jload
from tpulab_torch import loadgen as tload

SEEDS = (0, 1, 12345)


@pytest.mark.parametrize("name", sorted(jload.SPECS))
def test_traces_byte_equal_to_tpulab(name, tmp_path):
    assert sorted(tload.SPECS) == sorted(jload.SPECS)
    for seed in SEEDS:
        jt = jload.build_trace(replace(jload.built_in_spec(name), seed=seed))
        tt = tload.build_trace(replace(tload.built_in_spec(name), seed=seed))
        assert tt.to_json() == jt.to_json(), (name, seed)
        path = tmp_path / f"{name}_{seed}.json"
        tt.save(path)
        jpath = tmp_path / f"{name}_{seed}_jax.json"
        jt.save(jpath)
        assert path.read_bytes() == jpath.read_bytes()
        assert tload.Trace.load(jpath).to_json() == jt.to_json()


def _outcomes(trace, seed):
    """Per-request outcomes of every kind ``summarize`` folds, drawn from
    a seeded stream: completed in or out of SLO, shed, rebuilding,
    cancelled and errors."""
    rng = random.Random(seed)
    out = []
    for r in trace.requests:
        kind = rng.choice(("ok", "ok", "ok", "shed", "rebuilding", "cancelled", "error"))
        ttft = rng.uniform(1, 4000) if kind == "ok" else None
        out.append({
            "cls": r["cls"], "tag": r.get("tag"), "ok": kind == "ok",
            "shed": kind == "shed", "rebuilding": kind == "rebuilding",
            "cancelled": kind == "cancelled",
            "ttft_ms": ttft, "itl_max_ms": rng.uniform(0, 600),
            "e2e_ms": (ttft + rng.uniform(0, 9000)) if ttft else None,
            "bytes_out": rng.randrange(0, 64),
        })
    return out


@pytest.mark.parametrize("name", sorted(jload.SPECS))
def test_summarize_equals_tpulab(name):
    for seed in SEEDS:
        trace = jload.build_trace(replace(jload.built_in_spec(name), seed=seed))
        results = _outcomes(trace, seed)
        ttrace = tload.Trace.from_json(trace.to_json())
        for wall in (0.0, 3.5):
            assert tload.summarize(results, ttrace, wall) == jload.summarize(results, trace, wall)


def test_shed_contract_patterns_equal():
    """The retry contract the replay client parses: the same patterns."""
    assert tload.SHED_RE.pattern == jload.SHED_RE.pattern
    for body in ("shed retry_after_ms=250 (queue full)",
                 "rebuilding retry_after_ms=50 (no placeable replica)",
                 "rebuilding pool=prefill retry_after_ms=75 (pool draining)"):
        jm, tm = jload.SHED_RE.search(body), tload.SHED_RE.search(body)
        assert (jm is None) == (tm is None) and (tm is None or tm.groups() == jm.groups())
