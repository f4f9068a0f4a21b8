"""Shared terminal rendering for the observability tools.

The port's copy of ``tpulab.obs.render``: the same strings from the same
inputs (tests/test_torch_obs_render.py).  The live console
(:mod:`tpulab_torch.obs.console`) renders its surfaces — latency
percentile table, fleet health table, slow-log worst-N, alert states,
history sparklines — from here.  The functions are all pure
(JSON/scrape dict in, string out) so tests exercise them without a
daemon.

Everything is stdlib-only, matching the rest of ``tpulab_torch.obs``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from tpulab_torch import router as _router
from tpulab_torch.obs.registry import percentile_from_buckets

#: histograms the latency summary table reports, in display order
LATENCY_METRICS = ("ttft_seconds", "itl_seconds", "e2e_seconds",
                   "queue_wait_seconds", "prefill_seconds")

#: bucket line, optionally carrying an OpenMetrics-style exemplar
#: suffix: ``name_bucket{le="x"} N # {rid="R"} V``
_BUCKET_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)_bucket\{le="(?P<le>[^"]+)"\}'
    r"\s+(?P<v>\S+)"
    r'(?:\s+#\s+\{rid="(?P<rid>[^"]+)"\}\s+(?P<ev>\S+))?$')
_PLAIN_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)\s+(?P<v>\S+)$")

#: eight-level unicode sparkline ramp (space = exactly zero)
_SPARK = " ▁▂▃▄▅▆▇█"


def parse_prometheus(text: str) -> dict:
    """Prometheus text -> {name: {"type", "value"|"buckets"/"sum"/
    "count"}}.  ``buckets`` are (upper_bound, CUMULATIVE count) pairs in
    exposition order, +Inf last — exactly what the text carries."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(None, 3)
            out.setdefault(name, {"type": mtype})
            continue
        if line.startswith("#"):
            continue
        m = _BUCKET_RE.match(line)
        if m:
            h = out.setdefault(m["name"], {"type": "histogram"})
            le = float("inf") if m["le"] == "+Inf" else float(m["le"])
            h.setdefault("buckets", []).append((le, int(float(m["v"]))))
            if m["rid"] is not None:
                # exemplars key by the bucket's le bound: (rid, value)
                h.setdefault("exemplars", {})[le] = (
                    int(m["rid"]), float(m["ev"]))
            continue
        m = _PLAIN_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, v = m["name"], float(m["v"])
        if name.endswith("_sum"):
            out.setdefault(name[:-4], {"type": "histogram"})["sum"] = v
        elif name.endswith("_count"):
            out.setdefault(name[:-6], {"type": "histogram"})["count"] = int(v)
        else:
            out.setdefault(name, {"type": "untyped"})["value"] = v
    return out


def histogram_percentile(metric: dict, q: float) -> float:
    """Quantile estimate from scraped CUMULATIVE buckets (converts to
    per-bucket counts and defers to the registry's shared rule)."""
    pairs = metric.get("buckets") or []
    if not pairs or pairs[-1][0] != float("inf"):
        raise ValueError("histogram is missing its +Inf bucket")
    bounds = tuple(le for le, _ in pairs[:-1])
    cums = [c for _, c in pairs]
    counts = [cums[0]] + [b - a for a, b in zip(cums, cums[1:])]
    return percentile_from_buckets(bounds, counts, q)


def summarize(metrics: dict) -> list:
    """Latency percentile rows from a parsed scrape."""
    rows = []
    for name in LATENCY_METRICS:
        m = metrics.get(name)
        if not m or m.get("type") != "histogram":
            continue
        rows.append({
            "metric": name,
            "count": m.get("count", 0),
            "p50_ms": round(histogram_percentile(m, 0.50) * 1e3, 3),
            "p90_ms": round(histogram_percentile(m, 0.90) * 1e3, 3),
            "p99_ms": round(histogram_percentile(m, 0.99) * 1e3, 3),
        })
    return rows


def format_latency_table(rows: list) -> str:
    if not rows:
        return ("no latency histograms populated yet "
                "(drive some generate traffic, or --drive N)")
    w = max(len(r["metric"]) for r in rows)
    lines = [f"{'metric':<{w}}  {'count':>7}  {'p50_ms':>9}  "
             f"{'p90_ms':>9}  {'p99_ms':>9}"]
    for r in rows:
        lines.append(f"{r['metric']:<{w}}  {r['count']:>7}  "
                     f"{r['p50_ms']:>9.3f}  {r['p90_ms']:>9.3f}  "
                     f"{r['p99_ms']:>9.3f}")
    return "\n".join(lines)


def engine_row_from_gauges(metrics: dict) -> Optional[dict]:
    """Synthesize a single-engine status row from the process-wide
    ``engine_*`` gauges of a scrape — what a NO-FLEET daemon (legacy
    direct-engine service, or none warm yet) can still prove.  None
    when the scrape carries no engine mirror at all."""
    def g(name):
        m = metrics.get(name)
        return int(m["value"]) if m and "value" in m else None

    if g("engine_ticks") is None:
        return None
    return {"requests_done": g("engine_requests_done"),
            "tokens_out": g("engine_tokens_out"),
            "ticks": g("engine_ticks"),
            "blocks_used": g("engine_blocks_used"),
            "blocks_total": g("engine_blocks_total"),
            "prefill_inflight": g("engine_prefill_inflight")}


def format_fleet(fleet: Optional[dict],
                 metrics: Optional[dict] = None) -> str:
    """The fleet health table.  Tolerates every daemon shape: a warm
    fleet renders per-replica rows (missing per-replica fields — a
    dead/rebuilding replica reports no load — render as ``-`` instead
    of KeyErroring); a NO-fleet daemon falls back to the single-engine
    gauge row; neither renders an honest one-liner."""
    if not fleet or not fleet.get("replicas"):
        row = engine_row_from_gauges(metrics or {})
        if row is None:
            return "fleet: none warm (no engine gauges in scrape)"
        return ("engine (no fleet): "
                + " ".join(f"{k}={'-' if v is None else v}"
                           for k, v in row.items()))
    head = f"fleet: {fleet['replicas']} replica(s)"
    # the elastic surface: target vs actual + the brownout
    # ladder, present only when the daemon runs with --autoscale-max
    auto = fleet.get("autoscale")
    if auto:
        head = (f"fleet: {fleet.get('active', fleet['replicas'])}"
                f"/{fleet['replicas']} serving, target "
                f"{auto.get('target')} "
                f"[{auto.get('min')}..{auto.get('max')}] "
                f"(scale-outs={auto.get('raises', 0)} "
                f"scale-ins={auto.get('lowers', 0)})")
    lines = [head]
    brown = fleet.get("brownout")
    if brown:
        rungs = brown.get("rungs") or []
        lines.append(
            f"  brownout: level {brown.get('level', 0)}"
            f"{' [' + ' > '.join(rungs) + ']' if rungs else ''} "
            f"(engages={brown.get('engages', 0)} "
            f"releases={brown.get('releases', 0)})")
    replicas = fleet.get("replica", [])
    # the disaggregation surface: per-pool serving
    # counts next to each pool's configured [min..max] band, and the
    # replica rows below carry their role.  A unified fleet (no pools,
    # every role "unified"/absent) renders exactly as before.
    pools = fleet.get("pools")
    pooled = bool(pools) or any(
        r.get("role") not in (None, "unified") for r in replicas)
    if pooled:
        counts = _router.pool_counts(
            r.get("role") for r in replicas if not r.get("retired"))
        parts = []
        for role in sorted(set(counts) | set(pools or {})):
            p = (pools or {}).get(role) or {}
            band = (f"[{p['min']}..{p['max']}]"
                    if "min" in p and "max" in p else "")
            parts.append(f"{role}={counts.get(role, 0)}{band}")
        lines.append("  pools: " + " ".join(parts))
    for r in replicas:
        def v(key, default="-"):
            x = r.get(key)
            return default if x is None else x

        flags = []
        if r.get("draining"):
            flags.append("draining")
        if r.get("retired"):
            flags.append("retired")
        elif r.get("dead"):
            flags.append("dead")
        role = f"{str(v('role', '?')):<8} " if pooled else ""
        lines.append(
            f"  replica{v('replica')} {str(v('health', '?')):<11} "
            f"{role}"
            f"{' '.join(flags) + ' ' if flags else ''}"
            f"pending={v('pending')} active={v('active')} "
            f"done={v('requests_done')} gen={v('generation', 0)} "
            f"restarts={v('restarts', 0)} parked={v('parked', 0)}")
    return "\n".join(lines)


def format_journey(journey: Optional[dict], width: int = 44) -> str:
    """Waterfall view of ONE stitched journey (the daemon's ``journey``
    response / :meth:`tpulab_torch.obs.journey.JourneyStore.snapshot`): one
    bar row per phase, positioned on the request's own [submit..retire]
    timeline so the handoff gap is visible at a glance.  Pure dict→str
    like every renderer here."""
    if not journey:
        return "journey: not found (evicted, or journeys disabled)"
    head = (f"journey rid={journey.get('rid')} "
            f"tag={journey.get('tag') or '-'} "
            f"{'complete' if journey.get('completed') else 'IN-FLIGHT'} "
            f"e2e={journey.get('e2e_ms') if journey.get('e2e_ms') is not None else '?'}ms "
            f"pools={'>'.join(journey.get('pools') or []) or '-'} "
            f"replicas={'>'.join(str(r) for r in journey.get('replicas') or []) or '-'}")
    if journey.get("handoff_ms") is not None:
        head += (f" handoff={journey['handoff_ms']}ms/"
                 f"{journey.get('handoff_bytes', 0)}B")
    phases = journey.get("phases") or []
    if not phases:
        return head + "\n  (no stitched phases — marks incomplete)"
    span = max(p["t1_ms"] for p in phases) or 1.0
    wname = max(len(p["phase"]) for p in phases)
    lines = [head]
    for p in phases:
        a = int(round(width * p["t0_ms"] / span))
        b = max(a + 1, int(round(width * p["t1_ms"] / span)))
        bar = " " * a + "█" * (b - a) + " " * (width - b)
        where = (f"r{p['replica']}" if p.get("replica") is not None
                 else "-")
        if p.get("pool"):
            where += f"/{p['pool']}"
        tail = f" {p['bytes']}B" if p.get("bytes") else ""
        lines.append(f"  {p['phase']:<{wname}} |{bar}| "
                     f"{p['ms']:>9.3f}ms {where}{tail}")
    return "\n".join(lines)


def format_journeys(resp: Optional[dict]) -> str:
    """Compact multi-journey listing (the console's journeys panel):
    one line per journey, newest first."""
    if not resp or not resp.get("journeys"):
        return "journeys: none recorded"
    st = resp.get("stats") or {}
    lines = [f"journeys: {len(resp['journeys'])} shown, "
             f"{st.get('completed', 0)} completed, "
             f"{st.get('resident', 0)}/{st.get('capacity', 0)} resident"]
    for j in resp["journeys"]:
        dom = max(j.get("phases") or [],
                  key=lambda p: p["ms"], default=None)
        lines.append(
            f"  rid={j.get('rid')} tag={j.get('tag') or '-'} "
            f"{'done' if j.get('completed') else 'live'} "
            f"e2e={j.get('e2e_ms') if j.get('e2e_ms') is not None else '?'}ms "
            f"pools={'>'.join(j.get('pools') or []) or '-'} "
            f"dom={dom['phase'] + ':' + format(dom['ms'], '.1f') + 'ms' if dom else '-'}"
            + (f" handoff={j['handoff_ms']}ms/{j.get('handoff_bytes', 0)}B"
               if j.get("handoff_ms") is not None else ""))
    return "\n".join(lines)


def format_slowlog(slow: Optional[dict]) -> str:
    if not slow:
        return "slowlog: empty"
    worst = slow.get("worst", [])
    lines = [f"slowlog: worst {len(worst)} of "
             f"{slow.get('recorded', 0)} recorded"]
    for e in worst:
        hops = e.get("replica_hops") or []
        where = ("replicas=" + ">".join(str(h) for h in hops)
                 + f" first_tok@r{e.get('replica_first_token')} "
                 f"migrations={e.get('migrations', 0)} "
                 if hops else "")
        # the pool that retired the request and its handoff
        # cost render only when present (older entries and
        # unified fleets carry neither)
        pool = f"pool={e['pool']} " if e.get("pool") else ""
        hand = (f"handoff={e['handoff_ms']}ms/{e.get('handoff_bytes', 0)}B "
                if e.get("handoff_ms") is not None else "")
        lines.append(
            f"  rid={e.get('rid')} tag={e.get('tag') or '-'} "
            f"e2e={e.get('e2e_ms')}ms ttft={e.get('ttft_ms')}ms "
            f"itl_max={e.get('itl_max_ms')}ms"
            f"@tok{e.get('itl_max_at_token')} "
            f"queue={e.get('queue_wait_ms')}ms "
            f"chunks={e.get('prefill_chunks')} "
            f"{pool}{hand}"
            f"{where}"
            f"tokens={e.get('tokens')}")
    return "\n".join(lines)


_SEV_MARK = {"page": "!!", "warn": " !", "info": "  "}


def format_alerts(alerts: Optional[dict], *, all_rules: bool = False
                  ) -> str:
    """The alert state table (the daemon's ``alerts`` response).  By
    default only non-OK rows render (plus a one-line summary); with
    ``all_rules`` every rule shows — the console's full view."""
    if not alerts or not alerts.get("rules"):
        return "alerts: no rules installed (sampler off?)"
    rows = alerts.get("alerts", [])
    shown = rows if all_rules else [
        r for r in rows if r["state"] != "ok"]
    head = (f"alerts: {alerts.get('firing', 0)} firing, "
            f"{alerts.get('pending', 0)} pending "
            f"({alerts.get('rules', 0)} rules)")
    if not shown:
        return head + " — all quiet"
    lines = [head]
    w = max(len(r["rule"]) for r in shown)
    for r in shown:
        val = r.get("value")
        extra = ""
        if r["state"] == "firing" and r.get("firing_for_s") is not None:
            extra = f" for {r['firing_for_s']:.0f}s"
        elif r["state"] == "resolved" and r.get(
                "resolved_ago_s") is not None:
            extra = f" {r['resolved_ago_s']:.0f}s ago"
        lines.append(
            f"  {_SEV_MARK.get(r.get('severity'), '  ')} "
            f"{r['rule']:<{w}}  {r['state']:<8}{extra:<12} "
            f"{'' if val is None else f'value={val:.4g}  '}"
            f"{r.get('detail', '')}")
    return "\n".join(lines)


def sparkline(values: Sequence[float], width: int = 32) -> str:
    """Fixed-width unicode sparkline of ``values`` (newest right;
    longer series keep the newest ``width`` points, shorter left-pad),
    scaled to the series max.  All-zero/empty renders flat."""
    vals = list(values)[-width:]
    if len(vals) < width:
        vals = [0.0] * (width - len(vals)) + vals
    top = max(vals) if vals else 0.0
    if top <= 0:
        return _SPARK[0] * width
    out = []
    for v in vals:
        i = 0 if v <= 0 else 1 + int((len(_SPARK) - 2) * min(
            1.0, v / top))
        out.append(_SPARK[i])
    return "".join(out)


def format_history(history: Optional[dict]) -> str:
    """The ``history`` response: ring/sampler status, the windowed
    percentile summary for the latency histograms, and one sparkline
    per requested rate series."""
    if not history:
        return "history: unavailable"
    s = history.get("sampler") or {}
    head = (f"history: {history.get('samples', 0)}/"
            f"{history.get('capacity', 0)} samples"
            + (f" @ {s['interval_s']:g}s" if s.get("interval_s") else "")
            + ("" if s.get("running") else " (sampler NOT running)"))
    win = history.get("window")
    if not win:
        return head + " — no window yet"
    lines = [head + f", window {win.get('seconds', 0):g}s"]
    hists = win.get("histograms") or {}
    for name in LATENCY_METRICS:
        h = hists.get(name)
        if not h or not h.get("count"):
            continue
        lines.append(f"  {name:<20} n={h['count']:<6} "
                     f"p50={h.get('p50_ms', 0):.2f}ms "
                     f"p90={h.get('p90_ms', 0):.2f}ms "
                     f"p99={h.get('p99_ms', 0):.2f}ms")
    series = history.get("series") or {}
    if series:
        w = max(len(n) for n in series)
        for name, pts in series.items():
            rates = [v for _, v in pts]
            cur = rates[-1] if rates else 0.0
            lines.append(f"  {name:<{w}} {sparkline(rates)} "
                         f"{cur:,.1f}/s")
    return "\n".join(lines)
