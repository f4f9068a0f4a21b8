"""Live terminal ops console for a running tpulab_torch daemon.

The port's copy of ``tools/obs_console.py``.  One screen, refreshed in
place every ``--interval`` seconds, built entirely from the daemon's
observability requests (:mod:`tpulab_torch.daemon`):

  * ``metrics``  — the latency percentile table (p50/p90/p99 TTFT /
    ITL / e2e / queue-wait / prefill) from the Prometheus scrape;
  * ``fleet``    — the per-replica health table;
  * ``history``  — windowed rates + percentiles from the
    ``--metrics-interval`` sampler ring, with unicode sparklines of
    the requested rate series (tokens/s, requests/s, ticks/s);
  * ``alerts``   — the rule-engine state table, firing first (SLO burn
    rates, recompile/occupancy tripwires, staleness);
  * ``slowlog``  — the worst-N requests by e2e, rid-linked to traces;
  * ``journey``  — the newest cross-engine request journeys: pools
    crossed, dominant phase, handoff cost per request.

All rendering is :mod:`tpulab_torch.obs.render`; the wire client is
:func:`tpulab_torch.client.request`.  Pure-stdlib, like the rest of the
obs layer.

Usage:
    python -m tpulab_torch.obs.console [--socket /tmp/tpulab.sock]
                                       [--interval 1.0] [--window 30]
                                       [--frames N | --once] [--all-rules]

``--once`` prints a single frame without ANSI clearing (scripts,
captures, tests); ``--frames N`` stops after N refreshes.  A daemon
request that fails mid-session renders as an ``unavailable`` line
instead of killing the console — a dashboard must outlive the thing it
watches.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tpulab_torch.client import request
from tpulab_torch.obs import render as R

#: default rate series the sparklines track
DEFAULT_SERIES = ("engine_tokens_out", "engine_requests_done",
                  "engine_ticks")

_CLEAR = "\x1b[H\x1b[2J"


def fetch(sock: str, *, window_s: float = 30.0,
          series: tuple = DEFAULT_SERIES, slowlog_n: int = 5,
          journeys_n: int = 4) -> dict:
    """One round of scrapes; every surface degrades independently
    (``None`` on failure) so a daemon mid-restart still renders."""
    out: dict = {}

    def grab(key, lab, config=None, decode_json=True):
        try:
            raw = request(sock, lab, config)
            out[key] = json.loads(raw) if decode_json else raw.decode()
        except Exception as e:  # noqa: BLE001 — a dashboard must
            # outlive the daemon it watches; the frame shows the gap
            out[key] = None
            out.setdefault("errors", []).append(f"{lab}: {e}")

    grab("metrics", "metrics", decode_json=False)
    grab("fleet", "fleet")
    grab("history", "history",
         {"seconds": window_s, "series": list(series)})
    grab("alerts", "alerts")
    grab("slowlog", "slowlog", {"n": slowlog_n})
    grab("journeys", "journey", {"n": journeys_n})
    return out


def render_frame(scr: dict, *, all_rules: bool = False,
                 title: str = "") -> str:
    """One console frame from a :func:`fetch` result — pure function,
    tested without a daemon (tests/test_torch_obs_render.py)."""
    metrics = {}
    if scr.get("metrics"):
        try:
            metrics = R.parse_prometheus(scr["metrics"])
        except ValueError:
            metrics = {}
    parts = [
        f"tpulab ops console{'  ' + title if title else ''}  "
        f"{time.strftime('%H:%M:%S')}",
        R.format_latency_table(R.summarize(metrics))
        if metrics else "metrics: unavailable",
        R.format_fleet(scr.get("fleet"), metrics),
        R.format_history(scr.get("history")),
        R.format_alerts(scr.get("alerts"), all_rules=all_rules),
        R.format_slowlog(scr.get("slowlog")),
        R.format_journeys(scr.get("journeys")),
    ]
    if scr.get("errors"):
        parts.append("scrape errors: " + "; ".join(scr["errors"]))
    return "\n\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--socket", default="/tmp/tpulab.sock")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh cadence in seconds")
    ap.add_argument("--window", type=float, default=30.0,
                    help="history window for rates/percentiles")
    ap.add_argument("--series", default=",".join(DEFAULT_SERIES),
                    help="comma-separated rate series to sparkline")
    ap.add_argument("--slowlog", type=int, default=5, metavar="N",
                    help="worst-N slow requests per frame")
    ap.add_argument("--journeys", type=int, default=4, metavar="N",
                    help="newest-N request journeys per frame")
    ap.add_argument("--frames", type=int, default=0, metavar="N",
                    help="stop after N frames (0 = until ^C)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame, no ANSI clear, exit")
    ap.add_argument("--all-rules", action="store_true",
                    help="show every alert rule, not just non-OK ones")
    args = ap.parse_args(argv)
    if args.interval <= 0:
        ap.error("--interval must be > 0")
    series = tuple(s for s in args.series.split(",") if s)
    shown = 0
    try:
        while True:
            scr = fetch(args.socket, window_s=args.window,
                        series=series, slowlog_n=args.slowlog,
                        journeys_n=args.journeys)
            frame = render_frame(scr, all_rules=args.all_rules,
                                 title=args.socket)
            if args.once:
                print(frame)
                return 0
            sys.stdout.write(_CLEAR + frame + "\n")
            sys.stdout.flush()
            shown += 1
            if args.frames and shown >= args.frames:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
