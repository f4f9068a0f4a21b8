"""Crash flight recorder: one self-explaining post-mortem bundle per
engine/replica failure.

When the daemon's supervisor quarantines an engine or its fleet
migrates off a crashed replica, the evidence of WHY — the last seconds
of the trace ring, the metric values at the instant of death, the slow
requests in flight, the compile ledger, the armed fault schedule —
lives in process state that the rebuild immediately starts
overwriting.  This module persists that evidence as ONE JSON bundle
under ``results/postmortems/`` at the moment of failure, so every
chaos-test failure (and every real production crash) is
self-explaining instead of reconstructable-if-you're-fast.

Bundle schema (version 1)::

    {
      "schema": 1, "reason": str, "recorded_unix": float, "pid": int,
      "error": {"type", "message"} | null,
      "engine": {"build_key", "build_stamp", "replica_index",
                 "fault_scope", "stats"} | null,
      "faults": faults.describe()          # the armed schedule + hits
      "compile_stats": COMPILESTATS.snapshot(),
      "metrics": REGISTRY.snapshot(),      # every counter/gauge/histogram
      "slowlog": SLOWLOG worst-N,
      "journeys": [...stitched cross-engine journeys (round 21) for
                   the dying engine's in-flight rids — the request the
                   crash killed explains itself across pools...],
      "alerts": [...alert rows FIRING at the time of death...],
      "trace": {"events": [...last-N chrome events...],
                "recorded": int, "dropped": int},
    }

Recording is failure-path-only (never per tick) and NEVER raises into
the supervisor that called it: a broken disk must not turn a recovered
crash into an unrecovered one.  Retention is bounded (:data:`KEEP`
newest bundles; older ones are deleted) so a crash-looping daemon
cannot fill the disk.  The daemon's ``postmortem`` request returns the
newest bundle; ``tools/obs_report.py --postmortem`` pretty-prints it.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from typing import Any, Dict, List, Optional

#: newest bundles kept on disk (older ones deleted at each record)
KEEP = 20

#: default bundle directory — resolvable from anywhere the daemon runs;
#: override with configure_flightrec() or TPULAB_POSTMORTEM_DIR
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "results" / "postmortems"

_LOCK = threading.Lock()
_DIR: Optional[pathlib.Path] = None
_SEQ = 0


def _dir() -> pathlib.Path:
    if _DIR is not None:
        return _DIR
    env = os.environ.get("TPULAB_POSTMORTEM_DIR")
    return pathlib.Path(env) if env else DEFAULT_DIR


def configure_flightrec(path) -> pathlib.Path:
    """Point the recorder at ``path`` (tests: a tmp dir; None restores
    the default/env resolution).  Returns the active directory."""
    global _DIR
    _DIR = pathlib.Path(path) if path is not None else None
    return _dir()


def _jsonable(x):
    """Best-effort JSON coercion for bundle leaves (tuples from build
    keys/histogram bounds, numpy scalars from stats)."""
    try:
        json.dumps(x)
        return x
    except TypeError:
        if isinstance(x, dict):
            return {str(k): _jsonable(v) for k, v in x.items()}
        if isinstance(x, (list, tuple, set)):
            return [_jsonable(v) for v in x]
        if hasattr(x, "item"):  # numpy scalar
            return x.item()
        return repr(x)


def _engine_section(engine) -> Optional[Dict[str, Any]]:
    if engine is None:
        return None
    out: Dict[str, Any] = {
        "build_key": _jsonable(getattr(engine, "_build_key", None)),
        "build_stamp": _jsonable(getattr(engine, "_build_stamp", None)),
        "replica_index": getattr(engine, "replica_index", None),
        "fault_scope": getattr(engine, "fault_scope", None),
    }
    try:
        out["stats"] = {k: int(v) for k, v in engine.stats().items()}
    except Exception as e:  # a corrupt engine must still yield a bundle
        out["stats"] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _journey_section(engine, n: int) -> List[Dict[str, Any]]:
    """Stitched journeys (tpulab_torch.obs.journey) for the dying engine's
    in-flight requests — pending queue + active slots — so the bundle
    carries each killed request's FULL cross-engine story (a handed-off
    request's prefill ran on another replica; per-engine state alone
    cannot explain it).  Falls back to the store's ``n`` newest when
    the engine is absent/unreadable.  Guarded like the alerts section:
    a broken journey store must not break crash recording."""
    try:
        from tpulab_torch.obs.journey import JOURNEY

        rids = []
        if engine is not None:
            for req in list(getattr(engine, "pending", None) or []):
                rids.append(getattr(req, "rid", 0))
            for req in list(getattr(engine, "active", None) or []):
                if req is not None:
                    rids.append(getattr(req, "rid", 0))
        out = []
        for rid in dict.fromkeys(r for r in rids if r):
            j = JOURNEY.snapshot(rid)
            if j is not None:
                out.append(j)
        return out if out else JOURNEY.recent(n)
    except Exception:  # noqa: BLE001
        return []


def record_postmortem(reason: str, *, engine=None, err=None,
                      trace_events: int = 1024, slow_n: int = 8,
                      extra: Optional[Dict] = None
                      ) -> Optional[pathlib.Path]:
    """Persist one post-mortem bundle; returns its path, or None when
    recording failed (never raises — see module docstring)."""
    global _SEQ
    try:
        from tpulab_torch import faults
        from tpulab_torch.obs.compilestats import COMPILESTATS
        from tpulab_torch.obs.registry import REGISTRY
        from tpulab_torch.obs.slowlog import SLOWLOG
        from tpulab_torch.obs.tracer import TRACER

        dump = TRACER.chrome_trace()
        events = dump["traceEvents"][-int(trace_events):]
        try:
            # the firing-alert set at the time of death: a crash that
            # happened UNDER an already-burning SLO reads differently
            # from one out of a clear sky (import is lazy + guarded —
            # alerts itself records bundles on page fires, and a broken
            # alert engine must not break crash recording)
            from tpulab_torch.obs.alerts import ALERTS

            firing = ALERTS.firing()
        except Exception:
            firing = []
        bundle = {
            "schema": 1,
            "reason": str(reason),
            "recorded_unix": time.time(),
            "pid": os.getpid(),
            "error": ({"type": type(err).__name__, "message": str(err)}
                      if err is not None else None),
            "engine": _engine_section(engine),
            "faults": faults.describe(),
            "compile_stats": _jsonable(COMPILESTATS.snapshot()),
            "metrics": _jsonable(REGISTRY.snapshot()),
            "slowlog": _jsonable(SLOWLOG.snapshot(slow_n)),
            "journeys": _jsonable(_journey_section(engine, slow_n)),
            "alerts": _jsonable(firing),
            "trace": {
                "events": _jsonable(events),
                "recorded": dump["otherData"]["recorded"],
                "dropped": dump["otherData"]["dropped"],
            },
        }
        if extra:
            bundle["extra"] = _jsonable(extra)
        d = _dir()
        d.mkdir(parents=True, exist_ok=True)
        with _LOCK:
            _SEQ += 1
            # monotonic stamp + pid + seq: unique and sortable even
            # when two replicas crash inside the same second
            name = (f"postmortem_{int(time.time()):d}"
                    f"_{os.getpid()}_{_SEQ:04d}.json")
            path = d / name
            path.write_text(json.dumps(bundle, indent=1,
                                       default=repr) + "\n")
            prune()
        return path
    except Exception:  # noqa: BLE001 — the recorder must never turn a
        # recovered crash into an unrecovered one
        return None


def prune(keep: Optional[int] = None) -> int:
    """Bounded retention: delete every bundle past the newest ``keep``
    (default :data:`KEEP`) — strictly OLDEST first, and never raises
    (a bundle deleted underneath us by a concurrent pruner, a
    permission error, a vanished directory all just skip).  Returns how
    many bundles were actually removed.  Called on every
    :func:`record_postmortem`; directly tested so a crash-looping
    daemon provably cannot fill the disk."""
    keep = KEEP if keep is None else max(0, int(keep))
    removed = 0
    try:
        excess = list_bundles()[keep:] if keep else list_bundles()
        # list_bundles is newest-first, so the slice IS oldest-last;
        # delete from the very oldest up so an interrupted prune leaves
        # the newest evidence intact
        for old in reversed(excess):
            try:
                old.unlink()
                removed += 1
            except OSError:
                pass
    except Exception:  # noqa: BLE001 — retention must never raise into
        # the failure path that invoked it
        return removed
    return removed


def list_bundles() -> List[pathlib.Path]:
    """Bundle paths, NEWEST first (name-sorted: stamp_pid_seq)."""
    d = _dir()
    if not d.is_dir():
        return []
    return sorted(d.glob("postmortem_*.json"), reverse=True)


def latest_postmortem() -> Optional[Dict[str, Any]]:
    """The newest bundle (parsed, with its ``path`` added), or None.
    Skips over unreadable/corrupt files rather than failing the
    request — a half-written bundle from a dying process must not mask
    the previous good one."""
    for path in list_bundles():
        try:
            bundle = json.loads(path.read_text())
            bundle["path"] = str(path)
            return bundle
        except (OSError, ValueError):
            continue
    return None
