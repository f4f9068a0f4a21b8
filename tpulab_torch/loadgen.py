"""Trace-driven load generator: seeded, replayable serving traffic.

Every BENCH_* serving number so far is steady-state tokens/s on
synthetic waves — exactly the metric production serving comparisons do
NOT report (PAPERS.md arXiv:2605.25645 reports TTFT/ITL under load).
Production serving is judged by **goodput**: the fraction of requests
completed within their SLO under realistic bursty, heavy-tailed
traffic.  This module builds that traffic:

* **arrival processes** — ``poisson`` (memoryless, the steady-state
  story), ``onoff`` (bursty: exponential ON periods at a multiplied
  rate separated by exponential silences — the queue-building story),
  and ``ramp`` (a piecewise-constant rate schedule that steps ~10x
  mid-trace and back — the autoscaling story);
* **heavy-tailed sizes** — lognormal prompt lengths and output budgets
  (clamped to the daemon's serving window);
* **multi-turn sessions** — a follow-up turn extends its parent's
  prompt verbatim, so the engine's exact-match prefix cache sees the
  reuse a chat workload produces;
* **per-class SLOs** — each request draws a class
  (:class:`SLOClass`) carrying ``priority``/``deadline_ms`` for the
  daemon's shedding/preemption machinery plus the TTFT/ITL/e2e budgets
  goodput is scored against;
* **mid-stream cancellations** — a fraction of requests hang up after
  ``cancel_after_ms`` (the replay client closes its socket mid-stream,
  driving the daemon's abandoned-stream cancel path).

A trace is built ONCE from a seeded spec (:func:`build_trace`) and
serialized to JSON (:meth:`Trace.to_json` is byte-deterministic:
building the same spec twice yields identical bytes), so a run is
exactly replayable and a committed trace file IS the workload
definition.  :func:`replay` drives a live daemon with the trace
(client-observed TTFT/ITL/e2e per request, streamed chunk frames,
shed/cancel accounting) and :func:`summarize` folds the outcomes into
per-class goodput-under-SLO.  This is the port's own copy of
``tpulab.loadgen`` (its traces are byte-equal for the same spec and
seed): importing ``tpulab``'s imports jax, which a CUDA deployment of
the port need not have, so ``chip_smoke.py`` phase 12 replays through
this one.

The module is stdlib-only on purpose: nothing here touches a device
API, so the replay path never pays for, or serializes on, a device init.
"""

from __future__ import annotations

import heapq
import json
import math
import pathlib
import random
import re
import socket
import struct
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: shed response contract (tpulab_torch.daemon.ShedError, and the fleet
#: layer's RebuildingError — a rolling restart's brief whole-fleet
#: park): an error frame whose body matches this is backpressure, not
#: a failure — honor the retry-after.  Group 1 is the ARM (``shed`` =
#: load shedding, ``rebuilding`` = the fleet's drain park), group 2
#: the retry-after ms: the two must stay distinguishable client-side
#: too, or a rolling restart would masquerade as load shedding in
#: goodput accounting (the same separation RebuildingError keeps
#: server-side).  Round 20: a disaggregated fleet's pool-scoped park
#: (``PoolRebuildingError``) tags the frame ``rebuilding pool=<role>
#: retry_after_ms=N`` — the optional non-capturing pool tag keeps the
#: group numbering stable, so a pool park parses exactly like a
#: whole-fleet park (same arm, same retry); ``tpulab.loadgen.SHED_RE``
#: is the same pattern.
SHED_RE = re.compile(
    r"(shed|rebuilding)(?: pool=[\w-]+)? retry_after_ms=(\d+)")

#: deterministic filler vocabulary for prompt text (ASCII, so traces
#: stay readable and JSON stays byte-stable)
_WORDS = ("data", "model", "token", "block", "cache", "batch", "query",
          "shard", "prefix", "decode", "tensor", "kernel", "stream",
          "sample", "weight", "fetch")


@dataclass(frozen=True)
class SLOClass:
    """One traffic class: its share of arrivals, the wire fields the
    daemon acts on (``priority`` ranks KV-pressure preemption;
    ``deadline_ms`` opts into queue-wait shedding), and the
    client-observed budgets goodput is scored against."""

    name: str
    weight: float = 1.0
    priority: int = 0
    deadline_ms: Optional[float] = None
    ttft_ms: float = 30000.0
    itl_ms: float = 5000.0
    e2e_ms: float = 60000.0


#: default mix: latency-sensitive interactive traffic that sheds under
#: pressure, over best-effort bulk that absorbs it
DEFAULT_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("interactive", weight=0.6, priority=2, deadline_ms=8000.0,
             ttft_ms=15000.0, itl_ms=2000.0, e2e_ms=30000.0),
    SLOClass("bulk", weight=0.4, priority=0, deadline_ms=None,
             ttft_ms=30000.0, itl_ms=5000.0, e2e_ms=60000.0),
)


@dataclass(frozen=True)
class TraceSpec:
    """Everything :func:`build_trace` needs; fully determines the trace
    together with nothing else (all randomness flows from ``seed``)."""

    name: str = "trace"
    seed: int = 0
    n_requests: int = 64
    #: "poisson" | "onoff" | "ramp"
    arrival: str = "poisson"
    rate_rps: float = 8.0
    #: onoff burst shape: exponential ON/OFF period means, and the rate
    #: multiplier applied inside bursts
    on_ms: float = 800.0
    off_ms: float = 600.0
    burst_factor: float = 2.5
    #: ramp arrival: a piecewise-constant rate schedule of
    #: ``(start_ms, rate_rps)`` segments — the autoscale story (the
    #: arrival rate steps ~10x mid-trace and back down).  Empty for
    #: the other arrival kinds (defaulted so their committed trace
    #: JSON stays byte-stable).
    ramp_schedule: Tuple[Tuple[float, float], ...] = ()
    #: heavy-tail prompt bytes (lognormal around the median), clamped
    prompt_median: int = 48
    prompt_sigma: float = 0.6
    prompt_min: int = 8
    prompt_max: int = 192
    #: heavy-tail output budget (tokens), clamped
    steps_median: int = 16
    steps_sigma: float = 0.7
    steps_min: int = 4
    steps_max: int = 48
    #: multi-turn sessions: follow-up probability, turn cap, think-time
    #: range, and the per-token service estimate used ONLY to schedule
    #: a follow-up after its parent plausibly finished
    p_followup: float = 0.35
    max_turns: int = 3
    think_ms: Tuple[float, float] = (300.0, 1200.0)
    est_ms_per_token: float = 30.0
    #: mid-stream cancellations: fraction, and the hang-up delay range
    p_cancel: float = 0.1
    cancel_ms: Tuple[float, float] = (150.0, 900.0)
    #: prompt + steps cap (the daemon's serving window is 512)
    max_total: int = 500
    #: shared system-prompt headers (the hierarchical-cache tier's
    #: traffic shape): > 0 prepends one of ``n_system_prompts``
    #: deterministic headers of this many bytes to every ROOT prompt,
    #: drawn from a child rng so the request schedule of specs that
    #: leave this at 0 is unchanged.  Deep block-aligned sharing: every
    #: session opening with the same header re-walks the same prefix.
    system_prompt_len: int = 0
    n_system_prompts: int = 1
    classes: Tuple[SLOClass, ...] = DEFAULT_CLASSES


#: named specs the gate and the evidence queue reference by name —
#: "fast" is the host-only CI tier (small, bursty, every feature
#: exercised: sessions, cancels, deadline/priority mix); "steady" is
#: the longer poisson capture for on-chip runs
SPECS: Dict[str, TraceSpec] = {
    "fast": TraceSpec(name="fast", seed=12, n_requests=36, arrival="onoff",
                      rate_rps=8.0,
                      # hang up fast enough to catch the CPU tier's
                      # short service times mid-stream
                      cancel_ms=(20.0, 120.0)),
    "steady": TraceSpec(name="steady", seed=7, n_requests=200,
                        arrival="poisson", rate_rps=12.0),
    # the fleet chaos tier (tools/goodput_gate.py --chaos): longer
    # output budgets keep requests IN FLIGHT when the fault schedule
    # kills/wedges replicas mid-trace, and the classes carry no
    # deadline — the acceptance gate requires every non-cancelled
    # request to COMPLETE (migration, not shedding, absorbs the
    # failures), so deadline-shedding must not be in play
    "chaos": TraceSpec(
        name="chaos", seed=21, n_requests=32, arrival="onoff",
        rate_rps=8.0, steps_median=24, steps_sigma=0.5, steps_min=8,
        steps_max=48, p_cancel=0.08, cancel_ms=(30.0, 200.0),
        classes=(
            SLOClass("interactive", weight=0.6, priority=2,
                     deadline_ms=None, ttft_ms=20000.0, itl_ms=5000.0,
                     e2e_ms=45000.0),
            SLOClass("bulk", weight=0.4, priority=0, deadline_ms=None,
                     ttft_ms=40000.0, itl_ms=10000.0, e2e_ms=90000.0),
        )),
    # the elastic-fleet tier (tools/goodput_gate.py --spec ramp
    # --autoscale): a quiet floor phase, a ~10x arrival-rate step that
    # the autoscaler + brownout ladder must absorb, and a short tail
    # for the decay story.  Classes carry no deadline (the acceptance
    # gate requires every non-cancelled request to COMPLETE — scaling
    # and brownout, not shedding, absorb the burst) and ``steps_max``
    # stays at/below the default brownout token cap so an engaged
    # cap rung cannot change any stream's bytes mid-gate.
    "ramp": TraceSpec(
        name="ramp", seed=33, n_requests=56, arrival="ramp",
        rate_rps=2.0,
        ramp_schedule=((0.0, 2.0), (6000.0, 20.0), (8000.0, 2.0)),
        steps_median=24, steps_sigma=0.5, steps_min=8, steps_max=48,
        p_cancel=0.05, cancel_ms=(30.0, 200.0),
        classes=(
            SLOClass("interactive", weight=0.6, priority=2,
                     deadline_ms=None, ttft_ms=30000.0, itl_ms=10000.0,
                     e2e_ms=60000.0),
            SLOClass("bulk", weight=0.4, priority=0, deadline_ms=None,
                     ttft_ms=60000.0, itl_ms=15000.0, e2e_ms=120000.0),
        )),
    # the hierarchical-cache tier (tools/goodput_gate.py --prefix-cache):
    # heavy shared-prefix traffic — every root prompt opens with one of
    # four 96-byte system headers, long prompts, multi-turn sessions
    # that extend their parents verbatim — sized so the distinct
    # block-aligned working set is >= 4x the daemon's 128-block HBM
    # pool (the gate recomputes and asserts this from the trace
    # itself).  No cancels and no deadlines: the acceptance gate
    # requires EVERY stream bit-identical to a spill-disabled
    # reference, so shedding and hang-ups must not be in play.
    "prefix": TraceSpec(
        name="prefix", seed=41, n_requests=96, arrival="poisson",
        rate_rps=14.0, prompt_median=208, prompt_sigma=0.45,
        prompt_min=160, prompt_max=384, steps_median=8, steps_sigma=0.5,
        steps_min=4, steps_max=12, p_followup=0.55, max_turns=4,
        think_ms=(120.0, 500.0), est_ms_per_token=20.0, p_cancel=0.0,
        system_prompt_len=96, n_system_prompts=4,
        classes=(
            SLOClass("interactive", weight=0.7, priority=2,
                     deadline_ms=None, ttft_ms=30000.0, itl_ms=10000.0,
                     e2e_ms=60000.0),
            SLOClass("bulk", weight=0.3, priority=0, deadline_ms=None,
                     ttft_ms=60000.0, itl_ms=15000.0, e2e_ms=120000.0),
        )),
    # the disaggregated-serving tier (tools/goodput_gate.py --disagg):
    # a HEAVY-TAIL prompt mix — most arrivals are short interactive
    # turns, but the lognormal tail regularly lands near-max prompts
    # whose long prefills would steal decode ticks on a unified engine.
    # On the pool-spec'd fleet those prefills saturate the PREFILL
    # pool while the decode pool's ITL stays flat — the headline the
    # gate scores.  Short output budgets keep many streams decoding
    # concurrently with the long prefills; no cancels and no deadlines
    # (the acceptance gate requires every handed-off stream
    # bit-identical to the unified-serving goldens, so shedding and
    # hang-ups must not be in play).
    "disagg": TraceSpec(
        name="disagg", seed=47, n_requests=48, arrival="poisson",
        rate_rps=10.0, prompt_median=48, prompt_sigma=1.4,
        prompt_min=16, prompt_max=448, steps_median=12,
        steps_sigma=0.4, steps_min=6, steps_max=24, p_followup=0.25,
        max_turns=2, think_ms=(120.0, 500.0), est_ms_per_token=20.0,
        p_cancel=0.0,
        classes=(
            SLOClass("interactive", weight=0.7, priority=2,
                     deadline_ms=None, ttft_ms=30000.0, itl_ms=10000.0,
                     e2e_ms=60000.0),
            SLOClass("bulk", weight=0.3, priority=0, deadline_ms=None,
                     ttft_ms=60000.0, itl_ms=15000.0, e2e_ms=120000.0),
        )),
}


def built_in_spec(name: str) -> TraceSpec:
    try:
        return SPECS[name]
    except KeyError:
        raise ValueError(
            f"unknown spec {name!r}; expected one of {sorted(SPECS)}")


def _arrivals(spec: TraceSpec, rng: random.Random):
    """Yield arrival times (ms from trace start), forever."""
    t = 0.0
    if spec.arrival == "poisson":
        gap_ms = 1e3 / spec.rate_rps
        while True:
            t += rng.expovariate(1.0) * gap_ms
            yield t
    elif spec.arrival == "onoff":
        burst_gap_ms = 1e3 / (spec.rate_rps * spec.burst_factor)
        while True:
            on_end = t + rng.expovariate(1.0) * spec.on_ms
            while True:
                t += rng.expovariate(1.0) * burst_gap_ms
                if t >= on_end:
                    break
                yield t
            t = on_end + rng.expovariate(1.0) * spec.off_ms
    elif spec.arrival == "ramp":
        # piecewise-constant rate: each inter-arrival gap is drawn at
        # the rate of the segment the CURRENT time falls in (a gap may
        # overshoot a boundary — the standard piecewise approximation,
        # still fully determined by the seed).  Before the first
        # segment's start the first segment's rate applies.
        sched = sorted((float(at), float(r))
                       for at, r in spec.ramp_schedule)
        if not sched:
            raise ValueError(
                "arrival='ramp' needs a non-empty ramp_schedule")
        if any(r <= 0 for _, r in sched):
            raise ValueError("ramp_schedule rates must be > 0")
        while True:
            rate = sched[0][1]
            for at, r in sched:
                if at <= t:
                    rate = r
            t += rng.expovariate(1.0) * (1e3 / rate)
            yield t
    else:
        raise ValueError(
            f"arrival={spec.arrival!r}; expected 'poisson', 'onoff', "
            f"or 'ramp'")


def _lognormal_int(rng: random.Random, median: int, sigma: float,
                   lo: int, hi: int) -> int:
    """Heavy-tailed integer draw: lognormal with the given median,
    clamped to [lo, hi]."""
    v = int(round(math.exp(rng.gauss(math.log(max(1, median)), sigma))))
    return max(lo, min(hi, v))


def _text(rng: random.Random, n_bytes: int, prefix: str = "") -> str:
    """Deterministic ASCII filler of exactly ``n_bytes`` (>= len(prefix)
    or the prefix is truncated — callers size prompts first)."""
    parts = [prefix]
    size = len(prefix)
    while size < n_bytes:
        w = _WORDS[rng.randrange(len(_WORDS))]
        parts.append(w + " ")
        size += len(w) + 1
    return "".join(parts)[:n_bytes]


def _pick_class(rng: random.Random, classes: Sequence[SLOClass]) -> SLOClass:
    total = sum(c.weight for c in classes)
    x = rng.random() * total
    for c in classes:
        x -= c.weight
        if x < 0:
            return c
    return classes[-1]


class Trace:
    """A built trace: the spec it came from (provenance), the class
    table goodput is scored against, and the request schedule sorted by
    send time.  ``to_json``/``from_json`` round-trip exactly —
    ``to_json`` is byte-deterministic (sorted keys, fixed separators),
    so two builds of the same spec compare equal as BYTES."""

    VERSION = 1

    def __init__(self, spec: dict, classes: List[dict],
                 requests: List[dict]):
        self.spec = spec
        self.classes = classes
        self.requests = requests

    def to_json(self) -> str:
        return json.dumps(
            {"version": self.VERSION, "spec": self.spec,
             "classes": self.classes, "requests": self.requests},
            sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        obj = json.loads(text)
        if obj.get("version") != cls.VERSION:
            raise ValueError(
                f"trace version {obj.get('version')!r} != {cls.VERSION}")
        return cls(obj["spec"], obj["classes"], obj["requests"])

    def save(self, path) -> None:
        pathlib.Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "Trace":
        return cls.from_json(pathlib.Path(path).read_text())


def build_trace(spec: TraceSpec) -> Trace:
    """Deterministically expand a spec into a request schedule.

    Event-driven merge of the arrival stream (new sessions) with the
    follow-up heap (scheduled turns): each event consumes rng draws in
    a FIXED order, so the same spec always yields the same trace —
    byte-identical JSON (the replayability acceptance criterion)."""
    rng = random.Random(spec.seed)
    # shared system-prompt headers from a CHILD rng: specs that leave
    # system_prompt_len at 0 consume exactly the draws they always did,
    # so their committed traces stay byte-stable
    sys_prompts: List[str] = []
    if spec.system_prompt_len > 0:
        hrng = random.Random((spec.seed << 8) ^ 0x517)
        sys_prompts = [
            _text(hrng, spec.system_prompt_len, prefix=f"<sys{i}> ")
            for i in range(max(1, spec.n_system_prompts))]
    arrivals = _arrivals(spec, rng)
    followups: list = []  # (t_ms, seq, session, turn, parent_prompt)
    requests: List[dict] = []
    next_arrival = next(arrivals)
    session = 0
    seq = 0
    while len(requests) < spec.n_requests:
        if followups and followups[0][0] <= next_arrival:
            t_ms, _, sid, turn, parent_prompt = heapq.heappop(followups)
            prompt = None  # built below from the parent
        else:
            t_ms, sid, turn, parent_prompt = next_arrival, session, 0, None
            session += 1
            next_arrival = next(arrivals)
        cls = _pick_class(rng, spec.classes)
        steps = _lognormal_int(rng, spec.steps_median, spec.steps_sigma,
                               spec.steps_min, spec.steps_max)
        if parent_prompt is None:
            plen = _lognormal_int(rng, spec.prompt_median, spec.prompt_sigma,
                                  spec.prompt_min,
                                  min(spec.prompt_max,
                                      spec.max_total - steps))
            prefix = f"[{cls.name}] "
            if sys_prompts:
                prefix = (sys_prompts[rng.randrange(len(sys_prompts))]
                          + prefix)
                plen = max(plen, len(prefix) + 8)
            prompt = _text(rng, plen, prefix=prefix)
        else:
            # the follow-up EXTENDS its parent's prompt verbatim — the
            # engine's exact-match prefix cache sees the parent's
            # registered prefill blocks as a block-aligned prefix hit
            extra = _lognormal_int(rng, max(8, spec.prompt_median // 2),
                                   spec.prompt_sigma, 8, spec.prompt_max)
            room = spec.max_total - steps - len(parent_prompt)
            if room < 8:
                continue  # session hit the serving window: ends here
            prompt = parent_prompt + _text(rng, min(extra, room),
                                           prefix=f" <t{turn}> ")
        cancel_after_ms = None
        if rng.random() < spec.p_cancel:
            cancel_after_ms = round(rng.uniform(*spec.cancel_ms), 3)
        requests.append({
            "i": len(requests),
            "t_ms": round(t_ms, 3),
            "cls": cls.name,
            "session": sid,
            "turn": turn,
            "prompt": prompt,
            "steps": steps,
            "priority": cls.priority,
            "deadline_ms": cls.deadline_ms,
            "cancel_after_ms": cancel_after_ms,
        })
        if (cancel_after_ms is None and turn + 1 < spec.max_turns
                and rng.random() < spec.p_followup):
            think = rng.uniform(*spec.think_ms)
            est_service = steps * spec.est_ms_per_token
            seq += 1
            heapq.heappush(followups, (t_ms + est_service + think, seq,
                                       sid, turn + 1, prompt))
    requests.sort(key=lambda r: (r["t_ms"], r["i"]))
    for i, r in enumerate(requests):
        r["i"] = i
    classes = [asdict(c) for c in spec.classes]
    return Trace(asdict(spec), classes, requests)


# ------------------------------------------------------------------ replay
class _Cancelled(Exception):
    """The request's scripted hang-up point arrived mid-stream."""


def _read_exact(s: socket.socket, n: int, cancel_at: Optional[float],
                deadline: float) -> bytes:
    """Read exactly n bytes, polling so a scripted cancel or the hard
    deadline can interrupt a stalled stream."""
    buf = b""
    while len(buf) < n:
        now = time.monotonic()
        if cancel_at is not None and now >= cancel_at:
            raise _Cancelled
        if now >= deadline:
            raise TimeoutError("replay request deadline exceeded")
        bound = deadline if cancel_at is None else min(deadline, cancel_at)
        s.settimeout(max(0.01, min(0.25, bound - now)))
        try:
            r = s.recv(n - len(buf))
        except socket.timeout:
            continue
        if not r:
            raise ConnectionError("daemon closed mid-frame")
        buf += r
    return buf


def _blank_result(r: dict, tag: str) -> dict:
    """The one outcome-dict initializer — `_run_one` fills it in and
    `replay`'s timed-out-thread fallback returns it as-is, so the two
    sites can never drift a field apart."""
    return {
        "i": r["i"], "cls": r["cls"], "tag": tag, "session": r["session"],
        "turn": r["turn"], "t_sched_ms": r["t_ms"], "steps": r["steps"],
        "ok": False, "shed": False, "rebuilding": False,
        "cancelled": False, "error": None,
        "retry_after_ms": None, "ttft_ms": None, "e2e_ms": None,
        "itl_max_ms": 0.0, "n_chunks": 0, "bytes_out": 0,
        # output identity + stream integrity (the chaos gate's
        # zero-lost/duplicated-token evidence): ``sha`` hashes the
        # terminal frame's full output; ``stream_ok`` is whether the
        # streamed chunk concatenation equals that output exactly
        # (None when nothing streamed before the terminal frame)
        "sha": None, "stream_ok": None,
        # crash-durable serving (round 16): connections re-established
        # after a refused/reset socket (a daemon restart), and whether
        # the stream was continued by rid via the daemon's ``resume``
        # request instead of being resubmitted
        "reconnects": 0, "resumed": False,
    }


def _run_one(socket_path: str, r: dict, tag: str, timeout_s: float) -> dict:
    """Send one trace request; measure the client-observed span.

    Crash-durable path (round 16): the request carries its tag as the
    durable ``rid``, and a connection refused/reset mid-request — a
    daemon restart, the process-death analogue of the ``rebuilding``
    park — triggers a jittered-backoff reconnect that CONTINUES the
    stream by rid (``resume`` request, received-count = bytes already
    held) instead of resubmitting.  The streamed concatenation therefore
    stays gap- and duplicate-free across the crash, and ``stream_ok``
    against the terminal frame proves it.  A daemon without a journal
    answers ``resume unknown rid``: if nothing had streamed yet the
    client falls back to one fresh submission (old behaviour); if bytes
    HAD streamed it reports the error rather than resubmit-and-
    duplicate."""
    import random as _random

    out = _blank_result(r, tag)
    config = {"steps": r["steps"], "stream": True,
              "priority": r["priority"], "tag": tag, "rid": tag}
    if r.get("deadline_ms") is not None:
        config["deadline_ms"] = r["deadline_ms"]
    gen_header = json.dumps({"lab": "generate", "config": config}).encode()
    payload = r["prompt"].encode("utf-8")
    t_send = time.monotonic()
    deadline = t_send + timeout_s
    cancel_at = (t_send + r["cancel_after_ms"] / 1e3
                 if r.get("cancel_after_ms") is not None else None)
    rng = _random.Random(tag)
    t_prev = None
    streamed = b""
    mode = "generate"
    while True:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout_s)
        try:
            s.connect(socket_path)
            if mode == "generate":
                header, body_out = gen_header, payload
            else:
                header = json.dumps({
                    "lab": "resume",
                    "config": {"rid": tag, "received": len(streamed),
                               "stream": True}}).encode()
                body_out = b""
            s.sendall(struct.pack("<I", len(header)) + header
                      + struct.pack("<Q", len(body_out)) + body_out)
            while True:
                status = _read_exact(s, 1, cancel_at, deadline)[0]
                (n,) = struct.unpack(
                    "<Q", _read_exact(s, 8, cancel_at, deadline))
                body = _read_exact(s, n, cancel_at, deadline)
                now = time.monotonic()
                if status == 2:  # streamed chunk: client-observed ticks
                    out["n_chunks"] += 1
                    streamed += body
                    if out["ttft_ms"] is None:
                        out["ttft_ms"] = round((now - t_send) * 1e3, 3)
                    elif t_prev is not None:
                        out["itl_max_ms"] = round(
                            max(out["itl_max_ms"], (now - t_prev) * 1e3),
                            3)
                    t_prev = now
                    continue
                if status == 0:
                    import hashlib

                    out["ok"] = True
                    out["e2e_ms"] = round((now - t_send) * 1e3, 3)
                    out["bytes_out"] = len(body)
                    out["sha"] = hashlib.sha256(body).hexdigest()[:16]
                    if out["n_chunks"]:
                        # the terminal frame carries the FULL output
                        # with chunks included: exact equality of the
                        # streamed concatenation is the zero-lost/
                        # duplicated-token check a migrated/hedged/
                        # resumed stream must pass
                        out["stream_ok"] = streamed == body
                    return out
                text = body.decode("utf-8", "replace")
                if (mode == "resume" and not streamed
                        and "resume unknown rid" in text):
                    # the crash predated the accept record (or the
                    # daemon runs without a journal): nothing was ever
                    # admitted, so ONE fresh submission cannot
                    # duplicate anything
                    mode = "generate"
                    out["resumed"] = False
                    break
                shed = SHED_RE.search(text)
                if shed:
                    # both arms are backpressure, but they are NOT the
                    # same outcome: "shed" is the daemon refusing load,
                    # "rebuilding" is a rolling restart's drain park
                    out["shed" if shed.group(1) == "shed"
                        else "rebuilding"] = True
                    out["retry_after_ms"] = int(shed.group(2))
                else:
                    out["error"] = text[-300:]
                return out
        except _Cancelled:
            # scripted mid-stream hang-up: closing the socket (finally)
            # breaks the daemon's chunk stream, which cancels the
            # request
            out["cancelled"] = True
            return out
        except (OSError, ConnectionError, TimeoutError) as e:
            # connection refused/reset: the daemon-restart park.  Back
            # off with full jitter and reconnect in resume mode —
            # UNLESS the request's own deadline is spent, which stays a
            # hard failure exactly as before.
            if time.monotonic() >= deadline - 0.05:
                out["error"] = f"{type(e).__name__}: {e}"
                return out
            out["reconnects"] += 1
            mode = "resume"
            out["resumed"] = True
            backoff = rng.uniform(
                0.05, 0.05 * (2 ** min(out["reconnects"], 5)))
            time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
        finally:
            s.close()


def replay(trace: Trace, socket_path: str, *, time_scale: float = 1.0,
           timeout_s: float = 120.0,
           log=None) -> Tuple[List[dict], float]:
    """Replay a trace against a live daemon.

    Requests fire at ``t_ms * time_scale`` from replay start (scale 0 =
    as fast as the scheduler loop can spawn them), each on its own
    thread so a slow request never delays the schedule behind it.
    Returns (per-request outcome list in trace order, wall seconds).
    The schedule itself is deterministic — all wall-clock jitter is in
    the measured latencies, never in what was sent."""
    results: List[Optional[dict]] = [None] * len(trace.requests)
    threads = []
    name = trace.spec.get("name", "trace")
    t0 = time.monotonic()

    def runner(idx: int, req: dict):
        tag = f"{name}:{idx:05d}:{req['cls']}"
        results[idx] = _run_one(socket_path, req, tag, timeout_s)

    for req in trace.requests:
        due = t0 + (req["t_ms"] / 1e3) * time_scale
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=runner, args=(req["i"], req),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s)
    wall_s = time.monotonic() - t0
    for i, res in enumerate(results):
        if res is None:
            out = _blank_result(trace.requests[i], "")
            out["error"] = "replay thread timed out"
            results[i] = out
    if log:
        done = sum(1 for r in results if r["ok"])
        log(f"[loadgen] {name}: {done}/{len(results)} completed in "
            f"{wall_s:.1f}s")
    return [r for r in results if r is not None], wall_s


# --------------------------------------------------------------- goodput
def summarize(results: List[dict], trace: Trace, wall_s: float) -> dict:
    """Fold per-request outcomes into goodput-under-SLO.

    A request is GOOD when it completed AND met every one of its
    class's budgets (client-observed TTFT, worst inter-token gap, e2e).
    ``attainment`` divides by the eligible population (everything
    except scripted cancellations — a request the client hung up on is
    neither good nor bad); sheds, rebuilding parks, and errors count
    AGAINST attainment (the request was not served inside the window),
    but sheds and parks are tallied SEPARATELY — a rolling restart's
    drain park must not masquerade as load shedding (the distinction
    tpulab_torch.daemon.RebuildingError keeps server-side).
    ``goodput_tokens_per_s`` is
    the byte-LM token output of good requests over the replay wall
    time — the headline number the regression gate ratchets."""
    classes = {c["name"]: c for c in trace.classes}
    per: Dict[str, dict] = {}
    for c in trace.classes:
        per[c["name"]] = {
            "n": 0, "completed": 0, "shed": 0, "rebuilding": 0,
            "cancelled": 0, "errors": 0,
            "slo_ttft": 0, "slo_itl": 0, "slo_e2e": 0, "in_slo": 0,
            "goodput_tokens": 0,
            "budgets_ms": {"ttft": c["ttft_ms"], "itl": c["itl_ms"],
                           "e2e": c["e2e_ms"]},
        }
    for r in results:
        c = classes[r["cls"]]
        p = per[r["cls"]]
        p["n"] += 1
        if r["cancelled"]:
            p["cancelled"] += 1
            continue
        if r["shed"]:
            p["shed"] += 1
            continue
        if r.get("rebuilding"):
            p["rebuilding"] += 1
            continue
        if not r["ok"]:
            p["errors"] += 1
            continue
        p["completed"] += 1
        ok_ttft = r["ttft_ms"] is not None and r["ttft_ms"] <= c["ttft_ms"]
        ok_itl = r["itl_max_ms"] <= c["itl_ms"]
        ok_e2e = r["e2e_ms"] is not None and r["e2e_ms"] <= c["e2e_ms"]
        p["slo_ttft"] += ok_ttft
        p["slo_itl"] += ok_itl
        p["slo_e2e"] += ok_e2e
        if ok_ttft and ok_itl and ok_e2e:
            p["in_slo"] += 1
            p["goodput_tokens"] += r["bytes_out"]
    for p in per.values():
        eligible = p["n"] - p["cancelled"]
        p["attainment"] = (round(p["in_slo"] / eligible, 4)
                           if eligible else None)
    tot = {k: sum(p[k] for p in per.values())
           for k in ("n", "completed", "shed", "rebuilding", "cancelled",
                     "errors", "in_slo", "goodput_tokens")}
    eligible = tot["n"] - tot["cancelled"]
    return {
        "classes": per,
        "overall": {
            **tot,
            "attainment": (round(tot["in_slo"] / eligible, 4)
                           if eligible else None),
            "wall_s": round(wall_s, 3),
            "goodput_tokens_per_s": (round(tot["goodput_tokens"] / wall_s, 2)
                                     if wall_s > 0 else 0.0),
        },
    }
