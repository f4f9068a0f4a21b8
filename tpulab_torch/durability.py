"""Write-ahead request journal: crash durability for the serving daemon.

The port's copy of ``tpulab.durability``, with the same record format:
each package's :func:`scan` folds the other's journal to the same state.
Every other fault-tolerance layer (the supervisor's rebuild-and-replay,
the fleet's cross-replica migration) assumes the daemon *process*
survives the failure.  A SIGKILL, an OOM kill, or a spot-instance
preemption would still lose every in-flight request and every client
stream.
This module closes that gap with the standard database discipline: a
**write-ahead journal** of accepted requests, durable *before*
admission, from which a fresh daemon process rebuilds its fleet and
resumes every incomplete request through the exact replay machinery
the in-process layers already certified
(``PagedEngine.resubmit`` — greedy streams bit-identical, sampled
streams continuing their per-slot key chain).

Record schema (JSONL — one JSON object per line, append-only):

``{"t": "accept", "rid", "tag", "payload", "config"}``
    One per accepted request, appended and **fsynced before
    admission** (group commit: concurrent accepts share one fsync).
    ``rid`` is the client's durable request id (or a server-generated
    fallback), ``payload`` the base64 prompt bytes, ``config`` the
    full client config — together the request's replay recipe,
    including the engine build knobs (ckpt_dir/attn/kv_dtype/tp/
    prefill_chunk) recovery rebuilds the fleet from.

``{"t": "ckpt", "rid", "n", "tokens"}``
    Committed-prefix checkpoint at a bounded cadence
    (:attr:`Journal.ckpt_every` emitted tokens).  INCREMENTAL:
    ``tokens`` is the delta since the previous checkpoint and ``n``
    the authoritative total after it — scan stitches the chain back
    together, refusing both duplication (overlaps resolve by ``n``)
    and gaps (a gapped record is dropped, leaving the valid shorter
    prefix).  Buffered — neither flushed nor fsynced per record:
    appends are sequential, so a crash loses a SUFFIX of the chain,
    and losing checkpoints only means recovery regenerates those
    tokens, which is bit-identical by the resubmit contract.
    Checkpoint durability is an optimization, never a correctness
    input — the <1% decode-budget bench ``bench_journal_overhead``
    depends on both the buffering and the delta encoding.

``{"t": "done", "rid", "status", "tokens"?}``
    Terminal record: ``ok`` (with the full committed token stream),
    ``cancelled``, ``shed``, or ``error``.  A rid with a ``done``
    record is complete — recovery skips it and compaction drops it.

Crash tolerance on :func:`scan`: a torn FINAL line (the process died
mid-append) is ignored; an unparseable line anywhere earlier is real
corruption and raises :class:`JournalCorrupt` — silently skipping
interior records would silently drop accepted requests.

Compaction (:meth:`Journal.compact`) atomically rewrites the file
(temp file + fsync + rename) keeping only incomplete rids' accept
records and latest checkpoints, so a long-lived daemon's journal stays
proportional to its in-flight set, not its request history.

The module is dependency-free (no obs import): the daemon passes an
``on_record`` callback to count records into its registry.
"""

from __future__ import annotations

import base64
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

#: default committed-prefix checkpoint cadence (emitted tokens between
#: ``ckpt`` records); override per-journal or TPULAB_DAEMON_JOURNAL_CKPT
DEFAULT_CKPT_EVERY = 16


class JournalCorrupt(ValueError):
    """An interior journal line failed to parse: real corruption (a
    torn FINAL line is tolerated by :func:`scan`, never raised)."""


@dataclass
class JournalEntry:
    """One rid's folded journal state after a :func:`scan`."""

    rid: str
    accept: Dict = field(default_factory=dict)
    ckpt: Optional[List[int]] = None   # latest committed-prefix ckpt
    done: Optional[Dict] = None        # terminal record, if any

    @property
    def complete(self) -> bool:
        return self.done is not None


@dataclass
class JournalState:
    """Everything :func:`scan` recovered from one journal file."""

    entries: Dict[str, JournalEntry] = field(default_factory=dict)
    records: int = 0                   # parsed records
    torn: bool = False                 # final line was torn (ignored)

    def incomplete(self) -> Dict[str, JournalEntry]:
        """Accepted rids with no terminal record — the recovery set,
        in journal (acceptance) order."""
        return {rid: e for rid, e in self.entries.items()
                if not e.complete}

    def completed_ok(self) -> Dict[str, JournalEntry]:
        """Rids that retired cleanly (status ``ok``) — recovery
        re-registers their streams so a client whose terminal frame
        the crash ate can still resume-by-rid."""
        return {rid: e for rid, e in self.entries.items()
                if e.done is not None and e.done.get("status") == "ok"}


def _fold(state: JournalState, rec: Dict) -> None:
    t = rec.get("t")
    rid = str(rec.get("rid", ""))
    if not rid:
        return
    e = state.entries.get(rid)
    if t == "accept":
        if e is None:
            state.entries[rid] = JournalEntry(rid=rid, accept=rec)
        else:
            e.accept = rec
    elif t == "ckpt":
        if e is not None:
            base = e.ckpt or []
            delta = [int(x) for x in rec.get("tokens") or []]
            n = int(rec.get("n", len(base) + len(delta)))
            start = max(0, n - len(delta))
            if start > len(base):
                # a gap in the chain (an interior ckpt lost): keep the
                # valid shorter prefix — recovery just regenerates
                # more, bit-identically
                return
            e.ckpt = base[:start] + delta
    elif t == "done":
        if e is not None:
            e.done = rec


def scan(path) -> JournalState:
    """Fold a journal file into per-rid state, tolerating a torn final
    record (the one crash artifact an append-only log can legally
    carry).  A missing file scans as empty."""
    state = JournalState()
    try:
        raw = open(path, "rb").read()
    except FileNotFoundError:
        return state
    lines = raw.split(b"\n")
    # a file that ends mid-record has no trailing newline; split still
    # yields the partial tail as the last element — exactly the one
    # line allowed to fail below
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("journal record is not an object")
        except ValueError as err:
            if i >= len(lines) - 2 and not any(
                    later.strip() for later in lines[i + 1:]):
                # torn FINAL record: the fsync contract means it can
                # only be a checkpoint/done the crash interrupted —
                # ignore it and recover from what IS durable
                state.torn = True
                break
            raise JournalCorrupt(
                f"journal {path}: unparseable interior record at "
                f"line {i + 1}") from err
        _fold(state, rec)
        state.records += 1
    return state


def encode_payload(payload: bytes) -> str:
    return base64.b64encode(bytes(payload)).decode("ascii")


def decode_payload(text: str) -> bytes:
    return base64.b64decode(text.encode("ascii"))


class Journal:
    """Append-only write-ahead journal with group-commit fsync.

    Thread-safety: every append runs under the journal lock (the write
    + flush is the short critical section); the fsync an ``accept``
    needs happens OUTSIDE it under a separate commit lock, so N
    threads accepting concurrently pay ONE fsync for the group — the
    classic group-commit shape, which is what keeps the <1% decode
    budget honest under concurrent admission."""

    def __init__(self, path, *, ckpt_every: Optional[int] = None,
                 on_record: Optional[Callable[[], None]] = None):
        self.path = str(path)
        env = os.environ.get("TPULAB_DAEMON_JOURNAL_CKPT")
        self.ckpt_every = int(
            ckpt_every if ckpt_every is not None
            else (env or DEFAULT_CKPT_EVERY))
        if self.ckpt_every < 1:
            raise ValueError(
                f"ckpt_every must be >= 1, got {self.ckpt_every}")
        self._on_record = on_record
        self._lock = threading.Lock()
        self._commit_lock = threading.Lock()
        self._seq = 0          # records written+flushed
        self._synced = 0       # records covered by an fsync
        self._last_ckpt: Dict[str, int] = {}  # rid -> tokens at last ckpt
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "ab")

    # ------------------------------------------------------------ appends
    def _append(self, rec: Dict, sync: bool) -> None:
        line = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        with self._lock:
            self._f.write(line)
            # non-sync records (ckpt/done) stay in the userspace buffer
            # — no flush syscall on the decode hot path.  Losing them
            # to a crash only costs regeneration work, and a buffer cut
            # mid-record is indistinguishable from the torn final line
            # :func:`scan` already tolerates.  Accepts flush+fsync via
            # _sync_to below, which is the one durability contract.
            if sync:
                self._f.flush()
            self._seq += 1
            seq = self._seq
        if self._on_record is not None:
            self._on_record()
        if sync:
            self._sync_to(seq)

    def _sync_to(self, seq: int) -> None:
        with self._commit_lock:
            if self._synced >= seq:
                return  # a later group commit already covered us
            with self._lock:
                target = self._seq
                fd = self._f.fileno()
            os.fsync(fd)
            self._synced = target

    def append_accept(self, rid: str, tag: str, payload: bytes,
                      config: Dict) -> None:
        """Durable-before-admission: returns only once the record is
        fsynced (possibly by a concurrent accept's group commit)."""
        self._append({"t": "accept", "rid": str(rid), "tag": str(tag),
                      "payload": encode_payload(payload),
                      "config": dict(config)}, sync=True)

    def note_tokens(self, rid: str, tokens: List[int]) -> None:
        """Bounded-cadence committed-prefix checkpoint: appends an
        incremental ``ckpt`` record once ``ckpt_every`` tokens
        accumulated since the last one.  ``tokens`` is the FULL
        committed stream so far; only the delta since the previous
        checkpoint is serialized (scan stitches the chain)."""
        rid = str(rid)
        # lock-free fast path: the cadence check is one dict read + a
        # compare, and a stale read can only DELAY a checkpoint by one
        # call (the locked re-check below decides) — this is the call
        # the daemon makes per slot per decode tick, so it must cost
        # nanoseconds when no checkpoint is due
        if len(tokens) - self._last_ckpt.get(rid, 0) < self.ckpt_every:
            return
        with self._lock:
            last = self._last_ckpt.get(rid, 0)
            due = len(tokens) - last >= self.ckpt_every
            if due:
                self._last_ckpt[rid] = len(tokens)
        if due:
            self._append({"t": "ckpt", "rid": rid, "n": len(tokens),
                          "tokens": [int(t) for t in tokens[last:]]},
                         sync=False)

    def append_done(self, rid: str, status: str,
                    tokens: Optional[List[int]] = None) -> None:
        rid = str(rid)
        rec = {"t": "done", "rid": rid, "status": str(status)}
        if tokens is not None:
            rec["tokens"] = [int(t) for t in tokens]
        with self._lock:
            self._last_ckpt.pop(rid, None)
        self._append(rec, sync=False)

    # ------------------------------------------------------- maintenance
    def flush(self) -> None:
        """Flush + fsync everything appended so far (shutdown path)."""
        with self._lock:
            self._f.flush()
            seq = self._seq
        self._sync_to(seq)

    def scan(self) -> JournalState:
        self.flush()
        return scan(self.path)

    def compact(self, state: Optional[JournalState] = None) -> int:
        """Atomically rewrite the journal keeping only INCOMPLETE rids
        (their accept record + latest checkpoint).  Returns the record
        count of the compacted file.  temp-file + fsync + rename: a
        crash during compaction leaves either the old file or the new
        one, never a mix."""
        if state is None:
            state = self.scan()
        else:
            self.flush()
        tmp = self.path + ".compact.tmp"
        kept = 0
        with self._lock:
            # the delta chain restarts from the merged checkpoint the
            # rewrite emits: seed the cadence state so the NEXT
            # note_tokens appends a delta continuing from it, not a
            # full-prefix duplicate
            self._last_ckpt = {}
            with open(tmp, "wb") as out:
                for e in state.incomplete().values():
                    out.write(json.dumps(
                        e.accept, separators=(",", ":")).encode() + b"\n")
                    kept += 1
                    if e.ckpt:
                        out.write(json.dumps(
                            {"t": "ckpt", "rid": e.rid,
                             "n": len(e.ckpt), "tokens": e.ckpt},
                            separators=(",", ":")).encode() + b"\n")
                        kept += 1
                        self._last_ckpt[e.rid] = len(e.ckpt)
                out.flush()
                os.fsync(out.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
            self._seq = self._synced = kept
        return kept

    def close(self) -> None:
        try:
            self.flush()
        except (OSError, ValueError):
            pass
        with self._lock:
            try:
                self._f.close()
            except (OSError, ValueError):
                pass
