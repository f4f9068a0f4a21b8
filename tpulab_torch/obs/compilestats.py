"""The compile ledger: what the port built at run time, when, and for how long.

``tpulab``'s ledger records XLA compiles of its jitted programs and trips
when a steady-state engine tick compiles afresh.  The port compiles
nothing per shape: its engine and trainer run eagerly, and the only
compiles are the ``nvcc`` builds of ``tpulab_torch/ops/cuda/_build.py``
(the kernels' library, once per source hash) and the native loader's
``g++`` build.  Those land here, each under its artifact's name, through
:func:`note_build`.  The CUDA-graph captures of ROADMAP S1 will land here
too when they exist.  So the engine's ``recompiles`` counter stays 0 on
the eager path: a build that happens inside a steady tick (the first
kernel launch of a process that warmed up on the CPU path, say) is what
would trip it.

The interface is ``tpulab``'s:

* every compile appends ``(name, thread_id)`` to a process-global
  **event log**; :meth:`CompileStats.seq` / :meth:`names_since` let a
  caller bracket a region and ask "did MY thread compile anything in
  there?"  That is the engine's recompile tripwire (``PagedEngine``
  counts compiles that land inside a steady-state step into its
  ``recompiles`` counter, and under :func:`strict` raises
  :class:`RecompileError`, the test mode);
* ``set_model_flops``/``model_flops`` carry the analytic per-dispatch
  flops a subsystem registers for its hot program (the engine's
  per-tick matmul flops), which the MFU gauges of
  :mod:`tpulab_torch.obs.roofline` divide by;
* :meth:`CompileStats.snapshot` is the ``compile_stats`` daemon request's
  and the flight recorder's view.  Rows keep ``tpulab``'s keys;
  ``flops``, ``bytes_accessed`` and ``memory`` (XLA's cost analysis) are
  ``None`` here, since a build has no cost model.

Hot-path cost: a steady step reads :meth:`CompileStats.seq` (one
``len``) before and after; nothing else.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class RecompileError(RuntimeError):
    """A steady-state step triggered a build while the tripwire was
    armed (:func:`strict`).  In production the same event only
    increments the engine's ``recompiles`` counter; raising is the test
    mode."""


class ProgramStats:
    """One named program's ledger (guarded by the registry lock for
    writes; reads are GIL-consistent ints/floats)."""

    __slots__ = ("name", "compiles", "compile_seconds", "last_compile_s",
                 "model_flops", "first_compile_unix")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.compile_seconds = 0.0
        self.last_compile_s = 0.0
        self.model_flops: Optional[float] = None
        self.first_compile_unix: Optional[float] = None

    def snapshot(self) -> Dict[str, Any]:
        return {
            "compiles": self.compiles,
            "compile_seconds": round(self.compile_seconds, 6),
            "last_compile_seconds": round(self.last_compile_s, 6),
            "flops": None,
            "bytes_accessed": None,
            "model_flops": self.model_flops,
            "memory": None,
            "first_compile_unix": self.first_compile_unix,
        }


class CompileStats:
    """Process-global compile ledger (:data:`COMPILESTATS`); tests may
    build private instances."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[str, ProgramStats] = {}
        #: append-only (name, thread_id) per build: one per artifact and
        #: source hash, so the log stays small
        self._log: List[Tuple[str, int]] = []
        self.strict = False
        self.steady_recompiles = 0

    # -------------------------------------------------------- recording
    def _program(self, name: str) -> ProgramStats:
        with self._lock:
            p = self._programs.get(name)
            if p is None:
                p = self._programs[name] = ProgramStats(name)
            return p

    def note_build(self, name: str, seconds: float) -> None:
        """Record one run-time build of ``name`` that took ``seconds``
        (the compile event the tripwire brackets)."""
        prog = self._program(name)
        with self._lock:
            prog.compiles += 1
            prog.compile_seconds += seconds
            prog.last_compile_s = seconds
            if prog.first_compile_unix is None:
                prog.first_compile_unix = time.time()
            self._log.append((name, threading.get_ident()))

    # -------------------------------------------------------- tripwire
    def seq(self) -> int:
        """Monotonic compile-event count — bracket a region with
        ``c0 = seq()`` ... ``names_since(c0)`` to see what compiled
        inside it."""
        return len(self._log)

    def names_since(self, c0: int,
                    thread_id: Optional[int] = None) -> List[str]:
        """Program names compiled since event ``c0``; ``thread_id``
        (default: the calling thread) restricts to compiles that
        thread triggered — concurrent warmup on another engine's
        stepper must not trip a steady engine's wire."""
        tid = threading.get_ident() if thread_id is None else thread_id
        with self._lock:
            return [n for n, t in self._log[c0:] if t == tid]

    def note_steady_recompile(self, names: List[str]) -> None:
        """A steady-state region compiled ``names``: count it, and
        raise under :func:`strict` (the test mode)."""
        with self._lock:
            self.steady_recompiles += len(names)
            raise_now = self.strict
        if raise_now:
            raise RecompileError(
                f"steady-state recompile: {sorted(set(names))} built "
                f"inside a post-warmup step")

    # ------------------------------------------------------- model flops
    def set_model_flops(self, name: str, flops: float) -> None:
        """Register the analytic per-dispatch flops for ``name`` (what
        the MFU gauges divide by)."""
        self._program(name).model_flops = float(flops)

    def model_flops(self, name: str) -> Optional[float]:
        with self._lock:
            p = self._programs.get(name)
        return p.model_flops if p is not None else None

    # --------------------------------------------------------- reporting
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Copy-on-read {program: ledger} — the ``compile_stats``
        daemon request and the flight recorder both serialize this."""
        with self._lock:
            programs = list(self._programs.items())
        return {name: p.snapshot() for name, p in sorted(programs)}

    def total_compiles(self) -> int:
        return len(self._log)

    def total_compile_seconds(self) -> float:
        with self._lock:
            return sum(p.compile_seconds for p in self._programs.values())

    def reset(self) -> None:
        """Tests only: forget every ledger and the event log."""
        with self._lock:
            self._programs.clear()
            self._log.clear()
            self.steady_recompiles = 0


#: the process-global ledger every build records into
COMPILESTATS = CompileStats()


def note_build(name: str, seconds: float) -> None:
    COMPILESTATS.note_build(name, seconds)


@contextlib.contextmanager
def strict():
    """Arm the tripwire's raise mode (tests): any steady-state
    recompile noted while inside raises :class:`RecompileError` at the
    engine step that triggered it."""
    prior = COMPILESTATS.strict
    COMPILESTATS.strict = True
    try:
        yield COMPILESTATS
    finally:
        COMPILESTATS.strict = prior
