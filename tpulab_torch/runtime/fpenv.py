"""The floating-point environment of torch's CPU threads.

The port's CPU path is the plain version of every kernel, and its bits
are held against the JAX package's; they assume round-to-nearest.  A
POSIX thread starts with the floating-point environment of the thread
that created it, and the SSE rounding mode (MXCSR's RC bits, which
``fegetround`` does not read on x86-64: it reads the x87 control word)
stays with the thread.  In a pytest-xdist worker one thread of torch's
intra-op pool (OpenMP) has been seen computing in round-toward-zero
(ROADMAP C7); what set it was not found.

So the port checks the pool before its CPU work, by arithmetic rather
than by ``fegetround``: :func:`pool_rounds_to_nearest` adds, on every
thread of the pool, pairs whose sums round differently under each
mode.  :func:`ensure_nearest` runs where the port starts CPU work
(:func:`tpulab_torch.runtime.device.resolve_device` for the CPU, and the
CPU branch of each kernel wrapper): if a thread is off nearest it sets
every thread of the pool to nearest (``fesetround`` run on each through
libgomp's ``GOMP_parallel``) and checks again, and it raises, naming the
mode it found, where that does not help.

It also makes one call, on the calling thread, of each elementwise
function that ATen can hand to MKL's vector math library (VML), once per
process (:func:`init_vml`).  MKL chooses each VML function's code lazily,
at its first call; when two of torch's threads make that first call at
once, on a loaded machine, one of them can compute with another
variant: a first parallel ``torch.exp`` was seen giving one thread's half
of its output with relative errors up to 1.5e-4 (the usual 6e-8), the
next call right.  That moved the port's CPU flash attention past its
tolerance against ``tpulab`` (ROADMAP C9 and C7).  A first call on one
thread leaves nothing for the threads to race on.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

#: x86-64 <fenv.h> rounding modes (also MXCSR's RC field << 13 >> 3)
FE_TONEAREST, FE_DOWNWARD, FE_UPWARD, FE_TOWARDZERO = 0x000, 0x400, 0x800, 0xC00
MODE_NAMES = {FE_TONEAREST: "to nearest", FE_DOWNWARD: "downward", FE_UPWARD: "upward",
              FE_TOWARDZERO: "toward zero"}
#: elements a thread takes of one elementwise op (ATen's GRAIN_SIZE)
_GRAIN = 32768
_ULP = 2.0 ** -23


@functools.lru_cache(maxsize=8)
def _probe_tensors(threads: int):
    """x, y and x + y at nearest, ``threads`` grains long.  Even elements add
    3/4 of an ulp to 1 (nearest and upward give 1 + ulp, zero and downward
    give 1); odd elements add 1/4 (nearest, zero and downward give 1,
    upward 1 + ulp)."""
    n = threads * _GRAIN
    x = torch.ones(n, dtype=torch.float32)
    y = torch.full((n,), 0.25 * _ULP, dtype=torch.float32)
    y[0::2] = 0.75 * _ULP
    want = torch.ones(n, dtype=torch.float32)
    want[0::2] = 1.0 + _ULP
    return x, y, want


def probe_modes(threads: Optional[int] = None) -> set:
    """The rounding modes the pool's threads showed on one elementwise add."""
    x, y, want = _probe_tensors(threads or torch.get_num_threads())
    got = x + y
    even_low = bool((got[0::2] != want[0::2]).any())
    odd_high = bool((got[1::2] != want[1::2]).any())
    modes = set()
    if even_low:
        modes.add(FE_TOWARDZERO)  # or downward: the probe cannot tell them apart
    if odd_high:
        modes.add(FE_UPWARD)
    return modes or {FE_TONEAREST}


def pool_rounds_to_nearest() -> bool:
    x, y, want = _probe_tensors(torch.get_num_threads())
    return torch.equal(x + y, want)


@functools.lru_cache(maxsize=1)
def _gomp() -> Optional[ctypes.CDLL]:
    """torch's libgomp, as loaded in this process (None without one)."""
    torch_dir = os.path.dirname(torch.__file__)
    found = []
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if "libgomp" in os.path.basename(path) and path not in found:
                found.append(path)
    ours = [p for p in found if p.startswith(torch_dir)] or found
    return ctypes.CDLL(ours[0]) if ours else None


def set_pool_rounding(mode: int, threads: Optional[int] = None) -> None:
    """``fesetround(mode)`` on every thread of torch's intra-op pool (and
    the calling thread), through ``GOMP_parallel``."""
    gomp = _gomp()
    if gomp is None:
        raise RuntimeError("torch's intra-op pool is not libgomp's: cannot set its rounding")
    fn = ctypes.cast(ctypes.CDLL(None).fesetround, ctypes.c_void_p)
    gomp.GOMP_parallel.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
                                   ctypes.c_uint]
    gomp.GOMP_parallel.restype = None
    gomp.GOMP_parallel(fn, ctypes.c_void_p(mode), threads or torch.get_num_threads(), 0)


#: elementwise functions ATen may run through MKL's VML
_VML_FUNCTIONS = (torch.exp, torch.log, torch.log1p, torch.expm1, torch.tanh, torch.sin,
                  torch.cos, torch.sqrt, torch.rsqrt, torch.erf)


@functools.lru_cache(maxsize=1)
def init_vml() -> None:
    """Call each of ``_VML_FUNCTIONS`` once on this thread alone (8
    elements, far under ATen's grain), so MKL's lazy choice of code is
    made before any parallel call."""
    x = torch.full((8,), 0.5, dtype=torch.float32)
    for fn in _VML_FUNCTIONS:
        fn(x)
        fn(x.double())


def ensure_nearest() -> None:
    """Leave every thread of torch's pool rounding to nearest, or raise;
    and MKL's VML chosen on one thread (:func:`init_vml`)."""
    init_vml()
    if pool_rounds_to_nearest():
        return
    found = sorted(MODE_NAMES[m] for m in probe_modes())
    try:
        set_pool_rounding(FE_TONEAREST)
    except (OSError, AttributeError, RuntimeError) as exc:
        raise RuntimeError(f"torch's CPU threads round {' and '.join(found)}, "
                           f"not to nearest, and cannot be reset: {exc}") from exc
    if not pool_rounds_to_nearest():
        raise RuntimeError(f"torch's CPU threads round {' and '.join(found)}, "
                           "not to nearest, after a reset")
