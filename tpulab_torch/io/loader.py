"""ctypes binding of the native prefetching token loader (the counterpart
of ``tpulab.io.loader``, with the same API).

``native/loader/tpulab_loader.cpp`` streams (batch, row_tokens) int32
byte-token batches from files with worker threads and a step-ordered
buffer: the stream is a function of (files, seed, start_step) alone,
whatever the thread count, so a resumed run replays the exact tokens.

The port builds the library itself, from that source in the checkout, at
first use: ``g++ -std=c++17 -shared -fPIC -O2 -Wall -pthread`` (the flags
of ``tools/build_native.py``) into ``build/tpulab_torch/loader-<hash>/``,
where ``<hash>`` covers the source and the flags, under the lock the CUDA
kernels' build takes.  It never loads ``native/lib/``, the JAX side's build
product.  A failed build raises; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import pathlib
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "loader" / "tpulab_loader.cpp"
LIBRARY_NAME = "libtpulab_loader.so"
CXX_FLAGS = ["-std=c++17", "-shared", "-fPIC", "-O2", "-Wall", "-pthread"]


def library_dir() -> pathlib.Path:
    """Where the loader's library is built: keyed by the source and flags."""
    from tpulab_torch.ops.cuda._build import BUILD_ROOT

    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"loader-{h.hexdigest()[:16]}"


def build() -> pathlib.Path:
    """The loader's library, built from ``SOURCE`` first if needed."""
    from tpulab_torch.ops.cuda._build import build_once

    def make(tmp: pathlib.Path) -> None:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH: the native token loader cannot be built")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp / LIBRARY_NAME), str(SOURCE)],
                             capture_output=True, text=True)
        (tmp / "build.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stderr}")

    return build_once(library_dir(), LIBRARY_NAME, make)


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tl_open.restype = ctypes.c_void_p
    lib.tl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.tl_next.restype = ctypes.c_longlong
    lib.tl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.tl_short_reads.restype = ctypes.c_ulonglong
    lib.tl_short_reads.argtypes = [ctypes.c_void_p]
    lib.tl_close.restype = None
    lib.tl_close.argtypes = [ctypes.c_void_p]
    return lib


class TokenLoader:
    """Step-ordered prefetching byte-token stream over files."""

    def __init__(self, paths: Sequence[str], batch: int, row_tokens: int, *,
                 prefetch: int = 4, threads: int = 2, seed: int = 0, start_step: int = 0):
        self._h = None
        lib = _load()
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        err = ctypes.create_string_buffer(256)
        self._h = lib.tl_open(arr, len(paths), batch, row_tokens, prefetch, threads, seed,
                              start_step, err, len(err))
        if not self._h:
            raise RuntimeError(f"tl_open failed: {err.value.decode()}")
        self._lib = lib
        self.batch = batch
        self.row_tokens = row_tokens
        self._buf = np.empty((batch, row_tokens), np.int32)

    @classmethod
    def from_dir(cls, data_dir: str, batch: int, row_tokens: int, **kw) -> "TokenLoader":
        """All regular files under ``data_dir`` (sorted, recursive)."""
        paths = sorted(str(p) for p in pathlib.Path(data_dir).rglob("*") if p.is_file())
        if not paths:
            raise RuntimeError(f"no files under {data_dir}")
        return cls(paths, batch, row_tokens, **kw)

    def next(self) -> np.ndarray:
        """The next batch, in step order: a fresh (batch, row_tokens) int32
        array of byte tokens in [0, 256)."""
        if self._h is None:
            raise RuntimeError("loader is closed")
        step = self._lib.tl_next(self._h,
                                 self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if step < 0:
            raise RuntimeError("loader stopped")
        self.last_step = int(step)
        return self._buf.copy()

    def short_reads(self) -> Optional[int]:
        """Rows zero-padded by an IO failure (pread error, a file that
        shrank) since the open; None once closed."""
        if self._h is None:
            return None
        return int(self._lib.tl_short_reads(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
