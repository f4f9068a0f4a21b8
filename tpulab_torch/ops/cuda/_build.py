"""Builds and loads the port's CUDA kernels.

Every ``*.cu`` file in ``tpulab_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
which ``ctypes`` loads.  Nothing includes PyTorch's headers, so a build
takes seconds.  The sources compile in parallel (one ``nvcc`` each) and
link once.

The library is built at first use into ``build/tpulab_torch/<hash>/`` of
the checkout, where ``<hash>`` covers the sources and the flags: a
changed source builds anew, an unchanged one loads what is there.  A file
lock keeps two processes from building at once.

``-fmad=false`` keeps ``nvcc`` from contracting any multiply-add on its
own: where the JAX package's result depends on a fused multiply-add, the
kernel writes it out as ``__fmaf_rn``.

This module also holds the launch-geometry check that every wrapper runs
before it launches.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from tpulab_torch.runtime.device import LAUNCH_LIMITS

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "tpulab_torch"
LIBRARY_NAME = "libtpulab_torch.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C signature of every exported function: name -> argtypes (restype int,
#: the ``cudaGetLastError()`` after the launch)
SIGNATURES: Dict[str, List] = {
    # in, out, h, w, bx, by, gx, gy, stream
    "tl_roberts": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # op, dtype, a, b, out, n, grid, block, stream
    "tl_binary": [_I, _I, _P, _P, _P, _L, _I, _I, _P],
    # dtype, in, out, stats, nc, n, blocks, threads, stream
    "tl_classify": [_I, _P, _P, _P, _I, _L, _I, _I, _P],
    # d, q, k, v, o, lse, b, s, h, kv_heads, strides of q, k, v (batch,
    # seq, head; elements), scale, causal, window, q_offset, stream (float32)
    "tl_flash_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, *[_L] * 9,
                     ctypes.c_float, _I, _I, _I, _P],
    # the same with the shared-memory bytes before the stream (bfloat16)
    "tl_flash_fwd_bf16": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, *[_L] * 9,
                          ctypes.c_float, _I, _I, _I, _I, _P],
    # d, q, k, v, do, lse, delta, dq, b, s, h, kv_heads, scale, causal,
    # window, q_offset, stream (contiguous operands; float32)
    "tl_flash_bwd_dq": [_I, *[_P] * 7, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P],
    # the same with the shared-memory bytes before the stream (bfloat16)
    "tl_flash_bwd_dq_bf16": [_I, *[_P] * 7, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P],
    # d, then as tl_flash_bwd_dq with dk, dv in place of dq (float32)
    "tl_flash_bwd_dkv": [_I, *[_P] * 8, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P],
    # the same with the shared-memory bytes before the stream (bfloat16)
    "tl_flash_bwd_dkv_bf16": [_I, *[_P] * 8, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I,
                              _P],
    # dtype, d, quantized, q, kpool, vpool, kscale, vscale, tables, lengths,
    # out, workspace, tickets, slots, h, kv_heads, block_size, max_blocks,
    # window, q divisor, splits, span, shared-memory bytes, stream
    "tl_paged_decode": [_I, _I, _I, *[_P] * 10, *[_I] * 6, ctypes.c_float, _I, _I, _I, _P],
}


def sources() -> List[Path]:
    """The CUDA sources, in a fixed order."""
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Digest of every source and header plus the flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = [
        os.path.join(os.environ[var], "bin", "nvcc")
        for var in ("CUDA_HOME", "CUDA_PATH")
        if os.environ.get(var)
    ]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in CUDA_HOME, CUDA_PATH, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def compile_commands(nvcc: str, out_dir: Path) -> Tuple[List[List[str]], List[str]]:
    """One compile command per source, then the link command."""
    objects, compiles = [], []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        compiles.append([nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)])
        objects.append(str(obj))
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIBRARY_NAME), *objects]
    return compiles, link


def _run_all(commands: Sequence[List[str]], log) -> None:
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    failed = []
    for cmd, proc in zip(commands, procs):
        output, _ = proc.communicate()
        log.write(" ".join(cmd) + "\n" + output + "\n")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{output}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_once(target_dir: Path, artifact: str, make) -> Path:
    """``target_dir/artifact``, made first by ``make(tmp_dir)`` (which
    writes ``artifact`` into ``tmp_dir``) unless it is there.  A file lock
    under ``BUILD_ROOT`` keeps two processes from building at once; the
    finished directory is renamed into place, so a partial build is never
    loaded."""
    library = target_dir / artifact
    if library.is_file():
        return library
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if library.is_file():  # another process built it while we waited
            return library
        tmp = BUILD_ROOT / f"{target_dir.name}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        make(tmp)
        shutil.rmtree(target_dir, ignore_errors=True)  # a partial earlier build
        os.replace(tmp, target_dir)
    return library


def build() -> Path:
    """Path of the built library, building it first if its hash is new."""
    def make(tmp: Path) -> None:
        compiles, link = compile_commands(find_nvcc(), tmp)
        with open(tmp / "build.log", "w") as log:
            _run_all(compiles, log)
            _run_all([link], log)

    return build_once(BUILD_ROOT / source_hash(), LIBRARY_NAME, make)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with every signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tl_error_string.argtypes = [ctypes.c_int]
    lib.tl_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = load_library().tl_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


#: dynamic shared memory a block may take on Hopper, in bytes (227 KB,
#: after the opt-in attribute)
MAX_SHARED = 232_448


def check_geometry(grid: Sequence[int], block: Sequence[int], smem: int = 0) -> None:
    """Raise ``ValueError`` for a launch geometry the card would refuse,
    ``smem`` bytes of dynamic shared memory included."""
    if smem > MAX_SHARED:
        raise ValueError(f"a block asks for {smem} bytes of shared memory; the card allows "
                         f"{MAX_SHARED}")
    grid, block = tuple(int(v) for v in grid), tuple(int(v) for v in block)
    if any(v < 1 for v in grid + block):
        raise ValueError(f"launch dimensions must be >= 1, got grid {grid} block {block}")
    threads = 1
    for v in block:
        threads *= v
    if threads > LAUNCH_LIMITS["max_threads_per_block"]:
        raise ValueError(
            f"block {block} has {threads} threads; the card allows "
            f"{LAUNCH_LIMITS['max_threads_per_block']}"
        )
    for what, dims, limits in (
        ("block", block, LAUNCH_LIMITS["max_block_dim"]),
        ("grid", grid, LAUNCH_LIMITS["max_grid_dim"]),
    ):
        for axis, (v, limit) in enumerate(zip(dims, limits)):
            if v > limit:
                raise ValueError(f"{what} dimension {axis} is {v}; the card allows {limit}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_handle(device: torch.device) -> int:
    """The current stream of ``device``, as the int ``ctypes`` passes."""
    return torch.cuda.current_stream(device).cuda_stream


#: the opcodes of the tensor cores in SASS: ``HGMMA`` (``wgmma``) and
#: ``HMMA`` (``mma.sync``)
TENSOR_CORE_OPCODES = ("HGMMA", "HMMA")


def kernel_sass(library: Path) -> Dict[str, str]:
    """Each kernel's SASS in the built library, by mangled name, as
    ``cuobjdump -sass`` (beside ``nvcc``) prints it."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


def tensor_core_opcodes(sass: str) -> List[str]:
    """The tensor-core opcodes that occur in one kernel's SASS."""
    return [op for op in TENSOR_CORE_OPCODES if re.search(rf"\b{op}\b", sass)]
