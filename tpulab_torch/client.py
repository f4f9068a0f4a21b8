"""Clients of the port's daemon (:mod:`tpulab_torch.daemon`).

* :func:`request`: one round trip over the wire protocol, in Python;
* :func:`build_native_client`: the native thin client
  (``tpulab_torch/csrc/client/tpulab_client.cpp``, the port's copy of
  ``native/client/tpulab_client.cpp``: the reference suite's stdin/stdout
  contract forwarded over the socket), built from the source in the
  checkout with ``g++`` and ``tools/build_native.py``'s flags into
  ``build/tpulab_torch/client-<hash>/``, never into ``native/bin/``.

When the daemon is unreachable the native client execs ``python3 -m
tpulab_torch run`` (the port's CLI; ``native/``'s copy execs the JAX
package's), so a lab run gives its bytes either way.  A caller that must
know the daemon served the run checks the daemon's served count
(``serve``'s ``served_counter``) rather than the client's exit code.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import socket
import struct
import subprocess
import time
from typing import Callable, Optional

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "client" / "tpulab_client.cpp"
CLIENT_NAME = "tpulab_client"
CXX_FLAGS = ["-std=c++17", "-O2", "-Wall"]
#: the bound on each socket operation of a round trip
TIMEOUT_S = 600.0


def request(sock_path: str, lab: str, config: Optional[dict] = None, payload: bytes = b"",
            on_chunk: Optional[Callable[[bytes], None]] = None) -> bytes:
    """One daemon round trip: the terminal frame's bytes.  Chunk frames
    (status 2, a streaming ``generate``) go to ``on_chunk``; an error
    frame raises ``RuntimeError`` with its text.  The header names no
    backend, so a lab runs on the daemon's."""
    header = json.dumps({"lab": lab, "sweep": False, "backend": None,
                         "config": config or {}}).encode()
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(TIMEOUT_S)
        deadline = time.monotonic() + TIMEOUT_S
        while True:
            try:
                s.connect(sock_path)
                break
            except BlockingIOError:
                # the daemon's listen backlog is full (a burst of clients
                # ahead of its accept loop): a socket with a timeout is
                # non-blocking, so wait for room as a blocking connect would
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        s.sendall(struct.pack("<I", len(header)) + header
                  + struct.pack("<Q", len(payload)) + bytes(payload))

        def read_exact(n: int) -> bytes:
            buf = bytearray()
            while len(buf) < n:
                r = s.recv(n - len(buf))
                if not r:
                    raise ConnectionError("daemon closed mid-frame")
                buf += r
            return bytes(buf)

        while True:
            status = read_exact(1)[0]
            (n,) = struct.unpack("<Q", read_exact(8))
            out = read_exact(n)
            if status == 2:
                if on_chunk is not None:
                    on_chunk(out)
                continue
            if status != 0:
                raise RuntimeError(f"daemon error for {lab!r}: "
                                   f"{out.decode('utf-8', 'replace')[-800:]}")
            return out


def client_dir() -> pathlib.Path:
    """Where the native client is built: keyed by its source and flags."""
    from tpulab_torch.ops.cuda._build import BUILD_ROOT

    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"client-{h.hexdigest()[:16]}"


def build_native_client() -> pathlib.Path:
    """The native client's executable, built from :data:`SOURCE` first if
    needed (under the kernels' build lock).  Raises without ``g++``."""
    from tpulab_torch.ops.cuda._build import build_once

    def make(tmp: pathlib.Path) -> None:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH: the native client cannot be built")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp / CLIENT_NAME), str(SOURCE)],
                             capture_output=True, text=True)
        (tmp / "build.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stderr}")

    return build_once(client_dir(), CLIENT_NAME, make)
