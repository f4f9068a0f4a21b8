"""``python -m tpulab_torch.daemon --backend cpu`` as a subprocess, over
the wire.

The framing is tpulab's: lab1 over the socket, an error frame for an
unknown lab, status-2 chunk frames before the terminal frame of a
streaming ``generate``.  A stalled client is evicted at the receive
deadline while followers are served.  The native client (the port's
copy, ``tpulab_torch/csrc/client/tpulab_client.cpp``, built by ``g++``
into the port's build directory; skipped without ``g++``, as
``tests/test_native.py`` skips) returns lab1's bytes through the port's
daemon: it runs with an empty ``PATH``, so its fallback cannot stand in
for the daemon.  With no daemon at its socket the client's fallback runs
``python3 -m tpulab_torch run`` from a ``PYTHONPATH`` that holds no
``tpulab``, and gives lab2's bytes (ROADMAP C11).  The port's CLI has
``tpulab``'s subcommands, and ``python -m tpulab_torch daemon`` serves a
lab2 request (C12).  ``tools/goodput_gate.py --socket`` replays
tests/test_loadgen.py's ``tiny`` trace against the port's daemon
(started here: ``--spawn-daemon`` starts tpulab's) and exits 0.
"""

import importlib.util
import json
import os
import pathlib
import shutil
import socket
import struct
import subprocess
import sys
import time
from dataclasses import replace

import pytest

from tpulab import loadgen as jload
from tpulab.labs import lab1 as jlab1

from tpulab_torch import client
from tpulab_torch import loadgen as tload

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchd")
    sock = str(d / "torch.sock")
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPULAB_DAEMON_RECV_TIMEOUT_S="2",
               TPULAB_POSTMORTEM_DIR=str(d / "pm"), OMP_NUM_THREADS="2")
    log_path = d / "daemon.log"
    with open(log_path, "w") as log_f:  # a file, not a pipe nobody drains
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpulab_torch.daemon", "--backend", "cpu",
             "--socket", sock, "--slowlog", "16", "--trace-buffer", "65536"],
            env=env, stdout=log_f, stderr=subprocess.STDOUT, cwd=str(ROOT))
        try:
            for _ in range(600):
                if os.path.exists(sock):
                    break
                if proc.poll() is not None:
                    raise RuntimeError(f"daemon died: {log_path.read_text()[-4000:]}")
                time.sleep(0.05)
            else:
                raise RuntimeError("daemon socket never appeared")
            yield sock
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    assert proc.returncode is not None


def _raw(sock, header: dict, payload: bytes):
    """Every frame of one round trip: [(status, bytes), ...]."""
    h = json.dumps(header).encode()
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(120)
        s.connect(sock)
        s.sendall(struct.pack("<I", len(h)) + h + struct.pack("<Q", len(payload)) + payload)
        frames, buf = [], b""
        while True:
            while len(buf) < 9:
                r = s.recv(1 << 16)
                assert r, "daemon closed mid-frame"
                buf += r
            status, n = buf[0], struct.unpack("<Q", buf[1:9])[0]
            while len(buf) < 9 + n:
                r = s.recv(1 << 16)
                assert r, "daemon closed mid-frame"
                buf += r
            frames.append((status, buf[9:9 + n]))
            buf = buf[9 + n:]
            if status != 2:
                assert buf == b""
                return frames


LAB1_IN = b"3\n1.5 -2 1e300\n0.25 4 -1e300\n"


def test_framing(daemon):
    (frame,) = _raw(daemon, {"lab": "lab1", "config": {}}, LAB1_IN)
    assert frame[0] == 0 and frame[1].startswith(b"CPU execution time: <")
    want = jlab1.run(LAB1_IN.decode(), backend="cpu")
    assert frame[1].split(b"\n", 1)[1] == want.encode().split(b"\n", 1)[1]
    (err,) = _raw(daemon, {"lab": "nope"}, b"")
    assert err[0] == 1 and b"nope" in err[1]
    frames = _raw(daemon, {"lab": "generate", "config": {"steps": 6, "stream": True}}, b"hi")
    assert [s for s, _ in frames[:-1]] == [2] * (len(frames) - 1) and frames[-1][0] == 0
    assert b"".join(b for _, b in frames[:-1]) == frames[-1][1] and len(frames[-1][1]) == 6
    assert client.request(daemon, "platform") == b"cpu"


def test_stalled_client_is_evicted(daemon):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(daemon)
    s.sendall(b"\x01\x02")  # half a header-length prefix, then silence
    s.settimeout(8)
    t0 = time.perf_counter()
    try:
        got = s.recv(1)
    except OSError:
        got = b""
    dt = time.perf_counter() - t0
    s.close()
    assert got == b"" and dt < 7, dt
    assert client.request(daemon, "lab1", payload=LAB1_IN).startswith(b"CPU execution")


def test_native_client_lab1(daemon, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ in environment")
    exe = client.build_native_client()
    empty = tmp_path / "nobin"
    empty.mkdir()
    res = subprocess.run([str(exe), "lab1", "--backend", "cpu"], input=LAB1_IN,
                         capture_output=True, timeout=120,
                         env={"TPULAB_DAEMON_SOCKET": daemon, "PATH": str(empty)})
    assert res.returncode == 0, res.stderr
    want = jlab1.run(LAB1_IN.decode(), backend="cpu").encode()
    assert res.stdout.startswith(b"CPU execution time: <")
    assert res.stdout.split(b"\n", 1)[1] == want.split(b"\n", 1)[1]


def _lab2_case(tmp_path, name):
    from tpulab_torch.io import protocol
    from tpulab_torch.io.imagefile import load_image, save_image

    inp, out = tmp_path / f"{name}_in.data", tmp_path / f"{name}_out.data"
    save_image(str(inp), load_image(str(ROOT / "data/lab2/data/rings_16x16.txt")))
    return protocol.format_lab2_input(str(inp), str(out)).encode(), out


def _lab2_reference(tmp_path):
    """``python -m tpulab_torch run lab2 --backend cpu``: stdout past the
    timing line, and the output file."""
    stdin, out = _lab2_case(tmp_path, "ref")
    res = subprocess.run([sys.executable, "-m", "tpulab_torch", "run", "lab2", "--backend",
                          "cpu"], input=stdin, capture_output=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    return res.stdout.split(b"\n", 1)[1], out.read_bytes()


def test_cli_subcommands_equal_tpulab(capsys):
    import re

    from tpulab.cli.main import main as jmain
    from tpulab_torch.cli.main import main as tmain

    names = []
    for main in (tmain, jmain):
        assert main([]) == 2  # no subcommand: the help, exit 2
        usage = capsys.readouterr().out
        names.append(set(re.search(r"\{([a-z_,]+)\}", usage).group(1).split(",")))
    assert names[0] == names[1] and "daemon" in names[0]


def test_daemon_subcommand_serves_lab2(tmp_path):
    sock = str(tmp_path / "sub.sock")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    with open(tmp_path / "daemon.log", "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpulab_torch", "daemon", "--backend", "cpu", "--socket",
             sock], env=env, stdout=log_f, stderr=subprocess.STDOUT, cwd=str(ROOT))
        try:
            for _ in range(600):
                if os.path.exists(sock) or proc.poll() is not None:
                    break
                time.sleep(0.05)
            assert os.path.exists(sock), (tmp_path / "daemon.log").read_text()[-2000:]
            stdin, out = _lab2_case(tmp_path, "sub")
            got = client.request(sock, "lab2", payload=stdin)
            want_stdout, want_file = _lab2_reference(tmp_path)
            assert got.split(b"\n", 1)[1] == want_stdout and out.read_bytes() == want_file
            proc.send_signal(15)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    assert b"metrics sampler @ 1s" in (tmp_path / "daemon.log").read_bytes()


def test_native_client_cold_path_runs_the_port(tmp_path):
    """No daemon at the socket: the client execs ``python3 -m tpulab_torch
    run``, found through a ``PYTHONPATH`` that holds the port alone."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ in environment")
    assert client.SOURCE == ROOT / "tpulab_torch" / "csrc" / "client" / "tpulab_client.cpp"
    assert b'"tpulab_torch"' in client.SOURCE.read_bytes()
    exe = client.build_native_client()
    only_port = tmp_path / "only_port"
    only_port.mkdir()
    (only_port / "tpulab_torch").symlink_to(ROOT / "tpulab_torch")
    stdin, out = _lab2_case(tmp_path, "cold")
    env = {"TPULAB_DAEMON_SOCKET": str(tmp_path / "nobody.sock"),
           "PATH": os.path.dirname(sys.executable) + os.pathsep + os.environ.get("PATH", ""),
           "PYTHONPATH": str(only_port), "OMP_NUM_THREADS": "2"}
    res = subprocess.run([str(exe), "lab2", "--backend", "cpu"], input=stdin,
                         capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    want_stdout, want_file = _lab2_reference(tmp_path)
    assert res.stdout.startswith(b"CPU execution time: <")
    assert res.stdout.split(b"\n", 1)[1] == want_stdout and out.read_bytes() == want_file


def test_goodput_gate_against_the_port(daemon, tmp_path):
    spec = importlib.util.spec_from_file_location("goodput_gate",
                                                  ROOT / "tools" / "goodput_gate.py")
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    tiny = replace(tload.built_in_spec("fast"), name="tiny", n_requests=6, p_cancel=0.0,
                   steps_median=8, steps_max=12, prompt_median=24, prompt_max=64)
    trace = tload.build_trace(tiny)
    jtiny = replace(jload.built_in_spec("fast"), name="tiny", n_requests=6, p_cancel=0.0,
                    steps_median=8, steps_max=12, prompt_median=24, prompt_max=64)
    assert trace.to_json() == jload.build_trace(jtiny).to_json()
    trace_path, out_path = tmp_path / "tiny.json", tmp_path / "goodput.json"
    trace.save(trace_path)
    rc = gate.main(["--socket", daemon, "--trace", str(trace_path), "--out", str(out_path),
                    "--warmup", "1", "--slowlog", "4", "--time-scale", "0.25",
                    "--min-attainment", "0.0"])
    assert rc == 0
    report = json.loads(out_path.read_text())
    overall = report["goodput"]["overall"]
    assert overall["n"] == 6 and overall["errors"] == 0 and overall["completed"] == 6
    assert report["server_window"]["ttft_seconds"]["count"] >= 6
    assert any(e["tag"].startswith("tiny:") for e in report["slowlog"] if e["tag"])
    # the port's own replay client against the same daemon
    results, wall = tload.replay(trace, daemon, time_scale=0.25, timeout_s=120.0)
    summary = tload.summarize(results, trace, wall)
    assert summary["overall"]["completed"] == 6 and summary["overall"]["errors"] == 0


def test_chip_smoke_phase12_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 12 at a tiny size on the CPU: the native
    client's lab runs against phase 2's, with the daemon up and with none,
    generate on every knob set against the in-process engine, the crash
    and the rolling restart, the ``fast`` replay, history and alerts, the
    autoscaled and the pooled fleets, and the journaled daemon process
    (``--backend cpu``) killed and restarted."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ in environment")
    import torch

    import chip_smoke
    from tpulab_torch import daemon as td

    for name in ("BACKEND", "REPLICAS", "AUTOSCALE_MIN", "AUTOSCALE_MAX",
                 "AUTOSCALE_WINDOW_S", "POOL_SPEC", "PREFIX_INDEX", "SPILL_BLOCKS"):
        monkeypatch.setattr(td, name, getattr(td, name))
    monkeypatch.setattr(td, "_FLEETS", {})
    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(lab1_n=16, lab2_side=16, lab3_side=16, lab3_nc=2,
                daemon_serving=dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=256),
                daemon_clients=4, daemon_prompt_len=(8, 40), daemon_gen_steps=6,
                daemon_fleet_steps=10, daemon_fleet_chunk=8, daemon_crash_at=3,
                daemon_time_scale=0.25, daemon_autoscale_waves=(24, 4),
                daemon_autoscale_steps=64, daemon_journal_steps=160)
    inp = chip_smoke.make_inputs(tiny)
    outs, launches = chip_smoke.drive_main_path(inp, "cpu")
    main = {"outs": outs, "backend": "cpu",
            "files": {n: (chip_smoke.WORK / n).read_bytes()
                      for n in ("lab2_out.data", "lab3_out_float64.data",
                                "lab3_out_float32.data")},
            "launches": {n: launches[n] for n in chip_smoke.LAB_KERNELS}}
    out = chip_smoke.run_daemon_path(tiny, torch.device("cpu"), "cpu", "cpu", inp, main)
    assert set(out["native_client"]["timing"]) == {"lab1", "lab2", "lab3_float64",
                                                   "lab3_float32"}
    assert set(out["native_client"]["launches"]) >= set(chip_smoke.LAB_KERNELS)
    assert set(out["generate"]) == {"pallas/native", "pallas/int8", "gather/native",
                                    "gather/int8"}
    assert out["fleet"]["migrations"] >= 1 and out["fleet"]["sheds"] == 0
    assert out["loadgen"]["errors"] == 0 and out["platform"] == "cpu"
    assert out["served"] >= 4 + 4 * 4 + 2 * 4
    assert set(out["native_client"]["no_daemon"]["timing"]) == set(out["native_client"]["timing"])
    assert out["history_alerts"]["alert"]["health"] == "suspect"
    assert out["history_alerts"]["registry_tokens"] == 4 * tiny["daemon_alert_steps"]
    assert out["autoscale"]["scale_outs"] >= 1 and out["autoscale"]["scale_ins"] >= 1
    assert out["autoscale"]["sheds"] == 0 and out["autoscale"]["brownout"]["level"] == 0
    assert out["pools"]["handoffs"] == 4
    assert out["journal"]["replayed"] >= 1 and out["journal"]["resumed"] >= 1
