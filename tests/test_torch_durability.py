"""tpulab_torch.durability and the daemon's journal, held against tpulab.

The two packages keep one record format: the same seeded operations
(accepts, checkpoints at a small cadence, terminal records, compaction)
through each package's ``Journal`` write byte-equal files, and each
package's ``scan`` folds either file to the same ``JournalState``
(entries, record count, torn flag), a torn final record included;
interior corruption raises ``JournalCorrupt`` in both.

On the daemon (both daemons in one process, serving ``trained_small`` on
the CPU): the journal is off by default and arming it changes no byte;
resume-by-rid skips exactly the acknowledged prefix; a journal left by a
crash mid-decode (accept, one checkpoint, a torn tail), and the same
journal written by tpulab's ``Journal``, recovers in each daemon to
bytes equal to each other's and to a run with no fault, then records
``done ok`` so a second restart replays nothing; a cancelled rid is not
replayed; shed and failed requests journal their outcome.  A journal
that cannot be opened raises instead of serving without it.  Live: a
``daemon.kill`` fault ends ``python -m tpulab_torch daemon --journal J``
after the accept's fsync, and the restarted daemon answers the client's
``resume`` with the bytes of a fault-free submission.
"""

import json
import os
import pathlib
import random
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

import tpulab.daemon as jd
import tpulab.models.generate as jgen
from tpulab import durability as jdur
from tpulab.models import labformer as jlf

import tpulab_torch.daemon as td
import tpulab_torch.models.generate as tgen
from tpulab_torch import client as tclient
from tpulab_torch import durability as tdur
from tpulab_torch.models import labformer as tlf

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ops(seed, n_rids=5):
    """A seeded sequence of journal operations."""
    rng = random.Random(seed)
    ops = []
    streams = {f"r{i}": [] for i in range(n_rids)}
    for rid in streams:
        ops.append(("accept", rid, rng.choice(("", "t1")),
                    bytes(rng.randrange(256) for _ in range(rng.randint(1, 9))),
                    {"steps": rng.randint(4, 40), "rid": rid}))
    for _ in range(60):
        rid = rng.choice(list(streams))
        streams[rid] = streams[rid] + [rng.randrange(256) for _ in range(rng.randint(1, 4))]
        ops.append(("tokens", rid, list(streams[rid])))
    for rid in list(streams)[:3]:
        status = rng.choice(("ok", "cancelled", "error", "shed"))
        ops.append(("done", rid, status, streams[rid] if status == "ok" else None))
    return ops


def _apply(dur, path, ops, compact_at=None):
    j = dur.Journal(path, ckpt_every=3)
    for i, op in enumerate(ops):
        if compact_at is not None and i == compact_at:
            j.compact()
        if op[0] == "accept":
            j.append_accept(*op[1:])
        elif op[0] == "tokens":
            j.note_tokens(op[1], op[2])
        else:
            j.append_done(op[1], op[2], tokens=op[3])
    j.close()


def _state(st):
    return ({rid: (e.rid, e.accept, e.ckpt, e.done) for rid, e in st.entries.items()},
            st.records, st.torn)


@pytest.mark.parametrize("seed,compact_at", [(0, None), (1, None), (2, 30), (3, 50)])
def test_same_operations_same_bytes_and_state(seed, compact_at, tmp_path):
    ops = _ops(seed)
    jp, tp = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    _apply(jdur, jp, ops, compact_at)
    _apply(tdur, tp, ops, compact_at)
    assert tp.read_bytes() == jp.read_bytes()
    states = [_state(scan(p)) for scan in (jdur.scan, tdur.scan) for p in (jp, tp)]
    assert all(s == states[0] for s in states)
    assert states[0][0]  # the journal holds entries
    for scan in (jdur.scan, tdur.scan):
        st = scan(tp)
        assert list(st.incomplete()) == list(jdur.scan(jp).incomplete())
        assert list(st.completed_ok()) == list(jdur.scan(jp).completed_ok())


@pytest.mark.parametrize("cut", [7, 19, 2])
def test_torn_final_record_read_alike(cut, tmp_path):
    ops = _ops(5)
    src = tmp_path / "src.jsonl"
    _apply(tdur, src, ops)
    raw = src.read_bytes()
    torn = tmp_path / "torn.jsonl"
    torn.write_bytes(raw[:-cut])  # the process died mid-append
    jst, tst = jdur.scan(torn), tdur.scan(torn)
    assert _state(tst) == _state(jst) and tst.torn
    # a torn INTERIOR record is corruption in both packages
    lines = raw.split(b"\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_bytes(b"\n".join(lines[:3] + [lines[3][:5]] + lines[4:]))
    for scan, corrupt in ((jdur.scan, jdur.JournalCorrupt), (tdur.scan, tdur.JournalCorrupt)):
        with pytest.raises(corrupt, match="unparseable interior record at line 4"):
            scan(bad)
    assert _state(tdur.scan(tmp_path / "missing.jsonl")) == ({}, 0, False)


@pytest.mark.parametrize("payload", [b"", b"\x00\xff hello", bytes(range(256))])
def test_payload_codec_equal(payload):
    assert tdur.encode_payload(payload) == jdur.encode_payload(payload)
    assert tdur.decode_payload(jdur.encode_payload(payload)) == payload


def test_journal_that_cannot_open_raises(tmp_path):
    (tmp_path / "ro").mkdir()
    target = tmp_path / "ro" / "sub"
    target.write_bytes(b"")  # a FILE where the journal wants a directory
    with pytest.raises(OSError):
        tdur.Journal(target / "j.jsonl")
    with pytest.raises(ValueError, match="ckpt_every"):
        tdur.Journal(tmp_path / "k.jsonl", ckpt_every=0)


# ------------------------------------------------------------ the daemon

@pytest.fixture
def daemons(trained_small, trained_small_cfg, monkeypatch):
    tcfg = tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))
    monkeypatch.setattr(jgen, "demo_config", lambda: trained_small_cfg)
    monkeypatch.setattr(jgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(tgen, "demo_config", lambda: tcfg)
    monkeypatch.setattr(tgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(td, "BACKEND", "cpu")
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_SERVE_MAX_SEQ", 128)
        monkeypatch.setattr(mod, "_FLEETS", {})
        monkeypatch.setattr(mod, "_RESUME", {})
        monkeypatch.setattr(mod, "_JOURNAL", None)
    monkeypatch.setattr(jd, "_ENGINES", {})
    yield


def _gen(mod, config, payload):
    return mod.handle_request({"lab": "generate", "config": config}, payload)


def test_journal_off_by_default_and_armed_bit_equal(daemons, tmp_path, monkeypatch):
    payload = b"hello"
    cfg = {"steps": 12, "rid": "bit-1"}
    off = _gen(td, dict(cfg), payload)
    assert off == _gen(jd, dict(cfg), payload) and len(off) == 12
    assert td._resume_lookup("bit-1") is None
    jnl = tdur.Journal(tmp_path / "j.jsonl", on_record=td._C_JOURNAL_RECORDS.inc)
    monkeypatch.setattr(td, "_JOURNAL", jnl)
    c0 = td._C_JOURNAL_RECORDS.value
    assert _gen(td, dict(cfg), payload) == off
    jnl.flush()
    e = jdur.scan(tmp_path / "j.jsonl").entries["bit-1"]  # tpulab reads the port's file
    assert jdur.decode_payload(e.accept["payload"]) == payload
    assert e.done["status"] == "ok" and bytes(t & 0xFF for t in e.done["tokens"]) == off
    assert td._C_JOURNAL_RECORDS.value - c0 >= 2
    chunks = []
    for k in (0, 5, len(off)):
        chunks.clear()
        out = td.handle_request({"lab": "resume", "config": {"rid": "bit-1", "received": k,
                                                             "stream": True}},
                                b"", send_chunk=chunks.append)
        assert out == off and b"".join(chunks) == off[k:]
    for cfg_, err in (({"rid": "nope"}, "resume unknown rid=nope"),
                      ({"rid": "bit-1", "received": -1}, "received must be >= 0"),
                      ({}, "resume needs config")):
        with pytest.raises(ValueError, match=re.escape(err)):
            td.handle_request({"lab": "resume", "config": cfg_}, b"")
    jnl.close()


def _crashed_journal(dur, path, payload, toks):
    """What a daemon killed mid-decode leaves: accept, one checkpoint,
    and a torn final record."""
    j = dur.Journal(path, ckpt_every=5)
    j.append_accept("t-rec", "tr", payload, {"steps": 12, "rid": "t-rec"})
    j.note_tokens("t-rec", toks[:5])
    j.close()
    with open(path, "ab") as f:
        f.write(b'{"t":"ckpt","rid":"t-rec","n":9,"to')


@pytest.mark.parametrize("writer", ["port", "tpulab"])
def test_restart_recovery_bit_equal_across_packages(daemons, tmp_path, writer):
    payload = b"crashed"
    want = _gen(td, {"steps": 12}, payload)
    assert want == _gen(jd, {"steps": 12}, payload)
    toks = list(want)
    outs = {}
    for name, mod, dur in (("port", td, tdur), ("jax", jd, jdur)):
        path = tmp_path / f"{name}.jsonl"
        _crashed_journal(tdur if writer == "port" else jdur, path, payload, toks)
        jnl = dur.Journal(path)
        r0 = mod._C_RECOVERIES.value
        assert mod._recover_from_journal(jnl) == 1
        outs[name] = mod.handle_request(
            {"lab": "resume", "config": {"rid": "t-rec", "received": 0}}, b"")
        assert mod._C_RECOVERIES.value == r0 + 1
        jnl.close()
        e = tdur.scan(path).entries["t-rec"]
        assert e.done["status"] == "ok" and bytes(e.done["tokens"]) == want
        mod._RESUME.clear()
        jnl2 = dur.Journal(path)
        assert mod._recover_from_journal(jnl2) == 0  # idempotent restart
        assert mod.handle_request({"lab": "resume", "config": {"rid": "t-rec",
                                                               "received": 3}}, b"") == want
        assert mod._C_RECOVERIES.value == r0 + 1
        jnl2.close()
    assert outs["port"] == outs["jax"] == want


def test_cancelled_not_replayed_and_failures_journaled(daemons, tmp_path, monkeypatch):
    path = tmp_path / "c.jsonl"
    j = tdur.Journal(path)
    j.append_accept("t-can", "", b"bye", {"steps": 8})
    j.append_done("t-can", "cancelled")
    j.close()
    jnl = tdur.Journal(path)
    assert td._recover_from_journal(jnl) == 0
    with pytest.raises(ValueError, match="resume unknown rid"):
        td.handle_request({"lab": "resume", "config": {"rid": "t-can"}}, b"")
    assert tdur.scan(path).entries == {}
    monkeypatch.setattr(td, "_JOURNAL", jnl)
    with pytest.raises(ValueError, match="rid must be"):
        _gen(td, {"steps": 2, "rid": "x" * 300}, b"hi")
    monkeypatch.setattr(td._FLEET_SERVICE, "generate",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        _gen(td, {"steps": 2, "rid": "t-err"}, b"hi")
    st = jnl.scan()
    assert st.entries["t-err"].done["status"] == "error" and st.incomplete() == {}
    with pytest.raises(RuntimeError, match="boom"):
        td.handle_request({"lab": "resume", "config": {"rid": "t-err"}}, b"")
    jnl.close()


# ------------------------------------------------------- live subprocess

def _spawn(sock, log, *extra, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "tpulab_torch", "daemon", "--backend", "cpu",
         "--socket", str(sock), "--metrics-interval", "0", *extra],
        env=env, stdout=open(log, "ab"), stderr=subprocess.STDOUT, cwd=str(ROOT))


def _wait_socket(sock, proc, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pathlib.Path(sock).exists():
            return
        assert proc.poll() is None, "daemon exited before binding"
        time.sleep(0.05)
    raise AssertionError("daemon socket never appeared")


def _retry(sock, lab, config, payload=b"", deadline_s=120.0):
    end = time.monotonic() + deadline_s
    while True:
        try:
            return tclient.request(str(sock), lab, config, payload)
        except (ConnectionError, FileNotFoundError, OSError):
            if time.monotonic() > end:
                raise
            time.sleep(0.1)


def test_kill_and_restart_resumes_live(tmp_path):
    sock, journal, log = tmp_path / "k.sock", tmp_path / "k.jsonl", tmp_path / "daemon.log"
    payload = b"hello"
    schedule = json.dumps([{"site": "daemon.kill", "kind": "kill", "at": 1}])
    proc = _spawn(sock, log, "--journal", str(journal), env_extra={"TPULAB_FAULTS": schedule})
    proc2 = None
    try:
        _wait_socket(sock, proc)
        with pytest.raises((ConnectionError, OSError)):
            tclient.request(str(sock), "generate", {"steps": 6, "rid": "kill-1"}, payload)
        assert proc.wait(timeout=60) == 1  # os._exit(1), no cleanup
        st = jdur.scan(journal)  # tpulab's scan reads the port's journal
        assert list(st.incomplete()) == ["kill-1"]
        proc2 = _spawn(sock, log, "--journal", str(journal))
        _wait_socket(sock, proc2)
        out = _retry(sock, "resume", {"rid": "kill-1", "received": 0})
        want = _retry(sock, "generate", {"steps": 6, "rid": "kill-ref"}, payload)
        assert out == want and len(out) == 6
        text = _retry(sock, "metrics", {}).decode()
        for pat in (r"^daemon_recoveries [1-9]", r"^daemon_resumed_streams [1-9]",
                    r"^daemon_journal_records [1-9]"):
            assert re.search(pat, text, re.M), pat
        proc2.send_signal(signal.SIGTERM)
        assert proc2.wait(timeout=60) == 0
        proc2 = None
        assert tdur.scan(journal).incomplete() == {}  # compacted clean
        assert b"graceful shutdown" in log.read_bytes()
    finally:
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)
