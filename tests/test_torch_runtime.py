"""tpulab_torch runtime: import hygiene, timing contract, device policy,
CLI, codecs and grammars against tpulab, the kernel loader, launch limits."""

import dataclasses
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulab.io import load_image as jax_load_image
from tpulab.io import protocol as jax_protocol
from tpulab.runtime.timing import parse_timing_device, parse_timing_line
from tpulab.utils.argcfg import coerce_cli_kwargs as jax_coerce

from tpulab_torch.io import load_image, protocol, save_image
from tpulab_torch.labs import get_workload, run_workload
from tpulab_torch.ops.cuda import _build
from tpulab_torch.runtime import device as devmod
from tpulab_torch.runtime.timing import (
    format_timing_line,
    measure_kernel_ms,
    summarize_samples,
)
from tpulab_torch.utils.argcfg import coerce_cli_kwargs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_tpulab():
    """Every module of the port, and chip_smoke.py, import without JAX, and
    without pandas, matplotlib, ml_dtypes or requests (the card's machine
    has none of them): a finder refuses them in the subprocess."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pandas', 'matplotlib', 'ml_dtypes', 'requests'):\n"
        "            raise ImportError(f'{name} is not on the card machine')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import tpulab_torch\n"
        "for m in pkgutil.walk_packages(tpulab_torch.__path__, 'tpulab_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'tpulab' or n.startswith('tpulab.')]\n"
        "assert not bad, bad\n"
        "assert {'tpulab_torch.obs.roofline', 'tpulab_torch.utils.download',\n"
        "        'tpulab_torch.models.speculative'} <= set(sys.modules)\n"
        "print('ok', len([n for n in sys.modules if n.startswith('tpulab_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert int(res.stdout.split()[1]) >= 40  # every module was imported


@pytest.mark.parametrize("label", ["CUDA", "CPU"])
@pytest.mark.parametrize("ms", [0.0, 0.000123, 1.5, 1234.56789])
def test_timing_line_parses_with_tpulab(label, ms):
    line = format_timing_line(label, ms)
    assert parse_timing_device(line) == label
    assert parse_timing_line(line) == pytest.approx(ms, abs=1e-6)


def test_measure_kernel_ms_cpu_counts_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    ms, out = measure_kernel_ms(fn, (torch.zeros(3),), device=torch.device("cpu"),
                                iters=7, warmup=2, outer=3)
    assert ms >= 0 and out.tolist() == [1.0, 1.0, 1.0]
    assert len(calls) == 2 + 3 * 7
    stats = summarize_samples([1.0, 2.0, 3.0])
    assert stats["median_ms"] == 2.0 and stats["n_trials"] == 3


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    text = protocol.format_lab2_input(str(tmp_path / "a.data"), str(tmp_path / "b.data"))
    with pytest.raises(RuntimeError, match="--backend cpu"):
        run_workload("lab2", backend=None, stdin_text=text)
    with pytest.raises(RuntimeError):
        devmod.resolve_device("cuda")
    assert devmod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        devmod.resolve_device("tpu")


@pytest.mark.parametrize("name,text,want", [
    ("lab5", None, "45"),
    ("hw1", "1 -3 2\n", "2.000000 1.000000"),
    ("hw2", "3\n2.5 -1 0\n", "-1.000000e+00 0.000000e+00 2.500000e+00 "),
])
def test_lab5_hw1_hw2_resolve_and_run(name, text, want, tmp_path, capsys):
    if name == "lab5":
        path = tmp_path / "int10"
        path.write_bytes(struct.pack("<i", 10) + np.arange(10, dtype="<i4").tobytes())
        text = f"{path}\n"
    assert get_workload(name).__name__ == f"tpulab_torch.labs.{name}"
    assert run_workload(name, backend="cpu", stdin_text=text, extra=["--reps", "1"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == want


def test_unknown_workload():
    with pytest.raises(KeyError):
        get_workload("lab9")


@pytest.mark.parametrize("tokens", [
    ["--seed", "7", "--flag"],
    ["--dtype=float32", "--reps", "3", "--x", "1.5"],
    ["--compute-dtype", "float64", "--cfg", '{"a": [1, 2]}', "--n", "none"],
])
def test_argcfg_matches_tpulab(tokens):
    assert coerce_cli_kwargs(tokens) == jax_coerce(tokens)


def test_protocol_grammars_match_tpulab():
    a, b = np.array([1.5, -2e100, 3.0]), np.array([0.25, 1e-3, -7.0])
    for launch in (None, (256, 256)):
        text = protocol.format_lab1_input(a, b, launch=launch)
        assert text == jax_protocol.format_lab1_input(a, b, launch=launch)
        mine = protocol.parse_lab1(text, sweep=launch is not None)
        ref = jax_protocol.parse_lab1(text, sweep=launch is not None)
        np.testing.assert_array_equal(mine.a, ref.a)
        assert mine.launch == ref.launch
    text = protocol.format_lab2_input("in.data", "out.data", launch=(32, 32, 16, 16))
    assert (dataclasses.asdict(protocol.parse_lab2(text, sweep=True))
            == dataclasses.asdict(jax_protocol.parse_lab2(text, sweep=True)))
    classes = [np.array([[0, 0], [1, 2]]), np.array([[3, 1]])]
    text = protocol.format_lab3_input("i", "o", classes, launch=(8, 64))
    mine, ref = protocol.parse_lab3(text, sweep=True), jax_protocol.parse_lab3(text, sweep=True)
    assert mine.launch == ref.launch and len(mine.classes) == len(ref.classes)
    for c1, c2 in zip(mine.classes, ref.classes):
        np.testing.assert_array_equal(c1.points, c2.points)
    v = np.array([1.0, -0.5, 1e100])
    assert protocol.format_vector_10e(v) == jax_protocol.format_vector_10e(v)


@pytest.mark.parametrize("rel", [
    "data/lab2/data/grad_3x3.txt",
    "data/lab2/data/rings_16x16.txt",
    "data/lab2/showcase/cityline_512.data",
    "data/lab2/showcase/cityline_512.png",
    "data/lab3/data/blobs_8x8.txt",
])
def test_image_codecs_match_tpulab(rel, tmp_path):
    path = str(REPO / rel)
    img = load_image(path)
    np.testing.assert_array_equal(img, jax_load_image(path))
    for ext in (".data", ".txt"):
        out = str(tmp_path / f"x{ext}")
        save_image(out, img)
        np.testing.assert_array_equal(jax_load_image(out), img)


def test_cli_subprocess_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "tpulab_torch", "run", "lab1", "--backend", "cpu"],
        input="3\n1 2 3\n0.5 -1e100 3\n", cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    first, payload = res.stdout.split("\n", 1)
    assert parse_timing_device(first) == "CPU" and parse_timing_line(first) is not None
    assert payload == "5.0000000000e-01 1.0000000000e+100 0.0000000000e+00 "


def test_gpu_info_on_cpu():
    out = get_workload("gpu_info").run(backend="cpu")
    assert out.startswith("Device cpu:") and "platform: cpu" in out


# ----------------------------------------------------------------- kernel loader


def test_build_commands_target_hopper_without_contraction(tmp_path):
    compiles, link = _build.compile_commands("nvcc", tmp_path)
    assert len(compiles) == len(_build.sources()) >= 4
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd and "-shared" not in cmd
    assert "-shared" in link and link[-len(compiles):] == [c[-1] for c in compiles]
    names = {p.name for p in _build.sources()}
    assert {"stencil.cu", "elementwise.cu", "classify.cu"} <= names


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    for src in _build.CSRC_DIR.glob("*.cu"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.source_hash()
    assert _build.source_hash() == first
    (tmp_path / "stencil.cu").write_text("// changed\n")
    assert _build.source_hash() != first


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.mark.parametrize("grid,block", [
    ((1,), (1025,)),
    ((1, 1), (32, 33)),
    ((0,), (32,)),
    ((4, 65536), (8, 8)),
    ((2**31,), (32,)),
    ((1, 1), (1, 2048)),
])
def test_refused_geometry_raises(grid, block):
    with pytest.raises(ValueError):
        _build.check_geometry(grid, block)


@pytest.mark.parametrize("grid,block", [((1,), (1,)), ((2**31 - 1,), (1024,)),
                                        ((16, 65535), (32, 32))])
def test_accepted_geometry(grid, block):
    _build.check_geometry(grid, block)


@pytest.mark.parametrize("smem,ok", [(0, True), (48 * 1024, True), (_build.MAX_SHARED, True),
                                     (_build.MAX_SHARED + 1, False), (256 * 1024, False)])
def test_shared_memory_over_the_block_limit_is_refused(smem, ok):
    if ok:
        _build.check_geometry((1,), (128,), smem)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            _build.check_geometry((1,), (128,), smem)


def test_tensor_core_flash_blocks_fit_in_shared_memory():
    from tpulab_torch.ops.cuda.attention import HEAD_DIMS, TC_KERNELS, tc_shared_bytes

    for d in HEAD_DIMS:
        for kernel in TC_KERNELS:
            _build.check_geometry((1,), (128,), tc_shared_bytes(d, kernel))
    assert tc_shared_bytes(64, "flash_fwd") == 1024 + 5 * 64 * 128
    assert tc_shared_bytes(64, "flash_dq") == 1024 + 6 * 64 * 128
    assert tc_shared_bytes(128, "flash_dq") == 1024 + 6 * 64 * 256
    assert tc_shared_bytes(128, "flash_dkv") == 1024 + 2 * 64 * 256 + 4 * 32 * 256 + 4 * 32 * 4
    with pytest.raises(ValueError):
        tc_shared_bytes(64, "paged_decode")
