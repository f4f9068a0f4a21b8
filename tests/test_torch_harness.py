"""tpulab_torch's experiment harness, ``bench`` and ``selftest`` held against
tpulab's: each processor's stdin payloads and expected values for one
seed, the golden sweeps over ``data/`` against a port target, the
verification gate, ``summarize`` against tpulab's pandas ``summarize``,
the harness CLI end to end, and ``bench`` and ``selftest`` at a tiny size.
Every port target runs with ``backend="cpu"``."""

import asyncio
import csv
import math
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from tpulab.harness import processors as jax_processors
from tpulab.harness.tester import summarize as jax_summarize

from tpulab_torch import bench
from tpulab_torch.harness import InProcessTarget, SubprocessTarget, Tester, run_once
from tpulab_torch.harness import processors
from tpulab_torch.harness.processors.imageset import ImageDataset
from tpulab_torch.harness.run import main as harness_main
from tpulab_torch.harness.tester import summarize
from tpulab_torch.selftest import main as selftest_main
from tpulab_torch.utils import imgdata

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = {"warmup": 0, "reps": 1}


def _run(tester, proc):
    return asyncio.run(tester.run_experiments(proc))


def _tester(target, tmp_path, **kw):
    kw.setdefault("log", lambda *a, **k: None)
    return Tester(target, artifact_dir=str(tmp_path), **kw)


def _cpu_target(workload, **kw):
    config = dict(QUICK, **kw.pop("config", {}))
    return InProcessTarget(name=f"{workload}_cpu", device_label="CPU", workload=workload,
                           backend="cpu", config=config, **kw)


def _image_dirs(lab, out):
    return dict(dir_to_data=os.path.join(REPO, f"data/{lab}/data"), dir_to_data_out=str(out),
                dir_to_data_out_gt=os.path.join(REPO, f"data/{lab}/data_out_gt"))


# ------------------------------------------------- payloads equal tpulab's


def _payloads(proc, n=4):
    return [asyncio.run(proc.pre_process(device_info=f"dev__{i}")) for i in range(n)]


def _same_ctx(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_ctx(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize("name,kw", [
    ("lab1", {}), ("lab1", {"dtype": "float32"}), ("lab1", {"dtype": "bfloat16"}),
    ("hw1", {}), ("hw2", {}),
])
def test_synthetic_payloads_equal_tpulab(name, kw):
    mine = _payloads(processors.MAP_PROCESSORS[name](seed=7, **kw))
    theirs = _payloads(jax_processors.MAP_PROCESSORS[name](seed=7, **kw))
    for m, t in zip(mine, theirs):
        assert m.stdin_text == t.stdin_text and m.metadata == t.metadata
        _same_ctx(m.verify_ctx, t.verify_ctx)


@pytest.mark.parametrize("task", ["sum", "min", "max", "prod", "sort"])
@pytest.mark.parametrize("elem", ["int", "float", "uchar"])
def test_lab5_payloads_equal_tpulab(task, elem, tmp_path):
    kw = dict(seed=3, task=task, elem_type=elem, size_min=64, size_max=512)
    mine = _payloads(processors.Lab5Processor(workdir=str(tmp_path / "m"), **kw))
    theirs = _payloads(jax_processors.Lab5Processor(workdir=str(tmp_path / "t"), **kw))
    for m, t in zip(mine, theirs):
        assert m.stdin_text.replace(str(tmp_path / "m"), "") == \
            t.stdin_text.replace(str(tmp_path / "t"), "")
        path_m, path_t = m.stdin_text.split()[0], t.stdin_text.split()[0]
        assert open(path_m, "rb").read() == open(path_t, "rb").read()
        want, got = t.verify_ctx["expect"], m.verify_ctx["expect"]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype  # int64 for every integer type


@pytest.mark.parametrize("lab", ["lab2", "lab3"])
def test_image_payloads_equal_tpulab(lab, tmp_path):
    cls, jcls = processors.MAP_PROCESSORS[lab], jax_processors.MAP_PROCESSORS[lab]
    mine = _payloads(cls(seed=5, log=lambda *a: None, **_image_dirs(lab, tmp_path / "m")), 6)
    theirs = _payloads(jcls(seed=5, log=lambda *a: None, **_image_dirs(lab, tmp_path / "t")), 6)
    for m, t in zip(mine, theirs):
        assert m.stdin_text.replace(str(tmp_path / "m"), "") == \
            t.stdin_text.replace(str(tmp_path / "t"), "")
        assert m.metadata == t.metadata
        assert m.verify_ctx["golden"] == t.verify_ctx["golden"]


# ------------------------------------------------------------- the sweeps


@pytest.mark.parametrize("lab,kernel_sizes", [("lab2", [[[32, 32], [16, 16]]]),
                                              ("lab2", None), ("lab3", None)])
def test_golden_sweep_against_a_port_target(lab, kernel_sizes, tmp_path):
    proc = processors.MAP_PROCESSORS[lab](log=lambda *a: None, **_image_dirs(lab, tmp_path / "out"))
    target = _cpu_target(lab, sweep=kernel_sizes is not None)
    n_images = len(proc.dataset.paths)  # one run an image, round-robin
    rows = _run(_tester(target, tmp_path, k_times=n_images, kernel_sizes=kernel_sizes), proc)
    assert len(rows) == n_images and sum(r["image"].startswith(".") for r in rows) == 0
    assert all(r["verified"] is True and r["error"] is None for r in rows)
    assert all(r["device_reported"] == "CPU" for r in rows)
    assert (tmp_path / f"stats_{lab}_cpu.csv").exists()


def test_lab2_corruption_is_caught(tmp_path):
    class CorruptTarget(InProcessTarget):
        async def execute(self, stdin_text, sweep=None):
            out = await super().execute(stdin_text, sweep=sweep)
            path = stdin_text.splitlines()[1]
            blob = bytearray(open(path, "rb").read())
            blob[8] ^= 0xFF
            open(path, "wb").write(bytes(blob))
            return out

    proc = processors.Lab2Processor(verbose_diff=False, log=lambda *a: None,
                                    **_image_dirs("lab2", tmp_path / "out"))
    target = CorruptTarget(name="bad", workload="lab2", backend="cpu", config=QUICK)
    rows = _run(_tester(target, tmp_path, k_times=1), proc)
    assert not any(r["verified"] for r in rows)


def test_verification_gate_withholds_stats(tmp_path):
    target = _cpu_target("lab1")
    proc = processors.Lab1Processor(seed=2, size_min=32, size_max=64, op="add")
    rows = _run(_tester(target, tmp_path, k_times=2), proc)
    assert not any(r["verified"] for r in rows)
    assert (tmp_path / "failed_lab1_cpu.csv").exists()
    assert not (tmp_path / "stats_lab1_cpu.csv").exists()
    with open(tmp_path / "runs_lab1_cpu.csv") as f:
        assert len(list(csv.DictReader(f))) == 2


@pytest.mark.parametrize("workload,cfg,proc_kw", [
    ("hw1", {"timing": True}, {}),
    ("hw2", {"timing": True}, {}),
    ("lab5", {}, {"task": "sum", "elem_type": "float"}),
    ("lab5", {"task": "sort"}, {"task": "sort", "elem_type": "uchar"}),
    ("lab1", {"dtype": "bfloat16"}, {"dtype": "bfloat16", "size_min": 16, "size_max": 64}),
])
def test_small_workload_sweeps_verify(workload, cfg, proc_kw, tmp_path):
    if workload == "lab5":
        proc_kw = dict(proc_kw, workdir=str(tmp_path / "work"))
    proc = processors.MAP_PROCESSORS[workload](seed=9, **proc_kw)
    rows = _run(_tester(_cpu_target(workload, config=cfg), tmp_path, k_times=3), proc)
    assert all(r["verified"] is True for r in rows), [r["error"] for r in rows]


def test_summarize_equals_tpulab_pandas():
    rng = np.random.default_rng(1)
    rows = []
    for i in range(40):
        t = float(rng.uniform(0.1, 2.0)) if i % 7 else None
        rows.append({"device": ["CUDA", "CPU"][i % 2],
                     "kernel_size": str([None, [1, 32], 5][i % 3]),
                     "time_kernel_ms": t, "verified": True})
    rows.append({"device": "CPU", "kernel_size": "solo", "time_kernel_ms": 1.5, "verified": True})
    rows.append({"device": "CPU", "kernel_size": "none", "time_kernel_ms": None, "verified": True})
    mine = summarize(rows)
    theirs = jax_summarize(pd.DataFrame(rows)).to_dict("records")
    assert len(mine) == len(theirs)
    for m, t in zip(mine, theirs):
        for col in ("device", "kernel_size", "count"):
            assert m[col] == t[col]
        for col in ("mean", "median", "min", "max", "std"):
            assert (math.isnan(m[col]) and math.isnan(t[col])) or \
                m[col] == pytest.approx(t[col], rel=1e-12)


def test_plot_is_best_effort(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a machine without it
    logs = []
    proc = processors.Hw1Processor(seed=1)
    rows = _run(Tester(_cpu_target("hw1", config={"timing": True}), artifact_dir=str(tmp_path),
                       k_times=2, log=logs.append), proc)
    assert all(r["verified"] for r in rows)
    assert any("plot skipped" in line for line in logs)
    assert (tmp_path / "stats_hw1_cpu.csv").exists()


def test_extra_links_wait_for_download(tmp_path, capsys):
    """An extra link is fetched through ``utils/download``; one that cannot
    be fetched (nothing listens on localhost:1) is skipped with a log
    line, and the data dir's own images stay the dataset, as in tpulab."""
    data = os.path.join(REPO, "data/lab2/data")
    ds = ImageDataset(data, str(tmp_path / "o"), extra_links_to_png=["http://localhost:1/x.png"])
    want = jax_processors.imageset.ImageDataset(
        data, str(tmp_path / "j"), extra_links_to_png=["http://localhost:1/x.png"])
    assert ds.paths == want.paths and ds.paths
    assert capsys.readouterr().out.count("[download_file] skipped http://localhost:1/x.png") == 2


def test_protected_dirs_are_read_on_every_call(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text(open(os.path.join(REPO, "data/lab2/data/grad_3x3.txt")).read())
    monkeypatch.setenv("TPULAB_PROTECTED_DIRS", str(src))
    imgdata.ImgData(str(src / "a.txt"))
    assert sorted(os.listdir(src)) == ["a.txt"]
    monkeypatch.setenv("TPULAB_PROTECTED_DIRS", str(tmp_path / "elsewhere"))
    imgdata.ImgData(str(src / "a.txt"))
    assert sorted(os.listdir(src)) == ["a.data", "a.png", "a.txt"]


def test_subprocess_target_speaks_the_contract():
    argv = [sys.executable, "-m", "tpulab_torch", "run", "lab1", "--backend", "cpu",
            "--warmup", "0", "--reps", "1"]
    env_path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + env_path if env_path else "")
    try:
        record = asyncio.run(run_once(SubprocessTarget(name="sub", argv=argv),
                                      processors.Lab1Processor(seed=4, size_min=8, size_max=16)))
    finally:
        os.environ["PYTHONPATH"] = env_path
    assert record.error is None, record.error
    assert record.verified is True and record.device_reported == "CPU"


# ------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("lab", ["lab2", "lab3"])
def test_harness_cli_golden_sweep_with_cpu_ref(lab, tmp_path):
    d = _image_dirs(lab, tmp_path / "out")
    rc = harness_main(["--lab", lab, "--backend", "cpu", "--cpu-ref", "--k-times", "2",
                       "--artifact-dir", str(tmp_path / "a"), "--warmup", "0", "--reps", "1",
                       "--dir_to_data", d["dir_to_data"], "--dir_to_data_out", d["dir_to_data_out"],
                       "--dir_to_data_out_gt", d["dir_to_data_out_gt"]])
    assert rc == 0
    with open(tmp_path / "a" / f"stats_tpulab_torch_{lab}.csv") as f:
        stats = list(csv.DictReader(f))
    assert {s["device"] for s in stats} == {"CPU"} and sum(int(s["count"]) for s in stats) > 0
    with open(tmp_path / "a" / f"runs_tpulab_torch_{lab}.csv") as f:
        runs = list(csv.DictReader(f))
    assert {r["bin_name"] for r in runs} == {f"tpulab_torch_{lab}", f"tpulab_torch_{lab}_cpu"}
    assert all(r["verified"] == "True" for r in runs)


def test_harness_cli_lab1_sweep_and_lab5(tmp_path):
    assert harness_main(["--lab", "lab1", "--backend", "cpu", "--k-times", "1",
                         "--kernel-sizes", "[[1, 32], [4, 256]]",
                         "--artifact-dir", str(tmp_path / "l1"), "--size_min", "16",
                         "--size_max", "32", "--warmup", "0", "--reps", "1"]) == 0
    for task in ("sum", "sort"):
        assert harness_main(["--lab", "lab5", "--backend", "cpu", "--k-times", "1",
                             "--task", task, "--artifact-dir", str(tmp_path / task),
                             "--workdir", str(tmp_path / "w"), "--warmup", "0", "--reps", "1"]) == 0


def test_harness_cli_lab5_mesh_engages_over_gloo_ranks_and_equals_tpulab(tmp_path,
                                                                          monkeypatch):
    """Where ``--mesh`` engages, the harness's lab5 run goes over gloo ranks
    and its result equals ``tpulab``'s lab5 on a mesh of the same size."""
    # where the mesh engages (eight devices, --mesh 4) the run goes over four
    # gloo ranks, is verified, and its result is tpulab's lab5 on a mesh of four
    from tpulab.labs import lab5 as jax_lab5

    from tpulab_torch.labs import lab5

    monkeypatch.setattr(lab5, "device_count", lambda device: 8)
    rc = harness_main(["--lab", "lab5", "--backend", "cpu", "--k-times", "1", "--mesh", "4",
                       "--artifact-dir", str(tmp_path), "--workdir", str(tmp_path / "w"),
                       "--warmup", "0", "--reps", "1", "--return-task-res", "--return-inp"])
    assert rc == 0
    with open(tmp_path / "runs_tpulab_torch_lab5.csv") as f:
        (run,) = list(csv.DictReader(f))
    assert run["verified"] == "True" and run["device_reported"] == "CPU"
    want = jax_lab5.run(run["input_str"], backend="cpu", mesh=4, warmup=0, reps=1)
    assert run["task_result"] == want.splitlines()[1]


def test_bench_rows_at_a_tiny_size():
    rows = [row for name in bench.LAB_ROWS
            for row in bench.run_benchmarks(only=name, backend="cpu", size=16, nc=2, iters=2,
                                            n=4096, reps=2)]
    names = [r["metric"] for r in rows]
    assert names == ["lab1_subtract_n1000_float64_median_ms",
                     "lab1_subtract_n1048576_float32_median_ms",
                     "lab2_roberts_16x16_median_ms", "lab3_classify_16x16_nc2_median_ms",
                     "hw2_sort_n4096_f32_median_ms", "lab5_reduce_sum_n4096_i32_median_ms"]
    for row in rows:
        assert row["device"] == "cpu" and row["unit"] == "ms" and row["value"] > 0
        assert {"median_ms", "min_ms", "p25_ms", "p75_ms", "iqr_ms", "n_trials"} <= set(row)
    assert rows[0]["vs_baseline"] is not None and rows[3]["vs_baseline"] is None


def test_bench_card_fields_name_the_card(monkeypatch):
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    bench.card_fields.cache_clear()
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: Done())
    try:
        assert bench.card_fields("cuda") == {"device": "cuda", "card": "NVIDIA H100 80GB HBM3",
                                             "power_limit": "700.00 W"}
    finally:
        bench.card_fields.cache_clear()


def test_selftest_passes_and_fails_on_the_cpu(capsys, monkeypatch):
    assert selftest_main(["--backend", "cpu", "--skip", "train", "--skip", "serving"]) == 0
    out = capsys.readouterr().out
    assert "[selftest] OK (5/5 run, 2 skipped)" in out

    from tpulab_torch import selftest

    def broken(device):
        raise AssertionError("planted")

    monkeypatch.setattr(selftest, "CHECKS", [("broken", broken)] + selftest.CHECKS[:1])
    assert selftest_main(["--backend", "cpu"]) == 1
    assert "[selftest] FAIL  broken" in capsys.readouterr().out


def test_chip_smoke_lab_suite_phase_rehearses_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 8 at a tiny size, on the CPU (plain versions)."""
    import chip_smoke

    tiny = dict(lab5_n=4096, lab5_sort_n=2048, hw2_n=512, harness_side=64, harness_k=2,
                bench=dict(size=16, nc=2, iters=2, n=4096, reps=2),
                selftest_skip=["train", "serving"])
    suite, launches = chip_smoke.run_lab_suite_path(tiny, torch.device("cpu"), "cpu",
                                                    work=tmp_path)
    assert {r["file"] for r in suite["lab5"]} >= {"int32", "uint8", "float32", "specials"}
    assert all(r["raw_torch_sort_equal"] for r in suite["sort"])  # on the CPU it keeps the order
    assert suite["harness"]["lab2_seeded"]["runs"] == 2
    assert len(suite["bench"]) == 6 and suite["selftest"].startswith("[selftest] OK")
    assert set(launches.values()) == {0}  # no kernel on the CPU
