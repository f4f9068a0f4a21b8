#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpulab_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible::

    python3 chip_smoke.py

It exits non-zero, and prints no result, when no card is visible or when
it runs in a directory without the package.  Phases, each fatal on
failure:

1. Print the card's name and power limit (``nvidia-smi``), then build the
   kernels from ``tpulab_torch/csrc/`` (``nvcc``, sm_90a).
2. The main path: lab1 (float64, n=1000), lab2 (1024x1024) and lab3
   (1024x1024, 8 classes, float64 and float32) through the CLI's own entry
   point, with every kernel's launch count set to 0 just before and read
   just after.  Each timing line must say ``CUDA``; each output must equal,
   byte for byte, the plain PyTorch version run on the card.  Then lab2
   once more as ``python -m tpulab_torch run lab2 --to-plot``.
3. The repository's committed lab2 and lab3 goldens, on the card.
4. Every kernel against its plain version at the main path's shapes and
   at a size where the card does real work (lab2 8192x8192, lab1
   n=2**26 float64, lab3 4096x4096 with 32 classes in float64 and
   float32), under two launch geometries, byte-equal; with the times of
   the kernel (CUDA events), of the plain version and, for the
   elementwise kernel, of ``torch.sub``, beside each kernel's bound.
5. One ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM's published rates (NVIDIA data sheet): 3.35 TB/s
of device memory, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
tensor cores.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
#: flops per pixel of the Roberts function: luminance (1 mul, 2 fma),
#: two differences, magnitude (1 mul, 1 fma, sqrt), clamp
ROBERTS_FLOPS_PER_PIXEL = 14
#: flops per pixel and class of the classify function (3 sub, 12 mul, 9 add)
CLASSIFY_FLOPS = 24

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# class points of the repository's lab3 goldens (the harness pins them)
LAB3_GOLDEN_POINTS = {
    "checker_6x6": [[[0, 0], [2, 0], [4, 2], [0, 4]], [[1, 0], [3, 0], [5, 2], [1, 4]]],
    "blobs_8x8": [
        [[0, 0], [1, 0], [0, 1], [1, 1]],
        [[6, 6], [7, 6], [6, 7], [7, 7]],
        [[6, 0], [7, 0], [6, 1], [7, 1]],
    ],
}
LAB2_GOLDENS = ("grad_3x3", "noise_4x4", "rings_16x16", "spot_1x5")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cli(argv, stdin_text: str) -> str:
    """Run ``tpulab_torch``'s CLI entry point in this process; its stdout."""
    from tpulab_torch.cli.main import main as cli_main

    out = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
    finally:
        sys.stdin = old_stdin
    check(rc == 0, f"{argv} exited with {rc}")
    return out.getvalue()


def timing_word(stdout: str) -> str:
    from tpulab_torch.runtime.timing import parse_timing_device, parse_timing_line

    check(parse_timing_line(stdout) is not None, f"no timing line in {stdout[:80]!r}")
    return parse_timing_device(stdout)


def bitwise_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[a.element_size()]
    return bool(torch.equal(a.view(ints), b.view(ints)))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the outputs' values (packed planes: per byte)."""
    import torch

    if a.dtype == torch.int32:  # packed RGBA: compare the bytes as values
        a = a.view(torch.uint8).to(torch.int16)
        b = b.view(torch.uint8).to(torch.int16)
        return float((a - b).abs().max()) if a.numel() else 0.0
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both_nan | (a == b), torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def time_ms(fn, args, device, iters: int) -> float:
    from tpulab_torch.runtime.timing import measure_kernel_ms

    ms, _ = measure_kernel_ms(fn, args, device=device, iters=iters, warmup=2, outer=3)
    return ms


# ----------------------------------------------------------------- main path


def make_inputs(sizes: dict, seed: int = 0) -> dict:
    """Seeded inputs of the main path, written under ``WORK``."""
    from tpulab_torch.io import protocol, save_image

    rng = np.random.default_rng(seed)
    WORK.mkdir(parents=True, exist_ok=True)
    n = sizes["lab1_n"]
    a, b = rng.uniform(-1e100, 1e100, n), rng.uniform(-1e100, 1e100, n)
    inp = {"lab1_text": protocol.format_lab1_input(a, b)}
    for lab, side in (("lab2", sizes["lab2_side"]), ("lab3", sizes["lab3_side"])):
        img = rng.integers(0, 256, (side, side, 4), np.uint8)
        path = str(WORK / f"{lab}_in.data")
        save_image(path, img)
        inp[f"{lab}_img"], inp[f"{lab}_in"] = img, path
    side = sizes["lab3_side"]
    inp["lab3_classes"] = [
        np.stack([rng.integers(0, side, 16), rng.integers(0, side, 16)], axis=1)
        for _ in range(sizes["lab3_nc"])
    ]
    inp["lab2_text"] = protocol.format_lab2_input(inp["lab2_in"], str(WORK / "lab2_out.data"))
    for dt in ("float64", "float32"):
        inp[f"lab3_text_{dt}"] = protocol.format_lab3_input(
            inp["lab3_in"], str(WORK / f"lab3_out_{dt}.data"), inp["lab3_classes"])
    return inp


def counters() -> dict:
    from tpulab_torch.ops.cuda.classify import classify_u32
    from tpulab_torch.ops.cuda.elementwise import binary
    from tpulab_torch.ops.cuda.stencil import roberts_u32

    return {"roberts": roberts_u32, "elementwise": binary, "classify": classify_u32}


def drive_main_path(inp: dict, backend: str) -> tuple:
    """The CLI runs of the main path; (stdouts, launches per kernel)."""
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    dev = ["--backend", backend]
    outs = {
        "lab1": cli(["run", "lab1", *dev], inp["lab1_text"]),
        "lab2": cli(["run", "lab2", *dev], inp["lab2_text"]),
        "lab3_float64": cli(["run", "lab3", *dev], inp["lab3_text_float64"]),
        "lab3_float32": cli(["run", "lab3", *dev, "--compute-dtype", "float32"],
                            inp["lab3_text_float32"]),
    }
    launches = {name: fn.launches for name, fn in wrappers.items()}
    return outs, launches


def check_main_path(inp: dict, outs: dict, device) -> None:
    """Outputs of the main path against the plain versions on ``device``."""
    import torch

    from tpulab_torch.io import load_image, protocol
    from tpulab_torch.ops.cuda.classify import classify_u32_plain, pack_stats
    from tpulab_torch.ops.cuda.elementwise import binary_plain
    from tpulab_torch.ops.cuda.stencil import roberts_u32_plain
    from tpulab_torch.ops.mahalanobis import class_statistics
    from tpulab_torch.ops.roberts import pack_rgba, unpack_rgba

    word = "CUDA" if device.type == "cuda" else "CPU"
    for name, stdout in outs.items():
        check(timing_word(stdout) == word, f"{name} timing line says {stdout.split()[0]}")

    parsed = protocol.parse_lab1(inp["lab1_text"])
    a = torch.from_numpy(parsed.a).to(device)
    b = torch.from_numpy(parsed.b).to(device)
    want = protocol.format_vector_10e(binary_plain("subtract", a, b).cpu().numpy())
    check(outs["lab1"].split("\n", 1)[1] == want, "lab1 payload differs from the plain version")

    plain2 = unpack_rgba(roberts_u32_plain(pack_rgba(inp["lab2_img"]).to(device)))
    check(np.array_equal(load_image(str(WORK / "lab2_out.data")), plain2),
          "lab2 output differs from the plain version")

    stats = class_statistics(inp["lab3_img"], inp["lab3_classes"])
    u = pack_rgba(inp["lab3_img"]).to(device)
    for dt, tdt in (("float64", torch.float64), ("float32", torch.float32)):
        plain3 = unpack_rgba(classify_u32_plain(u, pack_stats(stats.mean, stats.inv_cov, tdt, device)))
        check(np.array_equal(load_image(str(WORK / f"lab3_out_{dt}.data")), plain3),
              f"lab3 {dt} output differs from the plain version")


def check_sweep_subprocess(inp: dict) -> None:
    """lab2 through ``python -m tpulab_torch`` in sweep mode."""
    from tpulab_torch.io import load_image, protocol

    out = str(WORK / "lab2_sweep_out.data")
    text = protocol.format_lab2_input(inp["lab2_in"], out, launch=(32, 32, 16, 16))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "tpulab_torch", "run", "lab2", "--to-plot"],
                         input=text, capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    check(res.returncode == 0, f"python -m tpulab_torch failed: {res.stderr[-2000:]}")
    lines = res.stdout.splitlines()
    check(timing_word(lines[0]) == "CUDA" and lines[1:] == ["FINISHED!"],
          f"sweep stdout {res.stdout!r}")
    check(np.array_equal(load_image(out), load_image(str(WORK / "lab2_out.data"))),
          "sweep-mode lab2 output differs from the main-path output")


def check_goldens(backend: str) -> int:
    """The repository's committed lab2 and lab3 goldens, through the labs."""
    from tpulab_torch.io import load_image, protocol, save_image
    from tpulab_torch.labs import lab2, lab3

    n = 0
    for name in LAB2_GOLDENS:
        inp, out = str(WORK / f"g_{name}.data"), str(WORK / f"g_{name}_out.data")
        save_image(inp, load_image(str(ROOT / f"data/lab2/data/{name}.txt")))
        lab2.run(protocol.format_lab2_input(inp, out), backend=backend, warmup=0, reps=1)
        want = load_image(str(ROOT / f"data/lab2/data_out_gt/{name}.txt"))
        check(np.array_equal(load_image(out), want), f"lab2 golden {name} differs")
        n += 1
    for name, points in LAB3_GOLDEN_POINTS.items():
        inp, out = str(WORK / f"g_{name}.data"), str(WORK / f"g_{name}_out.data")
        save_image(inp, load_image(str(ROOT / f"data/lab3/data/{name}.txt")))
        classes = [np.asarray(p) for p in points]
        lab3.run(protocol.format_lab3_input(inp, out, classes), backend=backend,
                 warmup=0, reps=1)
        want = load_image(str(ROOT / f"data/lab3/data_out_gt/{name}.txt"))
        check(np.array_equal(load_image(out), want), f"lab3 golden {name} differs")
        n += 1
    return n


# ------------------------------------------------------- kernels vs plain


def bound(bytes_moved: float, flops: float, flop_rate: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held(kernel, plain, args, launches, device, iters, plain_iters, library=None):
    """Run ``kernel`` under each geometry in ``launches`` against ``plain``;
    the numbers of the first geometry."""
    want = plain(*args)
    worst = 0.0
    for launch in launches:
        got = kernel(*args, launch)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, want))
        check(bitwise_equal(got, want), f"{kernel.__name__} under {launch} differs from plain")
    row = {
        "max_abs_err": worst,
        "geometries": [list(g) if g is not None else "default" for g in launches],
        "ms": time_ms(lambda *a: kernel(*a, launches[0]), args, device, iters),
        "plain_ms": time_ms(plain, args, device, plain_iters),
        "library_ms": time_ms(library, args, device, iters) if library else None,
    }
    return row


def kernel_rows(inp: dict, sizes: dict, device) -> dict:
    import torch

    from tpulab_torch.ops.cuda import classify as k3
    from tpulab_torch.ops.cuda import elementwise as k2
    from tpulab_torch.ops.cuda import stencil as k1
    from tpulab_torch.ops.mahalanobis import class_statistics
    from tpulab_torch.ops.roberts import pack_rgba

    rng = np.random.default_rng(1)
    rows = {}

    # B1 roberts: main-path image, then the large one
    def b1(img, geoms, iters, plain_iters):
        u = pack_rgba(img).to(device)
        r = held(k1.roberts_u32, k1.roberts_u32_plain, (u,), geoms, device, iters, plain_iters)
        r["bound_ms"], r["bound_by"] = bound(8.0 * u.numel(),
                                             ROBERTS_FLOPS_PER_PIXEL * u.numel(), FP32_FLOPS)
        r["shape"] = list(img.shape[:2])
        return r

    big = sizes["b1_side"]
    rows["roberts"] = b1(inp["lab2_img"], [None, (32, 32, 16, 16)], 200, 20)
    rows["roberts"]["at_scale"] = b1(rng.integers(0, 256, (big, big, 4), np.uint8),
                                     [None, (16, 16, 64, 64)], 20, 3)

    # B2 elementwise: lab1's float64 subtract, then n = 2**26 in every dtype
    def b2(n, dtype, op, geoms, iters, plain_iters):
        a = torch.from_numpy(rng.uniform(-1e100, 1e100, n)).to(device)
        b = torch.from_numpy(rng.uniform(-1e100, 1e100, n)).to(device)
        if dtype != torch.float64:
            a, b = (a * 1e-98).to(dtype), (b * 1e-98).to(dtype)
        lib = {"subtract": torch.sub, "minimum": torch.minimum}[op]
        r = held(lambda x, y, g: k2.binary(op, x, y, g), lambda x, y: k2.binary_plain(op, x, y),
                 (a, b), geoms, device, iters, plain_iters, library=lib)
        r["bound_ms"], r["bound_by"] = bound(3.0 * n * a.element_size(), n,
                                             FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS)
        r["shape"], r["dtype"], r["op"] = [n], str(dtype).split(".")[1], op
        return r

    n_big = sizes["b2_n"]
    rows["elementwise"] = b2(sizes["lab1_n"], torch.float64, "subtract", [None, (1, 32)], 200, 50)
    rows["elementwise"]["at_scale"] = b2(n_big, torch.float64, "subtract",
                                         [None, (256, 256)], 20, 20)
    rows["elementwise"]["variants"] = [
        b2(n_big, dt, op, [None, (1024, 1024)], 20, 5)
        for dt in (torch.float32, torch.bfloat16) for op in ("subtract", "minimum")
    ]

    # B3 classify: lab3's image and classes, then 32 classes on the large image
    def b3(img, classes, dtype, geoms, iters, plain_iters):
        stats = class_statistics(img, classes)
        u = pack_rgba(img).to(device)
        s = k3.pack_stats(stats.mean, stats.inv_cov, dtype, device)
        r = held(k3.classify_u32, k3.classify_u32_plain, (u, s), geoms, device,
                 iters, plain_iters)
        nc = len(classes)
        r["bound_ms"], r["bound_by"] = bound(
            8.0 * u.numel() + s.numel() * s.element_size(), CLASSIFY_FLOPS * u.numel() * nc,
            FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS)
        r["shape"], r["nc"], r["dtype"] = list(img.shape[:2]), nc, str(dtype).split(".")[1]
        return r

    side = sizes["b3_side"]
    img = rng.integers(0, 256, (side, side, 4), np.uint8)
    classes = [np.stack([rng.integers(0, side, 16), rng.integers(0, side, 16)], axis=1)
               for _ in range(32)]
    rows["classify"] = b3(inp["lab3_img"], inp["lab3_classes"], torch.float64,
                          [None, (256, 256)], 50, 3)
    rows["classify"]["at_scale"] = b3(img, classes, torch.float64, [None, (256, 256)], 5, 2)
    rows["classify"]["float32"] = b3(inp["lab3_img"], inp["lab3_classes"], torch.float32,
                                     [None, (256, 256)], 50, 3)
    rows["classify"]["float32"]["at_scale"] = b3(img, classes, torch.float32,
                                                 [None, (256, 256)], 5, 2)
    return rows


KERNEL_META = {
    "roberts": ("tpulab_torch/csrc/stencil.cu", "tpulab/ops/pallas/stencil.py:82"),
    "elementwise": ("tpulab_torch/csrc/elementwise.cu", "tpulab/ops/pallas/elementwise.py:57"),
    "classify": ("tpulab_torch/csrc/classify.cu", "tpulab/ops/pallas/classify.py:83"),
}

FULL_SIZES = {
    "lab1_n": 1000, "lab2_side": 1024, "lab3_side": 1024, "lab3_nc": 8,
    "b1_side": 8192, "b2_n": 2**26, "b3_side": 4096,
}


def run(device, sizes: dict, backend: str) -> dict:
    """Phases 2 to 4 on ``device``; the ``kernels`` payload."""
    t0 = time.perf_counter()
    inp = make_inputs(sizes)
    outs, launches = drive_main_path(inp, backend)
    print(f"main path: {json.dumps(launches)} launches; " + "; ".join(
        f"{k}: {v.splitlines()[0]}" for k, v in outs.items()), flush=True)
    check_main_path(inp, outs, device)
    for name, count in launches.items():
        check(count > 0 or device.type == "cpu", f"kernel {name} was not launched on the main path")
    if device.type == "cuda":
        check_sweep_subprocess(inp)
    print(f"goldens: {check_goldens(backend)} byte-equal", flush=True)
    rows = kernel_rows(inp, sizes, device)
    kernels = []
    for name, row in rows.items():
        source, replaces = KERNEL_META[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **row})
    print(f"phases 2-4 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": kernels}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import tpulab_torch  # noqa: F401  (fails where the package is absent)
    from tpulab_torch.ops.cuda import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    library = _build.build()
    _build.load_library()
    print(f"built {library.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (library.parent / "build.log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  " + line.strip())

    payload = run(torch.device("cuda", 0), FULL_SIZES, "cuda")
    print(json.dumps(payload), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
