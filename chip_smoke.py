#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpulab_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible::

    python3 chip_smoke.py
    python3 chip_smoke.py --parent DIR   # phases 4, 6c and 7d also time DIR in turns

It exits non-zero, and prints no result, when no card is visible or when
it runs in a directory without the package.  Phases, each fatal on
failure:

1. Print the card's name and power limit (``nvidia-smi``), then build the
   kernels from ``tpulab_torch/csrc/`` (``nvcc``, sm_90a), and read the
   built library's SASS (``cuobjdump -sass``): every bfloat16 instance of
   B4, B5 and B6 must hold ``wgmma`` (``HGMMA``), and the float32
   instances of B4-B6 no tensor-core instruction; the instructions, the
   ``ULDC`` and the integer<->float conversions (``I2F``/``F2I``) of B1
   and B3 are counted: B1 converts no pixel (at most one of each, its
   work index's division).
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
   B1 also at widths 4k + 1, 2, 3, 1xN, Nx1 and 1x1 under three
   geometries.  B3 in float64 also on a 4096x4096 image that holds each
   of the 2^24 colours once, against 32 random classes and each set of
   :func:`b3_class_sets`, under three geometries, and with the near-tie
   set's margins and flags zeroed (a planted fault that must differ); each
   float64 row reports the screen's candidates.  With ``--parent DIR``,
   B1 at 1024^2 and 8192^2 and B3 float64 at 1024^2/nc=8 and
   4096^2/nc=32 from DIR and from this checkout in turns
   (``IN_TURNS_LAB``).
5. The model path.  Each run of it is made with every launch count set to
   0 just before and read just after, and must launch the flash kernel
   (B4) once per layer of each 1024-token prefill and no lab kernel:

   a. ``tpulab_torch generate`` through the CLI's entry point: the demo
      labformer (d128, 8 heads, 4 layers, float32) greedy over a seeded
      1024-byte prompt for 32 steps;
   b. the serving labformer (d512, 8 heads, head_dim 64, 8 layers, d_ff
      2048; ``tpulab/bench.py:244-247``) in float32, batch 1, a
      1024-token prompt, on the card and on the CPU (plain versions):
      prefill logits within 1e-3, and greedy tokens equal up to the first
      step whose CPU top-2 margin is below 1e-2;
   c. the same model in bfloat16, batch 8, 1024-token prompts: prefill ms
      (CUDA events around each of 3 calls, the median), decode ms per
      token (CUDA events around each of 8 runs of 8 decode steps after one
      prefill: the median and every run), and ``generate`` of 64 tokens;
   d. B4 against its plain version, element by element within
      ``o_tolerance``, at the two main-path shapes, at (8, 8, 4096, 64)
      causal in bfloat16 and float32, and with a window, GQA and a query
      offset; at the bfloat16 main-path and at-scale shapes the same limit
      must reject the plain version with one key tile skipped.  Its time
      stands beside its bound and beside ``scaled_dot_product_attention``
      (``is_causal``, or the window's band as a boolean mask) wherever
      that computes the same function.
6. The training path.  Each run of it is made with every launch count set
   to 0 just before and read just after, and must launch B4 (flash
   forward), B5 (flash dq) and B6 (flash dk, dv) once per layer of each
   step, and no lab kernel; phase 5's serving runs must launch neither B5
   nor B6:

   a. ``tpulab_torch train`` through the CLI's entry point: the CLI's
      labformer (d128, 8 heads, head_dim 16, 4 layers, float32), ``--seq
      1024 --batch 2 --steps 4``: finite losses and the final JSON line;
   b. the flagship training config (d512, 8 heads, head_dim 64, 8 layers,
      d_ff 2048; ``tpulab/bench.py:142-149``) in float32 at batch 1, 1024
      tokens, 3 adamw steps on the card and on the CPU (plain versions):
      the losses of every step within ``TRAIN_LOSS_RTOL``, the first
      step's gradients leaf by leaf within ``TRAIN_GRAD_REL`` of the
      leaf's largest magnitude;
   c. the same config in bfloat16 at batch 8, 2048 tokens: step ms (CUDA
      events around each of 5 steps: the median and every step), tokens/s,
      peak device memory, and one profiled step.  With ``--parent DIR``
      (another checkout, such as the parent commit unpacked with ``git
      archive``), the same step and B5 at the training shape from DIR and
      from this checkout in turns, parent, change, change, parent, each in
      a process of its own;
   d. B5 and B6, fed B4's lse, against the plain backward on the same
      lse, element by element within ``grad_tolerance``, at (8, 8, 2048,
      64) bfloat16 (the training step's shape), at (8, 8, 4096, 64) in
      bfloat16 and float32, and with a window, GQA and a query offset
      with an lse cotangent; at the training shape the same limit must
      reject the plain backward with one key tile skipped.  Their times
      stand beside their bounds, their plain versions and the backward of
      ``scaled_dot_product_attention`` (``torch.autograd.grad`` of its
      output alone; dq, dk and dv together), wherever that computes the
      same function.
7. The paged serving path (``tpulab_torch.models.paged.PagedEngine``).
   Each run of it is made with every launch count set to 0 just before
   and read just after, and must launch the paged-decode kernel (B7) once
   per layer of each tick under ``attn="pallas"`` and never under
   ``"gather"``, and no other kernel (its prompts are too short for B4):

   a. ``tpulab``'s paged bench at full width (``tpulab/bench.py:290-341``):
      d512, 8 heads, 2 kv heads, 8 layers, d_ff 2048, bfloat16, random
      weights from seed 0; 8 slots, 256 blocks of 16, max_seq 256; 8
      requests of (8, 17, 5, 33, 9, 21, 12, 7) prompt tokens and 64 new
      tokens each.  With ``attn="pallas"``, ``"gather"`` and ``"pallas"``
      over int8 KV: tokens/s (wall clock, the median of 3 waves after one
      warm-up wave), ms per tick, and one profiled wave;
   b. the same model in float32 with ``"pallas"`` on the card against the
      port on the CPU, and ``"pallas"`` against ``"gather"`` on the card:
      each request's greedy stream equal up to its first step whose CPU
      top-2 margin is below 1e-2;
   c. the daemon's engine settings (``tpulab/daemon.py:2656-2680``): 4
      slots, 128 blocks of 16, max_seq 512, ``prefill_chunk`` 32,
      interleaved; requests sharing a 128-token prefix with tails up to 300
      tokens: prefix hits, prefill chunks, no stalled tick, host syncs and
      no leaked block;
   d. B7 against its plain version, element by element within
      ``paged_over_tolerance``, at the bench's shape (8 slots, 8 heads, 2 kv
      heads, head_dim 64, 16 blocks of 16, bfloat16, ragged lengths with 0
      and block edges) and at 64 slots of 4096 positions (native, int8, a
      256 window); at each of the latter the same limit must reject the
      plain version with one live block skipped.  Each row names B7's
      design (``split``: flash-decoding), its splits, span and blocks.
      Its time stands beside its bound, its plain version, the gather path
      and ``scaled_dot_product_attention`` over K/V gathered beforehand.
      With ``--parent DIR``, B7 at 64 slots x 4096 in bfloat16 and one
      ``"pallas"`` wave of the bench (after a warm-up, three timed) from
      DIR and from this checkout in turns, parent, change, change, parent,
      each in a process of its own.
8. The rest of the lab suite, with every launch count set to 0 just
   before and read just after (the lab kernels must launch):

   a. lab5 through the CLI over seeded binfmt files: sum, min and max of
      2^24 int32, uint8 and float32 elements (``tpulab/bench.py:1679``),
      prod of the integers and of 2^24 float32 values near 1, and min and
      max of a file of +-0, NaNs of distinct payloads and infinities and
      of two files of signed zeros (-0.0 is the min of {0.0, -0.0}, +0.0
      the max, as in ``tpulab``).
      Integer results equal the port's CPU run; float32 sums lie within
      ``2 * gamma_h * sum|x|`` of it (``SUM_DEPTH``), and each float32
      product within :func:`prod_tolerance` of the float64 product;
   b. lab5's sort of 2^20 float32 (holding the special values), int32
      and uint8 elements (``tpulab/bench.py:1653``) and of the special
      file: each output file byte-equal to the CPU run's; each row says
      whether ``torch.sort`` alone, without canonical keys, keeps
      ``jnp.sort``'s order on the card;
   c. hw1's branch cases (string-equal, timing word ``CPU``) and hw2 over
      2^20 floats with ``--timing``, byte-equal to the CPU run;
   d. ``python -m tpulab_torch.harness.run``: the lab2 golden sweep with
      ``--cpu-ref`` as its own process, the lab3 one in this process, and
      lab2 over a seeded 1024x1024 image under ``[[32,32],[16,16]]`` with
      the plain version's output as its golden: every row verified, the
      stats CSVs written;
   e. ``tpulab_torch bench``'s lab rows (each on ``cuda`` with the card's
      name and power limit) and ``tpulab_torch selftest`` (exit 0).
9. Speculative decoding and the model rows of ``bench``, each run with
   every launch count set to 0 just before and read just after:

   a. ``speculative_generate`` (the int8 draft, k=4, 128 steps) and
      ``prompt_lookup_generate`` at the bench's width (d512, 8 heads, 8
      layers, d_ff 2048, bf16, seed-0 weights) over a 1024-token prompt
      (B4 once per layer of each prefill): tokens equal to plain greedy
      decode on the card up to the first position whose top-2 margin falls
      below 1e-2 or four bf16 ulps of the row's largest logit; tokens/s of
      plain, speculative and lookup decode at the bench's 8-token prompt.
      Then the small labformer of the serving tests (d32, 2 layers),
      trained on the card as ``trained_small`` is: both streams bit-equal
      to greedy decode;
   b. the ``PagedEngine`` at the daemon's settings
      (``tpulab/daemon.py:2656-2680``) with ``spec_k=4``, ``attn="pallas"``
      and the int8 draft, under lookup, draft, plain, sampled and
      penalized requests: on the small labformer every stream equal to the
      engines without speculation (pallas and gather), one host wait per
      verify tick and no other host sync (``torch.cuda`` sync debug
      mode), B7 once per layer of each plain tick, no leaked block; at the
      paged bench's width in float32, greedy streams equal to the engine
      without speculation up to the first near-tie, and both tokens/s;
   c. a pure-Python loop timed 20 times (the host's drift), then every
      model row of ``tpulab_torch bench`` through the CLI (one ``--only``
      group at a time, ``BENCH_GROUPS``), each printed with the card's
      name, power limit and, where it counts flops, MFU against the H100's
      bf16 peak; ``labformer_train`` must launch B4, B5 and B6, the flash
      rows B4; ``spill_overhead`` and ``handoff_overhead`` hold their 1 %
      and 3 % budgets.  Then B4 at (1, s, 8, 64) bf16 against its plain
      version within ``o_tolerance``: at s=32768 on the last 256 query rows
      (every key; the whole score matrix would take 34 GB), at 8192 whole.
10. The cache tier and scheduler of the ``PagedEngine`` (the radix index,
    the host spill tier, priorities and preemption, the prefill/decode
    handoff), each run with every launch count set to 0 just before and
    read just after (B7 once per layer of each tick, nothing else):

    a. at the paged bench's width in bfloat16 with the daemon's engine
       settings, ``attn="pallas"``, ``prefix_index="radix"`` and
       ``spill_blocks=64``, ``n_blocks`` cut (and printed) only where a
       scenario needs pressure: a storm of 128-token prefixes whose cold
       leaves spill and come back with the last wave; two priority-0
       requests and a priority-5 arrival that preempts one; two requests
       handed from a prefill engine to a decode engine (one export, the
       blocks restored at admission).  Blocks spilled, prefetched and hit,
       preemptions and handoff bytes must each be at least 1; every greedy
       stream equals an engine without spill, preemption or handoff up to
       the first near tie (phase 9a's rule); no block leaks; no call the
       CUDA runtime flags as synchronizing (``set_sync_debug_mode``), and
       a steady window on the decode engine uploads nothing, drains
       nothing and reads no block back.  The waits for block reads (at
       eviction and export) and the drains are counted and printed;
    b. the small labformer of phase 9a, trained again here: a preempted
       greedy and a preempted sampled request, the spill round trip and the
       handoff, each stream bit-equal to its uninterrupted run.
11. The text model's checkpoint lifecycle, in ``build/chip_smoke/lifecycle``
    (removed at the end), each run with every launch count set to 0 just
    before and read just after (B4, B5 and B6 once per layer of each
    dispatched training step at s >= 1024; B4 once per layer of each eval
    batch, of each prefill of >= 1024 tokens and of each teacher and
    student forward in ``distill``; no lab kernel and no B7):

    a. a seeded ~4 MB corpus over 4 files (words drawn Zipf-like from a
       seeded list), ``tpulab_torch tokenizer train --vocab 512`` through
       the CLI; ``decode(encode(corpus))`` equals the corpus;
    b. the flagship (d512, 8 heads, 8 layers, d_ff 2048, bf16, b8 s2048) on
       the native loader with snapshots every 10 steps: 20 steps straight,
       10 then ``resume`` to 20, and 20 with ``recover=1`` and a fault at
       step 15; the printed losses and the step-20 snapshots (parameters,
       moments, counters) are bit-equal; save and restore ms of the
       flagship's train state and its snapshot bytes, with the card line;
    c. the same width at the tokenizer's vocab with ``--tokenizer``, 10
       steps and a snapshot; ``tpulab_torch eval --seq 2048`` through the
       CLI (finite loss, perplexity, bits per byte); ``generate
       --ckpt-dir`` greedy over a prompt of >= 1024 tokens, its text equal
       to ``generate()`` on ``load_params``;
    d. ``init_from`` b's snapshot with ``lora_rank=8`` for 5 steps (every
       base leaf bit-unchanged, ``generate --ckpt-dir`` prints the merged
       LoRA line); ``tpulab_torch distill`` from c's snapshot into a
       4-layer student at s1024 for 3 steps, then ``generate --ckpt-dir``
       on the student;
    e. ``tpulab_torch train --data-dir ... --seq 1024 --ckpt-dir ...
       --save-every 2 --steps 4``, then ``--resume --steps 6``: the resumed
       ``[train]`` lines equal a straight 6-step run's.
12. One ``{"model": {...}}`` line with phases 5 to 7's and 9 to 11's
    numbers, one ``{"lab_suite": {...}}`` line with phase 8's, one
    ``{"kernels": [...]}`` line, the card line again, and last ``{"ok":
    true, "device": {...}}``.

Bounds use the H100 SXM's published rates (NVIDIA data sheet): 3.35 TB/s
of device memory, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
tensor cores, 989 TFLOP/s bfloat16 on the tensor cores.  B3 counts issues
at half the flop rate (an FMA is two flops, one issue): its float32
screen's ``SCREEN_ISSUES`` per pixel and class, plus in float64
``CLASSIFY_F64_ISSUES`` per double fold this run's candidates need; its
float64 rows also give ``unfused_bound_ms``, the fold for every class.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
BF16_FLOPS = 989e12
#: flops per pixel of the Roberts function: luminance (1 mul, 2 fma),
#: two differences, magnitude (1 mul, 1 fma, sqrt), clamp
ROBERTS_FLOPS_PER_PIXEL = 14
#: issues per pixel and class of the reference's double fold: its 24
#: operations (3 sub, 12 mul, 9 add), each a DADD or DMUL of its own
#: (unfused, one flop an issue), and the argmin's compare
CLASSIFY_F64_ISSUES = 25
#: float32 issues per pixel and class of B3's screen: 15 of arithmetic (3
#: sub, 3 mul, 9 fma), the argmin's compare and two selects, and in float64
#: the candidate's bound, compare and bit
SCREEN_ISSUES = {"float32": 18, "float64": 21}

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


LAB_KERNELS = ("roberts", "elementwise", "classify")
MODEL_KERNELS = ("flash_fwd",)
TRAIN_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
#: kernels whose launches every model-side run checks exactly
COUNTED_KERNELS = TRAIN_KERNELS + ("paged_decode",)


def counters() -> dict:
    from tpulab_torch.ops.cuda.attention import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_with_lse,
    )
    from tpulab_torch.ops.cuda.classify import classify_u32
    from tpulab_torch.ops.cuda.elementwise import binary
    from tpulab_torch.ops.cuda.paged import paged_attend_kernel
    from tpulab_torch.ops.cuda.stencil import roberts_u32

    return {"roberts": roberts_u32, "elementwise": binary, "classify": classify_u32,
            "flash_fwd": flash_attention_with_lse, "flash_dq": flash_attention_bwd_dq,
            "flash_dkv": flash_attention_bwd_dkv, "paged_decode": paged_attend_kernel}


def zero_counts() -> dict:
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def check_launched(launches: dict, names, device, path: str) -> None:
    for name in names:
        check(launches[name] > 0 or device.type == "cpu",
              f"kernel {name} was not launched on the {path}")


def counted(fn, device, want: dict, path: str) -> tuple:
    """``fn()`` with every launch count set to 0 just before and read just
    after; (its result, launches per kernel).  On the card each model-side
    kernel must have launched as often as ``want`` (or ``want(result)``)
    says (absent: never), and no lab kernel at all."""
    wrappers = zero_counts()
    result = fn()
    launches = {name: w.launches for name, w in wrappers.items()}
    if callable(want):
        want = want(result)
    if device.type == "cuda":
        for name in COUNTED_KERNELS:
            check(launches[name] == want.get(name, 0),
                  f"{name} launches {launches[name]} on the {path}, want {want.get(name, 0)}")
        check(all(launches[k] == 0 for k in LAB_KERNELS), f"lab kernels ran on the {path}: {launches}")
    return result, launches


@contextlib.contextmanager
def watch_syncs(device):
    """Within the block, note every call the CUDA runtime flags as
    synchronizing (``torch.cuda.set_sync_debug_mode("warn")``), each with
    the frames above it; the list is yielded (always empty on the CPU)."""
    import traceback
    import warnings

    import torch

    syncs: list = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            syncs.append("".join(traceback.format_stack(limit=6)[:-1]))

    debug = device.type == "cuda"
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        if debug:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            if debug:
                torch.cuda.set_sync_debug_mode("default")


def drive_main_path(inp: dict, backend: str) -> tuple:
    """The CLI runs of the main path; (stdouts, launches per kernel)."""
    wrappers = zero_counts()
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


def _spd_inverse(rng, spread: float) -> np.ndarray:
    """A random inverse covariance of a class whose spread is ``spread``."""
    a = rng.normal(size=(3, 3))
    return np.linalg.inv((a @ a.T + np.eye(3) / 4) * spread**2)


#: the plane every pair of ``b3_class_sets()["symmetric"]`` bisects: b = r + g
TIE_PLANE = np.array([-1.0, -1.0, 1.0])


def faulted_screen(screen, margin_scale: float):
    """``screen`` with every margin times ``margin_scale`` and no class
    flagged: a planted fault, to show that B3's recheck is what keeps its
    labels."""
    from dataclasses import replace

    return replace(screen, margin=(screen.margin * np.float32(margin_scale)).astype(np.float32),
                   recheck=np.zeros_like(screen.recheck))


def b3_class_sets(seed: int = 0) -> dict:
    """The classes that attack B3's float64 screen: name -> (means
    ``(nc, 3)``, inverse covariances ``(nc, 3, 3)``), float64.

    ``symmetric`` is the near-tie set: three pairs of classes, each pair
    two means symmetric about a lattice pixel of the plane b = r + g with
    one inverse covariance, whose bisector is that plane, so every colour
    on it ties in real arithmetic and rounding decides.
    """
    rng = np.random.default_rng(seed)
    ic = [_spd_inverse(rng, 30.0) for _ in range(5)]
    mu = rng.uniform(30, 220, (5, 3))
    nan_ic = np.full((3, 3), np.nan)
    means, ics = [], []
    for q, length in (((40, 50, 90), 4.0), ((100, 20, 120), 9.0), ((10, 130, 140), 17.0)):
        k = _spd_inverse(rng, 30.0)
        w = np.linalg.solve(k, TIE_PLANE)  # the pair's offset: IC^-1 n, so IC offset ~ n
        delta = length * w / np.linalg.norm(w)
        means += [np.asarray(q, float) - delta, np.asarray(q, float) + delta]
        ics += [k, k]
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    sets = {
        "identical": ([mu[0], mu[0], mu[1]], [ic[0], ic[0], ic[1]]),  # exact ties: first wins
        "symmetric": (means, ics),
        "twin_1e-9": ([mu[2], mu[2] + 1e-9, mu[3]], [ic[2], ic[2], ic[3]]),  # float32 equal
        "nan": ([mu[0], mu[1], mu[2]], [ic[0], nan_ic, ic[2]]),
        "all_nan": ([mu[0], mu[1], mu[2]], [nan_ic] * 3),
        "extreme_ic": ([mu[0], mu[1], mu[2], mu[3]],
                       [ic[0] * 1e30, ic[1] * 1e-30, q @ np.diag([1e-7, 1e-1, 1e5]) @ q.T, ic[3]]),
        "outside": ([[-300.0, 128, 128], [128, 700, 40], [1e4, -1e4, 500], mu[4]],
                    [ic[0], ic[1], ic[2] * 1e-4, ic[4]]),
    }
    return {k: (np.asarray(m, float), np.asarray(c, float)) for k, (m, c) in sets.items()}


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
    # the quads' and strips' edges: w % 4 in {1, 2, 3}, 1 x N, N x 1, 1 x 1
    edges = [(1023, 1021), (517, 1026), (1000, 1027), (1, 4099), (4099, 1), (1, 1)]
    edge_rng = np.random.default_rng(4)
    for shape in edges:
        u = pack_rgba(edge_rng.integers(0, 256, shape + (4,), np.uint8)).to(device)
        want = k1.roberts_u32_plain(u)
        for geom in (None, (32, 32, 16, 16), (33, 3, 5, 7)):
            check(bitwise_equal(k1.roberts_u32(u, geom), want),
                  f"roberts at {shape} under {geom} differs from plain")
    rows["roberts"]["edges"] = {"shapes": [list(e) for e in edges],
                                "geometries": ["default", [32, 32, 16, 16], [33, 3, 5, 7]]}

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
    def b3(img, mean, inv_cov, dtype, geoms, iters, plain_iters):
        u = pack_rgba(img).to(device)
        s = k3.pack_stats(mean, inv_cov, dtype, device)
        screen = k3.stage_screen(mean, inv_cov, dtype)
        r = held(lambda x, st, g: k3.classify_u32(x, st, g, screen), k3.classify_u32_plain,
                 (u, s), geoms, device, iters, plain_iters)
        nc, n, name = len(mean), u.numel(), str(dtype).split(".")[1]
        issues = {"float32": SCREEN_ISSUES[name] * n * nc, "float64": 0.0}
        if dtype == torch.float64:
            r["candidates"] = b3_candidates(u, screen)
            issues["float64"] = CLASSIFY_F64_ISSUES * r["candidates"]["folds_per_pixel"] * n
            r["unfused_bound_ms"] = CLASSIFY_F64_ISSUES * n * nc / (FP64_FLOPS / 2) * 1e3
        bytes_moved = 8.0 * n + len(screen.param)
        t_ops = (issues["float32"] / (FP32_FLOPS / 2) + issues["float64"] / (FP64_FLOPS / 2)) * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        r["bound_ms"], r["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
        r["shape"], r["nc"], r["dtype"] = list(u.shape), nc, name
        return r

    side = sizes["b3_side"]
    img = rng.integers(0, 256, (side, side, 4), np.uint8)
    lab3 = class_statistics(inp["lab3_img"], inp["lab3_classes"])
    st = class_statistics(img, [np.stack([rng.integers(0, side, 16), rng.integers(0, side, 16)],
                                         1) for _ in range(32)])
    big = st.mean, st.inv_cov
    rows["classify"] = b3(inp["lab3_img"], lab3.mean, lab3.inv_cov, torch.float64,
                          [None, (256, 256)], 50, 3)
    rows["classify"]["at_scale"] = b3(img, *big, torch.float64, [None, (256, 256)], 5, 2)
    rows["classify"]["float32"] = b3(inp["lab3_img"], lab3.mean, lab3.inv_cov, torch.float32,
                                     [None, (256, 256)], 50, 3)
    rows["classify"]["float32"]["at_scale"] = b3(img, *big, torch.float32,
                                                 [None, (256, 256)], 5, 2)
    rows["classify"]["every_colour"] = b3_every_colour(sizes["b3_side"], device, rng)
    return rows


def b3_candidates(u, screen) -> dict:
    """The float64 screen's candidates on ``u`` (``screen_plain``, which
    forms the kernel's float32 distances and bounds): their mean and most
    per pixel, the double folds per pixel (a pixel whose one candidate is
    unflagged needs none), and the folds a warp of 32 pixels pays, its
    lane with the most, averaged over warps."""
    import torch

    from tpulab_torch.ops.cuda.classify import screen_plain

    flat = u.reshape(-1)
    count = torch.zeros(flat.shape, dtype=torch.int64, device=u.device)
    folds = torch.zeros_like(count)
    flagged = int(sum(1 << c for c in np.flatnonzero(screen.recheck)))
    for start in range(0, flat.numel(), 1 << 22):  # the plain screen's temporaries, in parts
        cand, _ = screen_plain(flat[start:start + (1 << 22)], screen)
        n = sum((cand >> c) & 1 for c in range(screen.nc))
        alone = (n == 1) & ((cand & ~flagged) != 0)
        count[start:start + n.numel()] = n
        folds[start:start + n.numel()] = torch.where(alone, 0, n)
    pad = (-folds.numel()) % 32
    warp = torch.nn.functional.pad(folds, (0, pad)).reshape(-1, 32).amax(1)
    return {"mean": float(count.double().mean()), "max": int(count.max()),
            "folds_per_pixel": float(folds.double().mean()),
            "warp_folds_mean": float(warp.double().mean()), "warp_folds_max": int(warp.max())}


def b3_every_colour(side: int, device, rng) -> dict:
    """B3 in float64 on a ``side`` x ``side`` image that holds each of the
    2^24 RGB colours once (side 4096), against 32 random classes and each
    set of ``b3_class_sets``, under three geometries: byte-equal to the
    plain version; then the near-tie set with every margin and flag zeroed
    (a planted fault), which must differ."""
    import torch

    from tpulab_torch.ops.cuda import classify as k3
    from tpulab_torch.ops.mahalanobis import class_statistics
    from tpulab_torch.ops.roberts import pack_rgba, unpack_rgba

    colours = torch.arange(side * side, dtype=torch.int64, device=device) % (1 << 24)
    alpha = torch.from_numpy(rng.integers(0, 256, side * side)).to(device)
    u = (colours | (alpha << 24)).to(torch.int32).reshape(side, side)
    img = unpack_rgba(u)
    sets = dict(b3_class_sets())
    st = class_statistics(img, [np.stack([rng.integers(0, side, 16), rng.integers(0, side, 16)], 1)
                                for _ in range(32)])
    sets["random32"] = (st.mean, st.inv_cov)
    out = {"shape": [side, side], "sets": {}}
    for name, (mean, inv_cov) in sets.items():
        s = k3.pack_stats(mean, inv_cov, torch.float64, device)
        screen = k3.stage_screen(mean, inv_cov, torch.float64)
        want = k3.classify_u32_plain(u, s)
        for geom in (None, (256, 256), (7, 999)):
            check(bitwise_equal(k3.classify_u32(u, s, geom, screen), want),
                  f"classify float64 on every colour, set {name}, under {geom} differs from plain")
        out["sets"][name] = {"flagged": int(screen.recheck.sum()),
                             "candidates": b3_candidates(u, screen)}
        if name == "symmetric":
            faulted = faulted_screen(screen, 0.0)
            got = k3.classify_u32(u, s, None, faulted)
            wrong = int((got != want).sum())
            check(wrong > 0 or device.type == "cpu",  # the CPU path takes no screen
                  "classify with zeroed margins equals the plain version on the near-tie set: "
                  "the recheck is not what keeps the labels")
            out["planted_zero_margins"] = {"pixels_differ": wrong,
                                           "candidates": b3_candidates(u, faulted)}
    return out


# ---------------------------------------------------------------- model path

#: the serving-size labformer the JAX package benchmarks decode on
#: (tpulab/bench.py:244-247): head_dim 64
SERVING = dict(d_model=512, n_heads=8, n_layers=8, d_ff=2048, max_seq=1024)


def seeded_text(n: int, seed: int) -> str:
    """``n`` printable ASCII bytes from ``seed`` (one token each)."""
    return bytes(np.random.default_rng(seed).integers(32, 127, n).astype(np.uint8)).decode()


def drive_model_path(sizes: dict, backend: str) -> tuple:
    """``tpulab_torch generate`` through the CLI; (stdout, launches per kernel)."""
    from tpulab_torch.models.generate import demo_config

    wrappers = zero_counts()
    prompt = seeded_text(sizes["gen_prompt"], 3)
    out = cli(["generate", "--backend", backend, "--prompt", prompt, "--steps",
               str(sizes["gen_steps"]), "--temperature", "0"], "")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    check(out.startswith(prompt) and out.endswith("\n") and len(out) > len(prompt) + 1,
          f"generate printed {out[-80:]!r}")
    want = demo_config().n_layers if sizes["gen_prompt"] >= 1024 else 0
    check(backend == "cpu" or launches["flash_fwd"] == want,
          f"flash launches {launches['flash_fwd']} on the CLI prefill, want {want}")
    check(launches["flash_dq"] == launches["flash_dkv"] == 0,
          f"a backward kernel ran while serving: {launches}")
    check(all(launches[k] == 0 for k in LAB_KERNELS), f"lab kernels ran: {launches}")
    return out, launches


def greedy_with_logits(model, prompt, steps: int) -> tuple:
    """Greedy tokens (b, steps) and the logits each was taken from
    (b, steps, vocab), through the port's prefill and step on the model's
    device; both returned on the CPU."""
    import torch

    from tpulab_torch.models import generate as tgen

    b, p = prompt.shape
    with torch.inference_mode():
        logits, kc, vc = tgen._prefill(model, prompt, p + steps)
        toks, rows = [logits.argmax(-1)], [logits]
        for i in range(steps - 1):
            logits, kc, vc = tgen._forward_step(model, toks[-1], kc, vc, p + i)
            toks.append(logits.argmax(-1))
            rows.append(logits)
    return torch.stack(toks, 1).cpu(), torch.stack(rows, 1).float().cpu()


def check_serving_f32(sizes: dict, device) -> dict:
    """The serving model in f32 on ``device`` against the port on the CPU."""
    import torch

    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    cfg = LabformerConfig(**sizes["serving"], dtype=torch.float32)
    params = init_params(cfg, seed=0)
    prompt = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (1, sizes["serve_prompt"])))
    steps, tol = sizes["f32_steps"], 1e-3
    t0 = time.perf_counter()
    cpu_toks, cpu_logits = greedy_with_logits(Labformer.from_numpy(params, cfg, "cpu"),
                                              prompt, steps)
    cpu_s = time.perf_counter() - t0
    card = Labformer.from_numpy(params, cfg, device)
    # one prefill (B4 once per layer); the decode steps take no flash
    (dev_toks, dev_logits), launches = counted(
        lambda: greedy_with_logits(card, prompt.to(device), steps), device,
        {"flash_fwd": cfg.n_layers}, "serving f32 run")
    err = float((dev_logits[:, 0] - cpu_logits[:, 0]).abs().max())
    check(err <= tol, f"f32 prefill logits differ from the CPU's by {err} > {tol}")
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[0]
    checked = 0
    while checked < steps and margin[checked] >= 10 * tol:
        check(int(dev_toks[0, checked]) == int(cpu_toks[0, checked]),
              f"greedy token {checked} differs: card {int(dev_toks[0, checked])}, "
              f"CPU {int(cpu_toks[0, checked])} (CPU margin {float(margin[checked])})")
        step_err = float((dev_logits[:, checked] - cpu_logits[:, checked]).abs().max())
        check(step_err <= tol, f"f32 logits of step {checked} differ by {step_err}")
        checked += 1
    where = ("no step's CPU top-2 margin was below " + str(10 * tol) if checked == steps else
             f"stopped at step {checked}, whose CPU top-2 margin "
             f"{float(margin[checked]):.6f} < {10 * tol}")
    print(f"serving f32 b1 p{sizes['serve_prompt']}: prefill logits max |card - CPU| = {err}; "
          f"greedy tokens equal through {checked} of {steps} steps ({where}); "
          f"CPU run {cpu_s:.1f} s; launches {json.dumps(launches)}", flush=True)
    return {"prefill_logits_max_abs_err": err, "greedy_steps_equal": checked, "steps": steps,
            "launches": launches}


def event_ms(fn, device, reps: int = 3) -> float:
    """Median wall time of ``fn()`` between CUDA events (host clock on the CPU)."""
    from tpulab_torch.runtime.timing import measure_call_ms

    return measure_call_ms(fn, device=device, reps=reps, warmup=0)[0]


def profile_window(fn, device) -> dict:
    """Device busy time of ``fn()`` from ``torch.profiler`` (CUPTI): the sum
    of kernel times over the host's wall time, the kernels that took most,
    the port's flash kernels (B4-B6) and paged kernel (B7), and the host
    operators that took most of the host's own time.  On the CPU, or where
    the trace holds no kernel, "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {"busy_share": "not measured"}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if not busy_ms:
        return {"busy_share": "not measured", "wall_ms": wall_ms}
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    flash = [e for e in kernels if "(anonymous namespace)::flash_" in e.key]
    paged = [e for e in kernels if "(anonymous namespace)::paged_" in e.key]
    # the host's own time by operator (the profiler's overhead included)
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [[e.key[:80], dev_us(e) / 1e3, e.count] for e in top],
            "flash_kernels": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in flash],
            "paged_kernels": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in paged],
            "host_top": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in host]}


def decode_samples(model, prompt, reps: int, n: int, device) -> list:
    """ms per token of ``reps`` runs of ``n`` greedy decode steps, one after
    another after one prefill, each run between two CUDA events (host
    clock on the CPU)."""
    import torch

    from tpulab_torch.models import generate as tgen

    p = prompt.shape[1]
    samples = []
    with torch.inference_mode():
        logits, kc, vc = tgen._prefill(model, prompt, p + reps * n)
        tok, pos = logits.argmax(-1), p
        for _ in range(reps):
            if device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            for _ in range(n):
                logits, kc, vc = tgen._forward_step(model, tok, kc, vc, pos)
                tok, pos = logits.argmax(-1), pos + 1
            if device.type == "cuda":
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) / n)
            else:
                samples.append((time.perf_counter() - t0) * 1e3 / n)
    return samples


def time_serving_bf16(sizes: dict, device, card: str) -> dict:
    """Prefill ms and decode ms per token of the serving model in bf16."""
    import statistics

    import torch

    from tpulab_torch.models import generate as tgen
    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    cfg = LabformerConfig(**sizes["serving"], dtype=torch.bfloat16)
    model = Labformer.from_numpy(init_params(cfg, seed=0), cfg, device)
    b, p, steps = sizes["serve_batch"], sizes["serve_prompt"], sizes["serve_steps"]
    reps, n = sizes["decode_reps"], steps // sizes["decode_reps"]
    L = cfg.n_layers
    prompts = np.random.default_rng(5).integers(0, 256, (b, p)).astype(np.int32)
    tgen.generate(model, prompts, steps=2, temperature=0.0)  # warm-up
    tp = torch.from_numpy(prompts).long().to(device)
    launches = {}
    with torch.inference_mode():
        logits = tgen._prefill(model, tp, p + steps)[0]
        check(bool(torch.isfinite(logits.float()).all()), "bf16 prefill logits are not finite")
        prefill_ms, launches["prefill"] = counted(
            lambda: event_ms(lambda: tgen._prefill(model, tp, p + steps), device), device,
            {"flash_fwd": 3 * L}, "bf16 prefill (3 timed calls)")
    decode, launches["decode"] = counted(lambda: decode_samples(model, tp, reps, n, device),
                                         device, {"flash_fwd": L},
                                         f"bf16 prefill and {reps}x{n} decode steps")
    gen_ms, launches["generate"] = counted(
        lambda: event_ms(lambda: tgen.generate(model, prompts, steps=steps, temperature=0.0),
                         device), device, {"flash_fwd": 3 * L}, "bf16 generate (3 timed calls)")
    out = tgen.generate(model, prompts, steps=steps, temperature=0.0)
    check(out.shape == (b, steps) and out.min() >= 0 and out.max() < cfg.vocab,
          f"bf16 generate gave {out.shape} in [{out.min()}, {out.max()}]")
    decode_ms = statistics.median(decode)
    print(f"serving bf16 b{b} p{p}: prefill {prefill_ms:.6f} ms ({card})", flush=True)
    print(f"serving bf16 b{b} p{p}: decode {decode_ms:.6f} ms/token, median of {reps} runs "
          f"of {n} steps (min {min(decode):.6f}, max {max(decode):.6f}; "
          f"{', '.join(f'{x:.6f}' for x in decode)}) ({card})", flush=True)
    print(f"serving bf16 b{b} p{p}: generate of {steps} new tokens {gen_ms:.6f} ms "
          f"({card}); launches {json.dumps(launches)}", flush=True)

    def decode_steps(n=8):
        with torch.inference_mode():
            logits, kc, vc = tgen._prefill(model, tp, p + n)
            tok = logits.argmax(-1)
            for i in range(n):
                logits, kc, vc = tgen._forward_step(model, tok, kc, vc, p + i)
                tok = logits.argmax(-1)

    with torch.inference_mode():
        prof = {"prefill": profile_window(lambda: tgen._prefill(model, tp, p + steps), device)}
    prof["prefill_and_8_decode_steps"] = profile_window(decode_steps, device)
    for what, pr in prof.items():
        print(f"profile {what}: {json.dumps(pr)}", flush=True)
    return {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "decode_ms_per_token_runs": decode, "decode_steps_per_run": n,
            "generate_ms": gen_ms, "batch": b, "prompt": p, "new_tokens": steps,
            "launches": launches, "profile": prof}


def visible_pairs(s: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the mask keeps: the work this call's data needs."""
    if not causal:
        return s * s
    q = q_offset + np.arange(s, dtype=np.int64)
    hi = np.minimum(q, s - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())


def skipped_tile(q, k, v, tile: int, bk: int = 64):
    """The plain causal flash forward with one planted fault: query rows past
    key tile ``tile`` do not see that tile's keys."""
    import torch

    from tpulab_torch.ops.cuda.attention import softmax_scale

    s, d = q.shape[1], q.shape[3]
    qs = (q.float() * softmax_scale(d)).to(q.dtype).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    pos = torch.arange(s, device=q.device)
    hide = (pos[None, :] > pos[:, None]) | (
        (pos[None, :] // bk == tile) & (pos[:, None] >= (tile + 1) * bk))
    p = torch.softmax(scores.masked_fill(hide, -float("inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_row(shape, dtype, device, iters, plain_iters, *, kvh=None, window=0, q_offset=0,
              seed=0, plant=False, first_row=0) -> dict:
    """B4 against its plain version at one shape, with its times and bound;
    with ``plant``, also check that the tolerance rejects a skipped key tile.
    ``first_row`` > 0 holds only the output's rows from that one on (every
    key), where the plain version's whole score matrix would not fit; its
    ``plain_ms`` is then the time of those rows."""
    import torch
    import torch.nn.functional as F

    from tpulab_torch.ops.cuda.attention import (
        flash_attention_plain,
        flash_attention_with_lse,
        over_tolerance,
    )

    b, h, s, d = shape
    kvh = kvh or h
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(device, dtype)
               for sh in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    want_o, want_lse = flash_attention_plain(q, k, v, **kw, first_row=first_row)
    got_o, got_lse = flash_attention_with_lse(q, k, v, **kw)
    got_o, got_lse = got_o[:, first_row:], got_lse[:, first_row:]
    if device.type == "cuda":
        torch.cuda.synchronize()
    dead = torch.isneginf(want_lse)
    check(torch.equal(torch.isneginf(got_lse), dead) and bool((got_o.float()[dead] == 0).all()),
          f"flash {shape}: rows with no visible key differ")
    err, ratio = max_abs_err(got_o, want_o), over_tolerance(got_o, want_o)
    check(ratio <= 1, f"flash {shape} {dtype}: |o - plain| reaches {ratio} of o_tolerance "
                      f"(max |o - plain| = {err})")
    lse_err = max_abs_err(got_lse[~dead], want_lse[~dead])
    lse_tol = 2e-5 + 2e-5 * float(want_lse[~dead].abs().max())
    check(lse_err <= lse_tol, f"flash {shape} {dtype}: max |lse - plain| = {lse_err}")
    row = {"shape": [b, h, s, d], "kv_heads": kvh, "dtype": str(dtype).split(".")[1],
           "window": window, "q_offset": q_offset, "max_abs_err": err,
           "tolerance": "o_tolerance (tpulab_torch/ops/cuda/attention.py)",
           "err_over_tolerance": ratio, "lse_max_abs_err": lse_err,
           "rows_held": [first_row, s]}
    if plant:  # the same limit must reject a kernel that skips one key tile
        for tile in (s // 128, s // 64 - 2):
            fault = over_tolerance(skipped_tile(q, k, v, tile), want_o)
            check(fault > 10, f"flash {shape}: a skipped key tile {tile} is only {fault} of "
                              f"o_tolerance")
            row.setdefault("skipped_tile_over_tolerance", []).append([tile, fault])
    e = q.element_size()
    nbytes = (2 * b * s * h * d + 2 * b * s * kvh * d) * e + b * s * h * 4
    flops = 4.0 * b * h * d * visible_pairs(s, True, window, q_offset)
    row["ms"] = time_ms(lambda: flash_attention_with_lse(q, k, v, **kw), (), device, iters)
    row["plain_ms"] = time_ms(lambda: flash_attention_plain(q, k, v, **kw, first_row=first_row),
                              (), device, plain_iters)
    row["library_ms"] = None
    if not q_offset:  # one PyTorch call computes the same function
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pos = torch.arange(s, device=device)
        # causal: is_causal; a window: the (s, s) band as a boolean mask
        band = dict(is_causal=True) if not window else dict(
            attn_mask=(pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window))
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=kvh != h, **band)
        row["library_max_abs_err"] = max_abs_err(library().transpose(1, 2)[:, first_row:],
                                                 want_o)
        row["library_ms"] = time_ms(library, (), device, iters)
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
    return row


def flash_rows(sizes: dict, device) -> dict:
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    main_shape, serve_shape, big = sizes["b4_demo"], sizes["b4_serving"], sizes["b4_big"]
    row = flash_row(main_shape, f32, device, 50, 10)
    row["serving"] = flash_row(serve_shape, bf16, device, 20, 5, seed=1, plant=True)
    row["at_scale"] = [flash_row(big, bf16, device, 5, 2, seed=2, plant=True),
                       flash_row(big, f32, device, 5, 2, seed=3)]
    s = big[2]
    row["variants"] = [
        flash_row(big, bf16, device, 5, 2, window=256, seed=4),
        flash_row(big, bf16, device, 5, 2, kvh=2, seed=5),
        flash_row(big, bf16, device, 5, 2, window=s // 4, q_offset=s, seed=6),
    ]
    return row


def run_model_path(sizes: dict, device, backend: str, card: str) -> tuple:
    """Phase 5: (the flash row, its model-path launches, the model numbers)."""
    t0 = time.perf_counter()
    out, launches = drive_model_path(sizes, backend)
    print(f"model path: {json.dumps(launches)} launches; generate printed "
          f"{len(out) - 1 - sizes['gen_prompt']} characters after the prompt", flush=True)
    check_launched(launches, MODEL_KERNELS, device, "model path")
    model = {"cli_generate": {"launches": launches},
             "serving_f32": check_serving_f32(sizes, device),
             "serving_bf16": time_serving_bf16(sizes, device, card)}
    row = flash_rows(sizes, device)
    print(f"phase 5 took {time.perf_counter() - t0:.1f} s", flush=True)
    return row, launches, model


# ------------------------------------------------------------- training path

#: the flagship training config (tpulab/bench.py:142-149,
#: bench_labformer_train): the serving model's width
TRAIN = dict(d_model=512, n_heads=8, n_layers=8, d_ff=2048)
#: layers of the CLI trainer's labformer (tpulab_torch/train.py)
TRAIN_CLI_LAYERS = 4
#: card against CPU, f32: relative limit on each step's loss, and on each
#: first-step gradient leaf's largest |card - CPU| over its largest |CPU|
#: (the same sums in other orders through 8 layers and back)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3


def drive_train_path(sizes: dict, backend: str) -> tuple:
    """``tpulab_torch train`` through the CLI; (its losses, launches per kernel)."""
    wrappers = zero_counts()
    steps, seq = sizes["train_cli_steps"], sizes["train_cli_seq"]
    out = cli(["train", "--backend", backend, "--seq", str(seq), "--batch",
               str(sizes["train_cli_batch"]), "--steps", str(steps)], "")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    lines = out.splitlines()
    losses = [float(ln.split()[4]) for ln in lines if ln.startswith("[train] step")]
    final = json.loads(lines[-1])
    check(final["final_step"] == steps and len(losses) == steps
          and all(np.isfinite(losses)) and np.isfinite(final["loss"]),
          f"train printed {out[-600:]!r}")
    want = steps * TRAIN_CLI_LAYERS if seq >= 1024 else 0
    for name in TRAIN_KERNELS:
        check(backend == "cpu" or launches[name] == want,
              f"{name} launches {launches[name]} on the CLI training run, want {want}")
    check(all(launches[k] == 0 for k in LAB_KERNELS), f"lab kernels ran: {launches}")
    return losses, launches


def check_train_f32(sizes: dict, device) -> dict:
    """The flagship config in f32 on ``device`` against the port on the CPU."""
    import torch

    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.train import batches

    b, s, steps = sizes["train_f32_batch"], sizes["train_f32_seq"], sizes["train_f32_steps"]
    cfg = LabformerConfig(**sizes["train"], max_seq=s, dtype=torch.float32)
    batch_at = batches(cfg.vocab, b, s, 0)

    def run(dev):
        model, state, step = init_train_state(cfg, None, seed=0, device=dev)
        losses, grads = [], None
        for i in range(steps):
            model, state, loss = step(model, state, batch_at(i))
            losses.append(float(loss))
            if i == 0:
                grads = model.to_numpy(grads=True)
        return losses, grads

    t0 = time.perf_counter()
    cpu_losses, cpu_grads = run("cpu")
    cpu_s = time.perf_counter() - t0
    n = steps * cfg.n_layers
    (losses, grads), launches = counted(lambda: run(device), device,
                                        dict.fromkeys(TRAIN_KERNELS, n), "f32 training run")
    loss_err = max(abs(a - w) / abs(w) for a, w in zip(losses, cpu_losses))
    check(all(np.isfinite(losses)) and loss_err <= TRAIN_LOSS_RTOL,
          f"f32 training losses {losses} differ from the CPU's {cpu_losses}")
    flat = lambda tree: {**{f"blocks/{k}": v for k, v in tree["blocks"].items()},
                         **{k: v for k, v in tree.items() if k != "blocks"}}
    ratios = {}
    for name, want in flat(cpu_grads).items():
        got = flat(grads)[name].astype(np.float64)
        want = want.astype(np.float64)
        ratios[name] = float(np.abs(got - want).max() / (TRAIN_GRAD_REL * np.abs(want).max()))
    worst = max(ratios, key=ratios.get)
    check(ratios[worst] <= 1, f"f32 first-step gradient {worst} differs from the CPU's by "
                              f"{ratios[worst]} of its limit")
    print(f"training f32 b{b} s{s}: {steps} steps, losses {losses} (CPU {cpu_losses}, worst "
          f"relative difference {loss_err:.3e}); first-step gradients within "
          f"{ratios[worst]:.4f} of their limit at worst ({worst}); CPU run {cpu_s:.1f} s; "
          f"launches {json.dumps(launches)}", flush=True)
    return {"losses": losses, "cpu_losses": cpu_losses, "loss_max_rel_err": loss_err,
            "grad_worst_leaf": worst, "grad_err_over_limit": ratios[worst],
            "loss_rtol": TRAIN_LOSS_RTOL, "grad_rel": TRAIN_GRAD_REL, "launches": launches}


def time_train_bf16(sizes: dict, device, card: str) -> dict:
    """Step ms, tokens/s and one profiled step of the flagship config in bf16."""
    import statistics

    import torch

    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.train import batches

    b, s, n = sizes["train_batch"], sizes["train_seq"], sizes["train_steps"]
    cfg = LabformerConfig(**sizes["train"], max_seq=s, dtype=torch.bfloat16)
    model, state, step = init_train_state(cfg, None, seed=0, device=device)
    batch_at = batches(cfg.vocab, b, s, 0)
    tokens = [model.tokens(batch_at(i)) for i in range(n + 2)]
    losses = [float(step(model, state, tokens[0])[2])]  # warm-up
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def timed_steps():
        samples = []
        for i in range(n):
            if device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            loss = step(model, state, tokens[1 + i])[2]
            if device.type == "cuda":
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end))
            else:
                samples.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        return samples

    samples, launches = counted(timed_steps, device,
                                dict.fromkeys(TRAIN_KERNELS, n * cfg.n_layers),
                                f"{n} bf16 training steps")
    check(all(np.isfinite(losses)), f"bf16 training losses {losses}")
    step_ms = statistics.median(samples)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    prof = profile_window(lambda: step(model, state, tokens[-1]), device)
    print(f"training bf16 b{b} s{s}: step {step_ms:.6f} ms, median of {n} (min "
          f"{min(samples):.6f}, max {max(samples):.6f}; "
          f"{', '.join(f'{x:.6f}' for x in samples)}), {b * s / (step_ms / 1e3):.1f} tokens/s, "
          f"peak memory {peak} bytes ({card}); losses {losses}; launches "
          f"{json.dumps(launches)}", flush=True)
    print(f"profile training step: {json.dumps(prof)}", flush=True)
    return {"step_ms": step_ms, "step_ms_runs": samples, "tokens_per_s": b * s / (step_ms / 1e3),
            "batch": b, "seq": s, "losses": losses, "peak_memory_bytes": peak,
            "launches": launches, "profile": prof}


def bwd_rows(shape, dtype, device, iters, plain_iters, *, kvh=None, window=0, q_offset=0,
             seed=0, plant=False) -> tuple:
    """B5 and B6 against the plain backward at one shape, with their times
    and bounds: (the dq row, the dk/dv row).  With ``plant``, also check
    that the tolerance rejects a backward that skips one key tile."""
    import torch
    import torch.nn.functional as F

    from tpulab_torch.ops.cuda import attention as A

    b, h, s, d = shape
    kvh = kvh or h
    rng = np.random.default_rng(seed)
    make = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(device,
                                                                                       dtype)
    q, k, v, do = make(b, s, h, d), make(b, s, kvh, d), make(b, s, kvh, d), make(b, s, h, d)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    o, lse = A.flash_attention_with_lse(q, k, v, **kw)
    dlse = None
    if q_offset:  # a cotangent on lse, as ring attention gives it
        dlse = torch.from_numpy(rng.standard_normal((b, s, h), dtype=np.float32)).to(device)
    delta = A.bwd_delta(o, do, dlse)
    keep = A.visible(s, True, window, q_offset, device)
    want = A.flash_bwd_plain_masked(q, k, v, do, lse, delta, keep)
    dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    base = {"shape": [b, h, s, d], "kv_heads": kvh, "dtype": str(dtype).split(".")[1],
            "window": window, "q_offset": q_offset, "lse_cotangent": dlse is not None,
            "tolerance": "grad_tolerance (tpulab_torch/ops/cuda/attention.py)"}
    rows = ({**base}, {**base})
    for row, names, got, wanted in ((rows[0], ("dq",), (dq,), want[:1]),
                                    (rows[1], ("dk", "dv"), (dk, dv), want[1:])):
        row["max_abs_err"] = max(max_abs_err(g, w) for g, w in zip(got, wanted))
        for name, g, w in zip(names, got, wanted):
            ratio = A.grad_over_tolerance(g, w)
            check(bool(torch.isfinite(g.float()).all()) and ratio <= 1,
                  f"flash backward {shape} {dtype}: {name} reaches {ratio} of grad_tolerance")
            row[f"{name}_err_over_tolerance"] = ratio
    if plant:  # the same limit must reject a backward that skips one key tile
        pos = torch.arange(s, device=device)
        for tile in (s // 128, s // 64 - 2):
            hide = (pos[None, :] // 64 == tile) & (pos[:, None] >= (tile + 1) * 64)
            bad = A.flash_bwd_plain_masked(q, k, v, do, lse, delta, keep & ~hide)
            faults = [A.grad_over_tolerance(x, w) for x, w in zip(bad, want)]
            check(min(faults) > 10, f"flash backward {shape}: a skipped key tile {tile} is "
                                    f"only {faults} of grad_tolerance")
            rows[0].setdefault("skipped_tile_over_tolerance", []).append([tile, faults[0]])
            rows[1].setdefault("skipped_tile_over_tolerance", []).append([tile, *faults[1:]])
            del bad
    del want
    e = q.element_size()
    pairs = visible_pairs(s, True, window, q_offset)
    operands = (2 * b * s * h * d + 2 * b * s * kvh * d) * e + 2 * b * s * h * 4
    args = (q, k, v, do, lse, delta)
    rows[0]["ms"] = time_ms(lambda: A.flash_attention_bwd_dq(*args, **kw), (), device, iters)
    rows[1]["ms"] = time_ms(lambda: A.flash_attention_bwd_dkv(*args, **kw), (), device, iters)
    rows[0]["plain_ms"] = time_ms(lambda: A.flash_bwd_plain_masked(*args, keep, want_dkv=False),
                                  (), device, plain_iters)
    rows[1]["plain_ms"] = time_ms(lambda: A.flash_bwd_plain_masked(*args, keep, want_dq=False),
                                  (), device, plain_iters)
    library_ms = None
    if not q_offset:  # one PyTorch call computes the same gradient
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        band = dict(is_causal=True) if not window else dict(attn_mask=keep)
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=kvh != h, **band)
        dot = do.transpose(1, 2)
        library = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        rows[0]["library_dq_max_abs_err"] = max_abs_err(library()[0].transpose(1, 2), dq)
        library_ms = time_ms(library, (), device, iters)
        del out
    bf = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    for row, nbytes, flops in ((rows[0], operands + b * s * h * d * e, 6.0 * d * pairs * b * h),
                               (rows[1], operands + 2 * b * s * kvh * d * e,
                                8.0 * d * pairs * b * h)):
        row["library_ms"] = library_ms
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, bf)
    return rows


def bwd_kernel_rows(sizes: dict, device) -> tuple:
    """(the B5 row, the B6 row) for the kernels line."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    main_shape, big = sizes["b5_main"], sizes["b5_big"]
    dq, dkv = bwd_rows(main_shape, bf16, device, 10, 3, seed=11, plant=True)
    s = big[2]
    for key, runs in (("at_scale", [dict(dtype=bf16, seed=12), dict(dtype=f32, seed=13)]),
                      ("variants", [dict(dtype=bf16, window=256, seed=14),
                                    dict(dtype=bf16, kvh=2, seed=15),
                                    dict(dtype=bf16, window=s // 4, q_offset=s, seed=16)])):
        for run in runs:
            a, b = bwd_rows(big, run.pop("dtype"), device, 3, 2, **run)
            dq.setdefault(key, []).append(a)
            dkv.setdefault(key, []).append(b)
    return dq, dkv


#: one side of :func:`in_turns`, run as ``python -c`` from the root of a
#: checkout (argv[1]) with that checkout's package and ``chip_smoke.py``:
#: phase 6c's step and B5 in bfloat16 at the training shape
IN_TURNS_TRAIN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
t = c.time_train_bf16(c.FULL_SIZES, dev, c.card_line())
dq = c.bwd_rows(c.FULL_SIZES["b5_main"], torch.bfloat16, dev, 10, 1, seed=11)[0]
print("IN_TURNS " + json.dumps({"step_ms": t["step_ms"], "step_ms_runs": t["step_ms_runs"],
                                "tokens_per_s": t["tokens_per_s"],
                                "busy_ms": t["profile"].get("busy_ms"),
                                "wall_ms": t["profile"].get("wall_ms"),
                                "b5_ms": dq["ms"], "b5_plain_ms": dq["plain_ms"]}), flush=True)
"""

#: the side of :func:`in_turns` for phase 4, run as ``IN_TURNS_TRAIN`` is: B1
#: at 1024^2 and 8192^2, and B3 in float64 at 1024^2 with 8 classes and at
#: 4096^2 with 32, each checkout under its own default geometry (a parent
#: without ``stage_screen`` takes no screen)
IN_TURNS_LAB = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as c
from tpulab_torch.ops.cuda import classify as k3, stencil as k1
from tpulab_torch.ops.mahalanobis import class_statistics
from tpulab_torch.ops.roberts import pack_rgba
dev, rng, out = torch.device("cuda", 0), np.random.default_rng(3), {}
for side, iters in ((1024, 200), (8192, 20)):
    u = pack_rgba(rng.integers(0, 256, (side, side, 4), np.uint8)).to(dev)
    out[f"b1_{side}_ms"] = c.time_ms(k1.roberts_u32, (u,), dev, iters)
for side, nc, iters in ((1024, 8, 50), (4096, 32, 5)):
    img = rng.integers(0, 256, (side, side, 4), np.uint8)
    st = class_statistics(img, [np.stack([rng.integers(0, side, 16), rng.integers(0, side, 16)],
                                         1) for _ in range(nc)])
    s, u = k3.pack_stats(st.mean, st.inv_cov, torch.float64, dev), pack_rgba(img).to(dev)
    fn = k3.classify_u32
    if hasattr(k3, "stage_screen"):
        sc = k3.stage_screen(st.mean, st.inv_cov, torch.float64)
        fn = lambda x, t: k3.classify_u32(x, t, None, sc)
    out[f"b3_f64_{side}_nc{nc}_ms"] = c.time_ms(fn, (u, s), dev, iters)
print("IN_TURNS " + json.dumps(out), flush=True)
"""

#: the side of :func:`in_turns` for phase 7d, run as ``IN_TURNS_TRAIN`` is:
#: B7 in bfloat16 at 64 slots x 4096 positions, then the paged bench's
#: ``"pallas"`` wave (one warm-up, then three, each timed on the host's clock)
IN_TURNS_PAGED = """
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as c
from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params
dev = torch.device("cuda", 0)
sizes, big = c.FULL_SIZES, c.FULL_SIZES["b7_big"]
b7 = c.b7_row(big, [big[5] * big[4]] * big[0], dev, 20, 1, seed=22)
cfg = LabformerConfig(**sizes["paged"], dtype=torch.bfloat16)
model = Labformer.from_numpy(init_params(cfg, seed=0), cfg, dev)
c.paged_wave(model, cfg, sizes, "pallas", "native", dev)
waves = [c.paged_wave(model, cfg, sizes, "pallas", "native", dev) for _ in range(3)]
walls = [w["wall_s"] for w in waves]
tokens = sum(len(x) for x in waves[0]["streams"])
ticks = waves[0]["stats"]["ticks"]
print("IN_TURNS " + json.dumps({"b7_ms": b7["ms"], "b7_bound_ms": b7["bound_ms"],
                                "wave_s_runs": walls,
                                "tokens_per_s": tokens / statistics.median(walls),
                                "ms_per_tick": statistics.median(walls) * 1e3 / ticks}),
      flush=True)
"""


def in_turns(parent: Path, card: str, side: str, what: str) -> list:
    """``side`` run from the checkout at ``parent`` and from this one in
    turns, parent, change, change, parent, each in a process of its own on
    this card (host speed differs between machines, so two versions are
    compared only within one run); each run's ``IN_TURNS`` line."""
    import torch

    torch.cuda.empty_cache()  # the card's memory for the sides' own processes
    runs = []
    for name, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                       ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", side, str(root)], cwd=root,
                             capture_output=True, text=True, timeout=900)
        lines = [x for x in res.stdout.splitlines() if x.startswith("IN_TURNS ")]
        check(res.returncode == 0 and len(lines) == 1,
              f"in-turn run of {name} ({root}) exited with {res.returncode}: "
              f"{res.stderr[-2000:]}")
        runs.append({"side": name, **json.loads(lines[0].split(" ", 1)[1])})
        print(f"{what} in turns, {name}: {json.dumps(runs[-1])} ({card})", flush=True)
    return runs


def run_train_path(sizes: dict, device, backend: str, card: str,
                   parent: Path | None = None) -> tuple:
    """Phase 6: (the B5 row, the B6 row, their launches, the training
    numbers); with ``parent``, phase 6c also runs ``IN_TURNS_TRAIN`` in
    turns (:func:`in_turns`)."""
    t0 = time.perf_counter()
    losses, launches = drive_train_path(sizes, backend)
    print(f"training path: {json.dumps(launches)} launches; CLI losses {losses}", flush=True)
    check_launched(launches, TRAIN_KERNELS, device, "training path")
    training = {"cli_train": {"launches": launches, "losses": losses},
                "train_f32": check_train_f32(sizes, device),
                "train_bf16": time_train_bf16(sizes, device, card)}
    training["train_bf16"]["in_turns"] = (
        in_turns(parent, card, IN_TURNS_TRAIN, "training bf16") if parent
        else "not run: no --parent checkout given")
    dq, dkv = bwd_kernel_rows(sizes, device)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s", flush=True)
    return dq, dkv, launches, training


# ---------------------------------------------------------------- paged path

#: the model of tpulab's paged bench (tpulab/bench.py:290-341,
#: bench_paged_engine): the serving width with 2 kv heads
PAGED = dict(d_model=512, n_heads=8, n_kv_heads=2, n_layers=8, d_ff=2048, max_seq=1024)
#: the engine variants phase 7a times: (attn, kv_dtype)
PAGED_VARIANTS = (("pallas", "native"), ("gather", "native"), ("pallas", "int8"))


def paged_jobs(sizes: dict) -> list:
    """The bench's requests: seeded random prompts of the bench's lengths."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (p,)).astype(np.int32) for p in sizes["paged_prompts"]]


def paged_wave(model, cfg, sizes: dict, attn: str, kv_dtype: str, device) -> dict:
    """One wave of the bench's requests through a fresh engine: its outputs,
    stats and wall seconds (the engine drains every tick before it returns)."""
    import torch

    from tpulab_torch.models.paged import PagedEngine

    t0 = time.perf_counter()
    eng = PagedEngine(model, cfg, slots=sizes["paged_slots"], n_blocks=sizes["paged_blocks"],
                      block_size=sizes["paged_bs"], max_seq=sizes["paged_max_seq"], attn=attn,
                      kv_dtype=kv_dtype)
    rids = [eng.submit(p, max_new=sizes["paged_new"]) for p in paged_jobs(sizes)]
    out = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [out[r] for r in rids]
    check(all(len(x) == sizes["paged_new"] for x in streams), f"paged {attn} {kv_dtype}: "
          f"stream lengths {[len(x) for x in streams]}")
    check_no_leak(eng, f"paged {attn} {kv_dtype}")
    return {"streams": streams, "stats": eng.stats(), "wall_s": wall}


def check_no_leak(eng, what: str) -> None:
    """Every usable block is free or held by the prefix cache alone (the
    dict's entries or the radix index's nodes), and no slot holds one."""
    if eng._radix is not None:
        held = list(eng._radix.blocks())
    else:
        held = [b for blocks in eng.prefix_cache.values() for b in blocks]
    cached = set(held)
    check(len(eng.free) + len(cached) == eng.n_usable_blocks
          and int(eng.block_refs.sum()) == len(held) and bool(np.all(eng.tables == 0)),
          f"{what}: blocks leaked ({len(eng.free)} free, {len(cached)} cached of "
          f"{eng.n_usable_blocks})")


def b7_want(cfg, attn: str):
    """Launches a paged run must show: B7 once per layer per tick under
    pallas, never under gather; nothing else."""
    return lambda wave: {"paged_decode": wave["stats"]["ticks"] * cfg.n_layers
                         if attn == "pallas" else 0}


def time_paged_bench(sizes: dict, device, card: str) -> tuple:
    """Phase 7a: (the bench's numbers per variant, B7's launches on the
    first pallas wave)."""
    import statistics

    import torch

    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    cfg = LabformerConfig(**sizes["paged"], dtype=torch.bfloat16)
    model = Labformer.from_numpy(init_params(cfg, seed=0), cfg, device)
    rows, b7_launches = {}, None
    for attn, kv in PAGED_VARIANTS:
        wave, launches = counted(lambda: paged_wave(model, cfg, sizes, attn, kv, device), device,
                                 b7_want(cfg, attn), f"paged bench wave ({attn}, {kv})")
        if b7_launches is None and attn == "pallas":
            b7_launches = launches["paged_decode"]
        walls, ticks = [], wave["stats"]["ticks"]
        for _ in range(sizes["paged_reps"]):
            w, _ = counted(lambda: paged_wave(model, cfg, sizes, attn, kv, device), device,
                           b7_want(cfg, attn), f"paged bench wave ({attn}, {kv})")
            walls.append(w["wall_s"])
            check(w["stats"]["ticks"] == ticks, "paged bench waves differ in ticks")
        tokens = sum(len(x) for x in wave["streams"])
        wall = statistics.median(walls)
        prof = profile_window(lambda: paged_wave(model, cfg, sizes, attn, kv, device), device)
        if "kernel_launches" in prof:
            prof["launches_per_tick"] = prof["kernel_launches"] / ticks
        st = wave["stats"]
        row = {"tokens_per_s": tokens / wall, "ms_per_tick": wall * 1e3 / ticks,
               "wall_s_runs": walls, "tokens": tokens, "ticks": ticks,
               "launches": launches, "profile": prof,
               **{k: st[k] for k in ("prefill_chunks", "host_syncs", "h2d_ticks",
                                     "stall_ticks", "kv_pool_bytes")}}
        rows[f"{attn}_{kv}"] = row
        print(f"paged bench ({attn}, {kv}) bf16: {row['tokens_per_s']:.1f} tokens/s, "
              f"{row['ms_per_tick']:.3f} ms per tick, median of {len(walls)} waves "
              f"({', '.join(f'{x:.4f}' for x in walls)} s), {ticks} ticks ({card}); "
              f"launches {json.dumps(launches)}; profile {json.dumps(prof)}", flush=True)
    return rows, b7_launches


def check_paged_f32(sizes: dict, device) -> dict:
    """Phase 7b: the bench's model in f32, B7 on the card against the port
    on the CPU, and B7 against the gather path on the card."""
    import torch

    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    cfg = LabformerConfig(**sizes["paged"], dtype=torch.float32)
    params = init_params(cfg, seed=0)
    cpu_model = Labformer.from_numpy(params, cfg, "cpu")
    card = Labformer.from_numpy(params, cfg, device)
    t0 = time.perf_counter()
    cpu = paged_wave(cpu_model, cfg, sizes, "pallas", "native", torch.device("cpu"))
    margins = []
    for prompt in paged_jobs(sizes):
        _, logits = greedy_with_logits(cpu_model, torch.from_numpy(prompt)[None].long(),
                                       sizes["paged_new"])
        top2 = logits[0].topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).numpy())
    cpu_s = time.perf_counter() - t0
    got = {attn: counted(lambda: paged_wave(card, cfg, sizes, attn, "native", device), device,
                         b7_want(cfg, attn), f"paged f32 wave ({attn})")[0]
           for attn in ("pallas", "gather")}
    out = {"cpu_run_s": cpu_s}
    for name, ref, test in (("card_pallas_vs_cpu", cpu, got["pallas"]),
                            ("card_pallas_vs_card_gather", got["gather"], got["pallas"])):
        equal = []
        for i, (a, b, m) in enumerate(zip(ref["streams"], test["streams"], margins)):
            n = 0
            while n < len(m) and m[n] >= 1e-2:
                check(int(a[n]) == int(b[n]), f"paged f32 {name}: request {i} token {n} "
                      f"differs ({int(b[n])} vs {int(a[n])}; CPU margin {float(m[n])})")
                n += 1
            equal.append(n)
        out[name] = {"tokens_equal_until_margin": equal, "of": sizes["paged_new"]}
    print(f"paged f32: tokens equal up to the first CPU top-2 margin below 1e-2 "
          f"(per request, of {sizes['paged_new']}): card pallas vs CPU "
          f"{out['card_pallas_vs_cpu']['tokens_equal_until_margin']}, card pallas vs card "
          f"gather {out['card_pallas_vs_card_gather']['tokens_equal_until_margin']}; CPU run "
          f"{cpu_s:.1f} s", flush=True)
    return out


def check_paged_daemon(sizes: dict, device, card: str) -> dict:
    """Phase 7c: the daemon's engine settings with a shared 128-token
    prefix: the first request's prefill registers the prefix, the rest
    hit it, and admission never stalls a decoding slot."""
    import torch

    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params
    from tpulab_torch.models.paged import PagedEngine

    cfg = LabformerConfig(**sizes["paged"], dtype=torch.bfloat16)
    model = Labformer.from_numpy(init_params(cfg, seed=0), cfg, device)
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 256, sizes["daemon_prefix"]).astype(np.int32)
    tails = [5] + list(rng.integers(1, sizes["daemon_tail_max"] + 1,
                                    sizes["daemon_requests"] - 1))
    prompts = [np.concatenate([prefix, rng.integers(0, 256, t).astype(np.int32)])
               for t in tails]

    def serve():
        t0 = time.perf_counter()
        eng = PagedEngine(model, cfg, slots=sizes["daemon_slots"],
                          n_blocks=sizes["daemon_blocks"], block_size=16,
                          max_seq=sizes["daemon_max_seq"], prefill_chunk=sizes["daemon_chunk"],
                          attn="pallas")
        first = eng.submit(prompts[0], max_new=sizes["daemon_new"])
        while not any(r is not None and r.phase == "decode" for r in eng.active):
            eng.step()  # the first prompt's chunks, until its prefix registers
        rids = [first] + [eng.submit(p, max_new=sizes["daemon_new"]) for p in prompts[1:]]
        out = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(len(out[r]) == sizes["daemon_new"] for r in rids), "daemon-size streams")
        check_no_leak(eng, "daemon-size engine")
        return {"stats": eng.stats(), "wall_s": wall}

    res, launches = counted(serve, device, b7_want(cfg, "pallas"), "daemon-size engine")
    st = res["stats"]
    check(st["prefix_hits"] > 0, f"daemon-size engine: no prefix hit ({st})")
    check(st["stall_ticks"] == 0, f"daemon-size engine: {st['stall_ticks']} stalled ticks")
    row = {k: st[k] for k in ("prefix_hits", "prefix_misses", "prefill_chunks", "stall_ticks",
                              "host_syncs", "h2d_ticks", "ticks", "tokens_out", "blocks_free",
                              "cache_entries")}
    row.update(tails=[int(t) for t in tails], wall_s=res["wall_s"],
               tokens_per_s=st["tokens_out"] / res["wall_s"], launches=launches)
    print(f"paged daemon-size engine: {json.dumps(row)} ({card})", flush=True)
    return row


def skip_block(tables, lengths, j: int, bs: int):
    """Each slot's table and length with logical block ``j`` taken out:
    what a kernel that skipped that block, where it is wholly live, would
    attend (with a window, one block narrower)."""
    import torch

    cut = torch.cat([tables[:, :j], tables[:, j + 1:], torch.zeros_like(tables[:, :1])], 1)
    return cut, lengths - torch.where(lengths >= (j + 1) * bs, bs, 0).to(lengths.dtype)


def b7_row(shape, lengths, device, iters, plain_iters, *, int8=False, window=0, seed=0,
           plant=False) -> dict:
    """B7 against its plain version at one shape, with its times and bound;
    with ``plant``, also check that the limit rejects a skipped block."""
    import torch
    import torch.nn.functional as F

    from tpulab_torch.models.paged import _kv_quant, _paged_attend
    from tpulab_torch.ops.cuda.paged import (
        SMS,
        paged_attend_kernel,
        paged_attend_plain,
        paged_over_tolerance,
        pool_gather,
        row_blocks,
        split_plan,
    )

    S, h, kvh, d, bs, M = shape
    rng = np.random.default_rng(seed)
    P = S * M + 1
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(device)
    q = mk(S, 1, h, d).to(torch.bfloat16)
    kf, vf = mk(P, bs, kvh, d), mk(P, bs, kvh, d)
    kp, vp = (_kv_quant(kf), _kv_quant(vf)) if int8 else (kf.to(q.dtype), vf.to(q.dtype))
    del kf, vf
    tables = torch.from_numpy(1 + rng.permutation(S * M).reshape(S, M).astype(np.int32)).to(device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    args = (q, kp, vp, tables, lens, bs, window)
    want = paged_attend_plain(*args)
    got = paged_attend_kernel(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ratio = paged_over_tolerance(got, want)
    check(ratio <= 1, f"paged decode {shape} int8={int8} window={window}: |o - plain| reaches "
                      f"{ratio} of its limit")
    live = ~torch.isnan(want.float()).any(-1)
    nrb = row_blocks(h // kvh)
    splits, span = split_plan(S, kvh, M * bs, d, nrb, torch.cuda.get_device_properties(
        device).multi_processor_count if device.type == "cuda" else SMS)
    row = {"shape": {"slots": S, "heads": h, "kv_heads": kvh, "head_dim": d, "block_size": bs,
                     "max_blocks": M}, "design": "split", "splits": splits, "span": span,
           "blocks": S * kvh * nrb * splits, "dtype": "bfloat16",
           "kv": "int8" if int8 else "native",
           "window": window, "lengths": lengths if len(lengths) <= 8 else
           f"{len(lengths)} x {lengths[0]}", "max_abs_err": max_abs_err(got[live], want[live]),
           "tolerance": "paged_over_tolerance (tpulab_torch/ops/cuda/paged.py)",
           "err_over_tolerance": ratio}
    if 0 in lengths:
        row["length0_rows_nan"] = bool(torch.isnan(got[lens == 0]).all())
    if plant:
        j = (min(lengths) - 1) // bs - 2
        cut, cut_lens = skip_block(tables, lens, j, bs)
        fault = paged_over_tolerance(
            paged_attend_plain(q, kp, vp, cut, cut_lens, bs, max(window - bs, 0) if window
                               else 0), want)
        check(fault > 1, f"paged decode {shape}: a skipped block {j} is only {fault} of its "
                         f"limit")
        row["skipped_block_over_tolerance"] = [j, fault]
    del want
    visible = [min(n, window) if window else n for n in lengths]
    positions = sum(visible)
    e = q.element_size()
    kv_bytes = positions * kvh * d * (2 if int8 else 2 * e) + (8 * positions * kvh if int8 else 0)
    nbytes = kv_bytes + 2 * S * h * d * e
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * h * d * positions, BF16_FLOPS)
    row["bytes"] = nbytes
    row["ms"] = time_ms(lambda: paged_attend_kernel(*args), (), device, iters)
    row["plain_ms"] = time_ms(lambda: paged_attend_plain(*args), (), device, plain_iters)
    row["gather_ms"] = time_ms(lambda: _paged_attend(*args), (), device, plain_iters)
    # the yardstick: one PyTorch call over K/V gathered beforehand (the
    # gather is left out of its time); the port never calls it
    idx = tables.long()
    kd = pool_gather(kp, idx, q.dtype).reshape(S, M * bs, kvh, d).transpose(1, 2)
    vd = pool_gather(vp, idx, q.dtype).reshape(S, M * bs, kvh, d).transpose(1, 2)
    pos = torch.arange(M * bs, device=device)[None, :]
    keep = pos < lens[:, None].long()
    if window:
        keep = keep & (pos > lens[:, None].long() - 1 - window)
    qt = q.transpose(1, 2)
    library = lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=keep[:, None, None],
                                                     enable_gqa=kvh != h)
    lib_o = library().transpose(1, 2)
    row["library_max_abs_err"] = max_abs_err(lib_o[live], got[live])
    row["library_ms"] = time_ms(library, (), device, iters)
    row["library_note"] = "scaled_dot_product_attention on K/V gathered beforehand (gather not timed)"
    return row


def paged_kernel_row(sizes: dict, device) -> dict:
    """Phase 7d: the B7 row of the kernels line."""
    S, h, kvh, d, bs, M = sizes["b7_bench"]
    row = b7_row(sizes["b7_bench"], sizes["b7_bench_lengths"], device, 200, 20, seed=21)
    big = sizes["b7_big"]
    n = [big[5] * big[4]] * big[0]
    row["at_scale"] = [
        b7_row(big, n, device, 20, 3, seed=22, plant=True),
        b7_row(big, n, device, 20, 3, int8=True, seed=23, plant=True),
        b7_row(big, n, device, 20, 3, window=sizes["b7_window"], seed=24, plant=True),
    ]
    for r in [row, *row["at_scale"]]:
        print(f"paged decode {r['shape']} {r['kv']} window {r['window']}, {r['splits']} splits "
              f"of {r['span']} ({r['blocks']} blocks): {r['ms']:.6f} ms, "
              f"bound {r['bound_ms']:.6f} ({r['bound_by']}), plain {r['plain_ms']:.6f}, "
              f"gather {r['gather_ms']:.6f}, sdpa {r['library_ms']:.6f}; "
              f"{r['err_over_tolerance']:.4f} of the limit"
              + (f", skipped block {r['skipped_block_over_tolerance']}" if "skipped_block_over_tolerance" in r else ""),
              flush=True)
    return row


def run_paged_path(sizes: dict, device, card: str, parent: Path | None = None) -> tuple:
    """Phase 7: (the B7 row, its main-path launches, the paged numbers);
    with ``parent``, phase 7d also runs ``IN_TURNS_PAGED`` in turns
    (:func:`in_turns`)."""
    t0 = time.perf_counter()
    bench, b7_launches = time_paged_bench(sizes, device, card)
    paged = {"bench_bf16": bench, "f32": check_paged_f32(sizes, device),
             "daemon_size": check_paged_daemon(sizes, device, card)}
    row = paged_kernel_row(sizes, device)
    paged["in_turns"] = (in_turns(parent, card, IN_TURNS_PAGED, "paged B7 and wave") if parent
                         else "not run: no --parent checkout given")
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)
    return row, b7_launches, paged


# ------------------------------------------------------------ lab suite path

U32 = 2.0 ** -24
#: float32 sums of the card and of the CPU are held within 2 * gamma_h *
#: sum|x| of each other (gamma_h = h u / (1 - h u), u = 2^-24; Higham,
#: (4.4)): each is a tree of partial sums whose longest chain of dependent
#: additions is far below h = 2^12 (ATen's CUDA reduction: per-thread runs
#: of n / (threads * 4), then a tree; its CPU cascade sum: levels of short
#: blocks).  Both also lie within gamma_h * sum|x| of the float64 sum.
SUM_DEPTH = 2 ** 12
HW1_CASES = ("0 0 0", "0 0 5", "0 2 -4", "1 -3 2", "1 2 1", "1 0 1")


def sum_tolerance(values: np.ndarray) -> float:
    gamma = SUM_DEPTH * U32 / (1 - SUM_DEPTH * U32)
    return gamma * float(np.abs(values.astype(np.float64)).sum())


def prod_tolerance(n: int) -> float:
    """Relative error of a float32 product of n values in any order: each
    of its n - 1 multiplications rounds once, whatever the tree, so
    (1 + u)^(n - 1) - 1 and no less.  At n = 2^24 that is e - 1: the check
    holds the sign and the scale only (a tree and a sequential product of
    2^24 values near 1 differ by 5e-3 relative on the card)."""
    return (1 + U32) ** (n - 1) - 1


def special_floats() -> np.ndarray:
    """+-0 in both orders, NaNs of distinct payloads and both signs,
    infinities: what ``jnp.sort`` orders by its own rule."""
    bits = np.array([0x40400000, 0x80000000, 0x00000000, 0x7FC00001, 0x80000000,
                     0xFFC00002, 0x3F800000, 0x7F800003, 0xFF800000, 0x00000000,
                     0x7F800000, 0x7FC00004, 0xBF800000, 0x80000000, 0xFFFFFFFF],
                    np.uint32)
    return bits.view(np.float32)


def lab5_files(sizes: dict, work: Path, seed: int = 0) -> dict:
    """Seeded lab5 inputs in the binfmt format: name -> (path, values)."""
    from tpulab_torch.io import save_typed_array

    rng = np.random.default_rng(seed)
    n, ns = sizes["lab5_n"], sizes["lab5_sort_n"]
    arrays = {
        "int32": rng.integers(-10000, 10000, n).astype(np.int32),
        "uint8": rng.integers(0, 256, n).astype(np.uint8),
        "float32": rng.normal(scale=100.0, size=n).astype(np.float32),
        "float32_prod": (1 + rng.normal(scale=1e-3, size=n)).astype(np.float32),
        "sort_float32": rng.normal(scale=100.0, size=ns).astype(np.float32),
        "sort_int32": rng.integers(-2**31, 2**31 - 1, ns).astype(np.int32),
        "sort_uint8": rng.integers(0, 256, ns).astype(np.uint8),
        "specials": special_floats(),
        "zeros_min": np.array([0.0, 3.0, -0.0, 0.0], np.float32),
        "zeros_max": np.array([-0.0, -3.0, 0.0, -0.0], np.float32),
    }
    # the large float sort holds the special values too, at scattered places
    sf = arrays["sort_float32"]
    spots = rng.choice(ns, size=64 * special_floats().size, replace=False)
    sf[spots] = np.tile(special_floats(), 64)
    work.mkdir(parents=True, exist_ok=True)
    files = {}
    prefix = {np.dtype(np.int32): "int", np.dtype(np.uint8): "uchar", np.dtype(np.float32): "float"}
    for name, values in arrays.items():
        # the element type comes from the file name's prefix, as in the reference's data
        path = str(work / f"{prefix[values.dtype]}_{name}_{values.size}")
        save_typed_array(path, values)
        files[name] = (path, values)
    return files


def check_lab5(files: dict, backend: str) -> list:
    """Phase 8a: lab5's reductions through the CLI on the card against the
    port's CPU run."""
    rows = []
    for name in ("int32", "uint8", "float32", "float32_prod", "specials", "zeros_min",
                 "zeros_max"):
        path, values = files[name]
        tasks = {"float32_prod": ("prod",), "specials": ("min", "max"), "zeros_min": ("min", "max"),
                 "zeros_max": ("min", "max")}.get(
            name, ("sum", "min", "max") + (("prod",) if values.dtype != np.float32 else ()))
        for task in tasks:
            argv = ["run", "lab5", "--task", task]
            dev = cli(argv + ["--backend", backend], path + "\n").splitlines()
            ref = cli(argv + ["--backend", "cpu"], path + "\n").splitlines()
            check(timing_word(dev[0]) == ("CUDA" if backend == "cuda" else "CPU"),
                  f"lab5 {name} {task} timing line says {dev[0]}")
            row = {"file": name, "n": int(values.size), "task": task, "value": dev[1],
                   "cpu_value": ref[1], "timing": dev[0]}
            if values.dtype == np.float32 and task == "sum":
                row["gap"] = abs(float(dev[1]) - float(ref[1]))
                row["limit"] = 2 * sum_tolerance(values)
                exact = float(values.astype(np.float64).sum())
                check(row["gap"] <= row["limit"]
                      and abs(float(dev[1]) - exact) <= sum_tolerance(values),
                      f"lab5 float32 sum {dev[1]} vs CPU {ref[1]} and exact {exact}")
            elif task == "prod" and values.dtype == np.float32:
                exact = float(np.prod(values.astype(np.float64)))
                row["gap"] = abs(float(dev[1]) - float(ref[1]))
                row["rel_to_exact"] = [abs(float(v) / exact - 1) for v in (dev[1], ref[1])]
                row["limit"] = prod_tolerance(values.size)
                check(max(row["rel_to_exact"]) <= row["limit"],
                      f"lab5 float32 prod {dev[1]} and CPU {ref[1]} vs exact {exact}")
            else:
                check(dev[1] == ref[1],
                      f"lab5 {name} {task}: {dev[1]} on the card, {ref[1]} on the CPU")
            print(f"lab5 {name} n={values.size} {task}: {dev[0]} -> {dev[1]} (CPU {ref[1]})",
                  flush=True)
            rows.append(row)
    return rows


def check_sorts(files: dict, backend: str, device) -> list:
    """Phase 8b: lab5's sort through the CLI on the card, its files byte-equal
    to the port's CPU run; and whether ``torch.sort`` alone, with no
    canonical keys, keeps ``jnp.sort``'s order on the card."""
    import torch

    from tpulab_torch.ops.sortops import sort_ascending

    rows = []
    for name in ("sort_float32", "sort_int32", "sort_uint8", "specials"):
        path, values = files[name]
        outs = {}
        for side in (backend, "cpu"):
            out = f"{path}_sorted_{side}"
            stdout = cli(["run", "lab5", "--task", "sort", "--backend", side], f"{path}\n{out}\n")
            outs[side] = (Path(out).read_bytes(), stdout.splitlines()[0])
        check(outs[backend][0] == outs["cpu"][0], f"lab5 sort of {name} differs from the CPU run")
        x = torch.from_numpy(values).to(device)
        raw = torch.sort(x, stable=True).values
        row = {"file": name, "n": int(values.size), "timing": outs[backend][1],
               "raw_torch_sort_equal": bitwise_equal(raw.cpu(), sort_ascending(x).cpu())}
        print(f"lab5 sort {name} n={values.size}: {row['timing']}; byte-equal to the CPU; "
              f"torch.sort alone keeps the order: {row['raw_torch_sort_equal']}", flush=True)
        rows.append(row)
    return rows


def check_hw(sizes: dict, backend: str, seed: int = 0) -> dict:
    """Phase 8c: hw1's cases and hw2 at ``hw2_n`` floats through the CLI,
    byte-equal to the port's CPU run."""
    from tpulab_torch.io import protocol

    for case in HW1_CASES:
        dev = cli(["run", "hw1", "--backend", backend], case + "\n")
        check(dev == cli(["run", "hw1", "--backend", "cpu"], case + "\n"), f"hw1 {case!r}: {dev!r}")
    timed = cli(["run", "hw1", "--backend", backend, "--timing"], HW1_CASES[3] + "\n")
    check(timing_word(timed) == "CPU", f"hw1 solves on the host: {timed!r}")
    rng = np.random.default_rng(seed)
    vals = rng.normal(scale=1e3, size=sizes["hw2_n"]).astype(np.float32)
    vals[::1000] = -0.0
    text = protocol.format_hw2_input(vals)
    dev = cli(["run", "hw2", "--backend", backend, "--timing"], text)
    ref = cli(["run", "hw2", "--backend", "cpu"], text)
    line, payload = dev.split("\n", 1)
    check(timing_word(line) == ("CUDA" if backend == "cuda" else "CPU"), f"hw2 timing: {line}")
    check(payload == ref, "hw2's sorted output differs from the CPU run")
    print(f"hw1: {len(HW1_CASES)} cases byte-equal; hw2 n={vals.size}: {line}", flush=True)
    return {"hw1_cases": len(HW1_CASES), "hw1_timing": timed.splitlines()[0],
            "hw2_n": int(vals.size), "hw2_timing": line}


def harness_runs(work: Path, stats: str) -> list:
    """Rows of a harness run's runs CSV, and its stats CSV must exist."""
    import csv

    check((work / f"stats_{stats}.csv").is_file(), f"no stats CSV in {work}")
    with open(work / f"runs_{stats}.csv") as f:
        return list(csv.DictReader(f))


def check_harness(sizes: dict, backend: str, work: Path, seed: int = 0) -> dict:
    """Phase 8d: ``python -m tpulab_torch.harness.run`` on the card: the lab2
    and lab3 golden sweeps with the CPU reference, and a lab2 sweep over a
    seeded image under the launch geometry ``[[32,32],[16,16]]`` with the
    plain version's output as its golden."""
    from tpulab_torch.harness.run import main as harness_main
    from tpulab_torch.io import save_image
    from tpulab_torch.ops.cuda.stencil import roberts_u32_plain
    from tpulab_torch.ops.roberts import pack_rgba, unpack_rgba

    dev = ["--backend", backend] if backend == "cpu" else []
    out = {}
    for lab in ("lab2", "lab3"):
        art = work / f"harness_{lab}"
        argv = ["--lab", lab, "--cpu-ref", "--k-times", str(sizes["harness_k"]),
                "--artifact-dir", str(art), "--dir_to_data", str(ROOT / f"data/{lab}/data"),
                "--dir_to_data_out", str(work / f"harness_{lab}_out"),
                "--dir_to_data_out_gt", str(ROOT / f"data/{lab}/data_out_gt"), *dev]
        if lab == "lab2":  # once as its own process, as a user runs it
            env = dict(os.environ, PYTHONPATH=str(ROOT))
            res = subprocess.run([sys.executable, "-m", "tpulab_torch.harness.run", *argv],
                                 capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
            check(res.returncode == 0, f"harness {lab}: {res.stdout[-1500:]} {res.stderr[-1500:]}")
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                check(harness_main(argv) == 0, f"harness {lab} failed")
        runs = harness_runs(art, f"tpulab_torch_{lab}")
        check(all(r["verified"] == "True" for r in runs), f"harness {lab}: unverified rows")
        word = "CUDA" if backend == "cuda" else "CPU"
        check({r["device_reported"] for r in runs if r["device"] != "CPU" or backend == "cpu"}
              == {word}, f"harness {lab}: device words {[r['device_reported'] for r in runs]}")
        out[lab] = {"runs_verified": len(runs)}
    side = sizes["harness_side"]
    img = np.random.default_rng(seed).integers(0, 256, (side, side, 4), np.uint8)
    data, gt = work / "harness_big" / "data", work / "harness_big" / "data_out_gt"
    data.mkdir(parents=True, exist_ok=True)
    gt.mkdir(parents=True, exist_ok=True)
    save_image(str(data / f"seeded_{side}.data"), img)
    plain = roberts_u32_plain(pack_rgba(img).to("cuda" if backend == "cuda" else "cpu"))
    save_image(str(gt / f"seeded_{side}.data"), unpack_rgba(plain))
    art = work / "harness_big_art"
    argv = ["--lab", "lab2", "--k-times", str(sizes["harness_k"]),
            "--kernel-sizes", "[[[32, 32], [16, 16]]]", "--artifact-dir", str(art),
            "--dir_to_data", str(data), "--dir_to_data_out", str(work / "harness_big" / "out"),
            "--dir_to_data_out_gt", str(gt), *dev]
    with contextlib.redirect_stdout(io.StringIO()):
        check(harness_main(argv) == 0, "harness lab2 sweep over the seeded image failed")
    runs = harness_runs(art, "tpulab_torch_lab2")
    check(all(r["verified"] == "True" for r in runs), "harness seeded lab2: unverified rows")
    times = [float(r["time_kernel_ms"]) for r in runs]
    out["lab2_seeded"] = {"side": side, "geometry": [[32, 32], [16, 16]], "runs": len(runs),
                          "median_ms": float(np.median(times))}
    print(f"harness: lab2 and lab3 goldens verified with the CPU reference "
          f"({out['lab2']['runs_verified']} and {out['lab3']['runs_verified']} runs); "
          f"lab2 {side}^2 under [[32,32],[16,16]] verified, median "
          f"{out['lab2_seeded']['median_ms']:.6f} ms", flush=True)
    return out


def check_bench_and_selftest(sizes: dict, backend: str) -> dict:
    """Phase 8e: ``tpulab_torch bench`` (every row on the device) and
    ``tpulab_torch selftest`` (exit 0), through the CLI's entry point."""
    from tpulab_torch.bench import LAB_ROWS

    extra = ["--backend", backend] if backend == "cpu" else []
    for key, value in sizes["bench"].items():
        extra += [f"--{key}", str(value)]
    rows = [json.loads(line) for name in LAB_ROWS
            for line in cli(["bench", "--only", name, *extra], "").splitlines()]
    for row in rows:
        print(json.dumps(row), flush=True)
        check(row["device"] == ("cuda" if backend == "cuda" else "cpu"), f"bench row {row}")
        check(backend == "cpu" or ("card" in row and "power_limit" in row), f"bench row {row}")
    skip = [a for s in sizes["selftest_skip"] for a in ("--skip", s)]
    stdout = cli(["selftest", *(["--backend", backend] if backend == "cpu" else []), *skip], "")
    print(stdout.strip(), flush=True)
    check("[selftest] OK" in stdout, "selftest did not pass")
    return {"bench": rows, "selftest": stdout.strip().splitlines()[-1]}


def run_lab_suite_path(sizes: dict, device, backend: str, work: Path = WORK) -> tuple:
    """Phase 8: lab5, hw1, hw2, the harness, ``bench`` and ``selftest`` on
    ``device``; (its numbers, launches per kernel over the whole phase)."""
    t0 = time.perf_counter()
    wrappers = zero_counts()
    files = lab5_files(sizes, work)
    suite = {"lab5": check_lab5(files, backend), "sort": check_sorts(files, backend, device),
             "hw": check_hw(sizes, backend), "harness": check_harness(sizes, backend, work),
             **check_bench_and_selftest(sizes, backend)}
    launches = {name: w.launches for name, w in wrappers.items()}
    check_launched(launches, LAB_KERNELS, device, "lab suite path")
    suite["launches"] = launches
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s; launches {json.dumps(launches)}",
          flush=True)
    return suite, launches


# ------------------------------------------------- speculative decoding, bench

#: the small labformer the serving tests share (``tests/conftest.py``'s
#: ``trained_small``): d32, 4 heads, 2 layers, d_ff 64, trained on the card
#: on a period-7 byte cycle until its greedy margins are wide
SMALL = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=128)
#: bench groups of phase 9c: each a ``--only`` substring (``labformer_decode``
#: runs its int8 and gqa2 rows, ``flash_attention`` its 8k row too)
BENCH_GROUPS = ("labformer_fwd", "labformer_train", "labformer_decode", "speculative_decode",
                "paged_engine", "paged_tick_overhead", "prefill_interleave", "spill_overhead",
                "handoff_overhead", "prefix_lookup", "flash_attention")


def cycle(n: int, offset: int = 0) -> np.ndarray:
    return ((np.arange(n) + offset) % 7).astype(np.int32)


def train_small(sizes: dict, device):
    """The shared small labformer, trained on ``device`` as ``trained_small``
    is (adamw, 8 rows of a period-7 cycle); frozen for serving."""
    import torch

    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_train_state

    cfg = LabformerConfig(**SMALL)
    model, opt, step = init_train_state(cfg, seed=0, device=device)
    tok = torch.from_numpy(np.tile(np.arange(33, dtype=np.int64) % 7, (8, 1))).to(device)
    for _ in range(sizes["small_train_steps"]):
        model, opt, loss = step(model, opt, tok)
    check(bool(torch.isfinite(loss)), f"small labformer: loss {float(loss)}")
    return Labformer.from_numpy(model.to_numpy(), cfg, device), cfg, float(loss)


def int8_draft(params: dict, cfg, device):
    """The int8-quantized labformer of a parameter tree (the speculative
    draft), on ``device``."""
    from tpulab_torch.models.labformer import Labformer
    from tpulab_torch.models.quant import quantize_decode_params

    return Labformer.from_numpy(quantize_decode_params(params, cfg), cfg, device)


def equal_until_near_tie(ref, got, logits, bf16: bool, what: str) -> int:
    """Tokens of ``got`` equal ``ref`` up to the first position whose top-2
    margin in ``logits`` (the plain stream's) falls below :func:`near_tie`;
    the count of positions held."""
    from tpulab_torch.ops.cuda.attention import bf16_ulp

    top2 = logits.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    tol = np.full(len(margin), 1e-2)
    if bf16:
        tol = np.maximum(tol, 4 * bf16_ulp(logits.abs().amax(-1)).numpy())
    n = 0
    while n < len(margin) and margin[n] >= tol[n]:
        check(int(ref[n]) == int(got[n]), f"{what}: token {n} differs ({int(got[n])} vs "
              f"{int(ref[n])}; margin {float(margin[n])})")
        n += 1
    return n


def run_speculative(sizes: dict, device, card: str) -> dict:
    """Phase 9a: ``speculative_generate`` (the int8 draft) and
    ``prompt_lookup_generate`` at the bench's width in bf16 against plain
    greedy decode on the card, then on the small labformer trained on the
    card, bit for bit; tokens/s of the three at the bench's prompt."""
    import torch

    from tpulab_torch.models.generate import generate
    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params
    from tpulab_torch.models.speculative import prompt_lookup_generate, speculative_generate
    from tpulab_torch.runtime.timing import measure_call_ms

    k, steps = sizes["spec_k"], sizes["spec_steps"]
    cfg = LabformerConfig(**sizes["serving"], dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    model = Labformer.from_numpy(params, cfg, device)
    draft = int8_draft(params, cfg, device)
    rng = np.random.default_rng(9)
    prompt = torch.from_numpy(rng.integers(0, 256, (1, sizes["spec_prompt"]))).to(device)
    flash = cfg.n_layers if sizes["spec_prompt"] >= 1024 else 0
    ref, logits = greedy_with_logits(model, prompt, steps)
    (spec, acc), spec_launches = counted(
        lambda: speculative_generate(draft, model, prompt, steps=steps, k=k), device,
        {"flash_fwd": 2 * flash}, "speculative decode")
    (look, look_acc), look_launches = counted(
        lambda: prompt_lookup_generate(model, prompt, steps=steps, k=k), device,
        {"flash_fwd": flash}, "prompt-lookup decode")
    out = {"width": {
        "prompt": sizes["spec_prompt"], "steps": steps, "k": k,
        "speculative_equal_until_near_tie": equal_until_near_tie(
            ref[0], spec[0], logits[0], True, "speculative bf16"),
        "lookup_equal_until_near_tie": equal_until_near_tie(
            ref[0], look[0], logits[0], True, "prompt lookup bf16"),
        "speculative_mean_accepted": acc, "lookup_mean_accepted": look_acc,
        "launches": {"speculative": spec_launches, "lookup": look_launches}}}
    # tokens/s at the bench row's prompt (tpulab/bench.py:222-289: 8 tokens)
    short = np.random.default_rng(0).integers(0, 256, (1, 8)).astype(np.int32)
    reps = sizes["spec_reps"]
    timed = {}
    for name, fn in (("plain", lambda: generate(model, short, steps, temperature=0.0)),
                     ("speculative", lambda: speculative_generate(draft, model, short,
                                                                  steps=steps, k=k)),
                     ("lookup", lambda: prompt_lookup_generate(model, short, steps=steps,
                                                               k=k))):
        runs: list = []
        ms, res = measure_call_ms(fn, device=device, reps=reps, warmup=1, collect=runs)
        timed[name] = {"tokens_per_s": steps / (ms / 1e3), "ms_runs": runs}
        if name != "plain":
            timed[name]["mean_accepted"] = res[1]
    for name in ("speculative", "lookup"):
        timed[name]["speedup_vs_plain"] = (timed[name]["tokens_per_s"]
                                          / timed["plain"]["tokens_per_s"])
    out["width"]["timed_bench_prompt"] = timed
    # the small labformer trained here: every stream bit-equal to plain greedy
    small, scfg, loss = train_small(sizes, device)
    sdraft = int8_draft(small.to_numpy(), scfg, device)  # float32: no bfloat16 leaf
    prompts = {"cycle5": np.tile(cycle(5), (2, 1)), "rep21": cycle(21)[None, :]}
    held = {}
    for name, pr in prompts.items():
        want = generate(small, pr, 24, temperature=0.0)
        got_s, acc_s = speculative_generate(sdraft, small, pr, steps=24, k=k)
        got_l, acc_l = prompt_lookup_generate(small, pr, steps=24, k=k)
        check(np.array_equal(got_s, want) and np.array_equal(got_l, want),
              f"small labformer {name}: speculative {got_s.tolist()} or lookup "
              f"{got_l.tolist()} is not greedy's {want.tolist()}")
        held[name] = {"speculative_mean_accepted": acc_s, "lookup_mean_accepted": acc_l}
    out["small_trained"] = {"loss": loss, "bit_equal": held}
    print(f"speculative (9a): {json.dumps(out)} ({card})", flush=True)
    return out, (small, scfg, sdraft)


def spec_jobs(prefix_len: int) -> list:
    """Mixed traffic: lookup and draft speculation, plain, sampled (one of
    them asking to speculate, which a sampled slot never does), penalized,
    a shared prefix and a prompt long enough for several chunks."""
    prefix = cycle(prefix_len)
    return [
        dict(prompt=cycle(40), max_new=48, spec="lookup"),
        dict(prompt=np.concatenate([prefix, [1, 2]]).astype(np.int32), max_new=40, spec="draft"),
        dict(prompt=np.concatenate([prefix, [3]]).astype(np.int32), max_new=32),
        dict(prompt=cycle(9, 2), max_new=40, temperature=1.2, seed=5, spec="lookup"),
        dict(prompt=cycle(200, 3), max_new=24, spec="lookup"),
        dict(prompt=cycle(6), max_new=24, repetition_penalty=2.0, spec="lookup"),
        dict(prompt=cycle(12, 4), max_new=32, spec="draft"),
        dict(prompt=np.concatenate([prefix, [5]]).astype(np.int32), max_new=56,
             temperature=0.8, seed=9),
    ]


def spec_engine_wave(model, cfg, draft, sizes: dict, jobs: list, spec_k: int, attn: str,
                     device, sync_debug: bool = False) -> dict:
    """One wave of ``jobs`` through an engine at the daemon's settings; its
    streams, stats, fetches per verify tick, wall seconds and (with
    ``sync_debug``, on the card) the host syncs the CUDA runtime saw."""
    import torch

    from tpulab_torch.models.paged import PagedEngine

    eng = PagedEngine(model, cfg, slots=sizes["daemon_slots"], n_blocks=sizes["daemon_blocks"],
                      block_size=16, max_seq=sizes["daemon_max_seq"],
                      prefill_chunk=sizes["daemon_chunk"], attn=attn, spec_k=spec_k,
                      draft_params=draft if spec_k else None)
    rids = [eng.submit(j["prompt"], max_new=j["max_new"], temperature=j.get("temperature", 0.0),
                       seed=j.get("seed", 0), repetition_penalty=j.get("repetition_penalty", 1.0),
                       spec=j.get("spec", "off") if spec_k else "off") for j in jobs]
    t0 = time.perf_counter()
    with watch_syncs(device if sync_debug else torch.device("cpu")) as syncs:
        out = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_no_leak(eng, f"speculative engine ({attn}, spec_k={spec_k})")
    return {"streams": [out[r] for r in rids], "stats": eng.stats(), "wall_s": wall,
            "spec_fetches": eng.spec_fetches, "sync_warnings": syncs}


def check_spec_engine(sizes: dict, device, card: str, small) -> dict:
    """Phase 9b: the engine at the daemon's settings with spec_k=4 and
    ``attn="pallas"`` under mixed traffic.  On the small labformer trained
    on the card: every stream (the sampled ones too) equal to the engines
    without speculation, one host wait per verify tick and no other sync,
    B7 once per layer of each plain tick.  At the paged bench's width in
    float32: greedy streams equal to the engine without speculation up to
    the first near-tie, and the tokens/s of both."""
    import torch

    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    model, cfg, draft = small
    jobs = spec_jobs(sizes["daemon_prefix"])
    k = sizes["spec_k"]

    def b7_spec(wave):
        st = wave["stats"]
        return {"paged_decode": (st["ticks"] - st["verify_passes"]) * cfg.n_layers}

    spec, launches = counted(lambda: spec_engine_wave(model, cfg, draft, sizes, jobs, k,
                                                      "pallas", device, sync_debug=True),
                             device, b7_spec, "speculative engine (pallas)")
    st = spec["stats"]
    check(st["verify_passes"] > 0 and st["spec_rounds"] > 0 and st["ticks"] > st["verify_passes"],
          f"speculative engine: no mix of verify and plain ticks ({st})")
    check(spec["spec_fetches"] == st["verify_passes"],
          f"speculative engine: {spec['spec_fetches']} host waits in {st['verify_passes']} "
          f"verify ticks")
    check(not spec["sync_warnings"], f"speculative engine synced: {spec['sync_warnings'][:3]}")
    check(device.type == "cpu" or launches["paged_decode"] > 0, "B7 ran on no plain tick")
    refs = {attn: counted(lambda: spec_engine_wave(model, cfg, None, sizes, jobs, 0, attn,
                                                   device), device, b7_want(cfg, attn),
                          f"engine without speculation ({attn})")[0]
            for attn in ("pallas", "gather")}
    for attn, ref in refs.items():
        for i, (a, b) in enumerate(zip(spec["streams"], ref["streams"])):
            check(np.array_equal(a, b), f"speculative engine request {i}: {a.tolist()} vs the "
                                        f"{attn} engine without speculation {b.tolist()}")
    out = {"small_trained": {
        **{key: st[key] for key in ("ticks", "verify_passes", "spec_rounds", "spec_accepted",
                                    "spec_tokens", "tokens_out", "prefix_hits",
                                    "prefill_chunks", "stall_ticks", "host_syncs")},
        "spec_fetches": spec["spec_fetches"], "sync_warnings": len(spec["sync_warnings"]),
        "plain_ticks_without_spec": refs["pallas"]["stats"]["ticks"], "launches": launches,
        "streams_equal": "every request, sampled included, vs pallas and gather"}}
    # the paged bench's width in float32
    wcfg = LabformerConfig(**sizes["paged"], dtype=torch.float32)
    wparams = init_params(wcfg, seed=0)
    wmodel = Labformer.from_numpy(wparams, wcfg, device)
    wdraft = int8_draft(wparams, wcfg, device)
    wspec, wl = counted(lambda: spec_engine_wave(wmodel, wcfg, wdraft, sizes, jobs, k, "pallas",
                                                 device), device,
                        lambda w: {"paged_decode": (w["stats"]["ticks"]
                                                    - w["stats"]["verify_passes"])
                                   * wcfg.n_layers}, "speculative engine at width")
    wref, _ = counted(lambda: spec_engine_wave(wmodel, wcfg, None, sizes, jobs, 0, "pallas",
                                               device), device, b7_want(wcfg, "pallas"),
                      "engine without speculation at width")
    held = []
    for i, job in enumerate(jobs):
        if job.get("temperature", 0.0) or job.get("repetition_penalty", 1.0) != 1.0:
            continue  # sampled and penalized streams are not plain greedy's
        _, logits = greedy_with_logits(wmodel, torch.from_numpy(job["prompt"])[None].to(device),
                                       job["max_new"])
        ref_toks = wref["streams"][i]
        held.append(equal_until_near_tie(ref_toks, wspec["streams"][i], logits[0], False,
                                         f"speculative engine at width, request {i}"))
    tokens = sum(len(x) for x in wspec["streams"])
    ws = wspec["stats"]
    out["width_f32"] = {
        "greedy_equal_until_near_tie": held, "tokens": tokens,
        "tokens_per_s": tokens / wspec["wall_s"], "tokens_per_s_without_spec":
            sum(len(x) for x in wref["streams"]) / wref["wall_s"],
        "ticks": ws["ticks"], "ticks_without_spec": wref["stats"]["ticks"],
        "verify_passes": ws["verify_passes"], "spec_rounds": ws["spec_rounds"],
        "spec_accepted": ws["spec_accepted"], "spec_fetches": wspec["spec_fetches"],
        "launches": wl}
    check(wspec["spec_fetches"] == ws["verify_passes"], "speculative engine at width: fetches")
    print(f"speculative engine (9b): {json.dumps(out)} ({card})", flush=True)
    return out


def host_loop_ms(n: int = 20, iters: int = 1_000_000) -> dict:
    """Wall ms of one pure-Python loop, ``n`` times in a row: how far the
    host's speed moves between runs of the same work (the host-bound rows
    compare two sides within a budget of 1 or 3 %)."""
    runs = []
    for _ in range(n):
        t0 = time.perf_counter()
        x = 0
        for i in range(iters):
            x += i * i
        runs.append((time.perf_counter() - t0) * 1e3)
    return {"min": min(runs), "median": float(np.median(runs)), "max": max(runs)}


def run_bench_rows(sizes: dict, device, backend: str, card: str) -> dict:
    """Phase 9c: every model row of ``tpulab_torch bench`` through the CLI,
    one ``--only`` group at a time with every launch count set to 0 just
    before and read just after; each row printed.  A pure-Python loop is
    timed first (:func:`host_loop_ms`)."""
    loop = host_loop_ms()
    print(f"host loop before the bench rows (9c): {json.dumps(loop)} ms ({card})", flush=True)
    extra = ["--backend", backend] if backend == "cpu" else []
    for key, value in sizes["bench_model"].items():
        extra += [f"--{key}", str(value)]
    rows, launches = [], {}
    h100 = "H100" in card and "HBM3" in card
    for group in sizes["bench_groups"]:
        wrappers = zero_counts()
        got = [json.loads(line) for line in cli(["bench", "--only", group, *extra],
                                                "").splitlines()]
        launches[group] = {name: w.launches for name, w in wrappers.items()}
        for row in got:
            print(json.dumps(row), flush=True)
            check(row["device"] == ("cuda" if backend == "cuda" else "cpu"), f"bench row {row}")
            check(backend == "cpu" or ("card" in row and "power_limit" in row), f"row {row}")
            flops = group in ("labformer_fwd", "labformer_train", "flash_attention")
            check(not (flops and h100) or "mfu_pct_of_bf16_peak" in row, f"no MFU in {row}")
        rows.extend(got)
        check(all(launches[group][k] == 0 for k in LAB_KERNELS), f"lab kernels in {group}")
    if device.type == "cuda":
        if "labformer_train" in launches:
            check(all(launches["labformer_train"][k] > 0 for k in TRAIN_KERNELS),
                  f"labformer_train launched {launches['labformer_train']}")
        if "flash_attention" in launches:
            check(launches["flash_attention"]["flash_fwd"] > 0, "flash rows launched no B4")
    return {"rows": rows, "launches": launches, "host_loop_ms": loop}


def flash_long_rows(sizes: dict, device) -> list:
    """Phase 9c: B4 at the flash rows' long contexts, (1, s, 8, 64) bf16,
    against its plain version: each ``(s, rows)`` of ``b4_long`` on its last
    ``rows`` query rows (every key), or whole where ``rows`` is 0."""
    import torch

    rows = []
    for s, tail in sizes["b4_long"]:
        rows.append(flash_row((1, 8, s, 64), torch.bfloat16, device, 5, 1, seed=13,
                              first_row=s - tail if tail else 0))
        print(f"B4 long context: {json.dumps(rows[-1])}", flush=True)
    return rows


def run_spec_and_bench_path(sizes: dict, device, backend: str, card: str) -> tuple:
    """Phase 9: (B4's long-context rows, the phase's numbers)."""
    t0 = time.perf_counter()
    spec, small = run_speculative(sizes, device, card)
    engine = check_spec_engine(sizes, device, card, small)
    bench_rows = run_bench_rows(sizes, device, backend, card)
    long_rows = flash_long_rows(sizes, device)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    return long_rows, {"speculative": spec, "engine": engine, "bench": bench_rows}


# ------------------------------------------------- the cache tier and scheduler


def cache_engine(model, cfg, sizes: dict, n_blocks: int, *, spill: bool, **kw):
    """An engine at the daemon's settings with ``attn="pallas"``; with
    ``spill``, the radix index and the host tier armed."""
    from tpulab_torch.models.paged import PagedEngine

    tier = dict(prefix_index="radix", spill_blocks=sizes["cache_spill_blocks"]) if spill else {}
    return PagedEngine(model, cfg, slots=sizes["daemon_slots"], n_blocks=n_blocks,
                       block_size=16, max_seq=sizes["daemon_max_seq"],
                       prefill_chunk=sizes["daemon_chunk"], attn="pallas", **tier, **kw)


def cache_requests(sizes: dict, seed: int = 11) -> dict:
    """The full-width phase's requests: (prompt, max_new) per scenario.

    ``storm``: waves of requests that share one prefix a wave, the last
    wave back on the first prefix; ``preempt``: two long priority-0
    requests, then a priority-5 one; ``handoff``: a prompt of whole blocks
    plus one token and one with a tail to recompute."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, 256, n).astype(np.int32)

    prefixes = [text(sizes["cache_prefix"]) for _ in range(sizes["cache_waves"])]
    storm = [[(np.concatenate([prefix, text(int(t))]), sizes["cache_new"])
              for t in rng.integers(1, sizes["cache_tail_max"] + 1, sizes["cache_wave_reqs"])]
             for prefix in prefixes + prefixes[:1]]
    low, high = sizes["cache_low"], sizes["cache_high"]
    preempt = [(text(low[0]), low[1]), (text(low[0]), low[1]), (text(high[0]), high[1])]
    handoff = [(text(n), sizes["cache_handoff_new"]) for n in sizes["cache_handoff_prompts"]]
    return {"storm": storm, "preempt": preempt, "handoff": handoff}


def run_storm(model, cfg, sizes: dict, waves: list) -> tuple:
    """The prefix storm on a pool cut to ``cache_storm_blocks``: cold leaves
    spill as later prefixes push them out, and come back with the last wave;
    (streams, engine)."""
    eng = cache_engine(model, cfg, sizes, sizes["cache_storm_blocks"], spill=True)
    streams = []
    for wave in waves:
        rids = [eng.submit(p, max_new=n) for p, n in wave]
        out = eng.run()
        streams += [out[r] for r in rids]
    return streams, eng


def run_preempt(model, cfg, sizes: dict, reqs: list) -> tuple:
    """Two priority-0 requests fill a pool cut to ``cache_preempt_blocks``;
    once both decode, a priority-5 arrival needs more than is free and
    preempts the later one, which resumes behind it; (streams, engine)."""
    eng = cache_engine(model, cfg, sizes, sizes["cache_preempt_blocks"], spill=True)
    rids = [eng.submit(p, max_new=n) for p, n in reqs[:2]]
    while not (all(r is not None and r.phase == "decode" and len(r.out) >= 4
                   for r in eng.active[:2])):
        eng.step()
    rids.append(eng.submit(reqs[2][0], max_new=reqs[2][1], priority=5))
    out = eng.run()
    return [out[r] for r in rids], eng


def run_handoff(model, cfg, sizes: dict, reqs: list, device) -> tuple:
    """The handoff between a prefill and a decode engine (both at the
    daemon's pool): both requests park at the end of their interleaved
    prefill, leave in one export, land in the decode engine's host tier and
    resume there with fresh ids.  Then a steady window on the decode engine:
    no upload, no host sync, no block read.  (streams, engines, bytes, the
    steady window's numbers)."""
    eng_p = cache_engine(model, cfg, sizes, sizes["daemon_blocks"], spill=True)
    eng_d = cache_engine(model, cfg, sizes, sizes["daemon_blocks"], spill=True)
    eng_p.handoff_at_boundary = True
    for p, n in reqs:
        eng_p.submit(p, max_new=n)
    while len(eng_p.handoff_ready) < len(reqs):
        eng_p.step()
    exported = eng_p.export_handoff()
    check(all(len(payload) == (len(p) - 1) // 16 for (_, payload), (p, _) in
              zip(exported, reqs)), "handoff: an export lacks blocks")
    nbytes = sum(eng_d.import_handoff(payload) for _, payload in exported)
    rids = [eng_d.resubmit(req, fresh_id=True) for req, _ in exported]
    while eng_d.pending or any(r is not None and r.phase != "decode" for r in eng_d.active):
        eng_d.step()
    for _ in range(2):
        eng_d.step()
    before = dict(eng_d.stats(), kv_fetches=eng_d.kv_fetches)
    steps = sizes["cache_steady_steps"]
    with watch_syncs(device) as syncs:
        for _ in range(steps):
            eng_d.step()
    after = dict(eng_d.stats(), kv_fetches=eng_d.kv_fetches)
    steady = {k: after[k] - before[k] for k in ("ticks", "h2d_ticks", "host_syncs", "kv_fetches")}
    check(steady == {"ticks": steps, "h2d_ticks": 0, "host_syncs": 0, "kv_fetches": 0}
          and not syncs, f"handoff decode engine: a steady tick moved host state {steady} "
          f"or synced {syncs[:2]}")
    out = eng_d.run()
    return [out[r] for r in rids], (eng_p, eng_d), nbytes, dict(steady, sync_warnings=len(syncs))


def block_transfer_ms(eng, device, reps: int = 10) -> dict:
    """Wall ms of the spill tier's two legs on ``eng``'s pool, the median of
    ``reps``: reading 1 and 8 blocks back to the host (one gather, one
    pinned copy, its wait) and writing them again (one upload each part,
    then a synchronize)."""
    import statistics

    import torch

    out = {}
    for n in (1, 8):
        blocks = list(range(1, n + 1))
        reads, writes = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            kp, vp = eng._read_blocks(blocks)
            reads.append((time.perf_counter() - t0) * 1e3)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._write_blocks(blocks, kp, vp)
            if device.type == "cuda":
                torch.cuda.synchronize()
            writes.append((time.perf_counter() - t0) * 1e3)
        out[f"{n}_blocks"] = {"read_ms": statistics.median(reads),
                              "write_ms": statistics.median(writes)}
    return out


def check_cache_width(sizes: dict, device, card: str) -> dict:
    """Phase 10a: the cache tier and scheduler at the paged bench's width in
    bf16 with the daemon's settings: spill and prefetch, preemption and the
    handoff, each greedy stream equal to an engine without them up to the
    first near tie, B7 once per layer of each tick, no leaked block, and no
    call that synchronizes (the block reads back and drains wait on
    events, and are counted)."""
    import torch

    from tpulab_torch.models.labformer import Labformer, LabformerConfig, init_params

    cfg = LabformerConfig(**sizes["paged"], dtype=torch.bfloat16)
    model = Labformer.from_numpy(init_params(cfg, seed=0), cfg, device)
    reqs = cache_requests(sizes)
    cuts = {"storm": (sizes["daemon_blocks"], sizes["cache_storm_blocks"]),
            "preempt": (sizes["daemon_blocks"], sizes["cache_preempt_blocks"])}
    for name, (was, now) in cuts.items():
        print(f"cache tier (10a): n_blocks cut {was} -> {now} for the {name} scenario",
              flush=True)

    def served():
        t0 = time.perf_counter()
        with watch_syncs(device) as syncs:
            storm, e_storm = run_storm(model, cfg, sizes, reqs["storm"])
            pre, e_pre = run_preempt(model, cfg, sizes, reqs["preempt"])
            hand, e_hand, nbytes, steady = run_handoff(model, cfg, sizes, reqs["handoff"],
                                                       device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        engines = [e_storm, e_pre, *e_hand]
        return {"streams": {"storm": storm, "preempt": pre, "handoff": hand},
                "engines": engines, "bytes": nbytes, "steady": steady, "syncs": syncs,
                "wall_s": time.perf_counter() - t0}

    def b7_ticks(res):
        return {"paged_decode": sum(e.stats()["ticks"] for e in res["engines"]) * cfg.n_layers}

    res, launches = counted(served, device, b7_ticks, "cache tier and scheduler")
    e_storm, e_pre, e_p, e_d = res["engines"]
    for name, eng in zip(("storm", "preempt", "prefill", "decode"), res["engines"]):
        check_no_leak(eng, f"cache tier ({name} engine)")
    st, sp = e_storm.stats(), e_pre.stats()
    for key, value in (("spill_spilled", st["spill_spilled"]),
                       ("spill_prefetched", st["spill_prefetched"]),
                       ("spill_hits", st["spill_hits"]), ("preemptions", sp["preemptions"])):
        check(value >= 1, f"cache tier: {key} = {value}")
    check(res["bytes"] > 0, "cache tier: the handoff carried no bytes")
    check(not res["syncs"], f"cache tier: synchronizing calls {res['syncs'][:3]}")

    def reference():
        eng = cache_engine(model, cfg, sizes, sizes["daemon_blocks"], spill=False)
        flat = [r for wave in reqs["storm"] for r in wave] + reqs["preempt"] + reqs["handoff"]
        rids = [eng.submit(p, max_new=n) for p, n in flat]
        out = eng.run()
        check_no_leak(eng, "cache tier (reference engine)")
        return {"streams": [out[r] for r in rids], "ticks": eng.stats()["ticks"]}

    ref, ref_launches = counted(reference, device,
                                lambda r: {"paged_decode": r["ticks"] * cfg.n_layers},
                                "cache tier reference")
    got = res["streams"]["storm"] + res["streams"]["preempt"] + res["streams"]["handoff"]
    flat = [r for wave in reqs["storm"] for r in wave] + reqs["preempt"] + reqs["handoff"]
    held = []
    for i, ((prompt, n), a, b) in enumerate(zip(flat, ref["streams"], got)):
        check(len(b) == n, f"cache tier request {i}: {len(b)} tokens of {n}")
        _, logits = greedy_with_logits(model, torch.from_numpy(prompt)[None].to(device), n)
        held.append(equal_until_near_tie(a, b, logits[0], True, f"cache tier request {i}"))
    waits = {name: e.kv_fetches for name, e in zip(("storm", "preempt", "prefill", "decode"),
                                                   res["engines"])}
    legs = block_transfer_ms(e_storm, device)
    row = {"n_blocks_cuts": cuts,
           **{k: st[k] for k in ("spill_spilled", "spill_prefetched", "spill_hits", "evictions",
                                 "spill_host_blocks", "spill_host_bytes", "prefix_hits")},
           "preemptions": sp["preemptions"], "handoff_bytes": res["bytes"],
           "handoff_blocks": e_d.stats()["spill_prefetched"],
           "kv_read_waits": waits, "host_syncs": {"storm": st["host_syncs"],
                                                 "preempt": sp["host_syncs"],
                                                 "decode": e_d.stats()["host_syncs"]},
           "sync_warnings": len(res["syncs"]), "steady_window": res["steady"],
           "block_bytes": e_storm._block_bytes, "block_transfer_ms": legs,
           "requests": len(flat), "tokens_equal_until_near_tie": held,
           "wall_s": res["wall_s"], "launches": launches, "reference_launches": ref_launches}
    print(f"cache tier (10a): {json.dumps(row)} ({card})", flush=True)
    return row


def check_cache_small(small, device, card: str) -> dict:
    """Phase 10b: the small labformer phase 9a trains (``small``: model and
    config), on the card: a preempted greedy and a preempted sampled
    request, the spill round trip and the handoff, every stream bit-equal
    to its uninterrupted run."""
    from tpulab_torch.models.paged import PagedEngine

    model, cfg = small
    engines = []

    def engine(**kw):
        engines.append(PagedEngine(model, cfg, block_size=8, max_seq=64, attn="pallas", **kw))
        return engines[-1]

    def alone(prompt, n, **kw):
        eng = engine(slots=1, n_blocks=32)
        rid = eng.submit(prompt, max_new=n, **kw)
        return eng.run()[rid]

    out = {}
    for name, kw in (("greedy", {}), ("sampled", dict(temperature=2.0, seed=7))):
        eng = engine(slots=2, n_blocks=9)
        low = eng.submit(cycle(4), max_new=40, **kw)
        for _ in range(8):
            eng.step()
        high = eng.submit(cycle(5), max_new=30, priority=5)
        res = eng.run()
        check_no_leak(eng, f"small preempt ({name})")
        check(eng.stats()["preemptions"] == 1, f"small preempt ({name}): no preemption")
        check(np.array_equal(res[low], alone(cycle(4), 40, **kw))
              and np.array_equal(res[high], alone(cycle(5), 30)),
              f"small preempt ({name}): a stream differs from its uninterrupted run")
        out[f"preempt_{name}"] = "bit-equal"
    a = cycle(17)
    fillers = [((np.arange(i, i + 17)) % 11).astype(np.int32) for i in (1, 2, 3)]
    eng = engine(slots=1, n_blocks=8, prefix_index="radix", spill_blocks=16)
    for p in [a, *fillers, a]:
        rid = eng.submit(p, max_new=5)
        check(np.array_equal(eng.run()[rid], alone(p, 5)), "small spill round trip differs")
    st = eng.stats()
    check(st["spill_spilled"] >= 1 and st["spill_hits"] >= 1, f"small spill: {st}")
    check_no_leak(eng, "small spill")
    out["spill"] = {k: st[k] for k in ("spill_spilled", "spill_prefetched", "spill_hits")}
    eng_p = engine(slots=2, n_blocks=32, prefix_index="radix", spill_blocks=16)
    eng_d = engine(slots=2, n_blocks=32, prefix_index="radix", spill_blocks=16)
    eng_p.handoff_at_boundary = True
    prompt = cycle(41)
    eng_p.submit(prompt, max_new=12)
    while not eng_p.handoff_ready:
        eng_p.step()
    (req, payload), = eng_p.export_handoff()
    nbytes = eng_d.import_handoff(payload)
    rid = eng_d.resubmit(req, fresh_id=True)
    check(np.array_equal(eng_d.run()[rid], alone(prompt, 12)), "small handoff differs")
    out["handoff"] = {"blocks": len(payload), "bytes": nbytes}
    out["ticks"] = sum(e.stats()["ticks"] for e in engines)
    print(f"cache tier (10b): {json.dumps(out)} ({card})", flush=True)
    return out


def run_cache_path(sizes: dict, device, card: str) -> dict:
    """Phase 10: the cache tier and scheduler at full width, then on the
    small labformer (trained here as phase 9a trains it)."""
    t0 = time.perf_counter()
    width = check_cache_width(sizes, device, card)
    model, cfg, _ = train_small(sizes, device)
    small, launches = counted(lambda: check_cache_small((model, cfg), device, card),
                              device, lambda r: {"paged_decode": r["ticks"] * cfg.n_layers},
                              "small cache tier")
    small["launches"] = launches
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"width": width, "small_trained": small}


# ----------------------------------------------------- phase 11: the lifecycle


def lifecycle_corpus(root: Path, total: int, files: int, seed: int = 0) -> Path:
    """``total`` bytes of text over ``files`` files: words drawn Zipf-like
    (exponent 1.1) from a seeded list of 2000 lowercase words, so merges and
    losses mean something; under ``root/data``."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = [bytes(rng.choice(letters, rng.integers(2, 9))) for _ in range(2000)]
    p = 1.0 / np.arange(1, 2001) ** 1.1
    text = b" ".join(words[i] for i in rng.choice(2000, total // 5 + 16, p=p / p.sum()))
    data = root / "data"
    data.mkdir(parents=True)
    per = total // files
    for i in range(files):
        (data / f"part{i:02d}.txt").write_bytes(text[i * per:(i + 1) * per])
    return data


def train_lines(out: list) -> list:
    """The ``[train] step`` and ``[eval]`` lines of a run, without their times."""
    return [ln.split(" (")[0] for ln in out if ln.startswith(("[train] step", "[eval]"))]


def dispatches(out: list) -> int:
    line = [ln for ln in out if ln.startswith("[train] counters")][-1]
    return int(line.split("dispatches=")[1].split()[0])


def first_seen(lines: list) -> list:
    """``lines`` without repeats: a rollback replays the steps after its
    snapshot, whose lines print again."""
    return [ln for i, ln in enumerate(lines) if ln not in lines[:i]]


def snapshot_equal(a: Path, b: Path, step: int) -> bool:
    """Whether two snapshots of ``step`` hold the same bits, every
    parameter, moment and counter."""
    import torch

    from tpulab_torch import ckpt

    def load(d):
        return torch.load(d / str(step) / ckpt.STATE_FILE, weights_only=True)

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return (x.dtype == y.dtype and x.shape == y.shape
                    and bitwise_equal(x.contiguous(), y.contiguous()))
        if isinstance(x, dict):
            return set(x) == set(y) and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return x == y

    return same(load(a), load(b))


def life_train(sizes: dict, device, cfg, path: str, **kw) -> tuple:
    """``tpulab_torch.train.train`` at the lifecycle's batch and sequence,
    counted: B4, B5 and B6 once per layer of each dispatched step; (its
    log lines, launches)."""
    from tpulab_torch.train import train

    out: list = []

    def run():
        train(batch=sizes["life_batch"], seq=sizes["life_seq"], cfg=cfg, seed=0,
              log=out.append, device=device, **kw)
        return out

    _, launches = counted(run, device, lambda o: dict.fromkeys(
        TRAIN_KERNELS, dispatches(o) * cfg.n_layers if sizes["life_seq"] >= 1024 else 0), path)
    return out, launches


def save_restore_ms(sizes: dict, device, cfg, work: Path, card: str) -> dict:
    """Wall ms of ``ckpt.save`` and ``ckpt.restore`` of the flagship's train
    state (3 each, after a synchronize), and the snapshot's bytes."""
    import statistics

    import torch

    from tpulab_torch import ckpt
    from tpulab_torch.models.labformer import init_train_state
    from tpulab_torch.train import batches

    model, state, step = init_train_state(cfg, None, seed=0, device=device)
    step(model, state, batches(cfg.vocab, 1, 64, 0)(0))  # moments and counters exist
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    save, restore = [], []
    for i in range(3):
        sync()
        t0 = time.perf_counter()
        nbytes = ckpt.save(str(work / "timed"), i + 1, model, state)
        save.append((time.perf_counter() - t0) * 1e3)
    for i in range(3):
        sync()
        t0 = time.perf_counter()
        ckpt.restore(str(work / "timed"), i + 1, model, state)
        sync()
        restore.append((time.perf_counter() - t0) * 1e3)
    out = {"save_ms": statistics.median(save), "save_ms_runs": save,
           "restore_ms": statistics.median(restore), "restore_ms_runs": restore,
           "snapshot_bytes": nbytes, "card": card}
    print(f"checkpoint of the flagship train state ({cfg.dtype}, params and adam moments): "
          f"save {out['save_ms']:.3f} ms (median of {save}), restore {out['restore_ms']:.3f} "
          f"ms (median of {restore}), {nbytes} bytes a snapshot ({card})", flush=True)
    return out


def check_byte_flagship(sizes: dict, device, data: Path, work: Path) -> dict:
    """Phase 11b: the flagship on the native loader, 20 steps straight, 10
    then resumed to 20, and 20 with one recover from a fault at step 15:
    the three runs' printed losses and final snapshots bit-equal."""
    import torch

    from tpulab_torch.models.labformer import LabformerConfig

    cfg = LabformerConfig(**sizes["life"], max_seq=sizes["life_seq"], dtype=torch.bfloat16)
    n, every, fault = sizes["life_steps"], sizes["life_save_every"], sizes["life_fault"]
    common = dict(data_dir=str(data), save_every=every)
    straight, l_straight = life_train(sizes, device, cfg, "straight flagship run",
                                      steps=n, ckpt_dir=str(work / "straight"), **common)
    first, l_first = life_train(sizes, device, cfg, "interrupted flagship run",
                                steps=every, ckpt_dir=str(work / "resumed"), **common)
    rest, l_rest = life_train(sizes, device, cfg, "resumed flagship run", steps=n,
                              ckpt_dir=str(work / "resumed"), resume=True, **common)
    rec, l_rec = life_train(sizes, device, cfg, "recovered flagship run", steps=n,
                            ckpt_dir=str(work / "recovered"), recover=1,
                            inject_fault=(fault,), **common)
    want = train_lines(straight)
    check(len(want) == n, f"straight run printed {straight[-3:]}")
    check(f"[train] resumed from step {every}" in rest, f"resume printed {rest[:2]}")
    check(train_lines(first) + train_lines(rest) == want,
          f"resumed losses {train_lines(rest)} differ from {want[every:]}")
    check(sum(ln.startswith("[fault]") for ln in rec) == 1
          and any(ln.startswith("[recover]") and f"snapshot {every} (1/1)" in ln for ln in rec),
          f"recover printed {[ln for ln in rec if ln.startswith(('[fault]', '[recover]'))]}")
    check(first_seen(train_lines(rec)) == want,
          f"recovered losses {train_lines(rec)} differ from {want}")
    for name in ("resumed", "recovered"):
        check(snapshot_equal(work / "straight", work / name, n),
              f"the {name} run's step-{n} snapshot differs from the straight run's")
    print(f"byte flagship (11b) bf16 b{sizes['life_batch']} s{sizes['life_seq']}: {n} steps "
          f"straight, {every} + resume, and recover from a fault at {fault} are bit-equal "
          f"(losses and step-{n} snapshots); losses {[ln.split()[-1] for ln in want]}; "
          f"dispatches {dispatches(straight)}, {dispatches(first)} + {dispatches(rest)}, "
          f"{dispatches(rec)}", flush=True)
    return {"losses": [float(ln.split()[-1]) for ln in want], "bit_equal": True,
            "launches": {"straight": l_straight, "interrupted": l_first, "resumed": l_rest,
                         "recovered": l_rec},
            "dispatches": {"straight": dispatches(straight), "interrupted": dispatches(first),
                           "resumed": dispatches(rest), "recovered": dispatches(rec)}}


def bpe_prompt(tok, data: Path, n_tokens: int) -> str:
    """Corpus text from the start of the last file that encodes to at least
    ``n_tokens`` ids."""
    text = sorted(data.iterdir())[-1].read_bytes()
    n = 4 * n_tokens
    while len(tok.encode(text[:n])) < n_tokens:
        n *= 2
    return text[:n].decode()


def cli_generate(sizes: dict, device, backend: str, ckpt_dir: Path, prompt: str,
                 prompt_tokens: int, layers: int, path: str) -> tuple:
    """``tpulab_torch generate --ckpt-dir`` greedy through the CLI, counted:
    B4 once per layer of a prefill of at least 1024 tokens; (stdout,
    launches)."""
    argv = ["generate", "--backend", backend, "--ckpt-dir", str(ckpt_dir), "--prompt", prompt,
            "--steps", str(sizes["life_gen_steps"]), "--temperature", "0"]
    return counted(lambda: cli(argv, ""), device,
                   {"flash_fwd": layers if prompt_tokens >= 1024 else 0}, path)


def check_bpe_flagship(sizes: dict, device, backend: str, data: Path, tok_path: Path,
                       work: Path) -> dict:
    """Phase 11c: the flagship width at the tokenizer's vocab, trained on
    the encoded corpus with a snapshot, evaluated and served through the
    CLI; the served tokens equal ``generate()`` on ``load_params``."""
    import torch

    from tpulab_torch.io.bpe import BPETokenizer
    from tpulab_torch.models.generate import generate, load_params, load_sidecar
    from tpulab_torch.models.labformer import Labformer, LabformerConfig

    tok = BPETokenizer.load(str(tok_path))
    cfg = LabformerConfig(**sizes["life"], vocab=tok.vocab, max_seq=sizes["life_seq"],
                          dtype=torch.bfloat16)
    steps, ck = sizes["life_bpe_steps"], work / "bpe"
    out, l_train = life_train(sizes, device, cfg, "BPE flagship run", steps=steps,
                              ckpt_dir=str(ck), save_every=steps, data_dir=str(data),
                              tokenizer=str(tok_path))
    check(len(train_lines(out)) == steps, f"BPE run printed {out[-3:]}")
    nb, seq = sizes["life_eval_batches"], sizes["life_seq"]
    report, l_eval = counted(
        lambda: json.loads(cli(["eval", "--backend", backend, "--ckpt-dir", str(ck),
                                "--data-dir", str(data), "--seq", str(seq), "--batches",
                                str(nb), "--batch", str(sizes["life_batch"])], "")),
        device, {"flash_fwd": nb * cfg.n_layers if seq >= 1024 else 0}, "eval CLI")
    check(report["step"] == steps and report["tokenizer_vocab"] == tok.vocab
          and all(np.isfinite(report[k]) for k in
                  ("loss_nats_per_token", "perplexity", "bits_per_byte")),
          f"eval reported {report}")
    prompt = bpe_prompt(tok, data, sizes["life_prompt_tokens"])
    n_prompt = len(tok.encode(prompt.encode()))
    text, l_gen = cli_generate(sizes, device, backend, ck, prompt, n_prompt, cfg.n_layers,
                               "generate --ckpt-dir")
    check(f"[generate] loaded checkpoint step {steps}" in text, f"generate printed {text[:200]}")
    sc_cfg, sc_tok = load_sidecar(str(ck))
    params, step = load_params(sc_cfg, str(ck))
    ids = generate(Labformer.from_numpy(params, sc_cfg, device), sc_tok.encode(
        prompt.encode())[None, :], steps=sizes["life_gen_steps"], temperature=0.0)
    want = prompt + sc_tok.decode(ids[0]).decode("utf-8", errors="replace") + "\n"
    check(text.endswith(want), "generate --ckpt-dir differs from generate() on load_params")
    print(f"BPE flagship (11c) vocab {tok.vocab}: {steps} steps, losses "
          f"{[ln.split()[-1] for ln in train_lines(out)]}; eval {json.dumps(report)}; "
          f"generate over a {n_prompt}-token prompt equal to generate() on load_params",
          flush=True)
    return {"losses": [float(ln.split()[-1]) for ln in train_lines(out)], "eval": report,
            "prompt_tokens": n_prompt,
            "launches": {"train": l_train, "eval": l_eval, "generate": l_gen},
            "prompt": (prompt, n_prompt)}


def check_finetune_and_distill(sizes: dict, device, backend: str, data: Path,
                               prompt: tuple, work: Path) -> dict:
    """Phase 11d: LoRA from 11b's snapshot (base leaves bit-unchanged, the
    served model merged), and ``distill`` from 11c's snapshot into a
    smaller student served through ``generate --ckpt-dir``."""
    import torch

    from tpulab_torch.models.labformer import LabformerConfig

    cfg = LabformerConfig(**sizes["life"], max_seq=sizes["life_seq"], dtype=torch.bfloat16,
                          lora_rank=sizes["life_lora_rank"])
    n = sizes["life_lora_steps"]
    out, l_lora = life_train(sizes, device, cfg, "LoRA fine-tune", steps=n,
                             ckpt_dir=str(work / "lora"), save_every=n,
                             init_from=str(work / "straight"), data_dir=str(data))
    base = torch.load(work / "straight" / str(sizes["life_steps"]) / "state.pt",
                      weights_only=True)["params"]
    tuned = torch.load(work / "lora" / str(n) / "state.pt", weights_only=True)["params"]
    check(all(bitwise_equal(tuned[k], v) for k, v in base.items())
          and any("_lora_" in k for k in tuned), "the LoRA run moved a base leaf")
    byte_prompt = seeded_text(sizes["life_prompt_tokens"], 5)
    text, l_lora_gen = cli_generate(sizes, device, backend, work / "lora", byte_prompt,
                                    len(byte_prompt), cfg.n_layers, "generate --ckpt-dir (LoRA)")
    check(f"[generate] merged LoRA adapters (rank {cfg.lora_rank})" in text,
          f"generate printed {text[:300]}")
    layers, steps = sizes["life_student_layers"], sizes["life_distill_steps"]
    seq, b = sizes["life_distill_seq"], sizes["life_distill_batch"]
    teacher_layers = sizes["life"]["n_layers"]
    flash = seq >= 1024
    dist_out, l_dist = counted(
        lambda: cli(["distill", "--backend", backend, "--teacher", str(work / "bpe"), "--out",
                     str(work / "student"), "--student-layers", str(layers), "--steps",
                     str(steps), "--batch", str(b), "--seq", str(seq), "--data-dir",
                     str(data)], ""),
        device, {"flash_fwd": steps * (teacher_layers + layers) if flash else 0,
                 "flash_dq": steps * layers if flash else 0,
                 "flash_dkv": steps * layers if flash else 0}, "distill CLI")
    final = json.loads(dist_out.splitlines()[-1])
    check(final["student_layers"] == layers and np.isfinite(final["final_loss"]),
          f"distill printed {dist_out[-300:]}")
    stext, l_sgen = cli_generate(sizes, device, backend, work / "student", *prompt, layers,
                                 "generate --ckpt-dir (student)")
    check(f"[generate] loaded checkpoint step {steps}" in stext, f"generate printed {stext[:200]}")
    print(f"fine-tune and distil (11d): LoRA r{cfg.lora_rank} {n} steps from step "
          f"{sizes['life_steps']}, losses {[ln.split()[-1] for ln in train_lines(out)]}, base "
          f"leaves bit-unchanged; student L{layers}: {json.dumps(final)}", flush=True)
    return {"lora_losses": [float(ln.split()[-1]) for ln in train_lines(out)],
            "distill": final, "launches": {"lora": l_lora, "lora_generate": l_lora_gen,
                                           "distill": l_dist, "student_generate": l_sgen}}


def check_train_cli_resume(sizes: dict, device, backend: str, data: Path, work: Path) -> dict:
    """Phase 11e: ``tpulab_torch train`` through the CLI at the demo width on
    the corpus, 4 steps with snapshots every 2, then ``--resume`` to 6: the
    resumed ``[train]`` lines equal a straight 6-step run's."""
    seq, b = sizes["life_cli_seq"], sizes["life_cli_batch"]
    per = TRAIN_CLI_LAYERS if seq >= 1024 else 0

    def run(steps, ck, *extra):
        argv = ["train", "--backend", backend, "--data-dir", str(data), "--seq", str(seq),
                "--batch", str(b), "--ckpt-dir", str(ck), "--save-every", "2", "--steps",
                str(steps), *extra]
        return counted(lambda: cli(argv, "").splitlines(), device,
                       lambda o: dict.fromkeys(TRAIN_KERNELS, dispatches(o) * per),
                       f"train CLI {' '.join(extra)}")

    first, _ = run(4, work / "cli")
    rest, l_rest = run(6, work / "cli", "--resume")
    straight, l_straight = run(6, work / "cli_straight")
    check("[train] resumed from step 4" in rest, f"train --resume printed {rest[:2]}")
    check(train_lines(first) + train_lines(rest) == train_lines(straight),
          f"resumed CLI lines {train_lines(rest)} differ from {train_lines(straight)}")
    print(f"train CLI (11e) s{seq} b{b}: 4 + --resume to 6 equals 6 straight: "
          f"{train_lines(rest)}", flush=True)
    return {"resumed_lines": train_lines(rest),
            "launches": {"resumed": l_rest, "straight": l_straight}}


def run_lifecycle_path(sizes: dict, device, backend: str, card: str,
                       work: Path = WORK) -> dict:
    """Phase 11: the text model's checkpoint lifecycle at full width on
    ``device`` (corpus and tokenizer, the flagship's save, resume and
    recover, BPE training, eval, generate, LoRA, distil, the CLI's
    resume); its numbers."""
    import shutil

    import torch

    from tpulab_torch.io.bpe import BPETokenizer, corpus_from_dir
    from tpulab_torch.models.labformer import LabformerConfig

    t0 = time.perf_counter()
    root = work / "lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    data = lifecycle_corpus(root, sizes["life_corpus_bytes"], sizes["life_files"])
    tok_path = root / "tok.json"
    t_tok = time.perf_counter()
    made = json.loads(cli(["tokenizer", "train", "--data-dir", str(data), "--vocab",
                           str(sizes["life_vocab"]), "--out", str(tok_path)], ""))
    t_tok = time.perf_counter() - t_tok
    tok = BPETokenizer.load(str(tok_path))
    corpus = corpus_from_dir(str(data))
    t_enc = time.perf_counter()
    ids = tok.encode(corpus)
    t_enc = time.perf_counter() - t_enc
    check(made["vocab"] == tok.vocab == sizes["life_vocab"] and tok.decode(ids) == corpus,
          f"tokenizer: {made}; decode(encode(corpus)) differs from the corpus")
    print(f"corpus and tokenizer (11a): {len(corpus)} bytes over {sizes['life_files']} files, "
          f"{json.dumps(made)} in {t_tok:.1f} s; the corpus encodes to {len(ids)} ids in "
          f"{t_enc:.1f} s and decodes back", flush=True)
    out = {"corpus_bytes": len(corpus), "tokenizer": made, "tokenizer_train_s": t_tok,
           "encode_s": t_enc, "corpus_ids": int(len(ids))}
    out["byte_flagship"] = check_byte_flagship(sizes, device, data, root)
    cfg = LabformerConfig(**sizes["life"], max_seq=sizes["life_seq"], dtype=torch.bfloat16)
    out["checkpoint"] = save_restore_ms(sizes, device, cfg, root, card)
    bpe = check_bpe_flagship(sizes, device, backend, data, tok_path, root)
    out["bpe_flagship"] = {k: v for k, v in bpe.items() if k != "prompt"}
    out["finetune_distill"] = check_finetune_and_distill(sizes, device, backend, data,
                                                         bpe["prompt"], root)
    out["train_cli"] = check_train_cli_resume(sizes, device, backend, data, root)
    shutil.rmtree(root)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 took {out['seconds']:.1f} s", flush=True)
    return out


KERNEL_META = {
    "roberts": ("tpulab_torch/csrc/stencil.cu", "tpulab/ops/pallas/stencil.py:82"),
    "elementwise": ("tpulab_torch/csrc/elementwise.cu", "tpulab/ops/pallas/elementwise.py:57"),
    "classify": ("tpulab_torch/csrc/classify.cu", "tpulab/ops/pallas/classify.py:83"),
    "flash_fwd": ("tpulab_torch/csrc/flash_fwd.cu", "tpulab/ops/pallas/attention.py:215"),
    "flash_dq": ("tpulab_torch/csrc/flash_bwd.cu", "tpulab/ops/pallas/attention.py:435"),
    "flash_dkv": ("tpulab_torch/csrc/flash_bwd.cu", "tpulab/ops/pallas/attention.py:458"),
    "paged_decode": ("tpulab_torch/csrc/paged_decode.cu", "tpulab/ops/pallas/paged.py:193"),
}

#: each flash kernel's design per dtype: ``wgmma`` on the tensor cores or
#: ``fma`` on the f32 FMA pipes
FLASH_DESIGN = {"flash_fwd": {"float32": "fma", "bfloat16": "wgmma"},
                "flash_dq": {"float32": "fma", "bfloat16": "wgmma"},
                "flash_dkv": {"float32": "fma", "bfloat16": "wgmma"}}
#: (row, dtype) of a flash kernel's instance, by a part of its mangled name
FLASH_TEMPLATES = (("flash_fwd_wgmma_kernel", "flash_fwd", "bfloat16"),
                   ("flash_fwd_kernel", "flash_fwd", "float32"),
                   ("flash_dkv_wgmma_kernel", "flash_dkv", "bfloat16"),
                   ("flash_bwd_dkv_kernel", "flash_dkv", "float32"),
                   ("flash_dq_wgmma_kernel", "flash_dq", "bfloat16"),
                   ("flash_bwd_dq_kernel", "flash_dq", "float32"))


def sass_check(library: Path) -> dict:
    """Each flash row's tensor-core opcodes per dtype in the library's SASS,
    held to ``FLASH_DESIGN``: a ``wgmma`` design holds HGMMA in every
    instance, an ``fma`` design no tensor-core opcode in any."""
    from tpulab_torch.ops.cuda import _build
    from tpulab_torch.ops.cuda.attention import HEAD_DIMS

    found = {}
    for name, text in _build.kernel_sass(library).items():
        for part, row, dtype in FLASH_TEMPLATES:
            if part in name:
                found.setdefault(row, {}).setdefault(dtype, []).append(
                    _build.tensor_core_opcodes(text))
                break
    out = {}
    for row, designs in FLASH_DESIGN.items():
        out[row] = {}
        for dtype, design in designs.items():
            ops = found.get(row, {}).get(dtype, [])
            check(len(ops) == len(HEAD_DIMS), f"{row} {dtype}: {len(ops)} instances in the SASS")
            want = ["HGMMA"] if design == "wgmma" else []
            check(all(o == want for o in ops),
                  f"{row} {dtype} ({design}): tensor-core opcodes {ops} in the SASS")
            out[row][dtype] = sorted({op for o in ops for op in o})
    return out


#: the conversion opcodes between integer and float (``I2FP``/``F2IP``
#: are Hopper's forms on the integer pipe)
CONVERSION_OPCODES = ("I2F", "F2I", "I2FP", "F2IP")


def lab_sass_counts(library: Path) -> dict:
    """Per instance of B1 and of B3 at 8 and 32 classes: its SASS
    instructions, its uniform constant loads (``ULDC``, how ptxas reads
    B3's statistics) and its integer<->float conversions by opcode.  B1
    converts no pixel: its one ``I2F`` and one ``F2I`` at most are the
    division of its work index by the quads of a row, once per item."""
    from tpulab_torch.ops.cuda import _build

    out = {}
    for name, text in _build.kernel_sass(library).items():
        if "roberts_kernel" in name or re.search(r"classify_kernel.*Li(8|32)E", name):
            ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", text,
                             flags=re.M)
            out[name] = {"instructions": len(ops), "ULDC": ops.count("ULDC"),
                         **{op: ops.count(op) for op in CONVERSION_OPCODES if op in ops}}
    check(sum("roberts_kernel" in n for n in out) == 2, f"roberts instances in the SASS: {out}")
    check(all(max(v.get(op, 0) for op in CONVERSION_OPCODES) <= 1
              for n, v in out.items() if "roberts_kernel" in n),
          f"roberts converts its pixels: {out}")
    return out


FULL_SIZES = {
    "lab1_n": 1000, "lab2_side": 1024, "lab3_side": 1024, "lab3_nc": 8,
    "b1_side": 8192, "b2_n": 2**26, "b3_side": 4096,
    "gen_prompt": 1024, "gen_steps": 32, "serving": SERVING, "serve_prompt": 1024,
    "f32_steps": 16, "serve_batch": 8, "serve_steps": 64, "decode_reps": 8,
    "b4_demo": (1, 8, 1024, 16), "b4_serving": (8, 8, 1024, 64), "b4_big": (8, 8, 4096, 64),
    "train_cli_seq": 1024, "train_cli_batch": 2, "train_cli_steps": 4, "train": TRAIN,
    "train_f32_batch": 1, "train_f32_seq": 1024, "train_f32_steps": 3,
    "train_batch": 8, "train_seq": 2048, "train_steps": 5,
    "b5_main": (8, 8, 2048, 64), "b5_big": (8, 8, 4096, 64),
    "paged": PAGED, "paged_slots": 8, "paged_blocks": 256, "paged_bs": 16,
    "paged_max_seq": 256, "paged_prompts": (8, 17, 5, 33, 9, 21, 12, 7), "paged_new": 64,
    "paged_reps": 3, "daemon_slots": 4, "daemon_blocks": 128, "daemon_max_seq": 512,
    "daemon_chunk": 32, "daemon_prefix": 128, "daemon_tail_max": 300, "daemon_new": 32,
    "daemon_requests": 8,
    # B7 alone: (slots, heads, kv heads, head_dim, block size, table blocks)
    "b7_bench": (8, 8, 2, 64, 16, 16), "b7_bench_lengths": [0, 1, 15, 16, 17, 100, 255, 256],
    "b7_big": (64, 8, 2, 64, 16, 256), "b7_window": 256,
    # phase 8: lab5 at tpulab/bench.py:1679's 2^24 and its sort at :1653's 2^20
    "lab5_n": 2**24, "lab5_sort_n": 2**20, "hw2_n": 2**20, "harness_side": 1024,
    "harness_k": 3, "bench": {}, "selftest_skip": [],
    # phase 9: the bench's speculative row (tpulab/bench.py:222-289), a
    # 1024-token prompt to run B4 in both prefills, the small labformer's
    # training steps (tests/conftest.py), bench rows at tpulab's defaults
    "spec_k": 4, "spec_steps": 128, "spec_prompt": 1024, "spec_reps": 3,
    "small_train_steps": 80, "bench_model": {}, "bench_groups": BENCH_GROUPS,
    "b4_long": ((32768, 256), (8192, 0)),
    # phase 10: the daemon's engine settings with spill_blocks=64; the storm
    # (6 prefixes of 8 blocks, then the first again) on 48 blocks and the
    # preemption ((prompt, max_new) of each request) on 40
    "cache_prefix": 128, "cache_tail_max": 15, "cache_waves": 6, "cache_wave_reqs": 4,
    "cache_new": 16, "cache_storm_blocks": 48, "cache_preempt_blocks": 40,
    "cache_low": (64, 160), "cache_high": (100, 100), "cache_handoff_prompts": (257, 300),
    "cache_handoff_new": 32, "cache_spill_blocks": 64, "cache_steady_steps": 8,
    # phase 11: a ~4 MB corpus over 4 files, a 512-token BPE table; the
    # flagship (tpulab/bench.py:142-149) bf16 b8 s2048 for 20 steps with
    # snapshots every 10 and a fault at 15; prompts of >= 1024 tokens, so
    # every prefill runs B4
    "life_corpus_bytes": 4_000_000, "life_files": 4, "life_vocab": 512, "life": TRAIN,
    "life_batch": 8, "life_seq": 2048, "life_steps": 20, "life_save_every": 10,
    "life_fault": 15, "life_bpe_steps": 10, "life_eval_batches": 4, "life_prompt_tokens": 1024,
    "life_gen_steps": 16, "life_lora_rank": 8, "life_lora_steps": 5,
    "life_student_layers": 4, "life_distill_steps": 3, "life_distill_seq": 1024,
    "life_distill_batch": 4, "life_cli_seq": 1024, "life_cli_batch": 2,
}


def run(device, sizes: dict, backend: str, card: str = "cpu",
        parent: Path | None = None) -> dict:
    """Phases 2 to 11 on ``device``; the ``kernels``, ``model`` and ``lab_suite`` payloads.
    ``parent``: a checkout to time phases 4, 6c and 7d against (:func:`in_turns`)."""
    t0 = time.perf_counter()
    inp = make_inputs(sizes)
    outs, launches = drive_main_path(inp, backend)
    print(f"main path: {json.dumps(launches)} launches; " + "; ".join(
        f"{k}: {v.splitlines()[0]}" for k, v in outs.items()), flush=True)
    check_main_path(inp, outs, device)
    check_launched(launches, LAB_KERNELS, device, "lab path")
    if device.type == "cuda":
        check_sweep_subprocess(inp)
    print(f"goldens: {check_goldens(backend)} byte-equal", flush=True)
    rows = kernel_rows(inp, sizes, device)
    lab = (in_turns(parent, card, IN_TURNS_LAB, "lab B1 and B3") if parent
           else "not run: no --parent checkout given")
    for name, prefix in (("roberts", "b1_"), ("classify", "b3_")):
        rows[name]["in_turns"] = lab if isinstance(lab, str) else [
            {k: v for k, v in r.items() if k == "side" or k.startswith(prefix)} for r in lab]
    print(f"phases 2-4 took {time.perf_counter() - t0:.1f} s", flush=True)
    rows["flash_fwd"], model_launches, model = run_model_path(sizes, device, backend, card)
    launches["flash_fwd"] = model_launches["flash_fwd"]
    rows["flash_dq"], rows["flash_dkv"], train_launches, model["training"] = run_train_path(
        sizes, device, backend, card, parent)
    launches["flash_dq"] = train_launches["flash_dq"]
    launches["flash_dkv"] = train_launches["flash_dkv"]
    rows["paged_decode"], launches["paged_decode"], model["paged"] = run_paged_path(
        sizes, device, card, parent)
    suite, _ = run_lab_suite_path(sizes, device, backend)
    rows["flash_fwd"]["long_context"], model["phase9"] = run_spec_and_bench_path(
        sizes, device, backend, card)
    model["phase10"] = run_cache_path(sizes, device, card)
    model["phase11"] = run_lifecycle_path(sizes, device, backend, card)
    kernels = []
    for name, row in rows.items():
        source, replaces = KERNEL_META[name]
        design = {"design": FLASH_DESIGN[name]} if name in FLASH_DESIGN else {}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **design, **row})
    return {"kernels": kernels, "model": model, "lab_suite": suite}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive tpulab_torch on one CUDA card.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="the root of another checkout (e.g. the parent commit's, unpacked "
                         "with git archive): phase 4 times its B1 and B3, phase 6c its "
                         "training step and B5, phase 7d its B7 at 64 slots x 4096 and a "
                         "paged bench wave, in turns with this checkout's")
    args = ap.parse_args()
    parent = args.parent.resolve() if args.parent else None
    if parent is not None and not (parent / "chip_smoke.py").is_file():
        fail(f"--parent {parent}: no chip_smoke.py there")
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
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip())
    sass = sass_check(library)
    print(f"SASS tensor-core opcodes per flash kernel and dtype: {json.dumps(sass)}", flush=True)
    print(f"SASS of B1 and B3 (instructions, ULDC, conversions): "
          f"{json.dumps(lab_sass_counts(library))}", flush=True)

    # f32 products stay f32 on the card (no TF32), in the port and in its plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    payload = run(torch.device("cuda", 0), FULL_SIZES, "cuda", card, parent)
    for kernel in payload["kernels"]:
        if kernel["name"] in sass:
            kernel["sass_tensor_core_opcodes"] = sass[kernel["name"]]
    print(json.dumps({"model": payload["model"]}), flush=True)
    print(json.dumps({"lab_suite": payload["lab_suite"]}), flush=True)
    print(json.dumps({"kernels": payload["kernels"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
