"""Benchmark rows on the card: ``tpulab_torch bench``.

The JAX package's rows (``tpulab/bench.py``, ``tpulab/bench_image.py``)
with the same registry names, metric names, default sizes and fields,
each measured on the resolved device.  The lab rows:

* ``lab1_subtract_n1000_float64_median_ms`` and the float32 n=2^20 row;
* ``lab2_roberts_1024x1024_median_ms`` (the repo's headline, ``bench.py:38``);
* ``lab3_classify_1024x1024_nc8_median_ms`` (float64, the reference's ``double``);
* ``hw2_sort_n1048576_f32_median_ms``;
* ``lab5_reduce_sum_n16777216_i32_median_ms``.

The lab kernels are timed by
:func:`~tpulab_torch.runtime.timing.measure_kernel_ms`, every call on the
same staged input (the JAX package's sort and reduction rows take its
queue-amortised ``measure_ms`` for that reason).  ``vs_baseline`` divides
the reference suite's RTX A6000 median (``BASELINE.md``) by this row's.

The model rows: ``labformer_fwd``, ``labformer_train``,
``labformer_decode`` (and its ``_int8`` and ``_gqa2`` variants),
``speculative_decode``, ``paged_engine``, ``paged_tick_overhead``,
``prefill_interleave``, ``spill_overhead``, ``handoff_overhead``,
``prefix_lookup``, ``flash_attention`` and ``flash_attention_8k``.  Their MFU fields come from
:mod:`tpulab_torch.obs.roofline` (H100 peaks; none on the CPU).
``tpulab`` times a jitted program by enqueueing many calls; the port's
model loops are eager, so each row's docstring says how it is timed: CUDA
events around each call (:func:`~tpulab_torch.runtime.timing.measure_call_ms`),
the wall clock of a host-driven run after a synchronize, or, for the
flash kernel alone, :func:`~tpulab_torch.runtime.timing.measure_kernel_ms`.

Every row says ``"device": "cuda"`` (or ``"cpu"`` where ``backend="cpu"``
asks for the host) and, on the card, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` gives them.

Rows of ``tpulab``'s registry that wait for a module of their own are not
registered (``run_benchmarks`` raises rather than turning an error into a
row): ``mesh_tick_overhead`` (ROADMAP A12); ``obs_overhead``,
``journey_overhead``, ``obs_history_overhead``, ``fault_overhead``,
``journal_overhead`` and ``autoscale_overhead`` (A11); ``decode_recompiles``
and ``train_step_overhead`` (A13, A8.6); ``labvision_train`` (A8.8).
"""

from __future__ import annotations

import functools
import gc
import inspect
import subprocess
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from tpulab_torch.obs.roofline import labformer_fwd_flops, mfu_fields
from tpulab_torch.runtime.device import resolve_device
from tpulab_torch.runtime.timing import measure_call_ms, measure_kernel_ms, summarize_samples

# Best-config CUDA medians of the reference suite on an RTX A6000
# (BASELINE.md); keys with no published number are absent.
CUDA_BASELINES_MS = {
    "lab1_n1000": 0.14336,         # lab1 [512,512]
    "lab2_roberts_1024": 0.17866,  # lab2 large-tier best [[32,32],[16,16]]
}


def variance_fields(samples) -> Dict[str, Any]:
    """Flat spread fields (min/p25/p75/iqr/n) of a row, to 6 significant digits."""
    if not samples:
        return {}
    return {k: (float(f"{v:.6g}") if isinstance(v, float) else v)
            for k, v in summarize_samples(samples).items()}


@functools.lru_cache(maxsize=None)
def card_fields(device_type: str) -> Dict[str, Any]:
    """``device`` and, on the card, its name and power limit (``nvidia-smi``)."""
    if device_type != "cuda":
        return {"device": device_type}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        name, limit = (v.strip() for v in res.stdout.splitlines()[0].split(","))
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        name, limit = torch.cuda.get_device_name(0), "not measured"
    return {"device": "cuda", "card": name, "power_limit": limit}


def _row(metric: str, ms: float, device: torch.device, samples, base: Optional[float] = None):
    return {
        "metric": metric,
        "value": round(ms, 6),
        "unit": "ms",
        "vs_baseline": round(base / ms, 3) if base else None,
        **card_fields(device.type),
        **variance_fields(samples),
    }


def _test_image(h: int, w: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, 256, size=(h, w, 4), dtype=np.uint8)


def bench_lab1(n: int = 1000, dtype: str = "float64", iters: int = 500,
               backend: Optional[str] = None) -> Dict[str, Any]:
    from tpulab_torch.ops.cuda.elementwise import binary
    from tpulab_torch.ops.elementwise import stage_vector

    device = resolve_device(backend)
    rng = np.random.default_rng(0)
    a = stage_vector(rng.uniform(-1e3, 1e3, n), dtype, device)
    b = stage_vector(rng.uniform(-1e3, 1e3, n), dtype, device)
    samples: list = []
    ms, _ = measure_kernel_ms(lambda x, y: binary("subtract", x, y), (a, b), device=device,
                              iters=iters, outer=11, collect=samples)
    base = CUDA_BASELINES_MS["lab1_n1000"] if n == 1000 and dtype == "float64" else None
    return _row(f"lab1_subtract_n{n}_{dtype}_median_ms", ms, device, samples, base)


def bench_lab2(size: int = 1024, iters: int = 500,
               backend: Optional[str] = None) -> Dict[str, Any]:
    from tpulab_torch.ops.roberts import roberts_staged

    device = resolve_device(backend)
    fn, args = roberts_staged(_test_image(size, size), device=device)
    samples: list = []
    ms, _ = measure_kernel_ms(fn, args, device=device, iters=iters, outer=11, collect=samples)
    return _row(f"lab2_roberts_{size}x{size}_median_ms", ms, device, samples,
                CUDA_BASELINES_MS["lab2_roberts_1024"])


def bench_lab3(size: int = 1024, nc: int = 8, iters: int = 500,
               backend: Optional[str] = None) -> Dict[str, Any]:
    from tpulab_torch.ops.mahalanobis import class_statistics, classify_staged

    device = resolve_device(backend)
    rng = np.random.default_rng(11)
    img = _test_image(size, size)
    classes = [np.stack([rng.integers(0, size, 16), rng.integers(0, size, 16)], axis=1)
               for _ in range(nc)]
    fn, args = classify_staged(img, class_statistics(img, classes), device=device)
    samples: list = []
    ms, _ = measure_kernel_ms(fn, args, device=device, iters=iters, outer=11, collect=samples)
    return _row(f"lab3_classify_{size}x{size}_nc{nc}_median_ms", ms, device, samples)


def bench_sort(n: int = 1 << 20, reps: int = 50,
               backend: Optional[str] = None) -> Dict[str, Any]:
    """hw2/lab5 sort tier: n float32 keys, every timed call on the same
    unsorted input."""
    from tpulab_torch.ops.sortops import sort_ascending

    device = resolve_device(backend)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    samples: list = []
    ms, _ = measure_kernel_ms(sort_ascending, (x.to(device),), device=device, iters=reps,
                              warmup=3, outer=7, collect=samples)
    return _row(f"hw2_sort_n{n}_f32_median_ms", ms, device, samples)


def bench_reduce(n: int = 1 << 24, reps: int = 50,
                 backend: Optional[str] = None) -> Dict[str, Any]:
    """lab5 reduction tier: the sum of n int32, widened to int64."""
    from tpulab_torch.ops.reduction import reduce_values

    device = resolve_device(backend)
    x = torch.from_numpy(np.random.default_rng(0).integers(-100, 100, n).astype(np.int32))
    samples: list = []
    ms, _ = measure_kernel_ms(lambda v: reduce_values(v, "sum"), (x.to(device),),
                              device=device, iters=reps, warmup=3, outer=7, collect=samples)
    return _row(f"lab5_reduce_sum_n{n}_i32_median_ms", ms, device, samples)


# ------------------------------------------------------------ model rows


def _serving_cfg(max_seq: int, dtype: str, kv_heads: int = 0):
    """The labformer of ``tpulab``'s model rows: d512, 8 heads, 8 layers,
    d_ff 2048."""
    from tpulab_torch.models.labformer import LabformerConfig

    return LabformerConfig(d_model=512, n_heads=8, n_layers=8, d_ff=2048, max_seq=max_seq,
                           n_kv_heads=kv_heads,
                           dtype={"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype])


def _small_cfg(max_seq: int):
    """The engine-overhead rows' labformer: d64, 4 heads, 2 layers, f32."""
    from tpulab_torch.models.labformer import LabformerConfig

    return LabformerConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=max_seq,
                           dtype=torch.float32)


def _model(cfg, device: torch.device, seed: int = 0):
    from tpulab_torch.models.labformer import Labformer, init_params

    return Labformer.from_numpy(init_params(cfg, seed=seed), cfg, device)


def _tokens(cfg, shape, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, shape).astype(np.int64)).to(device)


def _wall_s(fn, device: torch.device):
    """Wall seconds of ``fn()`` after a synchronize, and its result."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def _model_row(metric: str, value: float, unit: str, device: torch.device, samples,
               **fields) -> Dict[str, Any]:
    return {"metric": metric, "value": value, "unit": unit, "vs_baseline": None, **fields,
            **card_fields(device.type), **variance_fields(samples)}


def bench_labformer(b: int = 8, s: int = 512, reps: int = 20, dtype: str = "bfloat16",
                    backend: Optional[str] = None) -> Dict[str, Any]:
    """The flagship forward (d512, L8): tokens/s and MFU.  CUDA events
    around each forward call (3 warm-up calls), the median."""
    device = resolve_device(backend)
    cfg = _serving_cfg(s, dtype)
    model = _model(cfg, device)
    tokens = _tokens(cfg, (b, s), device)
    samples: list = []
    with torch.inference_mode():
        ms, _ = measure_call_ms(lambda: model(tokens), device=device, reps=reps, warmup=3,
                                collect=samples)
    return _model_row(f"labformer_fwd_b{b}_s{s}_{dtype}_tokens_per_s",
                      round(b * s / (ms / 1e3), 1), "tokens/s", device, samples,
                      **mfu_fields(labformer_fwd_flops(cfg, b, s), ms, device))


def bench_labformer_train(b: int = 8, s: int = 2048, reps: int = 10, dtype: str = "bfloat16",
                          backend: Optional[str] = None) -> Dict[str, Any]:
    """The flagship training step (adamw; ``s`` past the flash threshold,
    so the step runs kernels B4, B5 and B6): tokens/s and MFU at 3x the
    forward's flops.  CUDA events around each step (3 warm-up steps), the
    median; the step updates the weights in place."""
    from tpulab_torch.models.labformer import init_train_state

    device = resolve_device(backend)
    cfg = _serving_cfg(s, dtype)
    model, opt_state, step = init_train_state(cfg, seed=0, device=device)
    tokens = _tokens(cfg, (b, s + 1), device)
    samples: list = []
    ms, _ = measure_call_ms(lambda: step(model, opt_state, tokens)[2], device=device,
                            reps=reps, warmup=3, collect=samples)
    return _model_row(f"labformer_train_b{b}_s{s}_{dtype}_tokens_per_s",
                      round(b * s / (ms / 1e3), 1), "tokens/s", device, samples,
                      **mfu_fields(3 * labformer_fwd_flops(cfg, b, s), ms, device))


def bench_labformer_decode(b: int = 8, steps: int = 128, reps: int = 3, dtype: str = "bfloat16",
                           int8: bool = False, kv_heads: int = 0,
                           backend: Optional[str] = None) -> Dict[str, Any]:
    """KV-cache decode of ``steps`` sampled tokens after an 8-token
    prompt: tokens/s.  ``int8`` runs the weight-only quantized tree,
    ``kv_heads`` grouped-query attention.  CUDA events around each
    ``generate`` call (2 warm-up calls), the median."""
    from tpulab_torch.models.generate import generate
    from tpulab_torch.models.labformer import Labformer, init_params
    from tpulab_torch.models.quant import quantize_decode_params

    device = resolve_device(backend)
    cfg = _serving_cfg(1024, dtype, kv_heads)
    params = init_params(cfg, seed=0)
    if int8:
        params = quantize_decode_params(params, cfg)
    model = Labformer.from_numpy(params, cfg, device)
    prompt = _tokens(cfg, (b, 8), device)
    samples: list = []
    ms, _ = measure_call_ms(lambda: generate(model, prompt, steps, temperature=1.0),
                            device=device, reps=reps, warmup=2, collect=samples)
    tag = ("_int8" if int8 else "") + (f"_gqa{kv_heads}" if kv_heads else "")
    return _model_row(f"labformer_decode_b{b}_{steps}steps_{dtype}{tag}_tokens_per_s",
                      round(b * steps / (ms / 1e3), 1), "tokens/s", device, samples)


def bench_speculative_decode(steps: int = 128, k: int = 4, reps: int = 3,
                             backend: Optional[str] = None) -> Dict[str, Any]:
    """Speculative decode (the int8 draft verifying into the bf16 target)
    against plain greedy decode of the same model at batch 1: the
    speculative tokens/s, with ``speedup_vs_plain`` and ``mean_accepted``.
    The weights are random, so acceptance is int8-vs-bf16 agreement on an
    untrained distribution.  CUDA events around each call of either (the
    speculative loop's host work is part of it), the median of at least 3
    after a warm-up."""
    from tpulab_torch.models.generate import generate
    from tpulab_torch.models.labformer import Labformer, init_params
    from tpulab_torch.models.quant import quantize_decode_params
    from tpulab_torch.models.speculative import speculative_generate

    device = resolve_device(backend)
    cfg = _serving_cfg(1024, "bfloat16")
    params = init_params(cfg, seed=0)
    model = Labformer.from_numpy(params, cfg, device)
    draft = Labformer.from_numpy(quantize_decode_params(params, cfg), cfg, device)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (1, 8)).astype(np.int32)
    reps = max(reps, 3)
    plain_ms, _ = measure_call_ms(lambda: generate(model, prompt, steps, temperature=0.0),
                                  device=device, reps=reps, warmup=2)
    samples: list = []
    spec_ms, (_, acc) = measure_call_ms(
        lambda: speculative_generate(draft, model, prompt, steps=steps, k=k), device=device,
        reps=reps, warmup=1, collect=samples)
    return _model_row(f"speculative_decode_b1_{steps}steps_k{k}_int8draft_tokens_per_s",
                      round(steps / (spec_ms / 1e3), 1), "tokens/s", device, samples,
                      plain_tokens_per_s=round(steps / (plain_ms / 1e3), 1),
                      speedup_vs_plain=round(plain_ms / spec_ms, 3),
                      mean_accepted=round(acc, 2))


def bench_paged_engine(slots: int = 8, steps: int = 64, reps: int = 3,
                       backend: Optional[str] = None) -> Dict[str, Any]:
    """Continuous-batching paged decode (d512, L8, 2 kv heads, bf16):
    aggregate tokens/s over 8 requests of mixed prompt lengths.  The wall
    clock of each wave (engine built, requests submitted, ``run()``) after
    a synchronize, the median of at least 3 after a warm-up wave."""
    from tpulab_torch.models.paged import PagedEngine

    device = resolve_device(backend)
    cfg = _serving_cfg(1024, "bfloat16", kv_heads=2)
    model = _model(cfg, device)
    rng = np.random.default_rng(0)
    jobs = [(rng.integers(0, cfg.vocab, (p,)).astype(np.int32), steps)
            for p in (8, 17, 5, 33, 9, 21, 12, 7)]

    def run_once():
        eng = PagedEngine(model, cfg, slots=slots, n_blocks=256, block_size=16, max_seq=256)
        for prompt, n in jobs:
            eng.submit(prompt, max_new=n)
        return eng.run()

    run_once()
    times, out = [], {}
    for _ in range(max(reps, 3)):
        t, out = _wall_s(run_once, device)
        times.append(t)
    total = sum(len(v) for v in out.values())
    t = float(np.median(times))
    return _model_row(f"paged_engine_{slots}slots_{len(jobs)}reqs_tokens_per_s",
                      round(total / t, 1), "tokens/s", device, [x * 1e3 for x in times],
                      total_tokens=total)


def bench_paged_tick(slots: int = 4, steps: int = 64, reps: int = 5,
                     backend: Optional[str] = None) -> Dict[str, Any]:
    """Steady-state engine ticks/s (d64, L2, f32): ``steps`` mid-generation
    ``step()`` calls after admission and 6 warm-up steps, no request ending
    inside the window, which must upload nothing.  The value is the
    default ``overlap=1``; ``sync_ticks_per_s`` is ``overlap=0``.  The wall
    clock of the window between two synchronizes, the median of at least
    3 windows each."""
    from tpulab_torch.models.paged import PagedEngine

    device = resolve_device(backend)
    cfg = _small_cfg(256)
    model = _model(cfg, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (8,)).astype(np.int32) for _ in range(slots)]
    warm = 6

    def window(overlap):
        eng = PagedEngine(model, cfg, slots=slots, n_blocks=64, block_size=16, max_seq=256,
                          overlap=overlap)
        for p in prompts:
            eng.submit(p, max_new=warm + steps + 4)
        for _ in range(warm):
            eng.step()
        h2d0 = eng.counters["h2d_ticks"]
        dt, _ = _wall_s(lambda: [eng.step() for _ in range(steps)], device)
        if eng.counters["h2d_ticks"] != h2d0:
            raise RuntimeError("a steady-state tick uploaded host state")
        return dt, eng.stats()

    for ov in (0, 1):
        window(ov)
    times: Dict[int, list] = {0: [], 1: []}
    stats: Dict[int, dict] = {}
    for _ in range(max(reps, 3)):
        for ov in (0, 1):
            dt, stats[ov] = window(ov)
            times[ov].append(dt)
    t_on, t_off = float(np.median(times[1])), float(np.median(times[0]))
    return _model_row(f"paged_tick_{slots}slots_ticks_per_s", round(steps / t_on, 1),
                      "ticks/s", device, [x * 1e3 for x in times[1]],
                      sync_ticks_per_s=round(steps / t_off, 1),
                      speedup_vs_sync=round(t_off / t_on, 3),
                      inflight_depth=stats[1]["inflight_depth"])


def bench_prefill_interleave(slots: int = 4, reps: int = 5,
                             backend: Optional[str] = None) -> Dict[str, Any]:
    """Long prompts admitted while other slots decode (d64, L2, f32): the
    value is interleaved admission with 16-token chunks;
    ``sync_tokens_per_s`` the synchronous dense prefill,
    ``sync_chunked_tokens_per_s`` the same chunks inline at admission.
    The wall clock of each run (submits and ``run()``) after a
    synchronize, the median of at least 3 per mode after a warm-up."""
    from tpulab_torch.models.paged import PagedEngine

    device = resolve_device(backend)
    cfg = _small_cfg(512)
    model = _model(cfg, device)
    rng = np.random.default_rng(0)
    shorts = [rng.integers(0, cfg.vocab, (8,)).astype(np.int32) for _ in range(3)]
    longs = [rng.integers(0, cfg.vocab, (p,)).astype(np.int32) for p in (144, 160, 136, 152)]

    def window(interleave, chunk):
        def run():
            eng = PagedEngine(model, cfg, slots=slots, n_blocks=128, block_size=16,
                              max_seq=256, prefill_chunk=chunk, interleave=interleave)
            for p in shorts:
                eng.submit(p, max_new=24)
            for p in longs:
                eng.submit(p, max_new=8)
            return eng.run(), eng.stats()

        dt, (out, st) = _wall_s(run, device)
        return dt, sum(len(v) for v in out.values()), st

    modes = {"interleave": (True, 16), "sync_dense": (False, 0), "sync_chunked": (False, 16)}
    for m in modes.values():
        window(*m)
    times: Dict[str, list] = {k: [] for k in modes}
    stats: Dict[str, dict] = {}
    toks: Dict[str, int] = {}
    for _ in range(max(reps, 3)):
        for name, m in modes.items():
            dt, toks[name], stats[name] = window(*m)
            times[name].append(dt)
    med = {k: float(np.median(v)) for k, v in times.items()}
    return _model_row(
        f"prefill_interleave_{slots}slots_tokens_per_s",
        round(toks["interleave"] / med["interleave"], 1), "tokens/s", device,
        [x * 1e3 for x in times["interleave"]],
        sync_tokens_per_s=round(toks["sync_dense"] / med["sync_dense"], 1),
        speedup_vs_sync=round(med["sync_dense"] / med["interleave"], 3),
        sync_chunked_tokens_per_s=round(toks["sync_chunked"] / med["sync_chunked"], 1),
        speedup_vs_sync_chunked=round(med["sync_chunked"] / med["interleave"], 3),
        stall_ticks=stats["interleave"]["stall_ticks"],
        stall_ticks_sync=stats["sync_chunked"]["stall_ticks"],
        prefill_chunks=stats["interleave"]["prefill_chunks"],
        host_syncs=stats["interleave"]["host_syncs"])


def _paired(first, second) -> tuple:
    """Advance two generators in turns, one step of each, until both end:
    (the seconds each spent inside its own steps, what each returned).
    Run so, the two sides of a comparison share the host's moment: on the
    card's machine the same Python loop's time moves by more than these
    rows' budgets from one second to the next (``chip_smoke.py`` phase 9c
    times one)."""
    gens, spent, results, live = (first, second), [0.0, 0.0], [None, None], [True, True]
    while any(live):
        for i in (0, 1):
            if not live[i]:
                continue
            t0 = time.perf_counter()
            try:
                next(gens[i])
            except StopIteration as stop:
                live[i], results[i] = False, stop.value
            spent[i] += time.perf_counter() - t0
    return spent, results


def _steps(eng, n: int):
    """``n`` engine steps, one a turn."""
    for _ in range(n):
        eng.step()
        yield


def _served(eng):
    """Engine steps, one a turn, until its queue and slots are empty; then
    what ``run()`` returns (the finished streams)."""
    for _ in range(100_000):
        if not (eng.pending or eng.inflight_depth or any(r is not None for r in eng.active)):
            return eng.run()
        eng.step()
        yield
    raise RuntimeError("engine did not converge")


def _best_of_reps(pair, reps: int, budget: float) -> Dict[bool, list]:
    """``tpulab``'s best-of-reps retry-merge: ``max(reps, 3)`` pairs a
    round, until the best "on" time is within ``budget`` of the best "off"
    time (5 rounds at most), else raise.  The seconds per side.

    ``pair(on_first)`` times one "off" and one "on" sample together
    (:func:`_paired`) and gives ``{False: s, True: s}``; each pair swaps
    which side steps first, and the cyclic garbage collector is off inside
    a pair (run beforehand instead), so neither side pays for the other's
    garbage."""
    times: Dict[bool, list] = {False: [], True: []}
    for _ in range(5):
        for i in range(max(reps, 3)):
            gc.collect()
            gc.disable()
            try:
                got = pair(i % 2 == 1)
            finally:
                gc.enable()
            for on in (False, True):
                times[on].append(got[on])
        best = min(times[True]) / min(times[False]) - 1.0
        if best < budget:
            return times
    raise RuntimeError(f"overhead {best * 100:.2f}% over the {budget * 100:g}% budget "
                       f"(on={min(times[True]):.4f}s off={min(times[False]):.4f}s)")


def _overhead_fields(times: Dict[bool, list]) -> Dict[str, Any]:
    t_on, t_off = float(np.median(times[True])), float(np.median(times[False]))
    return {"overhead_pct_median": round((t_on / t_off - 1.0) * 100, 2),
            "overhead_pct_best": round((min(times[True]) / min(times[False]) - 1.0) * 100, 2)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_spill_overhead(slots: int = 4, steps: int = 96, reps: int = 5,
                         backend: Optional[str] = None) -> Dict[str, Any]:
    """The cache tier's tax on steady decode (d64, L2, f32): engine ticks/s
    without it (the dict index, no spill) and with the radix index and an
    armed but cold host tier (``spill_blocks=64``), whose short prompts on
    a roomy pool never cross the spill watermark, so no block crosses to
    the host inside the window.  A window is ``steps`` mid-generation
    ``step()`` calls after admission and 6 warm-up steps.  ``tpulab`` times
    the two windows of a pair one after the other; here they run in turns,
    one step each (:func:`_paired`), each side timed over its own steps,
    between two synchronizes.  Budget: the best armed window within 1 % of
    the best plain one (best-of-reps, retried as ``tpulab`` retries it).
    The value is the armed ticks/s."""
    from tpulab_torch.models.paged import PagedEngine

    device = resolve_device(backend)
    cfg = _small_cfg(256)
    model = _model(cfg, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (8,)).astype(np.int32) for _ in range(slots)]
    warm = 6

    def warmed(spill_on: bool):
        kw = {"prefix_index": "radix", "spill_blocks": 64} if spill_on else {}
        eng = PagedEngine(model, cfg, slots=slots, n_blocks=64, block_size=16, max_seq=256,
                          **kw)
        for p in prompts:  # the budget outlives warm-up and window
            eng.submit(p, max_new=warm + steps + 4)
        for _ in range(warm):
            eng.step()
        return eng

    def pair(on_first: bool) -> Dict[bool, float]:
        order = (True, False) if on_first else (False, True)
        engs = {on: warmed(on) for on in order}
        _sync(device)
        spent, _ = _paired(*(_steps(engs[on], steps) for on in order))
        _sync(device)
        if engs[True].counters["spill_spilled"]:
            raise RuntimeError("spill fired inside the cold window")
        return dict(zip(order, spent))

    pair(False)
    times = _best_of_reps(pair, reps, 0.01)
    t_on, t_off = float(np.median(times[True])), float(np.median(times[False]))
    return {
        "metric": f"spill_overhead_{slots}slots_ticks_per_s",
        "value": round(steps / t_on, 1),
        "unit": "ticks/s",
        "vs_baseline": None,
        "off_ticks_per_s": round(steps / t_off, 1),
        **_overhead_fields(times),
        "spill_blocks": 64,
        **card_fields(device.type),
        **variance_fields([t * 1e3 for t in times[True]]),
    }


def bench_handoff_overhead(prompt_len: int = 241, steps: int = 48, reps: int = 5,
                           backend: Optional[str] = None) -> Dict[str, Any]:
    """The prefill/decode KV handoff's tax on one request's end-to-end time
    (d64, L2, f32): the same request served unified (one engine prefills
    and decodes) and handed off (a prefill engine runs to the end of the
    prefill, exports its blocks, and a decode engine imports them and
    resumes through ``resubmit``, its admission restoring the prefix from
    the host tier).  The prompt is a block plus one, so the decode side
    recomputes nothing and the difference is the transport.  Both use the
    radix index and the spill tier; the handed-off stream must equal the
    unified one before any time counts, and in every timed pair.  The
    engines are built beforehand; the two requests of a pair run in turns,
    one engine step (or the export and import) each (:func:`_paired`),
    each timed over its own steps, between two synchronizes (``tpulab``
    times them one after the other).  Budget: the best handoff within 3 %
    of the best unified run (best-of-reps, retried as ``tpulab`` retries
    it).  The value is the handoff's tokens/s."""
    from tpulab_torch.models.paged import PagedEngine

    device = resolve_device(backend)
    cfg = _small_cfg(384)
    model = _model(cfg, device)
    prompt = (np.arange(prompt_len) % (cfg.vocab - 1)).astype(np.int32)

    def mk():
        return PagedEngine(model, cfg, slots=2, n_blocks=32, block_size=16, max_seq=384,
                           prefix_index="radix", spill_blocks=64)

    def unified(eng):
        eng.submit(prompt, max_new=steps)
        return (yield from _served(eng))

    def handed_off(eng_p, eng_d):
        eng_p.handoff_at_boundary = True
        eng_p.submit(prompt, max_new=steps)
        while not eng_p.handoff_ready:
            eng_p.step()
            yield
        (req, payload), = eng_p.export_handoff()
        eng_d.import_handoff(payload)
        eng_d.resubmit(req, fresh_id=True)
        yield
        return (yield from _served(eng_d))

    def pair(on_first: bool) -> Dict[bool, float]:
        runs = {False: unified(mk()), True: handed_off(mk(), mk())}
        order = (True, False) if on_first else (False, True)
        _sync(device)
        spent, done = _paired(*(runs[on] for on in order))
        _sync(device)
        streams = dict(zip(order, done))
        (ref,), (hand,) = streams[False].values(), streams[True].values()
        if not np.array_equal(ref, hand):
            raise RuntimeError(f"handoff stream diverged from unified serving: {ref[:8]}... "
                               f"vs {hand[:8]}...")
        return dict(zip(order, spent))

    pair(False)
    times = _best_of_reps(pair, reps, 0.03)
    t_on, t_off = float(np.median(times[True])), float(np.median(times[False]))
    return {
        "metric": "handoff_overhead_e2e_tokens_per_s",
        "value": round(steps / t_on, 1),
        "unit": "tokens/s",
        "vs_baseline": None,
        "unified_tokens_per_s": round(steps / t_off, 1),
        **_overhead_fields(times),
        "prompt_len": prompt_len,
        **card_fields(device.type),
        **variance_fields([t * 1e3 for t in times[True]]),
    }


def bench_prefix_lookup(short: int = 4096, factor: int = 4, reps: int = 7,
                        backend: Optional[str] = None) -> Dict[str, Any]:
    """The admission path's prefix lookup scales linearly in prompt length:
    ``_lookup_prefix`` on a miss at ``short`` and ``short * factor``
    tokens, best of ``reps`` each (host work alone, ``time.perf_counter``);
    the ratio must stay under ``factor**2 / 2``, where a quadratic scan
    would land."""
    from tpulab_torch.models.paged import PagedEngine

    device = resolve_device(backend)
    cfg = _small_cfg(256)
    eng = PagedEngine(_model(cfg, device), cfg, slots=2, n_blocks=16, block_size=16,
                      max_seq=256)
    rng = np.random.default_rng(0)
    long = short * factor
    p_short = rng.integers(0, cfg.vocab, (short,)).astype(np.int32)
    p_long = rng.integers(0, cfg.vocab, (long,)).astype(np.int32)

    def timed(prompt):
        t0 = time.perf_counter()
        blocks, pos = eng._lookup_prefix(prompt)
        dt = time.perf_counter() - t0
        if blocks or pos:
            raise RuntimeError("a random prompt hit the empty prefix cache")
        return dt

    timed(p_short), timed(p_long)
    t_s = min(timed(p_short) for _ in range(max(reps, 3)))
    t_l = min(timed(p_long) for _ in range(max(reps, 3)))
    ratio, bound = t_l / t_s, factor ** 2 / 2.0
    if ratio >= bound:
        raise RuntimeError(f"prefix lookup scaled {ratio:.1f}x over a {factor}x longer prompt "
                           f"(>= {bound:.0f}x): the admission path has gone quadratic")
    return {"metric": "prefix_lookup_tokens_per_s", "value": round(long / t_l, 1),
            "unit": "tokens/s", "vs_baseline": None, "short_tokens": short,
            "long_tokens": long, "scaling_ratio": round(ratio, 2),
            "linear_bound": round(bound, 1), **card_fields(device.type)}


def bench_flash_attention(s: int = 32768, reps: int = 5,
                          backend: Optional[str] = None) -> Dict[str, Any]:
    """Causal flash attention (kernel B4) at (1, s, 8, 64) bf16, where the
    dense scores would not fit (s=32768: 34 GB in f32).  CUDA events around
    ``reps`` launches after a spin kernel (``measure_kernel_ms``), the
    median of 5 trials."""
    from tpulab_torch.ops.cuda.attention import flash_attention

    device = resolve_device(backend)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, 8, 64)).astype(np.float32))
               .to(device, torch.bfloat16) for _ in range(3))
    samples: list = []
    ms, _ = measure_kernel_ms(flash_attention, (q, k, v), device=device, iters=max(reps, 5),
                              warmup=2, outer=5, collect=samples)
    flops = 8 * (4 * s * s * 64) // 2  # QK^T and PV over 8 heads, causal half
    return {"metric": f"flash_attention_s{s}_h8_d64_bf16_median_ms", "value": round(ms, 4),
            "unit": "ms", "vs_baseline": None, **card_fields(device.type),
            **mfu_fields(flops, ms, device), **variance_fields(samples)}


REGISTRY = {
    "lab1_n1000": functools.partial(bench_lab1, 1000),
    "lab1_f32_1m": functools.partial(bench_lab1, 1 << 20, dtype="float32"),
    "labformer_fwd": bench_labformer,
    "labformer_train": bench_labformer_train,
    "labformer_decode": bench_labformer_decode,
    "labformer_decode_int8": functools.partial(bench_labformer_decode, int8=True),
    "labformer_decode_gqa2": functools.partial(bench_labformer_decode, kv_heads=2),
    "speculative_decode": bench_speculative_decode,
    "paged_engine": bench_paged_engine,
    "paged_tick_overhead": bench_paged_tick,
    "prefill_interleave": bench_prefill_interleave,
    "spill_overhead": bench_spill_overhead,
    "handoff_overhead": bench_handoff_overhead,
    "prefix_lookup": bench_prefix_lookup,
    "lab2_roberts_1024": bench_lab2,
    "lab3_classify_1024": bench_lab3,
    "hw2_sort": bench_sort,
    "lab5_reduce": bench_reduce,
    "flash_attention": bench_flash_attention,
    "flash_attention_8k": functools.partial(bench_flash_attention, s=8192),
}


#: the lab suite's rows (each a substring of no other row's name, so
#: ``only=name`` runs that row alone)
LAB_ROWS = ("lab1_n1000", "lab1_f32_1m", "lab2_roberts_1024", "lab3_classify_1024",
            "hw2_sort", "lab5_reduce")


def run_benchmarks(only: Optional[str] = None, **kw) -> Iterator[Dict[str, Any]]:
    """Rows of every registered benchmark (or those whose name holds
    ``only``), one at a time.  Extra kwargs (``backend``, ``size``,
    ``iters``, ``reps``, ``n``, ...) go to each benchmark that declares
    them.  An error is raised, not turned into a row."""
    for name, fn in REGISTRY.items():
        if only and only not in name:
            continue
        base = fn.func if isinstance(fn, functools.partial) else fn
        params = list(inspect.signature(base).parameters)
        bound = (set(params[: len(fn.args)]) | set(fn.keywords)
                 if isinstance(fn, functools.partial) else set())
        yield fn(**{k: v for k, v in kw.items() if k in params and k not in bound})
