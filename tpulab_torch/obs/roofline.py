"""MFU and roofline accounting (the counterpart of ``tpulab.obs.roofline``).

* :func:`labformer_fwd_flops` / :func:`per_token_flops`: analytic matmul
  flops of the labformer (projections, MLP, logits, the attention
  contractions; a multiply-add is 2), ``tpulab``'s convention;
* :func:`device_peaks`: the peak bf16 rate and memory rate of the card,
  keyed on its name.  Only the H100 SXM (its name holds "H100" and
  "HBM3") has figures here: 989 TFLOP/s dense bf16 on the tensor cores
  and 3.35 TB/s (NVIDIA's data sheet).  Any other card, and the CPU, get
  ``None``, so a consumer reports no MFU rather than a made-up one;
* :func:`mfu_fields` / :func:`mfu_pct`: achieved TFLOP/s and the percent
  of that peak for a measured time.

* :func:`roofline_rows`: per-program rows from a compile-ledger snapshot
  (:mod:`tpulab_torch.obs.compilestats`), classified compute- or
  bandwidth-bound where the ledger has flops and bytes (the port's builds
  carry neither, so their rows say "unknown");
* :func:`update_mfu_gauges`: the ``engine_mfu`` / ``train_mfu`` gauges,
  the engine's registered per-tick flops over the mean ``itl_seconds``
  observation and the trainer's windows (:func:`note_train_window`) as a
  percent of the bf16 peak (0 where the card has no figures, and on the
  CPU);
* :func:`update_device_memory_gauges`: ``engine_hbm_bytes_in_use`` /
  ``engine_hbm_bytes_limit`` from the CUDA caching allocator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

#: gauge names
G_ENGINE_MFU = "engine_mfu"
G_TRAIN_MFU = "train_mfu"

#: train-MFU accumulator: dispatched analytic flops and wall seconds,
#: process-cumulative like the registry
_TRAIN_ACCUM = {"flops": 0.0, "wall": 0.0}

#: per-card peaks: (substrings of the card's name, bf16 TFLOP/s, GB/s)
CARD_PEAKS = (
    (("H100", "HBM3"), 989.0, 3350.0),
)


def note_train_window(flops: float, wall_seconds: float) -> None:
    """Add one training window's dispatched analytic flops and wall time
    to the train-MFU ledger."""
    _TRAIN_ACCUM["flops"] += float(flops)
    _TRAIN_ACCUM["wall"] += float(wall_seconds)


def labformer_fwd_flops(cfg, b: int, s: int, causal: bool = True) -> int:
    """Analytic model flops of one labformer forward over (b, s) tokens:
    matmul flops only, causal attention counting half the score matrix."""
    d, dff = cfg.d_model, cfg.d_ff
    per_tok = 2 * cfg.n_layers * (4 * d * d + 2 * d * dff) + 2 * d * cfg.vocab
    attn = cfg.n_layers * 4 * s * s * d  # QK^T + PV, all heads
    if causal:
        attn //= 2
    return b * (s * per_tok + attn)


def per_token_flops(cfg) -> int:
    """Matmul flops to decode one token (projections, MLP, logits; the
    context-dependent attention reads are bandwidth, not matmul)."""
    d, dff = cfg.d_model, cfg.d_ff
    return 2 * cfg.n_layers * (4 * d * d + 2 * d * dff) + 2 * d * cfg.vocab


def device_peaks(device=None, device_kind: Optional[str] = None
                 ) -> Dict[str, Optional[float]]:
    """``{"device_kind", "peak_tflops", "peak_gbps"}`` for the named card,
    or for ``device`` (a ``torch.device``; None is the current card where
    one is visible, else the CPU).  Peaks are None for the CPU and for a
    card with no figures in :data:`CARD_PEAKS`."""
    if device_kind is None:
        if device is None:
            device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        device = torch.device(device)
        device_kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else device.type)
    for words, tflops, gbps in CARD_PEAKS:
        if all(w in device_kind for w in words):
            return {"device_kind": device_kind, "peak_tflops": tflops, "peak_gbps": gbps}
    return {"device_kind": device_kind, "peak_tflops": None, "peak_gbps": None}


def mfu_fields(flops: float, ms: float, device) -> Dict[str, Any]:
    """Achieved TFLOP/s and percent of the bf16 peak for ``flops`` model
    flops in ``ms`` (the bench rows' fields); ``{}`` when the flops, the
    time or the peak is unknown."""
    peak = device_peaks(device)["peak_tflops"]
    if flops <= 0 or not peak or ms <= 0:
        return {}
    achieved = flops / (ms / 1e3) / 1e12
    return {
        "model_flops": float(flops),
        "achieved_tflops": round(achieved, 2),
        "mfu_pct_of_bf16_peak": round(100.0 * achieved / peak, 2),
        "peak_tflops": peak,
    }


def mfu_pct(flops: float, seconds: float, peaks: Optional[Dict] = None) -> float:
    """Percent of the bf16 peak for ``flops`` in ``seconds`` (0.0 where
    the peak is unknown)."""
    peaks = peaks if peaks is not None else device_peaks()
    peak = peaks.get("peak_tflops")
    if not peak or flops <= 0 or seconds <= 0:
        return 0.0
    return 100.0 * (flops / seconds / 1e12) / peak


def classify(flops: Optional[float], bytes_accessed: Optional[float],
             peaks: Dict) -> Dict[str, Any]:
    """Roofline classification of one program: arithmetic intensity
    against the card's ridge point (peak flops over peak bytes/s)."""
    out: Dict[str, Any] = {
        "intensity_flops_per_byte": None, "ridge_flops_per_byte": None,
        "bound": "unknown", "ceiling_tflops": None,
    }
    if not flops or not bytes_accessed:
        return out
    intensity = flops / bytes_accessed
    out["intensity_flops_per_byte"] = round(intensity, 3)
    peak_tf, peak_gb = peaks.get("peak_tflops"), peaks.get("peak_gbps")
    if not peak_tf or not peak_gb:
        out["bound"] = "unknown (no device peaks)"
        return out
    ridge = (peak_tf * 1e12) / (peak_gb * 1e9)
    out["ridge_flops_per_byte"] = round(ridge, 3)
    if intensity >= ridge:
        out["bound"] = "compute-bound"
        out["ceiling_tflops"] = peak_tf
    else:
        out["bound"] = "bandwidth-bound"
        out["ceiling_tflops"] = round(intensity * peak_gb * 1e9 / 1e12, 3)
    return out


def roofline_rows(compile_stats: Optional[Dict] = None,
                  peaks: Optional[Dict] = None) -> List[Dict[str, Any]]:
    """Per-program roofline rows from a compile-ledger snapshot (the live
    :data:`~tpulab_torch.obs.compilestats.COMPILESTATS` by default)."""
    if compile_stats is None:
        from tpulab_torch.obs.compilestats import COMPILESTATS

        compile_stats = COMPILESTATS.snapshot()
    peaks = peaks if peaks is not None else device_peaks()
    rows = []
    for name, p in sorted(compile_stats.items()):
        flops = p.get("flops")
        nbytes = p.get("bytes_accessed")
        rows.append({
            "program": name,
            "compiles": p.get("compiles", 0),
            "compile_seconds": p.get("compile_seconds", 0.0),
            "flops": flops,
            "bytes_accessed": nbytes,
            "model_flops": p.get("model_flops"),
            **classify(flops, nbytes, peaks),
        })
    return rows


def update_mfu_gauges(peaks: Optional[Dict] = None, registry=None,
                      n_devices: int = 1) -> Dict[str, float]:
    """Recompute and publish ``engine_mfu`` / ``train_mfu`` (percent of
    the bf16 peak, 4 significant digits; 0.0 without a peak or traffic).
    ``engine_mfu`` is the last-built engine's registered ``paged_tick``
    flops over the mean ``itl_seconds`` observation; ``train_mfu`` the
    trainer's accumulated flops over its wall time.  Scrape path only."""
    from tpulab_torch.obs.compilestats import COMPILESTATS
    from tpulab_torch.obs.registry import REGISTRY

    reg = registry if registry is not None else REGISTRY
    peaks = dict(peaks if peaks is not None else device_peaks())
    if n_devices > 1 and peaks.get("peak_tflops"):
        peaks["peak_tflops"] = peaks["peak_tflops"] * n_devices
    out = {"engine_mfu": 0.0, "train_mfu": 0.0}
    sig = lambda x: float(f"{x:.4g}")  # noqa: E731
    itl = reg.get("itl_seconds")
    tick_flops = COMPILESTATS.model_flops("paged_tick")
    if itl is not None and tick_flops:
        snap = itl.snapshot()
        if snap["count"]:
            out["engine_mfu"] = sig(mfu_pct(tick_flops, snap["sum"] / snap["count"], peaks))
    if _TRAIN_ACCUM["flops"] and _TRAIN_ACCUM["wall"]:
        out["train_mfu"] = sig(mfu_pct(_TRAIN_ACCUM["flops"], _TRAIN_ACCUM["wall"], peaks))
    reg.gauge(G_ENGINE_MFU,
              "steady-state decode MFU, % of bf16 peak (0 on CPU proxy)"
              ).set(out["engine_mfu"])
    reg.gauge(G_TRAIN_MFU,
              "training wall-clock MFU, % of bf16 peak (0 on CPU proxy)"
              ).set(out["train_mfu"])
    return out


def update_device_memory_gauges(estimate_bytes: int = 0, registry=None,
                                device=None) -> Dict[str, int]:
    """Publish ``engine_hbm_bytes_in_use`` / ``engine_hbm_bytes_limit``:
    the CUDA caching allocator's allocated bytes and the card's total
    memory where ``device`` is a card, else ``estimate_bytes`` (the
    engines' pool and weight estimate) and a limit of 0.  Scrape path
    only."""
    from tpulab_torch.obs.registry import REGISTRY

    reg = registry if registry is not None else REGISTRY
    in_use, limit = 0, 0
    if device is not None and torch.device(device).type == "cuda":
        in_use = int(torch.cuda.memory_allocated(device))
        limit = int(torch.cuda.get_device_properties(device).total_memory)
    if not in_use:
        in_use = int(estimate_bytes)
    reg.gauge("engine_hbm_bytes_in_use",
              "device memory in use (memory_stats; pool-shape estimate "
              "on backends without it)").set(in_use)
    reg.gauge("engine_hbm_bytes_limit",
              "device memory limit (0 when the backend reports none)"
              ).set(limit)
    return {"engine_hbm_bytes_in_use": in_use, "engine_hbm_bytes_limit": limit}
