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

The engine and trainer gauges of ``tpulab.obs.roofline`` wait for the
port's observability layer (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

#: per-card peaks: (substrings of the card's name, bf16 TFLOP/s, GB/s)
CARD_PEAKS = (
    (("H100", "HBM3"), 989.0, 3350.0),
)


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
