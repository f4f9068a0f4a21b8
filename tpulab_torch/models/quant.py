"""Weight-only int8 quantization for the decode path
(the counterpart of ``tpulab.models.quant``).

Symmetric per-channel scheme: ``s_c = max|w_c| / 127``, ``q = round(w/s)``;
the dequantize folds after the matmul, ``x @ (q * s) == (x @ q) * s`` for
a per-column scale.  ``pack_int4``/``unpack_int4`` are the KV spill
tier's cold host format, in numpy.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch


class QTensor(NamedTuple):
    """int8 weight + f32 scale with the quantized (input) axis reduced.

    For a (d_in, d_out) matmul weight: ``q`` (d_in, d_out) int8, ``s``
    (d_out,).  For the (vocab, d) embedding: per-row, ``s`` (vocab,).
    """

    q: torch.Tensor
    s: torch.Tensor


def quantize_tensor(w: torch.Tensor, axis: int = 0) -> QTensor:
    """Symmetric per-channel int8: scale computed over ``axis``."""
    w32 = torch.as_tensor(w).float()
    amax = w32.abs().amax(dim=axis)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(w32 / s.unsqueeze(axis))
    return QTensor(q.to(torch.int8), s.float())


def qmat(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain tensor or a per-column QTensor."""
    if isinstance(w, QTensor):
        return (x @ w.q.to(x.dtype)) * w.s.to(x.dtype)
    return x @ w


def embed_lookup(embed, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``embed[tokens]`` for a plain or per-row-quantized embedding."""
    if isinstance(embed, QTensor):
        return embed.q[tokens].to(dtype) * embed.s[tokens][..., None].to(dtype)
    return embed[tokens]


def unembed(x: torch.Tensor, embed) -> torch.Tensor:
    """``x @ embed.T`` (logits) for a plain or per-row-quantized embedding."""
    if isinstance(embed, QTensor):
        return (x @ embed.q.T.to(x.dtype)) * embed.s.to(x.dtype)
    return x @ embed.T


def pack_int4(q: np.ndarray) -> Tuple[np.ndarray, bool]:
    """Pack int8 values in [-8, 7] two to a byte, low nibble first.

    Host-side numpy, the KV spill tier's cold format: the packed uint8
    array over the flattened input, and whether a padding nibble was
    appended (an odd count); :func:`unpack_int4` inverts it exactly."""
    flat = np.asarray(q, np.int8).reshape(-1)
    if flat.size and (flat.min() < -8 or flat.max() > 7):
        raise ValueError("pack_int4 input out of int4 range [-8, 7]")
    odd = bool(flat.size % 2)
    if odd:
        flat = np.concatenate([flat, np.zeros(1, np.int8)])
    u = (flat.astype(np.int16) & 0xF).astype(np.uint8)
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8), odd


def unpack_int4(packed: np.ndarray, odd: bool = False) -> np.ndarray:
    """Inverse of :func:`pack_int4`: packed uint8 -> flat int8 in [-8, 7]."""
    p = np.asarray(packed, np.uint8)
    lo = (p & 0xF).astype(np.int8)
    hi = ((p >> 4) & 0xF).astype(np.int8)
    out = np.empty(p.size * 2, np.int8)
    out[0::2] = lo
    out[1::2] = hi
    out = np.where(out > 7, out - 16, out).astype(np.int8)
    return out[:-1] if odd else out


def quantize_decode_params(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """int8-quantize the decode-path weights of a dense labformer's
    parameter tree (stacked ``(L, d_in, d_out)`` leaves).

    Projections and MLP weights go per-output-channel; the tied embedding
    goes per-vocab-row.  Norms stay full precision.  MoE configs are
    refused: the expert einsums are not wired for QTensor.
    """
    if getattr(cfg, "n_experts", 0):
        raise NotImplementedError("int8 decode supports dense models only")
    out = dict(params)
    out["embed"] = quantize_tensor(params["embed"], axis=1)
    blocks = dict(params["blocks"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
        if name in blocks:
            blocks[name] = quantize_tensor(blocks[name], axis=1)
    out["blocks"] = blocks
    return out
