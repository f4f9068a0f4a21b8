"""The single-device part of ``tpulab.parallel.ring``: the dense attention
oracle and the one flash-selection predicate.

The ring, zigzag and Ulysses bodies (sequence parallelism over a mesh)
wait for the multi-device tier (ROADMAP A12).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

FLASH_AUTO_TOKENS = 1024  # "auto" switches to flash from this many local tokens


def use_flash(local_impl: str, n_tokens: int) -> bool:
    """"flash" always, "auto" from FLASH_AUTO_TOKENS tokens, "dense" never."""
    return local_impl == "flash" or (
        local_impl == "auto" and n_tokens >= FLASH_AUTO_TOKENS)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense scaled-dot-product attention over ``(..., seq, heads, head_dim)``.

    q is divided by sqrt(d) in its own dtype before the product and the
    scores are formed in that dtype, then widened to f32 for the softmax
    (``tpulab.parallel.ring.attention_reference``).  ``window`` > 0
    (causal only) keeps each query's ``window`` most recent keys.
    """
    d = q.shape[-1]
    qs = q / torch.tensor(math.sqrt(d), dtype=torch.float64).to(q.dtype)
    s = torch.einsum("...qhd,...khd->...hqk", qs, k).float()
    if causal:
        n_q, n_k = q.shape[-3], k.shape[-3]
        q_pos = torch.arange(n_q, device=q.device)[:, None]
        k_pos = torch.arange(n_k, device=q.device)[None, :]
        bias = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
        s = s + bias
        if window:
            s = torch.where(q_pos - k_pos >= window, NEG_INF, s)
    elif window:
        raise NotImplementedError("sliding window requires causal=True")
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("...hqk,...khd->...qhd", p, v.float())
    o = o / p.sum(dim=-1)[..., None].transpose(-2, -3)
    return o.to(q.dtype)
