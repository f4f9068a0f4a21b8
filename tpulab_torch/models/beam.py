"""Beam search over the KV-cached decode loop (the counterpart of
``tpulab.models.beam``).

Beams ride the cache's batch axis: the prompt is tiled ``beams`` times and
prefilled once (kernel B4 per layer where the path picks flash), step 0
takes the top ``beams`` tokens of the shared distribution, and each later
step scores ``beams * vocab`` continuations, keeps the ``beams`` best by
accumulated log-probability, and reorders both caches along their batch
axis (axis 1 of ``(L, b, S, kv_heads, head_dim)``) with ``index_select`` so
every surviving beam carries its own history.  The loop stays on the
device (no host read inside it); the (token, parent) history is
backtracked on the host afterwards.

The byte LM has no EOS, so beams run the full ``steps`` and the best beam
has the highest total log-probability at the end.  ``jax.lax.top_k`` puts
the lower index first among equal values, and ``torch.topk`` promises no
order on ties, so :func:`top_k` takes the first ``k`` of a stable sort:
ties go to the lower flat index, as in ``tpulab``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpulab_torch.models.generate import _forward_step, _prefill
from tpulab_torch.models.labformer import Labformer


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of a 1-D ``x``,
    largest first, equal values in index order (``jax.lax.top_k``'s)."""
    idx = torch.sort(-x, stable=True).indices[:k]
    return x[idx], idx


def _select(totals: torch.Tensor, beams: int, trace: Optional[dict]):
    """The ``beams`` best of the candidate totals; with ``trace``, note the
    kept totals and the gap from the last kept to the best dropped one
    (``inf`` when none is dropped), device tensors read after the loop."""
    if trace is None:
        return top_k(totals, beams)
    vals, idx = top_k(totals, beams + 1)
    gap = (vals[beams - 1] - vals[beams] if vals.numel() > beams
           else totals.new_tensor(float("inf")))
    trace.setdefault("scores", []).append(vals[:beams])
    trace.setdefault("gap", []).append(gap)
    return vals[:beams], idx[:beams]


@torch.inference_mode()
def _search(model: Labformer, prompt: torch.Tensor, steps: int, beams: int,
            trace: Optional[dict] = None):
    """prompt (1, p) -> (first tokens (B,), token history (steps-1, B),
    parent history (steps-1, B), scores (B,)), all on the device."""
    p = prompt.shape[1]
    logits0, kc, vc = _prefill(model, prompt.expand(beams, p), p + steps)
    scores, tok = _select(torch.log_softmax(logits0[0].float(), dim=-1), beams, trace)
    first, toks, parents = tok, [], []
    for i in range(steps - 1):
        logits, kc, vc = _forward_step(model, tok, kc, vc, p + i)
        lp = torch.log_softmax(logits.float(), dim=-1)
        vocab = lp.shape[1]
        scores, idx = _select((scores[:, None] + lp).reshape(-1), beams, trace)
        parent = torch.div(idx, vocab, rounding_mode="floor")
        tok = idx % vocab
        # beam b continues parent[b]'s history
        kc = kc.index_select(1, parent)
        vc = vc.index_select(1, parent)
        toks.append(tok)
        parents.append(parent)
    empty = first.new_zeros((0, beams))
    return (first, torch.stack(toks) if toks else empty,
            torch.stack(parents) if parents else empty, scores)


def beam_search(model: Labformer, prompt, steps: int = 64, beams: int = 4,
                trace: Optional[dict] = None) -> Tuple[np.ndarray, float]:
    """Best continuation of ``prompt`` (shape (p,) or (1, p)) by beam
    search on ``model``'s device: ``(tokens (steps,) int32,
    total_log_prob)``.  ``beams=1`` is greedy decoding exactly.  A
    ``trace`` dict receives, per step, the kept totals (``"scores"``), the
    gap to the best dropped candidate (``"gap"``), and the chosen tokens
    and parents (``"tokens"``, ``"parents"``; step 0's parents are 0), as
    host arrays."""
    cfg = model.cfg
    if cfg.lora_rank:
        # this decode path reads base weights only — serving an
        # adapter-active model here would silently drop the finetune
        raise ValueError(
            "beam_search with lora_rank > 0: fold the adapters first "
            "(labformer.merge_lora(params, cfg))"
        )
    prompt = np.asarray(prompt, np.int32).reshape(1, -1)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if not 1 <= beams <= cfg.vocab:
        raise ValueError(
            f"beams must be in [1, {cfg.vocab}] (vocab size), got {beams}"
        )
    first, toks, parents, scores = _search(model, model.tokens(prompt), steps, beams, trace)
    if trace is not None:
        trace["scores"] = torch.stack(trace["scores"]).cpu().numpy()
        trace["gap"] = torch.stack(trace["gap"]).cpu().numpy()
        trace["tokens"] = torch.cat([first[None], toks]).cpu().numpy()
        trace["parents"] = torch.cat([torch.zeros_like(first)[None], parents]).cpu().numpy()
    # one read back: the four results in one host copy
    host = torch.cat([first.float()[None], toks.float(), parents.float(),
                      scores[None]]).cpu().numpy()
    first = host[0].astype(np.int64)
    toks = host[1:steps].astype(np.int64)
    parents = host[steps:2 * steps - 1].astype(np.int64)
    scores = host[-1].astype(np.float32)
    best = int(scores.argmax())
    # backtrack: walk parents from the last step to the first generated
    # token; the step-0 token is indexed by the surviving lineage's root
    seq = np.zeros(steps, np.int32)
    b = best
    for i in range(steps - 2, -1, -1):
        seq[i + 1] = toks[i, b]
        b = int(parents[i, b])
    seq[0] = first[b]
    return seq, float(scores[best])
