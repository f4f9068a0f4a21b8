"""Speculative decoding: a cheap draft proposes, the target verifies k
tokens per forward pass (the counterpart of ``tpulab.models.speculative``).

The greedy variant is lossless: the emitted stream is the target's own
greedy stream; the draft changes only how many target passes it takes.
Each round:

1. the draft greedily proposes ``k`` tokens from the last committed token
   (its own KV cache, one pass per token);
2. the target runs one windowed cached forward over ``[committed, d_1 ..
   d_k]``: window row i gives its next token after ``d_1..d_i``;
3. the longest prefix the target agrees with is committed, plus one
   target token (the correction, or the bonus on full acceptance): every
   round commits 1 to k+1 tokens.

Cache discipline: no cache is ever rolled back.  Rejected drafts leave
stale K/V past the committed frontier, which the position mask of
``generate._attend_cached`` never reads; the next round overwrites it.
Each round fetches its drafts and the target's choices to the host in
one copy.

``tpulab`` jits the draft scan and the verify window; here both are eager
loops over the port's cached decode (``tpulab_torch.models.generate``).
The natural draft is the int8-quantized target
(``quant.quantize_decode_params``); any labformer with the same
vocabulary works.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpulab_torch.models.generate import _forward_step, _forward_window, _prefill
from tpulab_torch.models.labformer import Labformer


@torch.inference_mode()
def _draft_propose(model: Labformer, last_token: torch.Tensor, k_caches: torch.Tensor,
                   v_caches: torch.Tensor, pos, k: int) -> torch.Tensor:
    """Greedily decode ``k`` tokens from ``last_token`` (b,) at ``pos``
    (an int, or (b,) per row); the (b, k) drafts, the caches written in
    place.

    Runs k+1 steps and drops the last output: each step writes its input
    token's K/V, so the extra step is what lands ``d_k``'s K/V at pos+k;
    without it a fully accepted round would leave a hole in the draft
    cache that every later position attends as zeros."""
    tok, drafts = last_token, []
    for i in range(k + 1):
        logits, _, _ = _forward_step(model, tok, k_caches, v_caches, pos + i)
        tok = logits.argmax(dim=-1)
        drafts.append(tok)
    return torch.stack(drafts[:k], dim=1)


def _draft_propose_slots(model: Labformer, last_tok: torch.Tensor, k_caches: torch.Tensor,
                         v_caches: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """Per-slot proposals at per-slot positions, the engine's draft
    proposer: slot s greedily decodes ``k`` tokens from ``last_tok[s]`` at
    ``pos[s]`` against its own row of the dense caches (L, S, C, kv, d).
    ``tpulab`` vmaps :func:`_draft_propose` over the slots; here the
    batched decode takes the positions per row."""
    return _draft_propose(model, last_tok, k_caches, v_caches, pos.long(), k)


@torch.inference_mode()
def _target_verify(model: Labformer, window: torch.Tensor, k_caches: torch.Tensor,
                   v_caches: torch.Tensor, pos: int) -> torch.Tensor:
    """window (b, k+1) = [committed, drafts...] at positions pos.. ->
    the target's greedy choice after each window prefix, (b, k+1)."""
    logits, _, _ = _forward_window(model, window, k_caches, v_caches, pos)
    return logits.argmax(dim=-1)


def _spec_loop(model: Labformer, t_kc: torch.Tensor, t_vc: torch.Tensor,
               committed: torch.Tensor, start_pos: int, steps: int, k: int,
               propose: Callable, on_commit: Optional[Callable] = None
               ) -> Tuple[np.ndarray, float]:
    """The verify, accept and commit loop of both proposers.
    ``propose(committed, pos)`` gives (b, k) drafts, a device tensor or a
    numpy array; ``on_commit(emitted)`` sees each round's committed tokens.

    Acceptance is batch-wide: the window is shared, so a round commits the
    longest prefix every row accepts (batch 1 gets its full rate)."""
    dev = committed.device
    out = [committed.cpu().numpy()[:, None]]
    n_out = 1
    pos = start_pos
    accepted = []
    while n_out < steps:
        drafts = propose(committed, pos)
        on_device = isinstance(drafts, torch.Tensor)
        drafts_t = drafts if on_device else torch.as_tensor(drafts, device=dev)
        window = torch.cat([committed[:, None], drafts_t.long()], dim=1)
        choices = _target_verify(model, window, t_kc, t_vc, pos)
        # one fetch a round: the drafts ride with the choices
        if on_device:
            both = torch.cat([window[:, 1:], choices], dim=1).cpu().numpy()
            drafts_np, choices_np = both[:, :k], both[:, k:]
        else:
            drafts_np, choices_np = np.asarray(drafts), choices.cpu().numpy()
        agree = drafts_np == choices_np[:, :k]
        m = 0
        while m < k and bool(agree[:, m].all()):
            m += 1
        accepted.append(m)
        emitted = np.concatenate([drafts_np[:, :m], choices_np[:, m:m + 1]], axis=1)
        out.append(emitted)
        if on_commit is not None:
            on_commit(emitted)
        n_out += m + 1
        pos += m + 1
        committed = torch.as_tensor(emitted[:, -1], device=dev).long()
    tokens = np.concatenate(out, axis=1)[:, :steps].astype(np.int32)
    return tokens, float(np.mean(accepted)) if accepted else 0.0


def _refuse_lora(model: Labformer, what: str) -> None:
    if model.cfg.lora_rank:
        raise ValueError(
            f"{what} with lora_rank > 0: fold the adapters first "
            "(labformer.merge_lora(params, cfg))")


@torch.inference_mode()
def speculative_generate(draft: Labformer, target: Labformer, prompt, steps: int = 64,
                         k: int = 4) -> Tuple[np.ndarray, float]:
    """Greedy speculative decode of ``prompt`` (b, p); ``(tokens (b,
    steps) int32, mean_accepted)``.  The tokens are the target's own
    greedy stream; ``mean_accepted`` is the mean number of drafts accepted
    a round (0..k).  Both models lie on the same device."""
    if draft.cfg.vocab != target.cfg.vocab:
        raise ValueError("draft and target must share a vocabulary")
    _refuse_lora(draft, "speculative_generate")
    _refuse_lora(target, "speculative_generate")
    prompt = target.tokens(prompt)
    b, p = prompt.shape
    cache_len = p + steps + k + 2
    t_logits, t_kc, t_vc = _prefill(target, prompt, cache_len)
    _, d_kc, d_vc = _prefill(draft, prompt, cache_len)
    committed = t_logits.argmax(dim=-1)

    def propose(committed, pos):
        return _draft_propose(draft, committed, d_kc, d_vc, pos, k)

    return _spec_loop(target, t_kc, t_vc, committed, p, steps, k, propose)


def _lookup_propose(history: np.ndarray, k: int, ngram: int) -> np.ndarray:
    """Draft-free proposal (prompt lookup): the ``k`` tokens that followed
    the most recent earlier occurrence of the last ``ngram`` committed
    tokens.  No match, or a short continuation, pads with the last token;
    a bad proposal costs only its rejected verify rows."""
    n = len(history)
    fill = np.full(k, history[-1], np.int32)
    if n <= ngram:
        return fill
    key = history[n - ngram:]
    # window starts run 0..n-1-ngram: the trailing self-match is excluded,
    # overlapping earlier matches stay eligible
    windows = np.lib.stride_tricks.sliding_window_view(history[:-1], ngram)
    hits = np.nonzero((windows == key).all(axis=1))[0]
    if hits.size == 0:
        return fill
    i = int(hits[-1])
    cont = history[i + ngram: i + ngram + k]
    if len(cont) < k:
        cont = np.concatenate([cont, fill[: k - len(cont)]])
    return cont.astype(np.int32)


@torch.inference_mode()
def prompt_lookup_generate(model: Labformer, prompt, steps: int = 64, k: int = 4,
                           ngram: int = 3) -> Tuple[np.ndarray, float]:
    """Draft-free greedy speculative decoding: proposals are n-gram
    matches against the committed sequence, verified through the same
    windowed target pass as :func:`speculative_generate`, so the output is
    plain greedy decoding's.  ``(tokens (b, steps) int32, mean_accepted)``."""
    _refuse_lora(model, "prompt_lookup_generate")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    prompt = model.tokens(prompt)
    prompt_np = prompt.cpu().numpy().astype(np.int32)
    b, p = prompt.shape
    cache_len = p + steps + k + 2
    t_logits, t_kc, t_vc = _prefill(model, prompt, cache_len)
    committed = t_logits.argmax(dim=-1)
    first = committed.cpu().numpy().astype(np.int32)
    history = [np.concatenate([prompt_np[r], first[r:r + 1]]) for r in range(b)]

    def propose(committed_, pos_):
        return np.stack([_lookup_propose(history[r], k, ngram) for r in range(b)])

    def on_commit(emitted):
        for r in range(b):
            history[r] = np.concatenate([history[r], emitted[r].astype(np.int32)])

    return _spec_loop(model, t_kc, t_vc, committed, p, steps, k, propose, on_commit)
