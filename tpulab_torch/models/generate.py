"""Autoregressive decoding for the labformer: KV cache, decode loop,
sampling (the counterpart of ``tpulab.models.generate``).

Prefill is one forward over the whole prompt, whose attention takes the
path ``use_flash`` picks (kernel B4 from 1024 tokens under ``"auto"``); it
fills a pre-allocated ``(L, b, S, kv_heads, head_dim)`` cache pair.  Each
decode step runs one token through every layer against the cache.  The
JAX package jits the whole loop as one ``lax.scan``; here the loop is
eager Python over the same steps, and the cache is written in place.

Sampling draws from a ``torch.Generator`` seeded from ``seed``, on the
logits' device.  Its streams are not those of ``jax.random``: sampled
output is held to its distribution, greedy output token for token.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from tpulab_torch.models.labformer import (
    Labformer,
    LabformerConfig,
    _mlp,
    _rmsnorm,
    _rope,
    attend,
    cfg_from_dict,
    init_params,
)
from tpulab_torch.models.quant import embed_lookup, qmat, unembed
from tpulab_torch.parallel.ring import NEG_INF


def init_kv_cache(cfg: LabformerConfig, batch: int, max_seq: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    # kv_heads, not n_heads: under GQA the cache shrinks by the group factor
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _positions(pos, w: int, device: torch.device) -> torch.Tensor:
    """Positions of a w-token window: (w,) from an int ``pos``, (b, w)
    from a per-row ``pos`` (b,) tensor."""
    j = torch.arange(w, device=device)
    return pos.long()[:, None] + j if isinstance(pos, torch.Tensor) else pos + j


def _attend_cached(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   pos, window: int = 0) -> torch.Tensor:
    """q: (b, w, h, d) window at positions pos..pos+w-1; caches (b, S, kv, d).
    ``pos`` is an int shared by every row or a (b,) tensor, one per row.

    Window row r attends keys [0, pos+r] (and, with ``window``, only the
    last ``window`` of them), so cache contents past a row's own position
    (a rejected speculative draft) are never read.  Query head i reads
    cache head ``i // (h // kv)``.  q is scaled in the model dtype before
    the product and the scores widened to f32, as in the dense forward."""
    b, w, h, dh = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    q = q / torch.tensor(math.sqrt(dh), dtype=torch.float64).to(q.dtype)
    qg = q.reshape(b, w, kvh, g, dh)
    s = torch.einsum("bqcgd,bkcd->bcgqk", qg, k_cache).float()
    key_pos = torch.arange(k_cache.shape[1], device=q.device)
    q_pos = _positions(pos, w, q.device)[..., None]  # (w, 1) or (b, w, 1)
    valid = key_pos <= q_pos
    if window:
        valid = valid & (key_pos > q_pos - window)
    if valid.dim() == 3:  # per row: (b, 1, 1, w, S)
        valid = valid[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bcgqk,bkcd->bqcgd", p, v_cache.float())
    return o.reshape(b, w, h, dh).to(q.dtype)


def _decode_block(x: torch.Tensor, blk, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos, cfg: LabformerConfig) -> torch.Tensor:
    """One transformer block for a (b, w, d) window at positions
    pos..pos+w-1 (``pos`` an int, or a (b,) tensor of per-row positions);
    writes the window's K/V into the layer's caches in place."""
    b, w, _ = x.shape
    h, dh, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    xn = _rmsnorm(x, blk.ln1)
    q = qmat(xn, blk.wq).reshape(b, w, h, dh)
    k = qmat(xn, blk.wk).reshape(b, w, kvh, dh)
    v = qmat(xn, blk.wv).reshape(b, w, kvh, dh)
    positions = _positions(pos, w, x.device)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if isinstance(pos, torch.Tensor):
        rows = torch.arange(b, device=x.device)[:, None]
        k_cache[rows, positions] = k
        v_cache[rows, positions] = v
    else:
        k_cache[:, pos:pos + w] = k
        v_cache[:, pos:pos + w] = v
    o = _attend_cached(q, k_cache, v_cache, pos, cfg.attn_window)
    x = x + qmat(o.reshape(b, w, cfg.d_model), blk.wo)
    y, _ = _mlp(_rmsnorm(x, blk.ln2), blk, cfg)  # aux unused at decode
    return x + y


def _forward_window(model: Labformer, tokens: torch.Tensor, k_caches: torch.Tensor,
                    v_caches: torch.Tensor, pos):
    """tokens (b, w) at positions pos.. (an int, or (b,) per row) ->
    (logits (b, w, vocab), caches): the speculative verify scores every
    window position in one pass."""
    cfg = model.cfg
    x = embed_lookup(model.top.embed, tokens, cfg.dtype)
    for i, blk in enumerate(model.blocks):
        x = _decode_block(x, blk, k_caches[i], v_caches[i], pos, cfg)
    x = _rmsnorm(x, model.top.final_norm)
    return unembed(x, model.top.embed), k_caches, v_caches


def _forward_step(model: Labformer, token: torch.Tensor, k_caches: torch.Tensor,
                  v_caches: torch.Tensor, pos):
    """token (b,) at position ``pos`` (an int, or (b,) per row) ->
    (logits (b, vocab), caches)."""
    logits, k_caches, v_caches = _forward_window(model, token[:, None], k_caches,
                                                 v_caches, pos)
    return logits[:, 0, :], k_caches, v_caches


def _prefill(model: Labformer, prompt: torch.Tensor, cache_len: int):
    """One batched forward over the whole prompt, filling the KV caches.

    Returns ``(last_logits, k_caches, v_caches)``; the caches hold the
    prompt's kv-width K/V, zero-padded to ``cache_len``."""
    cfg = model.cfg
    b, p = prompt.shape
    h, dh, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    k_caches, v_caches = init_kv_cache(cfg, b, cache_len, prompt.device)
    x = embed_lookup(model.top.embed, prompt, cfg.dtype)
    positions = torch.arange(p, device=prompt.device)
    for i, blk in enumerate(model.blocks):
        xn = _rmsnorm(x, blk.ln1)
        q = qmat(xn, blk.wq).reshape(b, p, h, dh)
        k = qmat(xn, blk.wk).reshape(b, p, kvh, dh)
        v = qmat(xn, blk.wv).reshape(b, p, kvh, dh)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        o = attend(q, k, v, cfg, p)
        x = x + qmat(o.reshape(b, p, cfg.d_model), blk.wo)
        y, _ = _mlp(_rmsnorm(x, blk.ln2), blk, cfg)
        x = x + y
        k_caches[i, :, :p] = k
        v_caches[i, :, :p] = v
    x = _rmsnorm(x[:, -1:], model.top.final_norm)
    return unembed(x, model.top.embed)[:, 0, :], k_caches, v_caches


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF-convention repetition discount over the tokens marked in ``seen``
    (b, vocab) bool: positive logits divide by ``penalty``, negative
    multiply.  The result is f32, as ``tpulab``'s promotes."""
    logits = logits.float()
    pen = torch.as_tensor(penalty, dtype=torch.float32, device=logits.device)
    discounted = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen, discounted, logits)


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p nucleus (the
    token that crosses the boundary stays; ``top_p=0`` keeps the top one)."""
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if top_k:
        kth = torch.sort(logits, dim=-1).values[..., -min(top_k, logits.shape[-1])]
        logits = torch.where(logits < kth[..., None], NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1).values.flip(-1)
        probs = torch.softmax(sorted_logits.float(), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        exceeded = (cum - probs) > float(np.float32(max(float(top_p), 0.0)))
        cutoff = torch.where(exceeded, math.inf, sorted_logits.float()).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits.float() < cutoff, NEG_INF, logits)
    return logits


def _sample(logits: torch.Tensor, generator: torch.Generator, seen: torch.Tensor,
            temperature: float, top_k: int, top_p: float,
            repetition_penalty: float) -> torch.Tensor:
    """Next token per row: greedy at ``temperature == 0``, else a draw
    from the softmax of the scaled, filtered logits."""
    if repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    # temperature before top-p: the nucleus holds top_p of the mass sampled
    scaled = _filter_logits(logits / temperature, top_k, top_p)
    probs = torch.softmax(scaled.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(model: Labformer, prompt, steps: int = 64, temperature: float = 1.0,
             seed: int = 0, top_k: int = 0, top_p: float = 1.0,
             repetition_penalty: float = 1.0, stop_token: int = -1) -> np.ndarray:
    """Prefill ``prompt`` (b, p), then ``steps`` tokens from the cached
    decode loop; (b, steps) int32.

    Greedy when ``temperature == 0``; else categorical over the
    temperature-scaled, top-k/top-p-filtered distribution (``top_k=0`` /
    ``top_p=1.0`` disable the filters).  ``repetition_penalty > 1``
    discounts every token already in the prompt or output, greedy too.
    ``stop_token >= 0`` freezes a row once it emits that token: every later
    position repeats it.
    """
    cfg = model.cfg
    if cfg.lora_rank:
        raise ValueError(
            "generate with lora_rank > 0: fold the adapters first "
            "(labformer.merge_lora(params, cfg))"
        )
    prompt = model.tokens(prompt)
    b, p = prompt.shape
    dev = prompt.device
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    rows = torch.arange(b, device=dev)
    seen = torch.zeros((b, cfg.vocab), dtype=torch.bool, device=dev)
    if repetition_penalty != 1.0:
        seen[rows[:, None], prompt] = True

    def sample(logits):
        return _sample(logits, generator, seen, temperature, top_k, top_p,
                       repetition_penalty)

    logits, kc, vc = _prefill(model, prompt, p + steps)
    tok = sample(logits)
    done = tok == stop_token
    out = [tok]
    for i in range(steps - 1):
        if repetition_penalty != 1.0:
            seen[rows, tok] = True
        logits, kc, vc = _forward_step(model, tok, kc, vc, p + i)
        nxt = sample(logits)
        if stop_token >= 0:
            nxt = torch.where(done, stop_token, nxt)
            done = done | (nxt == stop_token)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


def demo_config() -> LabformerConfig:
    """The byte-LM demo model of the generation CLI (``tpulab``'s default)."""
    return LabformerConfig(d_model=128, n_heads=8, n_layers=4, d_ff=512,
                           max_seq=1024)


def load_sidecar(ckpt_dir: Optional[str]):
    """``(cfg | None, tokenizer | None)`` from a checkpoint's config sidecar
    (``tpulab_config.json`` and the copied tokenizer), written by either
    package's trainer or ``distill``; ``(None, None)`` when there is none."""
    if not ckpt_dir:
        return None, None
    path = os.path.join(ckpt_dir, "tpulab_config.json")
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        sidecar = json.load(f)
    cfg = cfg_from_dict(sidecar["config"])
    tok = None
    if sidecar.get("tokenizer"):
        from tpulab_torch.io.bpe import BPETokenizer

        tok = BPETokenizer.load(os.path.join(ckpt_dir, sidecar["tokenizer"]))
    return cfg, tok


def load_params(cfg: LabformerConfig, ckpt_dir: Optional[str] = None, seed: int = 0):
    """``(params, step | None)``: ``init_params(cfg, seed)``, or with
    ``ckpt_dir`` the newest snapshot's parameters in the port's format.

    A partial restore, parameters only (the optimizer state is not read):
    every leaf of ``cfg``'s tree must be in the snapshot with its shape,
    and is cast to ``cfg.dtype``; snapshot leaves the tree lacks are left
    out.  An orbax directory raises ``ValueError``, one with no snapshot
    ``FileNotFoundError``."""
    from tpulab_torch import ckpt

    params = init_params(cfg, seed=seed)
    if not ckpt_dir:
        return params, None
    path = os.path.abspath(ckpt_dir)
    step = ckpt.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir} (no {ckpt.FORMAT} "
                                f"snapshot)")
    saved = ckpt.read_params(path, step)

    def take(key, like, got):
        if got is None:
            raise ValueError(f"{ckpt_dir} step {step}: the snapshot has no leaf {key}")
        if tuple(got.shape) != tuple(like.shape):
            raise ValueError(f"{ckpt_dir} step {step}: leaf {key} is {tuple(got.shape)}, "
                             f"the config wants {tuple(like.shape)}")
        return got.to(like.dtype)

    out = {k: take(k, v, saved.get(k)) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: take(f"blocks/{k}", v, saved["blocks"].get(k))
                     for k, v in params["blocks"].items()}
    return out, step


def main(argv=None) -> int:
    """``tpulab_torch generate``: sampling from the labformer, with random
    weights from ``--seed`` unless ``--ckpt-dir`` names a snapshot."""
    import argparse
    import dataclasses

    from tpulab_torch.runtime.device import BACKENDS, resolve_device

    ap = argparse.ArgumentParser(prog="tpulab_torch generate", description=main.__doc__)
    ap.add_argument("--prompt", default="hello")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k most likely tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling probability mass (1.0 = off)")
    ap.add_argument("--repetition-penalty", type=float, default=1.0,
                    help="discount tokens already in the prompt or output, HF "
                         "convention (1.0 = off; applies to greedy too)")
    ap.add_argument("--stop-byte", type=int, default=-1,
                    help="freeze a row once it emits this byte; output is "
                         "trimmed at its first occurrence (-1 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest snapshot of a training run (the port's format); "
                         "its sidecar sets the architecture and tokenizer")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="the checkpoint was finetuned with this LoRA rank: restore the "
                         "adapters too and fold them (merge_lora) before serving")
    ap.add_argument("--lora-alpha", type=float, default=None,
                    help="LoRA scale numerator used at finetune time (default: the "
                         "sidecar's value, else 16.0)")
    ap.add_argument("--tokenizer", default=None, metavar="TOK_JSON",
                    help="BPE table the checkpoint was trained with: sets the vocab, "
                         "encodes the prompt, decodes the output")
    ap.add_argument("--speculative", action="store_true",
                    help="greedy speculative decode with the int8-quantized "
                         "model as draft (lossless: plain greedy's tokens)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per verify round")
    ap.add_argument("--prompt-lookup", action="store_true",
                    help="draft-free greedy speculative decoding: n-gram "
                         "proposals from the committed sequence (lossless)")
    ap.add_argument("--lookup-ngram", type=int, default=3,
                    help="n-gram length the lookup proposer matches")
    args = ap.parse_args(argv)

    device = resolve_device(args.backend)
    # precedence as tpulab's: the sidecar's config, then the tokenizer's
    # vocab, then the LoRA flags (--lora-alpha None keeps the trained alpha)
    sc_cfg, tok = load_sidecar(args.ckpt_dir)
    if sc_cfg is not None:
        cfg = sc_cfg
        print(f"[generate] config sidecar: d{cfg.d_model} L{cfg.n_layers} vocab {cfg.vocab}"
              + (f" lora r{cfg.lora_rank}" if cfg.lora_rank else ""))
    else:
        cfg = demo_config()
    if args.tokenizer:
        from tpulab_torch.io.bpe import BPETokenizer

        tok = BPETokenizer.load(args.tokenizer)
    if tok is not None and tok.vocab != cfg.vocab:
        cfg = dataclasses.replace(cfg, vocab=tok.vocab)
    if args.lora_rank and args.lora_rank != cfg.lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=args.lora_rank)
    if args.lora_alpha is not None and args.lora_alpha != cfg.lora_alpha:
        cfg = dataclasses.replace(cfg, lora_alpha=args.lora_alpha)
    try:
        params, step = load_params(cfg, args.ckpt_dir, seed=args.seed)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    if step is not None:
        print(f"[generate] loaded checkpoint step {step}")
    if cfg.lora_rank:
        from tpulab_torch.models.labformer import merge_lora

        rank = cfg.lora_rank
        params, cfg = merge_lora(params, cfg)
        print(f"[generate] merged LoRA adapters (rank {rank})")

    # a stop byte is a byte in any token space: under BPE it is found in
    # the decoded bytes (it may sit inside a merged token)
    stop_limit = 256 if tok is not None else cfg.vocab
    if args.stop_byte >= stop_limit:
        raise SystemExit(
            f"--stop-byte must be a byte in [0, {stop_limit - 1}] (or -1 "
            f"= off); got {args.stop_byte}"
        )

    def refuse_sampling_flags(what: str, *extra: str):
        """A deterministic strategy refuses every sampling flag."""
        if (args.temperature not in (0.0, 1.0) or args.top_k
                or args.top_p != 1.0 or args.repetition_penalty != 1.0
                or args.stop_byte >= 0
                or any(getattr(args, e.replace("-", "_")) for e in extra)):
            raise SystemExit(
                f"{what} is deterministic; drop --temperature/--top-k/"
                f"--top-p/--repetition-penalty/--stop-byte"
                + "".join(f"/--{e}" for e in extra))

    model = Labformer.from_numpy(params, cfg, device)
    raw = args.prompt.encode("utf-8")
    prompt = (tok.encode(raw)[None, :] if tok is not None
              else np.frombuffer(raw, np.uint8)[None, :]).astype(np.int32)
    if args.prompt_lookup:
        refuse_sampling_flags("--prompt-lookup", "speculative")
        if args.draft_k < 1:
            raise SystemExit(f"--draft-k must be >= 1, got {args.draft_k}")
        if args.lookup_ngram < 1:
            raise SystemExit(f"--lookup-ngram must be >= 1, got {args.lookup_ngram}")
        from tpulab_torch.models.speculative import prompt_lookup_generate

        out, acc = prompt_lookup_generate(model, prompt, steps=args.steps, k=args.draft_k,
                                          ngram=args.lookup_ngram)
        print(f"[prompt-lookup] mean accepted {acc:.2f}/{args.draft_k} per round",
              file=sys.stderr)
    elif args.speculative:
        refuse_sampling_flags("--speculative")
        if args.draft_k < 1:
            raise SystemExit(f"--draft-k must be >= 1, got {args.draft_k}")
        from tpulab_torch.models.quant import quantize_decode_params
        from tpulab_torch.models.speculative import speculative_generate

        draft = Labformer.from_numpy(quantize_decode_params(params, cfg), cfg, device)
        out, acc = speculative_generate(draft, model, prompt, steps=args.steps,
                                        k=args.draft_k)
        print(f"[speculative] mean accepted {acc:.2f}/{args.draft_k} per round",
              file=sys.stderr)
    else:
        # the in-loop freeze matches raw ids; under BPE the stop byte is
        # also looked for in the decoded bytes below
        out = generate(model, prompt, steps=args.steps, temperature=args.temperature,
                       seed=args.seed, top_k=args.top_k, top_p=args.top_p,
                       repetition_penalty=args.repetition_penalty,
                       stop_token=args.stop_byte)
    # the stop byte is the final token and is kept in the text
    toks = [int(t) for t in out[0]]
    if tok is None:
        if args.stop_byte >= 0 and args.stop_byte in toks:
            toks = toks[: toks.index(args.stop_byte) + 1]
        data = bytes(t & 0xFF for t in toks)
    else:
        data = tok.decode(toks)
        if args.stop_byte >= 0:
            cut = data.find(bytes([args.stop_byte]))
            if cut >= 0:
                data = data[: cut + 1]
    sys.stdout.write(args.prompt + data.decode("utf-8", errors="replace") + "\n")
    return 0
