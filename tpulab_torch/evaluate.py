"""``tpulab_torch eval``: held-out evaluation of a checkpoint (the
counterpart of ``tpulab.evaluate``).

The labformer's cross-entropy on fresh windows of a corpus (bytes, or BPE
ids when the checkpoint's sidecar names a tokenizer) or of the trainer's
synthetic evaluation stream, reported as mean loss (nats per token),
perplexity and bits per byte, which compares a byte model with a BPE
model of any vocab.  The sidecar sets the architecture; LoRA adapters are
merged first.  Runs on the card unless ``--backend cpu``; at ``--seq``
from 1024 up the forward's attention is kernel B4.

Usage: python -m tpulab_torch eval --ckpt-dir CK [--data-dir D] [--batches N]
       [--batch B] [--seq S] [--seed N] [--backend cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np


def evaluate(ckpt_dir: str, data_dir: Optional[str] = None, *, batches: int = 8,
             batch: int = 8, seq: int = 128, seed: int = 0, limit_bytes: int = 1 << 24,
             device=None) -> dict:
    """The report of ``tpulab.evaluate.evaluate`` (the same keys)."""
    import torch

    from tpulab_torch.models.generate import demo_config, load_params, load_sidecar
    from tpulab_torch.models.labformer import Labformer, merge_lora

    cfg, tok = load_sidecar(ckpt_dir)
    if cfg is None:
        cfg = demo_config()
    params, step = load_params(cfg, ckpt_dir)
    if cfg.lora_rank:
        params, cfg = merge_lora(params, cfg)

    corpus_bytes = truncated = None
    if data_dir:
        from tpulab_torch.io.bpe import corpus_from_dir

        # one byte past the limit tells "exactly at the limit" from "capped"
        corpus = corpus_from_dir(data_dir, limit_bytes + 1)
        truncated = len(corpus) > limit_bytes
        corpus = corpus[:limit_bytes]
        corpus_bytes = len(corpus)
        ids = (tok.encode(corpus) if tok is not None
               else np.frombuffer(corpus, np.uint8).astype(np.int32))
        if len(ids) < seq + 1:
            raise ValueError(f"corpus encodes to {len(ids)} tokens; need >= {seq + 1}")

        def window_at(j):
            rng = np.random.default_rng((seed << 24) ^ (7919 * (j + 1)))
            starts = rng.integers(0, len(ids) - seq, batch)
            return np.stack([ids[s:s + seq + 1] for s in starts])
    else:
        if tok is not None:
            raise ValueError(
                "a BPE checkpoint needs --data-dir (the synthetic "
                "stream is byte-space noise, meaningless in its vocab)")
        # the stream the trainer's --eval-every reports on
        from tpulab_torch.train import batches as stream

        window_at = stream(cfg.vocab, batch, seq, seed + 104729)

    model = Labformer.from_numpy(params, cfg, device)
    total_nats = 0.0
    total_tokens = 0
    total_bytes = 0
    with torch.inference_mode():
        for j in range(batches):
            win = window_at(j)
            loss = float(model.loss_fn(win))  # nats per token
            n_pred = win.shape[0] * (win.shape[1] - 1)
            total_nats += loss * n_pred
            total_tokens += n_pred
            # the bytes the predicted tokens (win[:, 1:]) cover
            if tok is None:
                total_bytes += n_pred
            else:
                total_bytes += sum(len(tok.decode(row[1:])) for row in np.asarray(win))

    mean_loss = total_nats / total_tokens
    report = {
        "ckpt_dir": ckpt_dir,
        "step": step,
        "data": data_dir or "synthetic",
        "tokenizer_vocab": (tok.vocab if tok is not None else None),
        "batches": batches,
        "tokens": total_tokens,
        "loss_nats_per_token": round(mean_loss, 4),
        "perplexity": round(float(np.exp(mean_loss)), 3),
        "bits_per_byte": round(total_nats / np.log(2.0) / total_bytes, 4),
    }
    if corpus_bytes is not None:
        report["corpus_bytes"] = corpus_bytes
        report["corpus_truncated_at_limit"] = bool(truncated)
    return report


def main(argv=None) -> int:
    from tpulab_torch.runtime.device import BACKENDS

    ap = argparse.ArgumentParser(prog="tpulab_torch eval", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--data-dir", default=None,
                    help="held-out corpus dir (default: synthetic stream; "
                         "required for BPE checkpoints)")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--limit-bytes", type=int, default=1 << 24,
                    help="corpus read cap; the report flags truncation")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        report = evaluate(args.ckpt_dir, args.data_dir, batches=args.batches,
                          batch=args.batch, seq=args.seq, seed=args.seed,
                          limit_bytes=args.limit_bytes, device=args.backend)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
