"""Knowledge distillation: train a smaller labformer on a teacher's logits
(the counterpart of ``tpulab.models.distill``).

The student minimizes ``alpha * KL(teacher_T || student_T) * T^2 +
(1 - alpha) * CE(data)`` (Hinton et al. 2015): the teacher's distribution
softened at temperature T, and plain cross-entropy on the stream as the
anchor.  Each step runs the teacher's forward under ``torch.no_grad()``,
then the student's forward and backward (on the card, kernel B4 in both
forwards and B5, B6 in the backward from 1024 tokens up), then the
optimizer, in place.

``python -m tpulab_torch distill --teacher CK --out CK2`` writes a
servable student checkpoint in the port's format, with a sidecar and the
teacher's tokenizer copied in, so ``generate``/``eval --ckpt-dir`` read it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpulab_torch import optim
from tpulab_torch.models.labformer import (Labformer, LabformerConfig, _flat, _leaf_sizes,
                                            init_params)


def distill_loss_fn(student: Labformer, tokens: torch.Tensor, teacher_logits: torch.Tensor,
                    temperature: float, alpha: float) -> torch.Tensor:
    """Soft-target KL at ``temperature`` blended with data CE, in float32.

    ``teacher_logits`` are the teacher's logits over the same ``tokens``;
    both models read ``tokens[:, :-1]`` and predict ``tokens[:, 1:]``."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    s_logits = student(inputs).float()
    t_logits = teacher_logits.float()
    T = np.float32(temperature).item()
    t_soft = torch.log_softmax(t_logits / T, dim=-1)
    s_soft = torch.log_softmax(s_logits / T, dim=-1)
    # KL(teacher || student) summed over the vocab, mean over positions;
    # T^2 keeps the soft gradients' size comparable to CE's
    kl = (torch.exp(t_soft) * (t_soft - s_soft)).sum(dim=-1).mean() * T * T
    ll = torch.gather(torch.log_softmax(s_logits, dim=-1), -1, targets[..., None])[..., 0]
    ce = -ll.mean()
    a = np.float32(alpha)
    return a.item() * kl + (np.float32(1.0) - a).item() * ce


def make_distill_step(teacher: Labformer, student_cfg: LabformerConfig,
                      optimizer: Optional[optim.Transform] = None, temperature: float = 2.0,
                      alpha: float = 0.5):
    """``(optimizer, step)``: ``step(student, opt_state, tokens) ->
    (student, opt_state, loss)``, updating the student in place."""
    if teacher.cfg.vocab != student_cfg.vocab:
        raise ValueError("teacher and student must share a vocabulary")
    optimizer = optimizer or optim.adamw(1e-3)

    def step(student: Labformer, opt_state, tokens):
        tokens = student.tokens(tokens)
        with torch.no_grad():
            t_logits = teacher(tokens[:, :-1])
        leaves = _flat(student)
        for p in leaves:
            p.grad = None
        loss = distill_loss_fn(student, tokens, t_logits, temperature, alpha)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        with torch.no_grad():
            optim.apply_updates(leaves, optimizer.update(grads, opt_state, leaves))
        return student, opt_state, loss.detach()

    return optimizer, step


def distill(teacher_params, teacher_cfg: LabformerConfig, student_cfg: LabformerConfig,
            steps: int = 200, batch: int = 8, seq: int = 64, seed: int = 0,
            temperature: float = 2.0, alpha: float = 0.5, optimizer=None, batch_at=None,
            log=print, device=None) -> Tuple[Labformer, float]:
    """Train a fresh ``student_cfg`` model (``init_params(seed)``) against
    the teacher on ``device`` (the card unless ``"cpu"``); returns the
    trained student module and the last loss.

    ``batch_at(step) -> (batch, seq+1) int32`` replaces the default stream
    (the trainer's synthetic ``batches``)."""
    from tpulab_torch.train import batches

    teacher = Labformer.from_numpy(teacher_params, teacher_cfg, device)
    optimizer, step_fn = make_distill_step(teacher, student_cfg, optimizer,
                                           temperature=temperature, alpha=alpha)
    student = Labformer.from_numpy(init_params(student_cfg, seed=seed), student_cfg,
                                   teacher.device, trainable=True)
    opt_state = optimizer.init(_flat(student), _leaf_sizes(student))
    batch_at = batch_at or batches(student_cfg.vocab, batch, seq, seed)
    loss = float("nan")
    for i in range(steps):
        student, opt_state, ldev = step_fn(student, opt_state, batch_at(i))
        loss = float(ldev)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite distill loss at step {i}")
        if i % 50 == 0:
            log(f"[distill] step {i} loss {loss:.4f}")
    return student, loss


def main(argv=None) -> int:
    """``tpulab_torch distill``: compress a trained checkpoint into a
    smaller student by soft-target KL, written as a servable checkpoint
    (the port's snapshot format, a config sidecar and the copied
    tokenizer), so ``generate``/``eval --ckpt-dir <out>`` read it."""
    import argparse
    import dataclasses
    import json
    import os

    from tpulab_torch import ckpt
    from tpulab_torch.models.generate import demo_config, load_params, load_sidecar
    from tpulab_torch.models.labformer import merge_lora
    from tpulab_torch.runtime.device import BACKENDS

    ap = argparse.ArgumentParser(prog="tpulab_torch distill", description=main.__doc__)
    ap.add_argument("--teacher", required=True, metavar="CKPT_DIR")
    ap.add_argument("--out", required=True, metavar="CKPT_DIR")
    ap.add_argument("--student-layers", type=int, default=0,
                    help="default: half the teacher's layers (min 1)")
    ap.add_argument("--student-d-model", type=int, default=0,
                    help="default: the teacher's d_model")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=2.0)
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="KL weight (1-alpha on data CE)")
    ap.add_argument("--data-dir", default=None,
                    help="distill on this corpus (the teacher's tokenizer applies); "
                         "default: the synthetic stream")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    out = os.path.abspath(args.out)
    teacher_dir = os.path.abspath(args.teacher)
    if os.path.exists(out):
        # refuse rather than remove a directory this run did not make
        raise SystemExit(f"--out {out} already exists; move it or pick "
                         f"a fresh directory")

    t_cfg, tok = load_sidecar(args.teacher)
    if t_cfg is None:
        t_cfg = demo_config()
    try:
        teacher, step = load_params(t_cfg, args.teacher)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    if t_cfg.lora_rank:
        teacher, t_cfg = merge_lora(teacher, t_cfg)
    print(f"[distill] teacher: step {step}, d{t_cfg.d_model} "
          f"L{t_cfg.n_layers} vocab {t_cfg.vocab}")

    s_cfg = dataclasses.replace(
        t_cfg, n_layers=args.student_layers or max(1, t_cfg.n_layers // 2),
        d_model=args.student_d_model or t_cfg.d_model, lora_rank=0)
    print(f"[distill] student: d{s_cfg.d_model} L{s_cfg.n_layers}")

    batch_at = None
    if args.data_dir:
        from tpulab_torch.io.bpe import corpus_from_dir
        from tpulab_torch.train import corpus_windows

        corpus = corpus_from_dir(args.data_dir)
        ids = (tok.encode(corpus) if tok is not None
               else np.frombuffer(corpus, np.uint8).astype(np.int32))
        if len(ids) < args.seq + 1:
            raise SystemExit(f"corpus encodes to {len(ids)} tokens; "
                             f"need >= {args.seq + 1}")
        batch_at = corpus_windows(ids, args.batch, args.seq, args.seed)

    student, loss = distill(
        teacher, t_cfg, s_cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        seed=args.seed, temperature=args.temperature, alpha=args.alpha,
        batch_at=batch_at, device=args.backend)

    ckpt.save(out, args.steps, student)  # parameters only, as tpulab's student
    tok_src = None
    if tok is not None:
        # the teacher's sidecar names its tokenizer file
        with open(os.path.join(teacher_dir, ckpt.SIDECAR)) as f:
            tok_src = os.path.join(teacher_dir, json.load(f).get("tokenizer", "tokenizer.json"))
    ckpt.write_sidecar(out, s_cfg, tok_src)
    print(json.dumps({"out": out, "final_loss": round(loss, 4),
                      "student_layers": s_cfg.n_layers,
                      "student_d_model": s_cfg.d_model}))
    return 0
