"""Training loop for the labformer on one device (the counterpart of
``tpulab.train``).

``python -m tpulab_torch train`` runs :func:`main`; the step is
:func:`tpulab_torch.models.labformer.make_train_step`, whose flash
attention runs kernels B4, B5 and B6 on the card (``--backend cuda``, the
default) and their plain versions on the host (``--backend cpu``).

Data: the same deterministic synthetic byte stream as ``tpulab``
(:func:`batches`, a copy), so the two packages see the same batches at the
same steps; evaluation reads the same held-out stream.  A non-finite loss
fails fast (``FloatingPointError``), and ``inject_fault`` fakes one to show
it.  ``overlap`` = 1 reads each step's loss one step late, so the host
enqueues the next step before it waits for the card; the ``[train]`` lines
keep their exact step/loss pairing either way.

What this slice does not port raises ``NotImplementedError`` naming its
ROADMAP item: checkpoints (``ckpt_dir``, ``resume``, ``recover``,
``save_every``) need a format of the port's own; ``data_dir``,
``tokenizer``, ``init_from``, the mesh and ZeRO options, fused
``steps_per_call``, ``remat_policy="dots"``, ``model="labvision"``,
``trace_dir`` and ``sanitize``.  The ``[train] metrics`` line waits for the
port of ``tpulab.obs`` (A11).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import deque
from typing import Optional

import numpy as np

#: optimizer names of ``tpulab.train`` (the CLI's choices); lion and
#: adafactor are refused with a pointer to their ROADMAP item
_OPTIMIZERS = ("adamw", "lion", "adafactor", "sgd")


def batches(vocab: int, batch: int, seq: int, seed: int):
    """Deterministic infinite batch stream, indexable by step (a copy of
    ``tpulab.train.batches``)."""
    def batch_at(step: int) -> np.ndarray:
        rng = np.random.default_rng((seed << 20) ^ step)
        base = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
        # inject structure so the loss can actually fall: runs of repeats
        rep = rng.integers(0, vocab, (batch, 1), dtype=np.int64)
        mask = rng.random((batch, seq + 1)) < 0.5
        return np.where(mask, rep, base).astype(np.int32)

    return batch_at


def build_optimizer(lr: float, steps: int, warmup_steps: int = 0, schedule: str = "const",
                    clip_norm: float = 0.0, optimizer: str = "adamw"):
    """``tpulab.train.build_optimizer`` on :mod:`tpulab_torch.optim`:
    optional global-norm clipping, then adamw or sgd (momentum 0.9) on a
    constant, linear-warmup or warmup-cosine schedule."""
    from tpulab_torch import optim

    if schedule == "cosine":
        sched = optim.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup_steps else lr, peak_value=lr,
            warmup_steps=warmup_steps, decay_steps=max(steps, warmup_steps + 1))
    elif schedule == "const":
        sched = optim.linear_schedule(0.0, lr, warmup_steps) if warmup_steps else lr
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if optimizer in ("lion", "adafactor"):
        raise NotImplementedError(
            f"optimizer {optimizer!r} is queued in ROADMAP A8.5; the port has adamw and sgd")
    makers = {"adamw": optim.adamw, "sgd": lambda s: optim.sgd(s, momentum=0.9)}
    if optimizer not in makers:
        raise ValueError(f"unknown optimizer {optimizer!r}; expected one of {_OPTIMIZERS}")
    chain = [optim.clip_by_global_norm(clip_norm)] if clip_norm else []
    return optim.chain(*chain, makers[optimizer](sched))


def _refuse_unported(**given) -> None:
    """NotImplementedError for every argument this slice does not port."""
    queued = {
        "ckpt_dir": "checkpoints need a format of the port's own (ROADMAP A8.1)",
        "resume": "resume needs the port's checkpoint format (ROADMAP A8.1)",
        "recover": "recover rolls back to checkpoints, which wait for ROADMAP A8.1",
        "save_every": "save_every needs the port's checkpoint format (ROADMAP A8.1)",
        "data_dir": "data_dir needs the native loader's port (ROADMAP A8.2)",
        "tokenizer": "the BPE tokenizer is queued in ROADMAP A8.3",
        "init_from": "init_from reads a checkpoint, which waits for ROADMAP A8.4",
        "mesh_devices": "mesh training waits for the multi-device tier (ROADMAP A12)",
        "zero1": "ZeRO-1 shards over a mesh (ROADMAP A12)",
        "zero2": "ZeRO-2 shards over a mesh (ROADMAP A12)",
        "steps_per_call": "fused multi-step calls are CUDA-graph work (ROADMAP A8.6)",
        "remat_policy": "remat_policy='dots' is queued in ROADMAP A8.7",
        "model": "labvision is queued in ROADMAP A8.8",
        "moe_impl": "dispatch MoE routes over a mesh (ROADMAP A12)",
        "trace_dir": "the profiler hook is queued in ROADMAP A8.10",
        "sanitize": "sanitize (NaN trapping) is queued in ROADMAP A8.10",
    }
    for name, value in given.items():
        if value:
            raise NotImplementedError(f"{name}: {queued[name]}")


def train(
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    ckpt_dir: Optional[str] = None,
    save_every: int = 20,
    resume: bool = False,
    mesh_devices: int = 0,
    seed: int = 0,
    sanitize: bool = False,
    trace_dir: Optional[str] = None,
    log=print,
    cfg=None,
    optimizer=None,
    accum: int = 1,
    remat: bool = False,
    remat_policy: str = "none",
    experts: int = 0,
    moe_impl: str = "dense",
    moe_aux_weight: float = 0.01,
    moe_top_k: int = 1,
    model: str = "labformer",
    eval_every: int = 0,
    eval_batches: int = 4,
    lr: float = 0.0,
    warmup_steps: int = 0,
    schedule: str = "const",
    clip_norm: float = 0.0,
    zero1: bool = False,
    zero2: bool = False,
    data_dir: Optional[str] = None,
    recover: int = 0,
    inject_fault: tuple = (),
    lora_rank: int = 0,
    lora_alpha: float = 16.0,
    init_from: Optional[str] = None,
    tokenizer: Optional[str] = None,
    opt_name: str = "adamw",
    steps_per_call: int = 1,
    overlap: int = 1,
    log_every: int = 1,
    device=None,
):
    """Run the loop on ``device`` (the card unless ``"cpu"``); returns
    ``(final_step, last_loss)``.  Arguments as ``tpulab.train.train``.

    ``eval_every > 0`` logs a held-out loss every that many steps, from
    the parameters after that step's update.  ``overlap`` (>= 0) keeps that
    many steps in flight before their losses are read; a final drain reads
    the rest.  ``log_every`` emits ``[train]`` lines every N steps (every
    loss is still checked).
    """
    import torch

    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.runtime.device import resolve_device

    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if log_every < 1:
        raise ValueError(f"log_every must be >= 1, got {log_every}")
    if overlap < 0:
        raise ValueError(f"overlap must be >= 0, got {overlap}")
    _refuse_unported(
        ckpt_dir=ckpt_dir, resume=resume, recover=recover, save_every=save_every != 20,
        data_dir=data_dir, tokenizer=tokenizer, init_from=init_from,
        mesh_devices=mesh_devices, zero1=zero1, zero2=zero2,
        steps_per_call=steps_per_call > 1, remat_policy=remat_policy != "none",
        model=model != "labformer", moe_impl=moe_impl != "dense", trace_dir=trace_dir,
        sanitize=sanitize)
    inject_fault = tuple(inject_fault or ())
    device = resolve_device(device) if device is None or isinstance(device, str) \
        else torch.device(device)

    if optimizer is None and (lr or warmup_steps or schedule != "const"
                              or clip_norm or opt_name != "adamw"):
        optimizer = build_optimizer(lr=lr or 3e-4, steps=steps, warmup_steps=warmup_steps,
                                    schedule=schedule, clip_norm=clip_norm,
                                    optimizer=opt_name)
    cfg = cfg or LabformerConfig(
        vocab=256, d_model=128, n_heads=8, n_layers=4, d_ff=512, max_seq=seq,
        remat=remat, remat_policy=remat_policy, n_experts=experts, moe_impl=moe_impl,
        moe_aux_weight=moe_aux_weight, moe_top_k=moe_top_k, lora_rank=lora_rank,
        lora_alpha=lora_alpha)
    net, opt_state, train_step = init_train_state(cfg, None, seed=seed, optimizer=optimizer,
                                                  accum=accum, device=device)
    batch_at = batches(cfg.vocab, batch, seq, seed)
    # disjoint seed space: the training stream hashes (seed<<20)^step
    val_at = batches(cfg.vocab, batch, seq, seed + 104729)

    def eval_loss() -> float:
        # every val batch enqueued, then read: the same float sum as tpulab
        with torch.no_grad():
            losses = [net.loss_fn(val_at(j)) for j in range(eval_batches)]
        return sum(float(v) for v in losses) / eval_batches

    loss = float("nan")
    pending: deque = deque()  # (step, device loss, host time at dispatch)
    counters = {"dispatches": 0, "fused_calls": 0, "host_syncs": 0}

    def drain_oldest() -> None:
        """Read and check the oldest in-flight step's loss (waits for it)."""
        nonlocal loss
        s, ldev, t0 = pending.popleft()
        lv = float(ldev)
        ms = (time.perf_counter() - t0) * 1e3
        if s in inject_fault:
            log(f"[fault] injected non-finite loss at step {s}")
            lv = float("nan")
        if not np.isfinite(lv):
            raise FloatingPointError(f"non-finite loss {lv} at step {s}")
        loss = lv
        if s % log_every == 0:
            log(f"[train] step {s} loss {lv:.4f} ({ms:.1f} ms)")

    for step in range(steps):
        t0 = time.perf_counter()
        net, opt_state, ldev = train_step(net, opt_state, batch_at(step))
        counters["dispatches"] += 1
        pending.append((step, ldev, t0))
        at_eval = bool(eval_every and (step + 1) % eval_every == 0)
        barrier = at_eval or step + 1 >= steps
        if barrier and overlap and pending:
            counters["host_syncs"] += 1  # window closed early
        while pending and (barrier or len(pending) > overlap):
            drain_oldest()
        if at_eval:
            log(f"[eval] step {step} val_loss {eval_loss():.4f}")
    if counters["dispatches"]:
        log(f"[train] counters dispatches={counters['dispatches']} "
            f"fused_calls={counters['fused_calls']} host_syncs={counters['host_syncs']} "
            f"steps_per_call={steps_per_call} overlap={overlap}")
    return steps, loss


def main(argv=None) -> int:
    from tpulab_torch.runtime.device import BACKENDS

    ap = argparse.ArgumentParser(prog="tpulab_torch train", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="cuda (default; no fallback) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None, help="not ported (ROADMAP A8.1)")
    ap.add_argument("--save-every", type=int, default=20, help="not ported (ROADMAP A8.1)")
    ap.add_argument("--resume", action="store_true", help="not ported (ROADMAP A8.1)")
    ap.add_argument("--mesh", type=int, default=0, help="not ported (ROADMAP A12)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sanitize", action="store_true", help="not ported (ROADMAP A8.10)")
    ap.add_argument("--trace-dir", default=None, help="not ported (ROADMAP A8.10)")
    ap.add_argument("--accum", type=int, default=1, help="gradient-accumulation microbatches")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize each block in the backward (torch.utils.checkpoint)")
    ap.add_argument("--remat-policy", default="none", choices=("none", "dots"),
                    help="none; dots is not ported (ROADMAP A8.7)")
    ap.add_argument("--experts", type=int, default=0, help="MoE experts (0 = dense MLP)")
    ap.add_argument("--moe-impl", default="dense", choices=("dense", "dispatch"),
                    help="dense; dispatch is not ported (ROADMAP A12)")
    ap.add_argument("--moe-aux-weight", type=float, default=0.01,
                    help="switch-transformer router load-balancing loss weight")
    ap.add_argument("--moe-top-k", type=int, default=1,
                    help="experts per token: 1 = switch, 2+ = renormalized combination")
    ap.add_argument("--model", default="labformer", choices=("labformer", "labvision"),
                    help="labformer; labvision is not ported (ROADMAP A8.8)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out loss every N steps (0 = off)")
    ap.add_argument("--lr", type=float, default=0.0, help="peak learning rate")
    ap.add_argument("--optimizer", default="adamw", choices=_OPTIMIZERS,
                    help="adamw (default) | sgd (momentum 0.9); lion and adafactor are "
                         "not ported (ROADMAP A8.5)")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--schedule", default="const", choices=("const", "cosine"))
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="global gradient-norm clip (0 = off)")
    ap.add_argument("--zero1", action="store_true", help="not ported (ROADMAP A12)")
    ap.add_argument("--zero2", action="store_true", help="not ported (ROADMAP A12)")
    ap.add_argument("--recover", type=int, default=0, help="not ported (ROADMAP A8.1)")
    ap.add_argument("--inject-fault", type=int, action="append", default=[], metavar="STEP",
                    help="fake a non-finite loss at STEP: the run fails fast")
    ap.add_argument("--data-dir", default=None, help="not ported (ROADMAP A8.2)")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="LoRA finetuning: adapter rank (0 = full training)")
    ap.add_argument("--lora-alpha", type=float, default=16.0,
                    help="LoRA scale numerator (delta = A@B * alpha/rank)")
    ap.add_argument("--init-from", default=None, help="not ported (ROADMAP A8.4)")
    ap.add_argument("--tokenizer", default=None, help="not ported (ROADMAP A8.3)")
    ap.add_argument("--steps-per-call", type=int, default=1, metavar="K",
                    help="1; K > 1 is not ported (ROADMAP A8.6)")
    ap.add_argument("--overlap", type=int, default=1, choices=(0, 1),
                    help="1 (default) reads each loss one step late; 0 waits every step")
    ap.add_argument("--log-every", type=int, default=1, metavar="N",
                    help="emit [train] lines every N steps")
    args = ap.parse_args(argv)
    step, loss = train(
        model=args.model, eval_every=args.eval_every, lr=args.lr,
        warmup_steps=args.warmup_steps, schedule=args.schedule, clip_norm=args.clip_norm,
        steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        save_every=args.save_every, resume=args.resume, mesh_devices=args.mesh,
        seed=args.seed, sanitize=args.sanitize, trace_dir=args.trace_dir, accum=args.accum,
        remat=args.remat, remat_policy=args.remat_policy, experts=args.experts,
        moe_impl=args.moe_impl, moe_aux_weight=args.moe_aux_weight,
        moe_top_k=args.moe_top_k, zero1=args.zero1, zero2=args.zero2,
        data_dir=args.data_dir, recover=args.recover,
        inject_fault=tuple(args.inject_fault), lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha, init_from=args.init_from, tokenizer=args.tokenizer,
        opt_name=args.optimizer, steps_per_call=args.steps_per_call, overlap=args.overlap,
        log_every=args.log_every, device=args.backend,
    )
    print(json.dumps({"final_step": step, "loss": loss}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
