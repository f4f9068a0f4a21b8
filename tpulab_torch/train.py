"""Training loop for the labformer on one device (the counterpart of
``tpulab.train``).

``python -m tpulab_torch train`` runs :func:`main`; the step is
:func:`tpulab_torch.models.labformer.make_train_step`, whose flash
attention runs kernels B4, B5 and B6 on the card (``--backend cuda``, the
default) and their plain versions on the host (``--backend cpu``).

Data: the same deterministic synthetic byte stream as ``tpulab``
(:func:`batches`, a copy), so the two packages see the same batches at the
same steps; with ``data_dir``, the native loader's byte stream
(:mod:`tpulab_torch.io.loader`), opened at the first step run so a resumed
run replays the same tokens; with ``tokenizer`` too, random windows of the
BPE-encoded corpus (:func:`corpus_windows`), its tail held out for
evaluation.  A non-finite loss fails fast (``FloatingPointError``), and
``inject_fault`` fakes one, once a step.  ``overlap`` = 1 reads each
step's loss one step late, so the host enqueues the next step before it
waits for the card; the ``[train]`` lines keep their exact step/loss
pairing either way.

Checkpoints (:mod:`tpulab_torch.ckpt`, the port's own format): with
``ckpt_dir`` a snapshot of the parameters and the optimizer state every
``save_every`` steps, the config sidecar ``tpulab`` writes, ``resume``
from the newest snapshot, ``recover`` (roll back to it on a non-finite
loss, at most that many times), and ``init_from`` (a snapshot's base
weights into a fresh run, the optimizer clean: the pretrain to LoRA
bridge).  A resumed or recovered run is bit-equal to an uninterrupted one.

What the port does not have raises ``NotImplementedError`` naming its
ROADMAP item: the mesh and ZeRO options, fused ``steps_per_call``,
``remat_policy="dots"``, ``model="labvision"``, ``trace_dir`` and
``sanitize``.  The ``[train] metrics`` line waits for the port of
``tpulab.obs`` (A11).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
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


def corpus_windows(src: np.ndarray, batch: int, seq: int, seed: int):
    """Deterministic random windows over a token array (a copy of
    ``tpulab.train.corpus_windows``): the encoded-corpus stream, its
    held-out evaluation and ``distill --data-dir`` all sample with it."""
    def batch_at(step: int) -> np.ndarray:
        rng = np.random.default_rng((seed << 20) ^ step)
        starts = rng.integers(0, len(src) - seq, batch)
        return np.stack([src[s:s + seq + 1] for s in starts])

    return batch_at


def _refuse_unported(**given) -> None:
    """NotImplementedError for every argument the port does not have."""
    queued = {
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


def _warm_start(model, cfg, init_from: str) -> None:
    """Graft a snapshot's base weights into the fresh model, in place
    (``tpulab.train._warm_start``): the optimizer state stays clean, and
    LoRA adapters keep their zero-delta init."""
    from tpulab_torch.models.generate import load_params
    from tpulab_torch.models.labformer import _join_lora, _split_lora

    base_cfg = dataclasses.replace(cfg, lora_rank=0) if cfg.lora_rank else cfg
    restored, _ = load_params(base_cfg, init_from)  # raises when there is no snapshot
    lora, live_base = _split_lora(model.to_tree())
    if set(restored["blocks"]) != set(live_base["blocks"]):
        raise ValueError(f"{init_from}: snapshot leaves {sorted(restored['blocks'])} differ "
                         f"from the model's {sorted(live_base['blocks'])}")
    model.assign(_join_lora(restored, lora))


def _check_resume_config(sc_path: str, cfg) -> None:
    """Refuse a resume whose config differs from the sidecar's (which
    serving reads).  A key the sidecar does not record (written before the
    field existed) matches while this run leaves it at its default."""
    from tpulab_torch.models.labformer import LabformerConfig, cfg_to_dict

    with open(sc_path) as f:
        recorded = json.load(f).get("config", {})
    current = cfg_to_dict(cfg)
    defaults = cfg_to_dict(LabformerConfig())
    diff = {}
    for k in sorted(set(recorded) | set(current)):
        if k in recorded:
            if recorded[k] != current.get(k):
                diff[k] = (recorded[k], current.get(k))
        elif current.get(k) != defaults.get(k):
            diff[k] = ("<not recorded>", current.get(k))
    if diff:
        detail = ", ".join(f"{k}: sidecar={a!r} flags={b!r}" for k, (a, b) in diff.items())
        raise ValueError(
            "resume config mismatch — the checkpoint sidecar "
            f"({sc_path}) records a different architecture than "
            f"this invocation's flags ({detail}); re-pass the "
            "original flags or use a fresh --ckpt-dir")


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
    many steps in flight before their losses are read; an eval, a save, a
    rollback and the end drain the rest.  ``log_every`` emits ``[train]``
    lines every N steps (every loss is still checked).
    """
    import torch

    from tpulab_torch import ckpt
    from tpulab_torch.models.labformer import LabformerConfig, init_train_state
    from tpulab_torch.runtime.device import resolve_device

    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if log_every < 1:
        raise ValueError(f"log_every must be >= 1, got {log_every}")
    if overlap < 0:
        raise ValueError(f"overlap must be >= 0, got {overlap}")
    _refuse_unported(
        mesh_devices=mesh_devices, zero1=zero1, zero2=zero2,
        steps_per_call=steps_per_call > 1, remat_policy=remat_policy != "none",
        model=model != "labformer", moe_impl=moe_impl != "dense", trace_dir=trace_dir,
        sanitize=sanitize)
    if recover and not ckpt_dir:
        raise ValueError(
            "--recover rolls back to checkpoints: give --ckpt-dir (and a "
            "save_every that snapshots often enough to bound lost work)")
    if init_from and resume:
        raise ValueError(
            "init_from (params-only warm start, fresh optimizer) and "
            "resume (full state restore) are mutually exclusive")
    inject_fault = tuple(inject_fault or ())
    device = resolve_device(device) if device is None or isinstance(device, str) \
        else torch.device(device)

    if optimizer is None and (lr or warmup_steps or schedule != "const"
                              or clip_norm or opt_name != "adamw"):
        optimizer = build_optimizer(lr=lr or 3e-4, steps=steps, warmup_steps=warmup_steps,
                                    schedule=schedule, clip_norm=clip_norm,
                                    optimizer=opt_name)
    tok = None
    if tokenizer:
        # the vocab comes from the merge table, and batches sample the
        # encoded corpus (the byte loader streams the wrong token space)
        if not data_dir:
            raise ValueError("--tokenizer encodes a corpus: give --data-dir too")
        from tpulab_torch.io.bpe import BPETokenizer

        tok = BPETokenizer.load(tokenizer)
        if cfg is not None and cfg.vocab < tok.vocab:
            raise ValueError(
                f"cfg.vocab={cfg.vocab} < tokenizer vocab {tok.vocab}: "
                f"encoded ids would silently clamp in the embedding")
    cfg = cfg or LabformerConfig(
        vocab=tok.vocab if tok else 256, d_model=128, n_heads=8, n_layers=4, d_ff=512,
        max_seq=seq, remat=remat, remat_policy=remat_policy, n_experts=experts,
        moe_impl=moe_impl, moe_aux_weight=moe_aux_weight, moe_top_k=moe_top_k,
        lora_rank=lora_rank, lora_alpha=lora_alpha)
    net, opt_state, train_step = init_train_state(cfg, None, seed=seed, optimizer=optimizer,
                                                  accum=accum, device=device)
    if init_from:
        _warm_start(net, cfg, init_from)

    box: dict = {}  # the open native loader, closed in the finally below

    def eval_of(losses) -> float:
        # every val batch enqueued, then read: the same float sum as tpulab
        return sum(float(v) for v in losses) / eval_batches

    if tok is not None:
        from tpulab_torch.io.bpe import corpus_from_dir

        ids = tok.encode(corpus_from_dir(data_dir))
        # held-out tail for eval: ~10 %, at least eval_batches windows; the
        # size check counts the tail it carves off
        hold = max((seq + 1) * max(eval_batches, 1), len(ids) // 10)
        need = (seq + 1) * max(4, batch)
        if len(ids) < need + hold:
            raise ValueError(
                f"corpus encodes to {len(ids)} tokens; need >= "
                f"{need + hold} (train windows {need} + eval tail "
                f"{hold}) for seq={seq} batch={batch}")
        train_ids, val_ids = ids[:-hold], ids[-hold:]
        batch_at = corpus_windows(train_ids, batch, seq, seed)
        val_at = corpus_windows(val_ids, batch, seq, seed + 104729)

        def eval_loss(step: int) -> float:
            # keyed by the train step, so a resumed run replays the windows
            n_eval = step // eval_every if eval_every else 0
            with torch.no_grad():
                return eval_of([net.loss_fn(val_at(n_eval * eval_batches + j))
                                for j in range(eval_batches)])
    elif data_dir:
        from tpulab_torch.io.loader import TokenLoader

        def batch_at(step: int) -> np.ndarray:
            # opened at the first step run (after a restore), read in order
            if "l" not in box:
                box["l"] = TokenLoader.from_dir(data_dir, batch=batch, row_tokens=seq + 1,
                                                seed=seed, start_step=step)
            return box["l"].next()

        def eval_loss(step: int) -> float:
            # the same corpus at another seed; eval n reads val steps
            # [n * eval_batches, ...), so a resumed run replays them
            n_eval = step // eval_every if eval_every else 0
            with TokenLoader.from_dir(data_dir, batch=batch, row_tokens=seq + 1,
                                      seed=seed + 104729,
                                      start_step=n_eval * eval_batches) as val:
                with torch.no_grad():
                    out = eval_of([net.loss_fn(val.next()) for _ in range(eval_batches)])
                if val.short_reads():
                    log(f"[eval] WARNING: {val.short_reads()} val rows "
                        f"zero-padded by short reads (IO errors)")
            return out
    else:
        batch_at = batches(cfg.vocab, batch, seq, seed)
        # disjoint seed space: the training stream hashes (seed<<20)^step
        val_at = batches(cfg.vocab, batch, seq, seed + 104729)

        def eval_loss(step: int) -> float:
            with torch.no_grad():
                return eval_of([net.loss_fn(val_at(j)) for j in range(eval_batches)])

    start_step = 0
    ckpt_path = None
    if ckpt_dir:
        ckpt_path = os.path.abspath(ckpt_dir)
        if not resume and os.path.exists(ckpt_path):
            shutil.rmtree(ckpt_path)  # a fresh run never restores a stale snapshot
        os.makedirs(ckpt_path, exist_ok=True)
        sc_path = os.path.join(ckpt_path, ckpt.SIDECAR)
        if resume and os.path.exists(sc_path):
            _check_resume_config(sc_path, cfg)  # on resume the sidecar is authoritative
        else:
            ckpt.write_sidecar(ckpt_path, cfg, tokenizer)
        latest = ckpt.latest_step(ckpt_path)
        if resume and latest is not None:
            start_step = latest
            ckpt.restore(ckpt_path, start_step, net, opt_state)
            log(f"[train] resumed from step {start_step}")

    loss = float("nan")
    fired_faults: set = set()
    recoveries = 0
    pending: deque = deque()  # (step, device loss, host time at dispatch)
    counters = {"dispatches": 0, "fused_calls": 0, "host_syncs": 0}

    def drain_oldest() -> Optional[int]:
        """Read and check the oldest in-flight step's loss (waits for it).
        Returns the snapshot to roll back to when a non-finite loss can
        recover; raises when it cannot."""
        nonlocal loss, recoveries
        s, ldev, t0 = pending.popleft()
        lv = float(ldev)
        ms = (time.perf_counter() - t0) * 1e3
        if s in inject_fault and s not in fired_faults:
            # a transient: once a step, so the replay after a rollback
            # sees the real loss
            fired_faults.add(s)
            log(f"[fault] injected non-finite loss at step {s}")
            lv = float("nan")
        if not np.isfinite(lv):
            rollback = ckpt.latest_step(ckpt_path) if ckpt_path else None
            if not (recover > 0 and recoveries < recover and rollback is not None):
                raise FloatingPointError(f"non-finite loss {lv} at step {s}")
            recoveries += 1
            log(f"[recover] non-finite loss at step {s}: "
                f"rolling back to snapshot {rollback} ({recoveries}/{recover})")
            return rollback
        loss = lv
        if s % log_every == 0:
            log(f"[train] step {s} loss {lv:.4f} ({ms:.1f} ms)")
        return None

    try:
        step = start_step
        while step < steps:
            t0 = time.perf_counter()
            net, opt_state, ldev = train_step(net, opt_state, batch_at(step))
            counters["dispatches"] += 1
            pending.append((step, ldev, t0))
            step += 1
            at_eval = bool(eval_every and step % eval_every == 0)
            at_save = bool(ckpt_path is not None and step % save_every == 0)
            barrier = at_eval or at_save or step >= steps
            if barrier and overlap and pending:
                counters["host_syncs"] += 1  # window closed early
            rollback = None
            while pending and (barrier or len(pending) > overlap):
                rollback = drain_oldest()
                if rollback is not None:
                    break
            if rollback is not None:
                # drop the steps in flight past the fault and replay from
                # the snapshot: the restore is total
                pending.clear()
                ckpt.restore(ckpt_path, rollback, net, opt_state)
                step = rollback
                if "l" in box:
                    box.pop("l").close()  # reopened at the rollback step
                continue
            if at_eval:
                log(f"[eval] step {step - 1} val_loss {eval_loss(step - 1):.4f}")
            if at_save:
                ckpt.save(ckpt_path, step, net, opt_state)
    finally:
        for ld in box.values():
            # an IO failure zero-pads a row; the loader counts them
            if ld.short_reads():
                log(f"[train] WARNING: {ld.short_reads()} rows zero-padded by "
                    f"short reads (IO errors) during streaming")
            ld.close()
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot directory (the port's format, tpulab_torch.ckpt)")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest snapshot in --ckpt-dir and continue")
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
    ap.add_argument("--recover", type=int, default=0,
                    help="on a non-finite loss, roll back to the newest snapshot and "
                         "continue, at most N times (0 = fail fast)")
    ap.add_argument("--inject-fault", type=int, action="append", default=[], metavar="STEP",
                    help="fake a transient non-finite loss at STEP (once; repeatable) "
                         "to exercise --recover")
    ap.add_argument("--data-dir", default=None,
                    help="stream byte tokens from files via the native loader "
                         "(default: synthetic stream)")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="LoRA finetuning: adapter rank (0 = full training)")
    ap.add_argument("--lora-alpha", type=float, default=16.0,
                    help="LoRA scale numerator (delta = A@B * alpha/rank)")
    ap.add_argument("--init-from", default=None, metavar="CKPT_DIR",
                    help="warm-start params from a snapshot (params only, fresh "
                         "optimizer): the pretrain -> --lora-rank bridge")
    ap.add_argument("--tokenizer", default=None, metavar="TOK_JSON",
                    help="BPE table (tpulab_torch tokenizer train): vocab from the "
                         "merges, batches from the encoded --data-dir corpus")
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
