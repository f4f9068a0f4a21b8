"""Training loop on one device (the counterpart of ``tpulab.train``).

``python -m tpulab_torch train`` runs :func:`main`.  ``model="labformer"``
(the default) trains the byte LM with
:func:`tpulab_torch.models.labformer.make_train_step`, whose flash
attention runs kernels B4, B5 and B6 on the card (``--backend cuda``, the
default) and their plain versions on the host (``--backend cpu``);
``remat_policy="dots"`` keeps each block's weight products and recomputes
the rest.  ``model="labvision"`` trains the CNN of
:mod:`tpulab_torch.models.labvision` on its synthetic lab3 colour-class
task (cuDNN convolutions, none of B1-B7).  The optimizers are adamw,
lion, adafactor and sgd of :mod:`tpulab_torch.optim`, ``tpulab``'s optax
stacks written out.

Data: the same deterministic synthetic byte stream as ``tpulab``
(:func:`batches`, a copy), so the two packages see the same batches at the
same steps; with ``data_dir``, the native loader's byte stream
(:mod:`tpulab_torch.io.loader`), opened at the first step run so a resumed
run replays the same tokens; with ``tokenizer`` too, random windows of the
BPE-encoded corpus (:func:`corpus_windows`), its tail held out for
evaluation; labvision's images from ``synth_batch`` at ``(seed << 20) ^
step``, its held-out batches at ``(seed << 21) ^ (7919 + j)``.  A
non-finite loss fails fast (``FloatingPointError``), and ``inject_fault``
fakes one, once a step; ``sanitize`` traps a non-finite value already
where a module or a backward op makes it.  ``overlap`` = 1 reads each
step's loss one step late, so the host enqueues the next step before it
waits for the card; the ``[train]`` lines keep their exact step/loss
pairing either way.

Observability: each step's host dispatch time and its dispatch-to-check
lag go into the registry (``train_dispatch_seconds``,
``train_loss_lag_seconds``), the train-MFU window into
``roofline.note_train_window``, and a ``[train] metrics`` line with their
percentiles and ``train_mfu_pct`` (against the card's bf16 peak; 0 on the
CPU) is printed at every eval and save boundary and at the end, as
``tpulab`` prints it.  ``trace_dir`` writes a ``torch.profiler`` trace of
the loop (:func:`tpulab_torch.obs.maybe_trace`).

Checkpoints (:mod:`tpulab_torch.ckpt`, the port's own format): with
``ckpt_dir`` a snapshot of the parameters and the optimizer state every
``save_every`` steps, the config sidecar ``tpulab`` writes (labformer),
``resume`` from the newest snapshot, ``recover`` (roll back to it on a
non-finite loss, at most that many times), and ``init_from`` (a snapshot's
base weights into a fresh run, the optimizer clean: the pretrain to LoRA
bridge).  A resumed or recovered run is bit-equal to an uninterrupted one.

``steps_per_call`` K > 1 runs blocks of K steps as one call
(``step.step_k`` of :func:`~tpulab_torch.models.labformer.make_train_step`:
one ``(K, batch, seq+1)`` upload, the K losses read back together), planned
as ``tpulab`` plans them: a block ends at each eval and save boundary, an
unfired injected fault and anything shorter than K run as K=1 calls, so
losses and parameters are bit-equal to the K=1 loop.  Under ``overlap`` = 1
a block's losses are drained one block late and checked step by step.

Mesh training (``mesh_devices`` N, ``--mesh N``): ``tpulab``'s
factorization of N over ``(dp, sp, tp, pp)`` (``best_factorization`` fills
pp, then tp, then sp; ``zero1`` takes a factor of 2 for dp from pp, tp or
sp), one rank a device (:func:`tpulab_torch.parallel.mesh.shared_pool`:
NCCL on the card, gloo with ``device="cpu"``), the loop in every rank on
its shards (:mod:`tpulab_torch.models.sharded`), rank 0's log lines and
result returned.  ``mesh_devices=1`` runs in this process, on a group of
one.  labvision splits its batch over a ``dp`` mesh of N.  A snapshot
holds the whole tree (the ZeRO moments and adafactor's statistics
gathered), so any topology resumes any other's.  adafactor runs on any
mesh but under ``zero1``/``zero2`` with dp > 1, where ``tpulab`` fails too:
that is a ``ValueError`` before any rank starts.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

#: optimizer names of ``tpulab.train`` (the CLI's choices)
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
    optional global-norm clipping, then adamw, lion, adafactor or sgd
    (momentum 0.9) on a constant, linear-warmup or warmup-cosine schedule."""
    from tpulab_torch import optim

    if schedule == "cosine":
        sched = optim.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup_steps else lr, peak_value=lr,
            warmup_steps=warmup_steps, decay_steps=max(steps, warmup_steps + 1))
    elif schedule == "const":
        sched = optim.linear_schedule(0.0, lr, warmup_steps) if warmup_steps else lr
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    makers = {"adamw": optim.adamw, "lion": optim.lion, "adafactor": optim.adafactor,
              "sgd": lambda s: optim.sgd(s, momentum=0.9)}
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


def mesh_sizes(mesh_devices: int, zero1: bool) -> dict:
    """``tpulab``'s factorization of ``mesh_devices`` over ``(dp, sp, tp,
    pp)`` (``tpulab/train.py:459-482``): ``best_factorization`` fills the
    innermost axes first; with ``zero1`` a factor of 2 moves to dp from
    pp, then tp, then sp."""
    from tpulab_torch.parallel.mesh import best_factorization

    sizes = best_factorization(mesh_devices, ("dp", "sp", "tp", "pp"))
    if zero1 and sizes["dp"] == 1:
        for a in ("pp", "tp", "sp"):
            if sizes[a] % 2 == 0:
                sizes[a] //= 2
                sizes["dp"] = 2
                break
        else:
            raise ValueError(
                f"zero1 needs a mesh with dp > 1; cannot "
                f"factor one out of {mesh_devices} devices")
    return sizes


def _train_rank(kwargs: dict):
    """One rank of a mesh run: the loop on this rank's shards; rank 0's
    log lines come back with the result."""
    import torch.distributed as dist

    lines: list = []
    log = lines.append if dist.get_rank() == 0 else (lambda *a, **k: None)
    step, loss = train(**kwargs, log=log)
    return step, loss, lines


def _train_on_pool(kwargs: dict, log, device) -> tuple:
    """``train(**kwargs)`` in every rank of a kept pool of
    ``mesh_devices`` ranks on ``device``'s type; rank 0's lines go to
    ``log``."""
    import pickle

    from tpulab_torch.parallel.mesh import shared_pool

    kwargs = {**kwargs, "device": device.type}
    try:
        pickle.dumps(kwargs)
    except (pickle.PicklingError, TypeError, AttributeError) as e:  # a closure (an optimizer)
        raise ValueError(f"mesh_devices={kwargs['mesh_devices']}: the arguments go to "
                         f"spawned ranks and must pickle; give the optimizer by name "
                         f"(opt_name, lr, schedule, ...): {e}") from None
    pool = shared_pool(kwargs["mesh_devices"], device.type)
    step, loss, lines = pool.run(_train_rank, kwargs)
    for line in lines:
        log(line)
    return step, loss


def _outputs(out):
    """The tensors of a module's output (nested tuples and lists)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _outputs(o)


@contextlib.contextmanager
def _sanitized(net, where: dict):
    """``tpulab``'s ``jax_debug_nans`` on the port: a forward hook on every
    module of ``net`` raises ``FloatingPointError`` naming the module and
    the step at the first non-finite output, and anomaly mode
    (``check_nan``) traps one made in the backward (turned into
    ``FloatingPointError`` naming the backward op and the step by the
    loop).  Each check waits for the device; no value changes."""
    def hook(name: str):
        def check(module, args, out):
            for t in _outputs(out):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"sanitize: non-finite value in the output of {name} "
                        f"at step {where['step']}")
        return check

    handles = [m.register_forward_hook(hook(name or type(net).__name__))
               for name, m in net.named_modules()]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()


def _warm_start(model, cfg, init_from: str) -> None:
    """Graft a snapshot's base weights into the fresh model, in place
    (``tpulab.train._warm_start``): the optimizer state stays clean, and
    LoRA adapters keep their zero-delta init."""
    from tpulab_torch.models.generate import load_params
    from tpulab_torch.models.labformer import _join_lora, _split_lora, gather_params

    base_cfg = dataclasses.replace(cfg, lora_rank=0) if cfg.lora_rank else cfg
    restored, _ = load_params(base_cfg, init_from)  # raises when there is no snapshot
    lora, live_base = _split_lora(gather_params(model))
    if set(restored["blocks"]) != set(live_base["blocks"]):
        raise ValueError(f"{init_from}: snapshot leaves {sorted(restored['blocks'])} differ "
                         f"from the model's {sorted(live_base['blocks'])}")
    model.assign_whole(_join_lora(restored, lora))


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

    ``model``: ``"labformer"`` (the byte LM) or ``"labvision"`` (the CNN
    on the synthetic lab3 colour-class task, lr 1e-3 by default); both
    share the checkpoints, the fail-fast and recover path, ``sanitize``
    and ``trace_dir``.  ``eval_every > 0`` logs a held-out loss every that
    many steps, from the parameters after that step's update.  ``overlap``
    (>= 0) keeps that many steps in flight before their losses are read;
    an eval, a save, a rollback and the end drain the rest.  ``log_every``
    emits ``[train]`` lines every N steps (every loss is still checked).
    ``trace_dir`` writes a ``torch.profiler`` trace of the loop there;
    ``sanitize`` traps the first non-finite value where it is made
    (:func:`_sanitized`; ``tpulab`` also turns buffer donation off, which
    the port never uses).  ``mesh_devices`` N > 1 runs the loop in N
    ranks (see the module's docstring).
    """
    args = {k: v for k, v in locals().items() if k != "log"}
    from tpulab_torch import ckpt
    from tpulab_torch.obs import TRACER, histogram, maybe_trace, roofline
    from tpulab_torch.runtime.device import resolve_device

    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if steps_per_call > 1 and model != "labformer":
        raise ValueError(
            "steps_per_call > 1 scans stacked token blocks — only the "
            "labformer trainer fuses multi-step dispatches")
    if log_every < 1:
        raise ValueError(f"log_every must be >= 1, got {log_every}")
    if overlap < 0:
        raise ValueError(f"overlap must be >= 0, got {overlap}")
    if recover and not ckpt_dir:
        raise ValueError(
            "--recover rolls back to checkpoints: give --ckpt-dir (and a "
            "save_every that snapshots often enough to bound lost work)")
    if (zero1 or zero2) and model != "labformer":
        raise ValueError("zero1/zero2 are implemented for the labformer trainer")
    if lora_rank and model != "labformer":
        raise ValueError("lora_rank applies to the labformer finetune path")
    if init_from and model != "labformer":
        raise ValueError("init_from warm-starts the labformer trainer")
    if tokenizer and model != "labformer":
        raise ValueError("tokenizer feeds the labformer byte/BPE LM")
    if init_from and resume:
        raise ValueError(
            "init_from (params-only warm start, fresh optimizer) and "
            "resume (full state restore) are mutually exclusive")
    if data_dir and model != "labformer":
        raise ValueError("data_dir streams byte tokens — only the labformer consumes it")
    if model not in ("labformer", "labvision"):
        raise ValueError(f"unknown model {model!r}")
    zero1 = bool(zero1 or zero2)  # stage 2 builds on stage 1's layouts
    if zero1 and not mesh_devices:
        raise ValueError(
            "zero1 requires a device mesh (--mesh N): optimizer moments "
            "shard over the dp axis")
    inject_fault = tuple(inject_fault or ())
    device = resolve_device(device) if device is None or isinstance(device, str) \
        else torch.device(device)
    if optimizer is None and (lr or warmup_steps or schedule != "const"
                              or clip_norm or opt_name != "adamw"):
        optimizer = build_optimizer(lr=lr or (1e-3 if model == "labvision" else 3e-4),
                                    steps=steps, warmup_steps=warmup_steps,
                                    schedule=schedule, clip_norm=clip_norm,
                                    optimizer=opt_name)
    mesh = None
    if mesh_devices:
        import torch.distributed as dist

        from tpulab_torch.parallel.mesh import make_mesh

        sizes = ({"dp": mesh_devices} if model == "labvision"
                 else mesh_sizes(mesh_devices, zero1))
        if model == "labformer":
            from tpulab_torch.models.labformer import refuse_zero_adafactor

            refuse_zero_adafactor(optimizer, sizes, zero1)
        in_rank = dist.is_initialized() and dist.get_world_size() == mesh_devices
        if mesh_devices > 1 and not in_rank:
            return _train_on_pool(args, log, device)
        mesh = make_mesh(sizes, backend=device.type)
    rank0 = mesh is None or dist.get_rank() == 0
    if not rank0:
        def log(*a, **k):
            pass

    box: dict = {}  # the open native loader, closed in the finally below

    def eval_of(losses) -> float:
        # every val batch enqueued, then read: the same float sum as tpulab
        return sum(float(v) for v in losses) / eval_batches

    if model == "labvision":
        from tpulab_torch.models.labvision import (LabvisionConfig, init_train_state,
                                                   synth_batch)

        cfg = cfg or LabvisionConfig()
        net, opt_state, vstep = init_train_state(cfg, seed=seed, optimizer=optimizer,
                                                 device=device, mesh=mesh)

        def batch_at(step: int):
            return synth_batch(cfg, batch, np.random.default_rng((seed << 20) ^ step))

        def train_step(net, opt_state, data):
            return vstep(net, opt_state, *data)

        def eval_loss(step: int) -> float:
            with torch.no_grad():
                return eval_of([
                    net.loss_fn(*synth_batch(cfg, batch,
                                             np.random.default_rng((seed << 21) ^ (7919 + j))))
                    for j in range(eval_batches)])
    else:
        from tpulab_torch.models.labformer import LabformerConfig, init_train_state

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
        net, opt_state, train_step = init_train_state(cfg, mesh, seed=seed, optimizer=optimizer,
                                                      accum=accum, zero1=zero1, zero2=zero2,
                                                      device=device)
        if init_from:
            _warm_start(net, cfg, init_from)

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

    if mesh is not None and model == "labformer":
        from tpulab_torch.models.labformer import restore_snapshot, save_snapshot

        def save(path, at, net, opt_state):
            save_snapshot(path, at, net, opt_state, train_step)

        def restore(path, at, net, opt_state):
            restore_snapshot(path, at, net, opt_state, train_step)
    elif mesh is not None:  # labvision's replicated parameters: rank 0 writes them
        def save(path, at, net, opt_state):
            if rank0:
                ckpt.save(path, at, net, opt_state)
            dist.barrier()

        restore = ckpt.restore
    else:
        save, restore = ckpt.save, ckpt.restore

    start_step = 0
    ckpt_path = None
    if ckpt_dir:
        ckpt_path = os.path.abspath(ckpt_dir)
        sc_path = os.path.join(ckpt_path, ckpt.SIDECAR)
        if rank0:
            if not resume and os.path.exists(ckpt_path):
                shutil.rmtree(ckpt_path)  # a fresh run never restores a stale snapshot
            os.makedirs(ckpt_path, exist_ok=True)
        if mesh is not None:
            dist.barrier()
        if model == "labformer":  # tpulab writes no sidecar for labvision
            if resume and os.path.exists(sc_path):
                _check_resume_config(sc_path, cfg)  # on resume the sidecar is authoritative
            elif rank0:
                ckpt.write_sidecar(ckpt_path, cfg, tokenizer)
        latest = ckpt.latest_step(ckpt_path)
        if resume and latest is not None:
            start_step = latest
            restore(ckpt_path, start_step, net, opt_state)
            log(f"[train] resumed from step {start_step}")

    loss = float("nan")
    fired_faults: set = set()
    recoveries = 0
    pending: deque = deque()  # (first step, k, device losses, host time at dispatch)
    counters = {"dispatches": 0, "fused_calls": 0, "host_syncs": 0}
    # the trainer's observability, as tpulab's: host dispatch time and the
    # dispatch -> checked-loss lag per block in the process-global registry,
    # and the train-MFU window (analytic labformer flops, 3x the forward,
    # over wall time; 0 without the card's peak), printed as the
    # "[train] metrics" line at each eval and save boundary and at the end
    h_dispatch = histogram("train_dispatch_seconds",
                           "host time to build + dispatch one fused train block")
    h_loss_lag = histogram("train_loss_lag_seconds",
                           "dispatch -> drained loss finiteness check, per block")
    step_flops = (3.0 * roofline.labformer_fwd_flops(cfg, batch, seq)
                  if model == "labformer" else 0.0)
    mfu = {"t0": time.perf_counter(), "steps": 0, "pct": 0.0}

    def note_mfu() -> None:
        now = time.perf_counter()
        roofline.note_train_window(step_flops * mfu["steps"], now - mfu["t0"])
        mfu["t0"], mfu["steps"] = now, 0
        mfu["pct"] = roofline.update_mfu_gauges()["train_mfu"]

    def metrics_line() -> str:
        # cumulative over the process, as the registry is
        return ("[train] metrics "
                f"dispatch_ms_p50={h_dispatch.percentile(0.5) * 1e3:.2f} "
                f"dispatch_ms_p99={h_dispatch.percentile(0.99) * 1e3:.2f} "
                f"loss_lag_ms_p50={h_loss_lag.percentile(0.5) * 1e3:.2f} "
                f"loss_lag_ms_p99={h_loss_lag.percentile(0.99) * 1e3:.2f} "
                f"blocks={h_dispatch.count} "
                f"train_mfu_pct={mfu['pct']}")

    def block_len(s: int) -> int:
        """``tpulab``'s ``_block_len``: the longest fused block starting at
        step ``s``, capped at ``steps_per_call``, ending at an eval or save
        boundary, never covering an unfired injected fault, never past
        ``steps``; anything shorter than ``steps_per_call`` runs as K=1
        calls."""
        k = min(steps_per_call, steps - s)
        for j in range(k):
            cur = s + j
            if cur in inject_fault and cur not in fired_faults:
                k = j if j else 1
                break
            if j < k - 1 and ((eval_every and (cur + 1) % eval_every == 0)
                              or (ckpt_path is not None and (cur + 1) % save_every == 0)):
                k = j + 1
                break
        return k if k == steps_per_call else 1

    def drain_oldest() -> Optional[int]:
        """Read and check the oldest in-flight block's losses (waits for
        them), step by step.  Returns the snapshot to roll back to when a
        non-finite loss can recover; raises when it cannot."""
        nonlocal loss, recoveries
        s0, k, ldev, t0 = pending.popleft()
        with TRACER.span("train.drain"):
            vals = ldev.reshape(-1).tolist()
        lag = time.perf_counter() - t0
        h_loss_lag.observe(lag)
        ms = lag * 1e3 / k
        for j, lv in enumerate(vals):
            s = s0 + j
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

    where = {"step": start_step}
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(maybe_trace(trace_dir if rank0 else None))
            if sanitize:
                stack.enter_context(_sanitized(net, where))
            step = start_step
            while step < steps:
                t0 = time.perf_counter()
                where["step"] = step
                k = block_len(step)
                with TRACER.span("train.dispatch"):
                    try:
                        if k == 1:
                            net, opt_state, ldev = train_step(net, opt_state, batch_at(step))
                        else:
                            block = np.stack([batch_at(step + j) for j in range(k)])
                            net, opt_state, ldev = train_step.step_k(net, opt_state, block)
                            counters["fused_calls"] += 1
                    except RuntimeError as e:
                        if sanitize and "nan values" in str(e):  # anomaly mode's trap
                            raise FloatingPointError(
                                f"sanitize: non-finite gradient in the backward of step "
                                f"{step}: {e}") from e
                        raise
                counters["dispatches"] += 1
                mfu["steps"] += k
                h_dispatch.observe(time.perf_counter() - t0)
                pending.append((step, k, ldev, t0))
                step += k
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
                    # drop the blocks in flight past the fault and replay
                    # from the snapshot: the restore is total
                    pending.clear()
                    restore(ckpt_path, rollback, net, opt_state)
                    step = rollback
                    if "l" in box:
                        box.pop("l").close()  # reopened at the rollback step
                    continue
                if at_eval:
                    log(f"[eval] step {step - 1} val_loss {eval_loss(step - 1):.4f}")
                if at_save:
                    save(ckpt_path, step, net, opt_state)
                if at_eval or at_save:
                    note_mfu()
                    log(metrics_line())
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
        note_mfu()
        log(metrics_line())
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
    ap.add_argument("--mesh", type=int, default=0,
                    help="train over N devices: (dp, sp, tp, pp) factored from N, one rank "
                         "a device (0 = one device, no mesh)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sanitize", action="store_true",
                    help="trap the first non-finite value where a module or a backward op "
                         "makes it (FloatingPointError naming it and the step)")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace of the loop (Chrome JSON) here")
    ap.add_argument("--accum", type=int, default=1, help="gradient-accumulation microbatches")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize each block in the backward (torch.utils.checkpoint)")
    ap.add_argument("--remat-policy", default="none", choices=("none", "dots"),
                    help="what remat keeps: none = recompute everything; dots = keep the "
                         "weight products, recompute the rest (attention included)")
    ap.add_argument("--experts", type=int, default=0, help="MoE experts (0 = dense MLP)")
    ap.add_argument("--moe-impl", default="dense", choices=("dense", "dispatch"),
                    help="dense (every expert, gate-combined) | dispatch (all_to_all over the "
                         "mesh's (dp, sp) axes, with capacity; needs --mesh)")
    ap.add_argument("--moe-aux-weight", type=float, default=0.01,
                    help="switch-transformer router load-balancing loss weight")
    ap.add_argument("--moe-top-k", type=int, default=1,
                    help="experts per token: 1 = switch, 2+ = renormalized combination")
    ap.add_argument("--model", default="labformer", choices=("labformer", "labvision"),
                    help="model family: the byte LM or the lab3-task CNN")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out loss every N steps (0 = off)")
    ap.add_argument("--lr", type=float, default=0.0, help="peak learning rate")
    ap.add_argument("--optimizer", default="adamw", choices=_OPTIMIZERS,
                    help="adamw (default) | lion (1 moment, ~3-10x lower lr) | adafactor "
                         "(factored statistics) | sgd (momentum 0.9)")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--schedule", default="const", choices=("const", "cosine"))
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="global gradient-norm clip (0 = off)")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1: shard optimizer moments over dp (needs --mesh)")
    ap.add_argument("--zero2", action="store_true",
                    help="ZeRO-2: also reduce-scatter gradients over dp (implies --zero1)")
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
                    help="optimizer steps per fused call (blocks end at eval/save "
                         "boundaries; faults and the tail run as K=1 calls)")
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
