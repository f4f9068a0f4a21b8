"""Labformer, the framework's byte-level decoder transformer, on PyTorch
(the counterpart of ``tpulab.models.labformer``).

:class:`Labformer` is an ``nn.Module`` with one :class:`Block` per layer in
a ``ModuleList``.  Its weights come from the JAX package's parameter tree
(:func:`init_params` makes the same tree from the same seed, bit for bit)
through :meth:`Labformer.from_numpy`, and go back, with their gradients,
through :meth:`Labformer.to_numpy`.  A model built with ``trainable=True``
has parameters that require grad (with LoRA, the adapters only); serving
builds it frozen and runs under ``torch.inference_mode``.

Attention takes the dense path or kernel B4 (flash) as
:func:`tpulab_torch.parallel.ring.use_flash` decides, exactly as
``tpulab`` does: the two round differently in bf16 (the dense path scales
q and forms the scores in the model dtype; flash scales in f32 and keeps
the scores in f32), so the port must take the path the reference takes.
Flash's gradient is kernels B5 and B6 (``ops/cuda/attention.py``).

Training (:func:`make_train_step`, :func:`init_train_state`) follows
``tpulab``'s: the loss's gradient (averaged over ``accum`` microbatches),
then the optimizer stack of :mod:`tpulab_torch.optim`, which reproduces
optax.  ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``); policy ``"dots"`` keeps the block's weight
products (:func:`_remat_context`).  The port updates the module's parameters and the optimizer state
in place where ``tpulab`` returns new trees.

Every model has a :class:`tpulab_torch.models.sharded.Plan`: with a mesh
(:func:`make_train_step`'s ``mesh``, a ``DeviceMesh`` of
``tpulab_torch.parallel.make_mesh`` over the ``(dp, sp, tp, pp)`` axes of
``tpulab``'s trainer) the model holds this rank's shards, and the same
step runs tensor, sequence, pipeline and data parallelism, the
all_to_all MoE dispatch, and ZeRO-1/2; without one, every axis has size
1 and the step is the one-device step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpulab_torch import ckpt, optim
from tpulab_torch.models import sharded
from tpulab_torch.models.quant import QTensor, qmat
from tpulab_torch.parallel import ring, spmd
from tpulab_torch.parallel.mesh import make_mesh, mesh_shape
from tpulab_torch.parallel.moe import _moe_body, combine_weights, dispatch_capacity
from tpulab_torch.parallel.ring import attention_reference, use_flash


@dataclasses.dataclass(frozen=True)
class LabformerConfig:
    vocab: int = 256          # byte-level
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 512
    n_experts: int = 0        # 0 => dense MLP; >0 => top-k MoE (moe_top_k)
    max_seq: int = 1024
    # grouped-query attention: 0 => n_heads (MHA); else the number of
    # shared K/V heads
    n_kv_heads: int = 0
    rope_theta: float = 10000.0
    dtype: Any = torch.float32  # params and activations
    # "dense" (O(s^2) reference), "flash" (kernel B4), or "auto" (flash
    # from 1024 tokens up)
    attn_impl: str = "auto"
    # sliding window: 0 => full causal; > 0 => each query sees its
    # attn_window most recent tokens, itself included
    attn_window: int = 0
    # mesh-only settings, kept so a tpulab sidecar round-trips
    sp_impl: str = "ring"
    remat: bool = False
    remat_policy: str = "none"
    moe_impl: str = "dense"
    moe_capacity_factor: float = 2.0
    # experts per token: 1 = switch (raw argmax gate), 2+ = renormalized
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    # LoRA adapters on wq and wv (serve through merge_lora)
    lora_rank: int = 0
    lora_alpha: float = 16.0

    def __post_init__(self):
        checks = {
            "attn_impl": ("auto", "flash", "dense"),
            "sp_impl": ("ring", "ulysses", "zigzag"),
            "moe_impl": ("dense", "dispatch"),
            "remat_policy": ("none", "dots"),
        }
        for field, allowed in checks.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field}={getattr(self, field)!r}; expected one of {allowed}")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads={self.n_heads} must be a multiple of "
                f"n_kv_heads={self.n_kv_heads}"
            )
        if self.attn_window < 0:
            raise ValueError(f"attn_window must be >= 0, got {self.attn_window}")
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {self.lora_rank}")
        if self.n_experts and not 1 <= self.moe_top_k <= self.n_experts:
            raise ValueError(
                f"moe_top_k={self.moe_top_k} outside [1, {self.n_experts}]")
        if self.remat_policy != "none" and not self.remat:
            raise ValueError(
                f"remat_policy={self.remat_policy!r} requires remat=True")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def cfg_to_dict(cfg: LabformerConfig) -> Dict[str, Any]:
    """JSON-able config dict (dtype by name), the same JSON as ``tpulab``'s
    checkpoint sidecar."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return d


def cfg_from_dict(d: Dict[str, Any]) -> LabformerConfig:
    """Inverse of :func:`cfg_to_dict`; unknown keys refuse loudly."""
    known = {f.name for f in dataclasses.fields(LabformerConfig)}
    extra = set(d) - known
    if extra:
        raise ValueError(f"unknown config keys {sorted(extra)} "
                         f"(sidecar from a newer tpulab?)")
    kw = dict(d)
    if "dtype" in kw:
        dtype = getattr(torch, str(kw["dtype"]), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {kw['dtype']!r}")
        kw["dtype"] = dtype
    return LabformerConfig(**kw)


def init_params(cfg: LabformerConfig, seed: int = 0) -> Dict[str, Any]:
    """The parameter tree of ``tpulab``'s ``init_params``, as CPU tensors.

    The same numpy generator calls in the same order: float64 draws,
    rounded to ``cfg.dtype`` once (bfloat16 through float32, as numpy's
    bfloat16 does), so every leaf is bit-equal to ``tpulab``'s.
    Per-layer leaves are stacked on axis 0.
    """
    rng = np.random.default_rng(seed)
    L, d, ff, dt = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.dtype

    def dense(*shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[-2]))
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dt)

    params: Dict[str, Any] = {
        "embed": dense(cfg.vocab, d, scale=0.02),
        "final_norm": torch.ones((d,), dtype=dt),
        "blocks": {
            "ln1": torch.ones((L, d), dtype=dt),
            "wq": dense(L, d, d),
            "wk": dense(L, d, cfg.kv_heads * cfg.head_dim),
            "wv": dense(L, d, cfg.kv_heads * cfg.head_dim),
            "wo": dense(L, d, d),
            "ln2": torch.ones((L, d), dtype=dt),
        },
    }
    if cfg.n_experts:
        E = cfg.n_experts
        params["blocks"]["router"] = dense(L, d, E, scale=0.02)
        params["blocks"]["w1"] = dense(L, E, d, ff)
        params["blocks"]["w2"] = dense(L, E, ff, d)
    else:
        params["blocks"]["w1"] = dense(L, d, ff)
        params["blocks"]["w2"] = dense(L, ff, d)
    if cfg.lora_rank:
        r = cfg.lora_rank
        kv = cfg.kv_heads * cfg.head_dim
        params["blocks"]["wq_lora_a"] = dense(L, d, r, scale=1.0 / r)
        params["blocks"]["wq_lora_b"] = torch.zeros((L, r, d), dtype=dt)
        params["blocks"]["wv_lora_a"] = dense(L, d, r, scale=1.0 / r)
        params["blocks"]["wv_lora_b"] = torch.zeros((L, r, kv), dtype=dt)
    return params


def merge_lora(params: Dict[str, Any], cfg: LabformerConfig):
    """Fold the adapters into the base weights for serving:
    ``(merged_params, cfg with lora_rank=0)``.  ``wq += A@B * alpha/rank``
    in float32, cast back to the weight's dtype; adapter leaves dropped."""
    if not cfg.lora_rank:
        return params, cfg
    scale = cfg.lora_alpha / cfg.lora_rank
    blocks = {k: v for k, v in params["blocks"].items() if "_lora_" not in k}
    for w, a, b in (("wq", "wq_lora_a", "wq_lora_b"), ("wv", "wv_lora_a", "wv_lora_b")):
        base = _to_torch(blocks[w])
        delta = torch.einsum("ldr,lro->ldo", _to_torch(params["blocks"][a]).float(),
                             _to_torch(params["blocks"][b]).float()) * scale
        blocks[w] = (base.float() + delta).to(base.dtype)
    merged = dict(params)
    merged["blocks"] = blocks
    return merged, dataclasses.replace(cfg, lora_rank=0)


def _split_lora(params: Dict[str, Any]):
    """(adapter subtree, base params), split by the ``_lora_`` leaf names."""
    blocks = params["blocks"]
    lora = {"blocks": {k: v for k, v in blocks.items() if "_lora_" in k}}
    base = dict(params)
    base["blocks"] = {k: v for k, v in blocks.items() if "_lora_" not in k}
    return lora, base


def _join_lora(base: Dict[str, Any], lora: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    out["blocks"] = {**base["blocks"], **lora["blocks"]}
    return out


# ------------------------------------------------------------ the bridge


def _to_torch(leaf) -> Union[torch.Tensor, QTensor]:
    """A tree leaf as a CPU tensor: numpy (bfloat16 included), torch, or a
    ``QTensor`` of either package."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if hasattr(leaf, "q") and hasattr(leaf, "s"):
        return QTensor(_to_torch(leaf.q), _to_torch(leaf.s))
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # numpy's bfloat16 (ml_dtypes), by its bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy has no bfloat16 of its own

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _layer(blocks: Dict[str, Any], i: int):
    def take(leaf):
        if isinstance(leaf, QTensor):
            return QTensor(leaf.q[i], leaf.s[i])
        return leaf[i]

    return {name: take(leaf) for name, leaf in blocks.items()}


class _Weights(nn.Module):
    """Named weights: tensors become parameters (requiring grad where
    ``trainable(name)``), ``QTensor`` leaves plain attributes (moved to the
    device with the rest)."""

    def __init__(self, leaves: Dict[str, Any], device: torch.device,
                 trainable: Callable[[str], bool] = lambda name: False):
        super().__init__()
        self.names = tuple(leaves)
        for name, leaf in leaves.items():
            if isinstance(leaf, QTensor):
                setattr(self, name, QTensor(leaf.q.to(device), leaf.s.to(device)))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf.to(device), requires_grad=trainable(name)))


class Block(_Weights):
    """One transformer layer: attention and MLP with pre-norm residuals."""

    def forward(self, x: torch.Tensor, cfg: LabformerConfig, positions: torch.Tensor,
                plan=None):
        x = x + _attention(_rmsnorm(x, self.ln1), self, cfg, positions, plan)
        y, aux_f = _mlp(_rmsnorm(x, self.ln2), self, cfg, plan)
        return x + y, aux_f


class Labformer(nn.Module):
    """The labformer.  ``forward(tokens)`` gives next-token logits for
    ``tokens`` (batch, seq) int.

    ``trainable`` makes the parameters require grad: every leaf, or with
    ``cfg.lora_rank`` the adapter leaves only (``tpulab``'s LoRA step
    differentiates the adapter subtree alone).  ``plan`` (a
    ``models.sharded.Plan``; :meth:`from_numpy` makes it from its ``mesh``
    and ``device``) says which part of the whole tree ``params`` this rank
    holds: on a mesh its stage's layers, its tp columns and rows, its
    experts; without one, all of it on ``device``.  The leaf methods
    (:meth:`to_tree`, :meth:`assign`) see this rank's parts;
    :func:`gather_params` and :meth:`assign_whole` the whole tree."""

    def __init__(self, params: Dict[str, Any], cfg: LabformerConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 trainable: bool = False, plan: Optional[sharded.Plan] = None):
        super().__init__()
        plan = plan if plan is not None else sharded.Plan(None, cfg, device)
        self.cfg, self.plan = cfg, plan
        tree = _parts(params, plan)
        def learns(name: str) -> bool:
            return trainable and (not cfg.lora_rank or "_lora_" in name)

        self.top = _Weights({k: v for k, v in tree.items() if k != "blocks"}, plan.device, learns)
        self.blocks = nn.ModuleList(
            Block(_layer(tree["blocks"], i), plan.device, learns)
            for i in range(plan.n_local_layers))

    @classmethod
    def from_numpy(cls, params: Dict[str, Any], cfg: LabformerConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   trainable: bool = False, mesh=None) -> "Labformer":
        """The module from ``tpulab``'s parameter tree (numpy leaves,
        per-layer leaves stacked on axis 0), on ``device`` (the card unless
        ``"cpu"``).  With a ``mesh`` (every rank of it calls this with the
        same whole tree), this rank's shards on its device."""
        return cls(params, cfg, device, trainable, sharded.Plan(mesh, cfg, device))

    def named_leaves(self) -> List[Tuple[str, list]]:
        """``(name, tensors)`` of every leaf, in the order of ``tpulab``'s
        flattened tree (blocks by name, then the top leaves); a per-layer
        leaf holds one tensor per layer."""
        leaves = [(f"blocks/{name}", [getattr(blk, name) for blk in self.blocks])
                  for name in sorted(self.blocks[0].names)]
        return leaves + [(name, [getattr(self.top, name)]) for name in sorted(self.top.names)]

    def trainable_leaves(self) -> List[Tuple[str, List[torch.Tensor]]]:
        """:meth:`named_leaves` that require grad."""
        return [(name, ts) for name, ts in self.named_leaves()
                if isinstance(ts[0], torch.Tensor) and ts[0].requires_grad]

    def to_tree(self, grads: bool = False) -> Dict[str, Any]:
        """The parameter tree with CPU tensor leaves (detached copies), the
        shape of :meth:`from_numpy`'s input.  ``grads``: the tree of the
        trainable leaves' ``.grad`` instead, the shape of ``tpulab``'s
        gradient tree (the adapter subtree alone under LoRA)."""
        def conv(leaf):
            if isinstance(leaf, QTensor):
                return QTensor(leaf.q.detach().cpu(), leaf.s.detach().cpu())
            return leaf.detach().cpu()

        def stack(leaves):
            if isinstance(leaves[0], QTensor):
                return QTensor(torch.stack([x.q for x in leaves]),
                               torch.stack([x.s for x in leaves]))
            return torch.stack(leaves)

        with torch.no_grad():
            if grads:
                out: Dict[str, Any] = {"blocks": {}}
                for name, ts in self.trainable_leaves():
                    if name.startswith("blocks/"):
                        out["blocks"][name[7:]] = conv(stack([t.grad for t in ts]))
                    else:
                        out[name] = conv(ts[0].grad)
                return out
            out = {name: conv(getattr(self.top, name)) for name in self.top.names}
            out["blocks"] = {
                name: conv(stack([getattr(blk, name) for blk in self.blocks]))
                for name in self.blocks[0].names
            }
        return out

    def to_numpy(self, grads: bool = False) -> Dict[str, Any]:
        """:meth:`to_tree` with numpy leaves (inverse of :meth:`from_numpy`;
        bfloat16 needs ``ml_dtypes``)."""
        def conv(leaf):
            if isinstance(leaf, QTensor):
                return QTensor(_to_numpy(leaf.q), _to_numpy(leaf.s))
            return _to_numpy(leaf)

        tree = self.to_tree(grads)
        out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
        out["blocks"] = {k: conv(v) for k, v in tree["blocks"].items()}
        return out

    @torch.no_grad()
    def assign(self, tree: Dict[str, Any]) -> None:
        """Copy ``tree``'s leaves (``init_params``' nesting, per-layer leaves
        stacked) into the matching parameters, in place; a leaf the tree
        lacks keeps its value."""
        for name, leaf in tree.items():
            if name != "blocks":
                getattr(self.top, name).copy_(_to_torch(leaf))
        for name, leaf in tree.get("blocks", {}).items():
            leaf = _to_torch(leaf)
            for i, blk in enumerate(self.blocks):
                getattr(blk, name).copy_(leaf[i])

    def assign_whole(self, tree: Dict[str, Any]) -> None:
        """:meth:`assign` of a whole tree: on a mesh, this rank's shards of it."""
        self.assign(_parts(tree, self.plan))

    @property
    def device(self) -> torch.device:
        embed = self.top.embed
        return (embed.q if isinstance(embed, QTensor) else embed).device

    def tokens(self, tokens) -> torch.Tensor:
        """``tokens`` as an int64 tensor on the model's device."""
        return torch.as_tensor(tokens, device=self.device).long()

    def _stage_forward(self, inputs: torch.Tensor, positions: torch.Tensor):
        """This rank's stage over its ``inputs`` (batch, seq): ``(x, auxes,
        loads, x_in)``.  Stage 0 embeds ``inputs``; a later stage takes the
        residual stream from the one before (``x_in``, a leaf that requires
        grad where grad is on)."""
        x_in = None
        if self.plan.first:
            x = self.top.embed[inputs]
        else:
            x = x_in = sharded.recv_prev((*inputs.shape, self.cfg.d_model),
                                         self.top.embed.dtype, self.plan)
            if torch.is_grad_enabled():
                x_in.requires_grad_()
        auxes, loads = [], []
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:  # keep the block's input (and its products under "dots"); recompute the rest
                x, (aux, load) = checkpoint(blk, x, self.cfg, positions, self.plan,
                                            use_reentrant=False,
                                            **_remat_context(self.cfg.remat_policy))
            else:
                x, (aux, load) = blk(x, self.cfg, positions, self.plan)
            auxes.append(aux)
            loads.append(load)
        return x, auxes, loads, x_in

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return _rmsnorm(x, self.top.final_norm) @ self.top.embed.T  # tied head

    def _forward_scan(self, tokens):
        """(logits, aux_per_layer (L,), load_per_layer (L, E or 1)); on a
        mesh, the whole of each on every rank (a collective, forward only)."""
        plan = self.plan
        inputs, positions = plan.local_tokens(self.tokens(tokens))
        x, auxes, loads, _ = self._stage_forward(inputs, positions)
        if plan.last:
            logits = self._head(x)
        else:
            sharded.send_next(x, plan)
            logits = torch.empty((*inputs.shape, self.cfg.vocab), dtype=x.dtype, device=x.device)
        return (plan.whole_tokens(logits), spmd.gather_dim(torch.stack(auxes), plan.pp, 0),
                spmd.gather_dim(torch.stack(loads), plan.pp, 0))

    def forward_with_aux(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, mean per-layer router load-balancing loss; 0 when dense)."""
        logits, aux_per_layer, _ = self._forward_scan(tokens)
        return logits, aux_per_layer.mean()

    def forward(self, tokens) -> torch.Tensor:
        """Logits for next-token prediction; ``tokens`` (batch, seq) int.  On
        a mesh, the whole logits on every rank (a collective)."""
        return self.forward_with_aux(tokens)[0]

    def expert_load(self, tokens) -> torch.Tensor:
        """(n_layers, n_experts) fraction of tokens argmax-routed per expert."""
        return self._forward_scan(tokens)[2]

    def _objective(self, tokens: torch.Tensor):
        """This rank's stage of the loss of the global ``(batch, seq+1)``
        block: ``(objective, logged, x_out, x_in)``.  ``objective`` is the
        part of the global loss whose gradient this stage's backward takes
        (the last stage's token share of the causal next-byte cross entropy,
        and each stage's layers' share of the weighted router loss);
        ``logged`` is its global value's part (a float32 device scalar, to
        be summed over pp).  On one device both are the loss."""
        plan, cfg = self.plan, self.cfg
        inputs, targets, positions = plan.local_batch(tokens)
        x, auxes, _, x_in = self._stage_forward(inputs, positions)
        objective = logged = None
        if plan.last:
            logp = torch.log_softmax(self._head(x).float(), dim=-1)
            ll = torch.gather(logp, -1, targets[..., None])[..., 0]
            n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
            objective = -ll.mean() if plan.data_ranks == 1 else -ll.sum() / n_tokens
            logged = objective.detach().clone()
            for a in ("dp", "sp"):
                spmd.all_reduce_(logged, plan.ax[a])
        if cfg.n_experts and cfg.moe_aux_weight:
            aux = torch.stack(auxes)
            aux = aux.mean() if plan.n_stages == 1 else aux.sum() / cfg.n_layers
            term = np.float32(cfg.moe_aux_weight).item() * aux
            objective = term if objective is None else objective + term
            logged = term.detach() if logged is None else logged + term.detach()
        if logged is None:
            logged = torch.zeros((), dtype=torch.float32, device=plan.device)
        return objective, logged, x, x_in

    def loss_fn(self, tokens) -> torch.Tensor:
        """Causal next-byte cross entropy, plus the weighted router
        load-balancing loss when the model has experts.  On a mesh, the
        global loss of the whole batch on every rank (a collective, forward
        only: the step's :func:`_backward` takes its gradient)."""
        tokens = self.tokens(tokens)
        if self.plan.mesh is None:
            return self._objective(tokens)[0]
        with torch.no_grad():
            _, logged, x, _ = self._objective(tokens)
            if not self.plan.last:
                sharded.send_next(x, self.plan)
            return self.plan.sum_stages(logged)


def _parts(tree: Dict[str, Any], plan: sharded.Plan) -> Dict[str, Any]:
    """This rank's parts of a whole parameter tree (``init_params``'
    nesting; numpy, torch or ``QTensor`` leaves) as CPU tensors."""
    out = {k: plan.take(k, _to_torch(v)) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: plan.take(f"blocks/{k}", _to_torch(v))
                     for k, v in tree.get("blocks", {}).items()}
    return out


# ------------------------------------------------------------ training


def gather_params(model: Labformer) -> Dict[str, Any]:
    """The whole parameter tree (CPU tensors) of a model on a mesh, on
    every rank (a collective); ``to_tree()`` on one device."""
    return model.plan.gather_tree(model.to_tree())


def mesh_grads(model: Labformer, tokens) -> Dict[str, Any]:
    """The whole gradient tree (CPU tensors) of the global loss of
    ``tokens`` at ``model``'s parameters, on every rank: the step's
    backward and its sums over the ranks, then every part gathered.  The
    parameters' ``.grad`` are left holding this rank's summed parts."""
    leaves = _flat(model)
    for p in leaves:
        p.grad = None
    _backward(model, model.tokens(tokens))
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sharded.sync_grads(model, [p.grad for p in leaves], None)
    return model.plan.gather_tree(model.to_tree(grads=True))


def _refuse_mesh_options(cfg: LabformerConfig, mesh, zero1: bool, zero2: bool,
                         optimizer) -> None:
    """``tpulab``'s refusals, before any step."""
    if cfg.lora_rank and (zero1 or zero2):
        raise ValueError(
            "lora_rank > 0 with zero1/zero2 is pointless: the "
            "optimizer state is already O(rank) per layer")
    if mesh is not None:
        refuse_zero_adafactor(optimizer, sharded._mesh_sizes(mesh), zero1 or zero2)


def refuse_zero_adafactor(optimizer: Optional[optim.Transform], sizes: Dict[str, int],
                          zero: bool) -> None:
    """``tpulab``'s failure under ZeRO with dp > 1 for an optimizer that
    keeps statistics over whole leaves (adafactor), as a ``ValueError``
    before any step: ``tpulab`` fails in ``device_put``, because its ZeRO
    placement gives every params-shaped subtree the parameter's sharding."""
    if optimizer is not None and optimizer.whole_leaves and zero and sizes.get("dp", 1) > 1:
        raise ValueError(
            "adafactor under zero1/zero2: tpulab's ZeRO placement (shard_opt_state) "
            "shards the optimizer state by each parameter's shape, which cannot hold "
            "adafactor's factored statistics (v_row, v_col); train adafactor without "
            "ZeRO, or ZeRO with adamw, lion or sgd")


#: the products remat "dots" keeps: 2-D matmuls, which is what the block's
#: weight products (``x @ w``, ``qmat``) dispatch to.  A batched product
#: (``bmm``: the dense path's scores) is recomputed, as
#: ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` leaves it
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str) -> Dict[str, Any]:
    """``checkpoint``'s keyword for a remat policy: none for ``"none"``
    (only the block's input is kept); under ``"dots"`` a selective
    checkpoint that keeps the weight products' outputs and recomputes the
    rest, attention (kernel B4) included, as ``tpulab``'s
    ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)`` does."""
    if policy != "dots":
        return {}
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                            _dots_policy)}


def _flat(model) -> List[torch.Tensor]:
    return [t for _, ts in model.trainable_leaves() for t in ts]


def _leaf_sizes(model) -> List[Tuple[str, int]]:
    """``(path, tensor count)`` of each trainable leaf: the optimizer's
    ``leaves`` (a per-layer leaf is one block of statistics)."""
    return [(name, len(ts)) for name, ts in model.trainable_leaves()]


def _backward(model: Labformer, tokens: torch.Tensor) -> torch.Tensor:
    """Forward and backward of one (micro)batch through this rank's stage;
    the gradients of its parts accumulate in their ``.grad`` (not yet
    summed over the ranks).  Returns the batch's global loss."""
    plan = model.plan
    objective, logged, x_out, x_in = model._objective(tokens)
    if plan.last:
        objective.backward()
    else:
        sharded.send_next(x_out, plan)
        outs, grads = [x_out], [sharded.recv_next(x_out, plan)]
        if objective is not None:
            outs.append(objective)
            grads.append(None)
        torch.autograd.backward(outs, grads)
    if not plan.first:
        sharded.send_prev(x_in.grad, plan)
    return plan.sum_stages(logged)


def make_train_step(cfg: LabformerConfig, mesh=None, optimizer: Optional[optim.Transform] = None,
                    accum: int = 1, zero1: bool = False, zero2: bool = False):
    """``(optimizer, step)``: ``step(model, opt_state, tokens) -> (model,
    opt_state, loss)`` on a trainable :class:`Labformer`, the counterpart of
    ``tpulab``'s ``make_train_step``.

    The step takes the loss's gradient (``accum`` > 1: averaged over that
    many microbatches of the batch as ``tpulab``'s
    ``_accum_value_and_grad``: losses and gradients summed in order from
    zero, then times ``float32(1 / accum)``), leaves it in each trainable
    leaf's ``.grad`` (where the bridge reads it), and applies
    ``optimizer`` (default ``optim.adamw(3e-4)``, as ``tpulab``'s) to the
    parameters and ``opt_state`` in place.  Under ``cfg.lora_rank`` only
    the adapter leaves are trainable, so only they get gradients and
    optimizer state.  ``loss`` is a device scalar (reading it waits for
    the step).

    On a ``mesh`` (the model of :func:`init_train_state` on it) every rank
    calls the step with the same global token block, and each gets the
    global loss; the gradients are summed over the ranks each leaf is
    replicated on (:mod:`tpulab_torch.models.sharded`).  ``zero1`` keeps
    1/dp of each moment the ZeRO-1 spec shards and all-gathers the update;
    ``zero2`` also reduce-scatters the gradients.  Without a mesh both are
    no-ops, as in ``tpulab``, and every collective is skipped.

    ``step.step_k(model, opt_state, block)`` runs K steps over one
    ``(K, batch, seq+1)`` token block, uploaded once, and returns the K
    losses as one ``(K,)`` device tensor with no host read: ``tpulab``'s
    fused K-step program (``tpulab/models/labformer.py:654-682``), run
    eagerly.  The K steps are the same step, in order, so the losses and
    parameters are bit-equal to K calls of ``step``."""
    optimizer = optimizer or optim.adamw(3e-4)
    if cfg.n_experts and cfg.moe_impl == "dispatch" and mesh is None:
        raise NotImplementedError(
            "moe_impl='dispatch' routes tokens over the (dp, sp) axes of a mesh: "
            "train with a mesh (make_train_step(cfg, mesh), train(mesh_devices=N))")
    _refuse_mesh_options(cfg, mesh, zero1, zero2, optimizer)
    views: Dict[int, sharded.ZeroView] = {}

    def zero_view(model: Labformer) -> sharded.ZeroView:
        if id(model) not in views:
            views[id(model)] = sharded.ZeroView(model, zero1 or zero2)
        return views[id(model)]

    def train_step(model: Labformer, opt_state, tokens):
        zv = zero_view(model)
        z2 = zv if zero2 and zv.dp is not None else None
        leaves = _flat(model)
        for p in leaves:
            p.grad = None

        def summed_grads():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
            grads = sharded.sync_grads(model, grads, z2)
            return z2.reduce_scatter(grads) if z2 is not None else zv.view(grads)

        tokens = model.tokens(tokens)
        if accum <= 1:
            loss = _backward(model, tokens)
            grads = summed_grads()
        else:
            micro = tokens.reshape(accum, tokens.shape[0] // accum, tokens.shape[1])
            total = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = None
            for mb in micro:
                total = total + _backward(model, mb)
                if z2 is not None:  # ZeRO-2 reduce-scatters each microbatch's gradients
                    part = summed_grads()
                    grads = part if grads is None else [a + b for a, b in zip(grads, part)]
                    for p in leaves:
                        p.grad = None
            if z2 is None:
                grads = summed_grads()
            inv = float(np.float32(1.0 / accum))
            with torch.no_grad():
                for g in grads:
                    g.mul_(optim._scalar(inv, g))
            loss = total * inv
        with torch.no_grad(), optim.global_sum(
                sharded.global_sum_over(zv.split_keys(), model.plan)), \
                optim.leaf_splits(zv.splits, sharded.sum_over):
            updates = optimizer.update(list(grads), opt_state, zv.view(leaves))
            optim.apply_updates(leaves, zv.gather(updates))
        return model, opt_state, loss

    def step_k(model: Labformer, opt_state, block):
        losses = []
        for tokens in model.tokens(block):
            model, opt_state, loss = train_step(model, opt_state, tokens)
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    train_step.step_k = step_k
    train_step.zero_view = zero_view
    train_step.optimizer = optimizer
    return optimizer, train_step


def init_train_state(cfg: LabformerConfig, mesh=None, seed: int = 0,
                     optimizer: Optional[optim.Transform] = None, accum: int = 1,
                     zero1: bool = False, zero2: bool = False,
                     device: Optional[Union[str, torch.device]] = None):
    """``(model, opt_state, step)``: the trainable model from
    :func:`init_params` (``seed``) on ``device`` (the card unless
    ``"cpu"``; with a ``mesh``, this rank's shards on its device), the
    optimizer's state over its trainable leaves (its ZeRO view: 1/dp of
    each leaf ``_zero1_spec`` shards, under ``zero1``/``zero2``), and the
    step of :func:`make_train_step`."""
    optimizer, step = make_train_step(cfg, mesh, optimizer, accum, zero1, zero2)
    model = Labformer.from_numpy(init_params(cfg, seed), cfg, device, trainable=True,
                                 mesh=mesh)
    zv = step.zero_view(model)
    with optim.leaf_splits(zv.splits, sharded.sum_over):
        return model, optimizer.init(zv.view(_flat(model)), zv.leaves()), step


def _whole_model(tree: Dict[str, Any], cfg: LabformerConfig) -> Labformer:
    """A CPU stand-in of the whole model (``ckpt``'s input): the one-device
    layout of ``tree``."""
    return Labformer(tree, cfg, "cpu", trainable=True)


def save_snapshot(ckpt_dir: str, step: int, model: Labformer, opt_state, train_step) -> None:
    """``ckpt.save`` of the whole tree and the whole optimizer state (the
    ZeRO moments gathered) of a model on a mesh, written by rank 0: a
    collective of every rank, so any topology resumes from it."""
    tree = gather_params(model)
    state = sharded.gather_opt_state(model, opt_state, train_step.zero_view(model))
    if dist.get_rank() == 0:
        ckpt.save(ckpt_dir, step, _whole_model(tree, model.cfg), state)
    dist.barrier()


def restore_snapshot(ckpt_dir: str, step: int, model: Labformer, opt_state, train_step) -> None:
    """Load snapshot ``step`` (of any topology) into this rank's shards and
    its part of the optimizer state, in place."""
    whole = _whole_model(ckpt.read_params(ckpt_dir, step), model.cfg)
    state = train_step.optimizer.init(_flat(whole), _leaf_sizes(whole))
    ckpt.restore(ckpt_dir, step, whole, state)
    model.assign_whole(whole.to_tree())
    sharded.fill_opt_state(model, opt_state, state, train_step.zero_view(model),
                           len(_flat(whole)))


# ------------------------------------------------------------ layers


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies, computed in float64 and rounded to f32 as
    ``tpulab`` does; kept on ``device`` so no layer copies them again.  On
    the card they leave from pinned memory, so even this first copy does
    not wait for the work already queued."""
    host = torch.from_numpy((theta ** (-np.arange(0, half) / half)).astype(np.float32))
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding over (..., seq, heads, head_dim), at
    ``positions`` (seq,) shared by every row or (batch, seq) per row."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    angles = positions[..., None].float() * freqs  # (seq, half) or (batch, seq, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def repeat_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int):
    """Expand kv-width K/V (..., kv_heads, head_dim) to full head parity,
    contiguously: query head ``i`` attends kv head ``i // (n_heads // kv_heads)``."""
    kvh = k.shape[-2]
    if kvh == n_heads:
        return k, v
    g = n_heads // kvh
    return k.repeat_interleave(g, dim=-2), v.repeat_interleave(g, dim=-2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: LabformerConfig,
           n_tokens: int) -> torch.Tensor:
    """Causal attention of (b, s, h, d) q over kv-width K/V, by the path
    ``use_flash`` picks: kernel B4, or the dense oracle on repeated K/V."""
    if use_flash(cfg.attn_impl, n_tokens):
        from tpulab_torch.ops.cuda.attention import flash_attention

        return flash_attention(q, k, v, causal=True, window=cfg.attn_window)
    return attention_reference(q, *repeat_kv(k, v, q.shape[-2]), causal=True,
                               window=cfg.attn_window)


def _attention(x: torch.Tensor, blk: _Weights, cfg: LabformerConfig,
               positions: torch.Tensor, plan=None) -> torch.Tensor:
    """Causal self-attention of the block.  On a mesh (``plan``), this
    rank's heads of its tokens: the head columns split over tp (Megatron:
    ``copy_to`` in, ``reduce_from`` after ``wo``), and over sp > 1 the
    ring, zigzag or Ulysses body of ``cfg.sp_impl`` on the sp group."""
    b, s, d = x.shape
    tp = plan.tp if plan is not None else None
    n_tp = tp.p if tp is not None else 1
    h, dh, kvh = cfg.n_heads // n_tp, cfg.head_dim, cfg.kv_heads
    kv_split = plan is None or plan.kv_split
    if kv_split:
        kvh //= n_tp
    xc = spmd.copy_to(x, tp)
    q_proj = xc @ blk.wq
    v_proj = xc @ blk.wv
    if cfg.lora_rank:
        scale = torch.tensor(cfg.lora_alpha / cfg.lora_rank, dtype=torch.float64).to(x.dtype)
        q_proj = q_proj + spmd.copy_to(x @ blk.wq_lora_a, tp) @ blk.wq_lora_b * scale.to(x.device)
        v_proj = v_proj + spmd.copy_to(x @ blk.wv_lora_a, tp) @ blk.wv_lora_b * scale.to(x.device)
    q = q_proj.reshape(b, s, h, dh)
    k = (xc @ blk.wk).reshape(b, s, kvh, dh)
    v = v_proj.reshape(b, s, kvh, dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if not kv_split:  # every kv head here: keep this tp rank's query heads' share
        k, v = (t.narrow(2, tp.idx * h, h) for t in repeat_kv(k, v, cfg.n_heads))
    sp = plan.sp if plan is not None else None
    if sp is not None:
        o = _sp_attention(q, *repeat_kv(k, v, h), cfg, sp, n_tp)
    else:
        o = attend(q, k, v, cfg, s)
    return spmd.reduce_from(o.reshape(b, s, h * dh) @ blk.wo, tp)


def _sp_attention(q, k, v, cfg: LabformerConfig, sp, n_tp: int) -> torch.Tensor:
    """``tpulab``'s sp branch (``tpulab/models/labformer.py:396-456``): the
    body of ``cfg.sp_impl`` and ``cfg.attn_impl`` over this rank's sequence
    shard (zigzag: the permuted layout the model boundary made)."""
    if cfg.attn_window and cfg.sp_impl == "zigzag":
        raise NotImplementedError(
            "attn_window over sp > 1 requires sp_impl='ulysses' or "
            "'ring' (zigzag's balance argument is void under a "
            "window — use ring)")
    s_local = q.shape[1]
    if cfg.sp_impl == "zigzag":
        body = ring._zigzag_local_body(cfg.attn_impl, s_local)
    elif cfg.sp_impl == "ulysses":
        if (cfg.n_heads // n_tp) % sp.p:
            raise ValueError(f"ulysses needs local heads divisible by sp: "
                             f"{cfg.n_heads} heads / tp={n_tp} over sp={sp.p}")
        body = functools.partial(ring._ulysses_body, causal=True, local_impl=cfg.attn_impl,
                                 window=cfg.attn_window)
    else:
        body = ring._ring_local_body(cfg.attn_impl, s_local, causal=True,
                                     window=cfg.attn_window)
    return body(q, k, v, ring.GroupExchange(sp))


def _moe_aux_loss(gate: torch.Tensor, top: torch.Tensor, n_experts: int):
    """Switch load-balancing loss and per-expert load: ``(aux, f)``."""
    f = F.one_hot(top, n_experts).float().mean(dim=(0, 1))
    p = gate.mean(dim=(0, 1))
    return n_experts * (f * p).sum(), f


def _mesh_aux_loss(gate: torch.Tensor, top: torch.Tensor, n_experts: int, plan):
    """:func:`_moe_aux_loss` over the global tokens of a mesh: the per-rank
    sums of ``f`` and ``P`` summed over the data axes before the product
    (``P``'s all-reduce hands each rank the whole gradient, so the data
    axes' gradient sum counts each rank's tokens once)."""
    n = gate.shape[0] * gate.shape[1] * plan.data_ranks
    ep = plan.axis("ep")
    f = spmd.all_reduce_(F.one_hot(top, n_experts).float().sum(dim=(0, 1)), ep)
    p = spmd.reduce_from(gate.sum(dim=(0, 1)), ep)
    f, p = f / n, p / n
    return n_experts * (f * p).sum(), f


def _mlp(x: torch.Tensor, blk: _Weights, cfg: LabformerConfig, plan=None):
    """``(y, (aux, f))``: block output, router loss, per-expert load
    ((1,) zeros for the dense MLP).  On a mesh (``plan``): ``d_ff`` split
    over tp (Megatron), and the experts over the fused (dp, sp) axis,
    gathered for the dense combine or reached by the all_to_all dispatch
    of ``moe_impl="dispatch"``."""
    tp = plan.tp if plan is not None else None
    if cfg.n_experts:
        gate = torch.softmax((x @ blk.router).float(), dim=-1)
        top = gate.argmax(dim=-1)
        if plan is None or plan.data_ranks == 1:
            aux = _moe_aux_loss(gate, top, cfg.n_experts)
        else:
            aux = _mesh_aux_loss(gate, top, cfg.n_experts, plan)
        b_, s_, d_ = x.shape
        if plan is not None and plan.moe_dispatch:
            return _dispatch(x, blk, cfg, plan), aux
        weights = combine_weights(gate.reshape(b_ * s_, -1), cfg.moe_top_k,
                                  x.dtype).reshape(b_, s_, cfg.n_experts)
        ep = plan.axis("ep") if plan is not None else None
        w1, w2 = spmd.gather_shards(blk.w1, ep, 0), spmd.gather_shards(blk.w2, ep, 0)
        hidden = F.gelu(torch.einsum("bsd,edf->bsef", spmd.copy_to(x, tp), w1),
                        approximate="tanh")
        out = torch.einsum("bsef,efd->bsed", hidden, w2)
        return spmd.reduce_from(torch.einsum("bsed,bse->bsd", out, weights), tp), aux
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = (zero, torch.zeros((1,), dtype=torch.float32, device=x.device))
    return spmd.reduce_from(qmat(F.gelu(qmat(spmd.copy_to(x, tp), blk.w1), approximate="tanh"),
                                 blk.w2), tp), aux


def _dispatch(x: torch.Tensor, blk: _Weights, cfg: LabformerConfig, plan) -> torch.Tensor:
    """``moe_impl="dispatch"`` (``tpulab/models/labformer.py:496-523``):
    ``parallel.moe._moe_body`` over the fused (dp, sp) axis, on ``tpulab``'s
    token groups (rows of the global ``(batch * seq)`` array, cut into
    equal runs per rank), with ``d_ff`` split over tp."""
    if plan.ep is None:
        raise ValueError("dispatch MoE needs dp and/or sp mesh axes")
    b, s, d = x.shape
    p = plan.data_ranks
    n_local = b * s  # b * s / (dp * sp) of the global tokens
    capacity = dispatch_capacity(cfg.moe_capacity_factor, cfg.moe_top_k, n_local, cfg.n_experts)
    blocks, runs = _token_partitions(plan, b, s, d)
    ep = plan.axis("ep")
    flat = spmd.repartition(x, ep, blocks, runs) if p > 1 else x.reshape(b * s, d)
    y = _moe_body(flat, blk.router, blk.w1, blk.w2, plan.ep, n_experts=cfg.n_experts,
                  capacity=capacity, k=cfg.moe_top_k, tp=plan.tp)
    return spmd.repartition(y, ep, runs, blocks) if p > 1 else y.reshape(b, s, d)


def _token_partitions(plan, b: int, s: int, d: int):
    """The two cuts of the global ``(B, S, d)`` token array among the (dp,
    sp) ranks: ``blocks`` (rank (i, j) holds batch rows i and sequence
    shard j, its activations) and ``runs`` (rank r holds rows ``[r n, (r+1)
    n)`` of the row-major ``(B * S, d)`` array, ``tpulab``'s shard_map
    groups)."""
    dp, sp = plan.size["dp"], plan.size["sp"]
    p, n = dp * sp, b * s

    def take_block(whole, r):  # the fused axis is row-major: r = i * sp + j
        i, j = divmod(r, sp)
        return whole[i * b:(i + 1) * b, j * s:(j + 1) * s]

    def assemble_blocks(parts):
        return torch.cat([torch.cat(parts[i * sp:(i + 1) * sp], dim=1) for i in range(dp)],
                         dim=0)

    def take_run(whole, r):
        return whole.reshape(p * n, d)[r * n:(r + 1) * n]

    def assemble_runs(parts):
        return torch.cat(parts, dim=0).reshape(dp * b, sp * s, d)

    return spmd.Partition(take_block, assemble_blocks), spmd.Partition(take_run, assemble_runs)


# ------------------------------------------------------------ the oracle


def dryrun_train_step(n_devices: int, backend: Optional[str] = None) -> None:
    """One sharded training step on tiny shapes over an ``n_devices`` mesh
    (``tpulab``'s ``dryrun_train_step``, the oracle of
    ``__graft_entry__.dryrun_multichip``), run in every rank of a pool of
    ``n_devices`` (or in this process for 1).

    The mesh's ``(dp, sp, tp, pp)`` sizes are factored from
    ``n_devices``; the MoE config sends its tokens through the all_to_all
    dispatch over ``(dp, sp)``, and the optimizer runs ZeRO-1.  The loss
    must be finite and ``wq`` must change.  With more than one device a
    dp-only mesh then certifies ZeRO: every moment leaf with an axis
    divisible by dp holds 1/dp on each rank, and ZeRO-2's first loss is
    within 1e-5 of ZeRO-1's."""
    mesh = make_mesh(n_devices=n_devices, axes=("dp", "sp", "tp", "pp"), backend=backend)
    shape = mesh_shape(mesh)
    sp, tp, pp = shape["sp"], shape["tp"], shape["pp"]
    cfg = LabformerConfig(
        d_model=max(32, 8 * tp) * 2, n_heads=max(4, tp * sp), n_layers=max(2, 2 * pp),
        d_ff=64, n_experts=4, max_seq=64, moe_impl="dispatch")
    model, opt_state, train_step = init_train_state(cfg, mesh, seed=0, zero1=True)
    rng = np.random.default_rng(1)
    seq = 8 * sp + 1  # +1: the loss shifts tokens and targets
    tokens = rng.integers(0, cfg.vocab, (2 * shape["dp"], seq)).astype(np.int32)
    before = gather_params(model)["blocks"]["wq"][0, 0, :4].clone()
    model, opt_state, loss = train_step(model, opt_state, tokens)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    after = gather_params(model)["blocks"]["wq"][0, 0, :4]
    assert not torch.allclose(before, after), "params did not update"

    if n_devices > 1:
        dp_mesh = make_mesh({"dp": n_devices}, backend=backend)
        zcfg = LabformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=8 * n_devices,
                               max_seq=64)
        ztok = rng.integers(0, zcfg.vocab, (n_devices, 17)).astype(np.int32)
        zm, zs, zstep = init_train_state(zcfg, dp_mesh, seed=0, zero1=True)
        zm, zs, zloss = zstep(zm, zs, ztok)
        assert np.isfinite(float(zloss)), "zero1 loss not finite"
        zm2, zs2, zstep2 = init_train_state(zcfg, dp_mesh, seed=0, zero2=True)
        zm2, zs2, zloss2 = zstep2(zm2, zs2, ztok)
        assert np.isfinite(float(zloss2)), "zero2 loss not finite"
        assert abs(float(zloss) - float(zloss2)) <= 1e-5, "zero2 first-step loss diverged from zero1"
        split, i = 0, 0
        view = zstep.zero_view(zm)
        for path, n, mode, arg in view.items:
            k = arg if mode == "layers" else n
            mine = sum(t.numel() for t in zs[0]["mu"][i:i + k])
            i += k
            whole = dict(zm.trainable_leaves())[path]
            shape_ = ((len(whole),) if path.startswith("blocks/") else ()) + tuple(whole[0].shape)
            if any(d % n_devices == 0 and d >= n_devices for d in shape_):
                assert mine * n_devices == math.prod(shape_), (path, mine, shape_)
                split += 1
        assert split, "no optimizer moment was dp-sharded"
