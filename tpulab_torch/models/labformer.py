"""Labformer, the framework's byte-level decoder transformer, on PyTorch
(the counterpart of ``tpulab.models.labformer``, single device).

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

What needs a mesh (sequence parallelism, the all_to_all MoE dispatch,
ZeRO) waits for mesh training, ROADMAP A12.3.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpulab_torch import optim
from tpulab_torch.models.quant import QTensor, qmat
from tpulab_torch.parallel.ring import attention_reference, use_flash
from tpulab_torch.runtime.device import resolve_device


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

    def forward(self, x: torch.Tensor, cfg: LabformerConfig, positions: torch.Tensor):
        x = x + _attention(_rmsnorm(x, self.ln1), self, cfg, positions)
        y, aux_f = _mlp(_rmsnorm(x, self.ln2), self, cfg)
        return x + y, aux_f


class Labformer(nn.Module):
    """The labformer on one device.  ``forward(tokens)`` gives next-token
    logits for ``tokens`` (batch, seq) int.

    ``trainable`` makes the parameters require grad: every leaf, or with
    ``cfg.lora_rank`` the adapter leaves only (``tpulab``'s LoRA step
    differentiates the adapter subtree alone)."""

    def __init__(self, params: Dict[str, Any], cfg: LabformerConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 trainable: bool = False):
        super().__init__()
        if cfg.n_experts and cfg.moe_impl == "dispatch":
            raise NotImplementedError(
                "moe_impl='dispatch' routes over a mesh; the port trains on one "
                "device until mesh training (ROADMAP A12.3)")
        device = resolve_device(device) if device is None or isinstance(device, str) \
            else torch.device(device)
        self.cfg = cfg
        tree = {k: _to_torch(v) for k, v in params.items() if k != "blocks"}
        blocks = {k: _to_torch(v) for k, v in params["blocks"].items()}
        def learns(name: str) -> bool:
            return trainable and (not cfg.lora_rank or "_lora_" in name)

        self.top = _Weights(tree, device, learns)
        self.blocks = nn.ModuleList(
            Block(_layer(blocks, i), device, learns) for i in range(cfg.n_layers))

    @classmethod
    def from_numpy(cls, params: Dict[str, Any], cfg: LabformerConfig,
                   device: Optional[Union[str, torch.device]] = None,
                   trainable: bool = False) -> "Labformer":
        """The module from ``tpulab``'s parameter tree (numpy leaves,
        per-layer leaves stacked on axis 0), on ``device`` (the card unless
        ``"cpu"``)."""
        return cls(params, cfg, device, trainable)

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

    @property
    def device(self) -> torch.device:
        embed = self.top.embed
        return (embed.q if isinstance(embed, QTensor) else embed).device

    def tokens(self, tokens) -> torch.Tensor:
        """``tokens`` as an int64 tensor on the model's device."""
        return torch.as_tensor(tokens, device=self.device).long()

    def _forward_scan(self, tokens):
        """(logits, aux_per_layer (L,), load_per_layer (L, E or 1))."""
        tokens = self.tokens(tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        x = self.top.embed[tokens]
        auxes, loads = [], []
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:  # keep the block's input (and its products under "dots"); recompute the rest
                x, (aux, load) = checkpoint(blk, x, self.cfg, positions, use_reentrant=False,
                                            **_remat_context(self.cfg.remat_policy))
            else:
                x, (aux, load) = blk(x, self.cfg, positions)
            auxes.append(aux)
            loads.append(load)
        x = _rmsnorm(x, self.top.final_norm)
        logits = x @ self.top.embed.T  # tied head
        return logits, torch.stack(auxes), torch.stack(loads)

    def forward_with_aux(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, mean per-layer router load-balancing loss; 0 when dense)."""
        logits, aux_per_layer, _ = self._forward_scan(tokens)
        return logits, aux_per_layer.mean()

    def forward(self, tokens) -> torch.Tensor:
        """Logits for next-token prediction; ``tokens`` (batch, seq) int."""
        return self.forward_with_aux(tokens)[0]

    def expert_load(self, tokens) -> torch.Tensor:
        """(n_layers, n_experts) fraction of tokens argmax-routed per expert."""
        return self._forward_scan(tokens)[2]

    def loss_fn(self, tokens) -> torch.Tensor:
        """Causal next-byte cross entropy, plus the weighted router
        load-balancing loss when the model has experts."""
        tokens = self.tokens(tokens)
        logits, aux = self.forward_with_aux(tokens[:, :-1])
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
        loss = -ll.mean()
        if self.cfg.n_experts and self.cfg.moe_aux_weight:
            loss = loss + np.float32(self.cfg.moe_aux_weight).item() * aux
        return loss


# ------------------------------------------------------------ training


def _refuse_mesh_options(cfg: LabformerConfig, mesh, zero1: bool, zero2: bool) -> None:
    if mesh is not None or zero1 or zero2:
        raise NotImplementedError(
            "mesh training (sp, ZeRO-1/2, dispatch MoE) is not ported yet "
            "(ROADMAP A12.3); train on one device with mesh=None")


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


def _accum_backward(model: Labformer, tokens: torch.Tensor, accum: int,
                    leaves: List[torch.Tensor]) -> torch.Tensor:
    """The loss, with the gradient left in each leaf's ``.grad``; ``accum``
    > 1 averages microbatches as ``tpulab``'s ``_accum_value_and_grad``:
    losses and gradients summed in order from zero, then times
    ``float32(1 / accum)``."""
    if accum <= 1:
        loss = model.loss_fn(tokens)
        loss.backward()
        return loss.detach()
    micro = tokens.reshape(accum, tokens.shape[0] // accum, tokens.shape[1])
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for mb in micro:
        loss = model.loss_fn(mb)
        loss.backward()
        total = total + loss.detach()
    inv = float(np.float32(1.0 / accum))
    with torch.no_grad():
        for p in leaves:
            p.grad.mul_(optim._scalar(inv, p.grad))
    return total * inv


def make_train_step(cfg: LabformerConfig, mesh=None, optimizer: Optional[optim.Transform] = None,
                    accum: int = 1, zero1: bool = False, zero2: bool = False):
    """``(optimizer, step)``: ``step(model, opt_state, tokens) -> (model,
    opt_state, loss)`` on a trainable :class:`Labformer`, the counterpart of
    ``tpulab``'s ``make_train_step``.

    The step takes the loss's gradient (``accum`` > 1: averaged over that
    many microbatches of the batch), leaves it in each trainable leaf's
    ``.grad`` (where the bridge reads it), and applies ``optimizer``
    (default ``optim.adamw(3e-4)``, as ``tpulab``'s) to the parameters and
    ``opt_state`` in place.  Under ``cfg.lora_rank`` only the adapter
    leaves are trainable, so only they get gradients and optimizer state.
    ``loss`` is a device scalar (reading it waits for the step).

    ``step.step_k(model, opt_state, block)`` runs K steps over one
    ``(K, batch, seq+1)`` token block, uploaded once, and returns the K
    losses as one ``(K,)`` device tensor with no host read: ``tpulab``'s
    fused K-step program (``tpulab/models/labformer.py:654-682``), run
    eagerly.  The K steps are the same step, in order, so the losses and
    parameters are bit-equal to K calls of ``step``."""
    _refuse_mesh_options(cfg, mesh, zero1, zero2)
    optimizer = optimizer or optim.adamw(3e-4)

    def train_step(model: Labformer, opt_state, tokens):
        leaves = _flat(model)
        for p in leaves:
            p.grad = None
        loss = _accum_backward(model, model.tokens(tokens), accum, leaves)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        with torch.no_grad():
            optim.apply_updates(leaves, optimizer.update(grads, opt_state, leaves))
        return model, opt_state, loss

    def step_k(model: Labformer, opt_state, block):
        losses = []
        for tokens in model.tokens(block):
            model, opt_state, loss = train_step(model, opt_state, tokens)
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    train_step.step_k = step_k
    return optimizer, train_step


def init_train_state(cfg: LabformerConfig, mesh=None, seed: int = 0,
                     optimizer: Optional[optim.Transform] = None, accum: int = 1,
                     zero1: bool = False, zero2: bool = False,
                     device: Optional[Union[str, torch.device]] = None):
    """``(model, opt_state, step)``: the trainable model from
    :func:`init_params` (``seed``) on ``device`` (the card unless
    ``"cpu"``), the optimizer's state over its trainable leaves, and the
    step of :func:`make_train_step`."""
    optimizer, step = make_train_step(cfg, mesh, optimizer, accum, zero1, zero2)
    model = Labformer.from_numpy(init_params(cfg, seed), cfg, device, trainable=True)
    return model, optimizer.init(_flat(model), _leaf_sizes(model)), step


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
               positions: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    h, dh, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    q_proj = x @ blk.wq
    v_proj = x @ blk.wv
    if cfg.lora_rank:
        scale = torch.tensor(cfg.lora_alpha / cfg.lora_rank, dtype=torch.float64).to(x.dtype)
        q_proj = q_proj + (x @ blk.wq_lora_a) @ blk.wq_lora_b * scale.to(x.device)
        v_proj = v_proj + (x @ blk.wv_lora_a) @ blk.wv_lora_b * scale.to(x.device)
    q = q_proj.reshape(b, s, h, dh)
    k = (x @ blk.wk).reshape(b, s, kvh, dh)
    v = v_proj.reshape(b, s, kvh, dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    return attend(q, k, v, cfg, s).reshape(b, s, d) @ blk.wo


def _route(gate: torch.Tensor, k: int, dtype: torch.dtype):
    """(eids (n*k,), scales (n*k,)): top-k routing, token-major.  ``k == 1``
    keeps the raw softmax mass; ``k > 1`` renormalizes over the chosen."""
    top_vals, top_ids = torch.topk(gate, k, dim=-1)
    if k > 1:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return top_ids.reshape(-1), top_vals.reshape(-1).to(dtype)


def combine_weights(gate: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """Dense (n, E) combine matrix from top-k routing."""
    n, n_experts = gate.shape
    eid, gval = _route(gate, k, dtype)
    rows = torch.arange(n, device=gate.device).repeat_interleave(k)
    out = torch.zeros((n, n_experts), dtype=dtype, device=gate.device)
    return out.index_put_((rows, eid), gval, accumulate=True)


def _moe_aux_loss(gate: torch.Tensor, top: torch.Tensor, n_experts: int):
    """Switch load-balancing loss and per-expert load: ``(aux, f)``."""
    f = F.one_hot(top, n_experts).float().mean(dim=(0, 1))
    p = gate.mean(dim=(0, 1))
    return n_experts * (f * p).sum(), f


def _mlp(x: torch.Tensor, blk: _Weights, cfg: LabformerConfig):
    """``(y, (aux, f))``: block output, router loss, per-expert load
    ((1,) zeros for the dense MLP)."""
    if cfg.n_experts:
        gate = torch.softmax((x @ blk.router).float(), dim=-1)
        top = gate.argmax(dim=-1)
        aux = _moe_aux_loss(gate, top, cfg.n_experts)
        b_, s_, _ = x.shape
        weights = combine_weights(gate.reshape(b_ * s_, -1), cfg.moe_top_k,
                                  x.dtype).reshape(b_, s_, cfg.n_experts)
        hidden = F.gelu(torch.einsum("bsd,edf->bsef", x, blk.w1), approximate="tanh")
        out = torch.einsum("bsef,efd->bsed", hidden, blk.w2)
        return torch.einsum("bsed,bse->bsd", out, weights), aux
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = (zero, torch.zeros((1,), dtype=torch.float32, device=x.device))
    return qmat(F.gelu(qmat(x, blk.w1), approximate="tanh"), blk.w2), aux
