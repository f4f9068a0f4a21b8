"""Where the labformer's parameters, batch and optimizer state lie on the
``(dp, sp, tp, pp)`` mesh of ``tpulab``'s trainer (the counterpart of
``tpulab/models/labformer.py:203-340``), and the collectives of its
training step (``models.labformer.make_train_step``).

``tpulab`` states shardings and lets GSPMD place the collectives.  The
port is SPMD: each rank (one process, one device) holds its own shards
and its own slice of the batch, and the collectives are written out.

* **Placement** (:class:`Plan`): ``tpulab``'s spec table
  (:func:`param_specs`): the layer axis over ``pp`` (stage ``r`` holds
  layers ``[r L/pp, (r+1) L/pp)``); the head columns of ``wq``, ``wk``,
  ``wv`` (and the LoRA ``B``s), the rows of ``wo``, and the ``d_ff`` of
  ``w1``/``w2`` over ``tp``; the expert axis over the fused ``(dp, sp)``
  axis ("ep").  The port deviates twice: the embedding is whole on every
  rank (GSPMD splits its ``d_model`` over tp), and ``wk``/``wv`` stay whole
  on every tp rank where ``kv_heads % tp`` (GSPMD splits them mid-head;
  the port computes every kv head and keeps its own query heads' share).
  :meth:`Plan.take` and :meth:`Plan.gather` are exact inverses.
* **tp** is Megatron's: :func:`spmd.copy_to` before a column-split
  product, :func:`spmd.reduce_from` after a row-split one.
* **sp** runs the ring, zigzag or Ulysses bodies of ``parallel.ring``
  over the sp group (``models.labformer._attention``); zigzag permutes
  the tokens and the targets once, rope keeps the original positions.
* **pp** runs the stages one after another on the whole local batch (no
  microbatches, as ``tpulab``'s scan over a pp-sharded layer axis):
  stage ``r`` receives the residual stream from ``r-1`` and sends its own
  to ``r+1``; the backward sends the gradient back the same way.
* **dp, sp**: a rank's loss is its tokens' share of the global mean; each
  gradient is summed over the axes its leaf is replicated on (dp and sp,
  pp for the embedding and the final norm), not over tp, where the
  Megatron exchanges already give every rank the whole gradient.
* **ZeRO-1/2** (:class:`ZeroView`): the optimizer sees each leaf's dp
  slice on the axis ``tpulab``'s ``_zero1_spec`` picks; its update is
  all-gathered over dp.  ZeRO-2 reduce-scatters the gradients over dp
  (after each ``accum`` microbatch) instead of all-reducing them.
* **Whole-leaf statistics** (adafactor's): :attr:`ZeroView.splits` says
  how each leaf of the optimizer's view lies across the ranks (its global
  shape, the axes splitting each dim), which ``optim.leaf_splits`` hands
  to the optimizer; each rank keeps its part of every statistic, and a
  mesh snapshot gathers them into the one-device layout.

A plan without a mesh is one device: every axis has size 1, every
collective is skipped, and the step runs the one-device arithmetic.

A plan also places the serving engine's parameters on the ``("batch",
"model")`` serving mesh (``parallel.mesh.serving_mesh``) or the legacy
``{"tp": N}`` one, as ``tpulab``'s ``shard_serving_params`` does: the model
axis (or ``"tp"``) takes tp's role in the layout above, and ``"batch"`` is
a data axis no parameter is split on.  Serving runs the dense MoE, as
``tpulab``'s engine does (dispatch MoE is a training layout).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpulab_torch import optim
from tpulab_torch.parallel import spmd
from tpulab_torch.parallel.mesh import mesh_anchor, mesh_shape
from tpulab_torch.parallel.ring import _zigzag_perm
from tpulab_torch.runtime.device import resolve_device

AXES = ("dp", "sp", "tp", "pp")
#: the axes of a serving mesh: ``"model"`` is the tp role, ``"batch"`` splits slots
SERVING_AXES = ("batch", "model")

# ------------------------------------------------------------ placement rules
#
# ``tpulab``'s sharding rules (``tpulab/models/labformer.py:204-294``): leaf
# name -> the mesh axis of each dim (a tuple entry fuses axes), layer axis
# first for blocks; the expert axis rides the fused (dp, sp) submesh.

_SPECS = {
    "embed": (None, "tp"),
    "final_norm": (None,),
    "ln1": ("pp", None),
    "ln2": ("pp", None),
    "wq": ("pp", None, "tp"),
    "wk": ("pp", None, "tp"),
    "wv": ("pp", None, "tp"),
    "wo": ("pp", "tp", None),
    "router": ("pp", None, None),
    "wq_lora_a": ("pp", None, None),
    "wq_lora_b": ("pp", None, "tp"),
    "wv_lora_a": ("pp", None, None),
    "wv_lora_b": ("pp", None, "tp"),
}
_SPECS_DENSE = {"w1": ("pp", None, "tp"), "w2": ("pp", "tp", None)}
_SPECS_MOE = {"w1": ("pp", ("dp", "sp"), None, "tp"), "w2": ("pp", ("dp", "sp"), "tp", None)}

#: the leaves the port keeps whole over tp where ``kv_heads % tp``
_KV_LEAVES = ("wk", "wv", "wv_lora_b")


def param_specs(cfg) -> Dict[str, Any]:
    """The spec tree of ``cfg``'s parameters (``tpulab``'s ``param_specs``)."""
    mlp = _SPECS_MOE if cfg.n_experts else _SPECS_DENSE
    block = {k: _SPECS[k] for k in ("ln1", "wq", "wk", "wv", "wo", "ln2")}
    block.update({k: mlp[k] for k in ("w1", "w2")})
    if cfg.n_experts:
        block["router"] = _SPECS["router"]
    if cfg.lora_rank:
        for k in ("wq_lora_a", "wq_lora_b", "wv_lora_a", "wv_lora_b"):
            block[k] = _SPECS[k]
    return {"embed": _SPECS["embed"], "final_norm": _SPECS["final_norm"], "blocks": block}


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else mesh_shape(mesh)


def _restrict(spec: tuple, mesh) -> tuple:
    """Drop the axes ``mesh`` (a mesh, ``{axis: size}`` or axis names) does
    not name; a fused entry keeps two or more names, else collapses."""
    names = mesh if isinstance(mesh, (tuple, list)) else tuple(_mesh_sizes(mesh))

    def keep(entry):
        if entry is None:
            return None
        kept = tuple(n for n in (entry if isinstance(entry, tuple) else (entry,))
                     if n in names)
        return kept if len(kept) > 1 else (kept[0] if kept else None)

    return tuple(keep(e) for e in spec)


def _zero1_axis(shape, spec: tuple, mesh) -> Optional[int]:
    """The dim ``tpulab``'s ZeRO-1 puts ``"dp"`` on for a moment leaf of
    ``shape`` and ``spec``: the first unsplit one divisible by the dp size;
    None where dp is 1 or absent, where the spec already uses dp (MoE
    experts), or where no dim divides."""
    dp = _mesh_sizes(mesh).get("dp", 1)
    if dp <= 1:
        return None
    spec = _restrict(spec, mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(e == "dp" or (isinstance(e, tuple) and "dp" in e) for e in entries):
        return None
    return next((i for i, (dim, e) in enumerate(zip(shape, entries))
                 if e is None and dim % dp == 0 and dim >= dp), None)


def _zero1_spec(shape, spec: tuple, mesh) -> tuple:
    """The ZeRO-1 spec of an optimizer-moment leaf (``tpulab``'s): the
    leaf's restricted spec with ``"dp"`` on :func:`_zero1_axis`'s dim, or
    unchanged where it has none."""
    axis = _zero1_axis(shape, spec, mesh)
    spec = _restrict(spec, mesh)
    if axis is None:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    entries[axis] = "dp"
    return tuple(entries)


class Plan:
    """This rank's place in a training mesh, for one config: its axes (an
    :class:`spmd.Axis`, None where the size is 1), its stage, and where
    each parameter leaf lies.  Every rank makes the plan's process groups
    together, in one order, when it is built.  Without a ``mesh`` the plan
    is one device (``device``: the card unless ``"cpu"``), every axis of
    size 1.  ``serving`` (implied by a ``("batch", "model")`` mesh) places
    the serving engine's parameters: the same layout, the dense MoE, and
    :attr:`batch` the axis the engine splits its slots over."""

    def __init__(self, mesh, cfg, device=None, serving: bool = False):
        self.mesh, self.cfg = mesh, cfg
        self.shape = mesh_shape(mesh) if mesh is not None else {}
        # a serving mesh names batch and model; model plays tp's part
        self.serving = serving or any(a in self.shape for a in SERVING_AXES)
        unknown = sorted(set(self.shape) - set(AXES) - set(SERVING_AXES))
        if unknown or (self.serving and set(self.shape) - set(SERVING_AXES) - {"tp"}) \
                or {"tp", "model"} <= set(self.shape):
            raise ValueError(f"mesh axes {sorted(self.shape)}: the labformer trains over "
                             f"{AXES} and serves over {SERVING_AXES} (or tp)")
        names = {a: a for a in AXES}
        if "model" in self.shape:
            names["tp"] = "model"
        self.size = {a: self.shape.get(names[a], 1) for a in AXES}
        self.ax = {a: spmd.mesh_axis(mesh, names[a]) if self.size[a] > 1 else None
                   for a in AXES}
        n_batch = self.shape.get("batch", 1)
        self.batch = spmd.mesh_axis(mesh, "batch") if n_batch > 1 else None
        # tpulab routes by all_to_all only where a training mesh is given
        self.moe_dispatch = mesh is not None and not self.serving and \
            cfg.moe_impl == "dispatch"
        self.idx = {a: self.ax[a].idx if self.ax[a] is not None else 0 for a in AXES}
        # tpulab's expert axis: the data axes the mesh names, fused
        self.ep_axes = tuple(a for a in ("dp", "sp") if a in self.shape)
        n_ep = math.prod(self.size[a] for a in self.ep_axes)
        if n_ep > 1:
            self.ep = spmd.mesh_axis(mesh, self.ep_axes)
        else:
            self.ep = spmd.Axis(None, 0, 1) if self.ep_axes else None
        tp, pp = self.size["tp"], self.size["pp"]
        if cfg.n_heads % tp:
            raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={tp}")
        if cfg.d_ff % tp:
            raise ValueError(f"d_ff={cfg.d_ff} not divisible by tp={tp}")
        if cfg.n_layers % pp:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
        if cfg.n_experts and cfg.n_experts % n_ep:
            raise ValueError(f"{cfg.n_experts} experts not divisible by the (dp, sp) "
                             f"axis of {n_ep} ranks")
        self.kv_split = cfg.kv_heads % tp == 0
        self.stage, self.n_stages = self.idx["pp"], pp
        self.n_local_layers = cfg.n_layers // pp
        self.specs = param_specs(cfg)
        if mesh is not None:
            self.device = mesh_anchor(mesh)
        elif device is None or isinstance(device, str):
            self.device = resolve_device(device)
        else:
            self.device = torch.device(device)

    # ------------------------------------------------------------ axes

    @property
    def tp(self) -> Optional[spmd.Axis]:
        return self.ax["tp"]

    @property
    def sp(self) -> Optional[spmd.Axis]:
        return self.ax["sp"]

    @property
    def pp(self) -> Optional[spmd.Axis]:
        return self.ax["pp"]

    @property
    def data_ranks(self) -> int:
        """Ranks that hold different tokens: dp x sp."""
        return self.size["dp"] * self.size["sp"]

    def axis(self, name: Optional[str]) -> Optional[spmd.Axis]:
        if name == "ep":
            return self.ep if self.ep is not None and self.ep.p > 1 else None
        return self.ax.get(name) if name else None

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1

    # ------------------------------------------------------------ leaves

    def tpulab_spec(self, path: str) -> tuple:
        """``tpulab``'s spec of the stacked leaf ``path``."""
        return self.specs["blocks"][path[7:]] if path.startswith("blocks/") else self.specs[path]

    def spec(self, path: str) -> Tuple[Optional[str], ...]:
        """The axis each dim of the stacked leaf ``path`` is split over
        (``"ep"``: the fused (dp, sp) axis), as this rank holds it:
        :meth:`tpulab_spec` with the port's two deviations."""
        name = path.split("/")[-1]
        if name == "embed":
            return (None, None)
        spec = self.tpulab_spec(path)
        if name in _KV_LEAVES and not self.kv_split:
            spec = spec[:-1] + (None,)
        return tuple("ep" if isinstance(e, tuple) else e for e in spec)

    def split_axes(self, path: str) -> Tuple[str, ...]:
        """The axes over which ranks hold different parts of ``path``."""
        return tuple(a for a in self.spec(path) if a and self.axis(a) is not None)

    def grad_axes(self, path: str) -> Tuple[str, ...]:
        """The axes ``path``'s gradient is summed over after the backward:
        the data axes its leaf is replicated on, pp for the leaves every
        stage holds, and tp for whole ``wk``/``wv`` (each tp rank uses its
        own heads' share of them)."""
        spec = self.spec(path)
        out = [] if "ep" in spec else ["dp", "sp"]
        if "pp" not in spec:
            out.append("pp")
        if not self.kv_split and path.split("/")[-1] in _KV_LEAVES:
            out.append("tp")
        return tuple(a for a in out if self.ax[a] is not None)

    def take(self, path: str, whole):
        """This rank's part of the whole stacked leaf (``whole`` itself
        where no axis of this mesh splits it)."""
        if self.mesh is None or not self.split_axes(path):
            return whole
        for dim, a in enumerate(self.spec(path)):
            ax = self.axis(a)
            if ax is not None:
                n = whole.shape[dim] // ax.p
                whole = whole.narrow(dim, ax.idx * n, n)
        return whole.clone(memory_format=torch.contiguous_format)

    def gather(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """The whole stacked leaf from every rank's part (a collective of
        every rank that splits it)."""
        for dim, a in enumerate(self.spec(path)):
            local = spmd.gather_dim(local, self.axis(a), dim)
        return local

    def gather_tree(self, local: Dict[str, Any]) -> Dict[str, Any]:
        """The whole tree (CPU tensors) from every rank's tree of its parts
        (``Labformer.to_tree``'s nesting): a collective of every rank."""
        if self.mesh is None:
            return local
        out = {k: self.gather(k, v.to(self.device)).cpu() for k, v in local.items()
               if k != "blocks"}
        out["blocks"] = {k: self.gather(f"blocks/{k}", v.to(self.device)).cpu()
                         for k, v in local["blocks"].items()}
        return out

    def global_shape(self, path: str, local_shape) -> Tuple[int, ...]:
        out = list(local_shape)
        for dim, a in enumerate(self.spec(path)):
            ax = self.axis(a)
            if ax is not None:
                out[dim] *= ax.p
        return tuple(out)

    # ------------------------------------------------------------ tokens

    def local_tokens(self, x: torch.Tensor):
        """``(part, positions)``: this rank's part of a global ``(batch,
        seq)`` array, its dp rows and its sp positions (zigzag: half-blocks
        ``i`` and ``2 sp - 1 - i`` of the permuted sequence), and their rope
        positions (the original ones)."""
        b, s = x.shape
        dp, sp = self.size["dp"], self.size["sp"]
        positions = torch.arange(s, device=x.device)
        if self.cfg.sp_impl == "zigzag" and sp > 1:
            if s % (2 * sp):
                raise ValueError(f"sp_impl=zigzag needs seq divisible by 2*sp "
                                 f"({2 * sp}); got {s}")
            perm = torch.from_numpy(_zigzag_perm(s, sp).astype(np.int64)).to(x.device)
            x, positions = x[:, perm], perm
        if b % dp:
            raise ValueError(f"batch {b} not divisible by dp={dp}")
        if s % sp:
            raise ValueError(f"seq {s} not divisible by sp={sp}")
        bl, sl = b // dp, s // sp
        rows = slice(self.idx["dp"] * bl, (self.idx["dp"] + 1) * bl)
        cols = slice(self.idx["sp"] * sl, (self.idx["sp"] + 1) * sl)
        return x[rows, cols], positions[cols]

    def local_batch(self, tokens: torch.Tensor):
        """``(inputs, targets, positions)`` of this rank's tokens from the
        global ``(batch, seq+1)`` block."""
        inputs, positions = self.local_tokens(tokens[:, :-1])
        return inputs, self.local_tokens(tokens[:, 1:])[0], positions

    def whole_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """The whole ``(batch, seq, ...)`` array of every rank's part of the
        last stage's ``t`` (forward only), in sequence order, on every rank."""
        if self.mesh is None:
            return t
        t = t.detach().contiguous()
        if self.pp is not None:
            dist.broadcast(t, src=self.pp.global_rank(self.n_stages - 1), group=self.pp.group)
        t = spmd.gather_dim(spmd.gather_dim(t, self.sp, 1), self.ax["dp"], 0)
        if self.cfg.sp_impl == "zigzag" and self.size["sp"] > 1:
            t = t[:, np.argsort(_zigzag_perm(t.shape[1], self.size["sp"]))]
        return t

    def sum_stages(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` summed over pp (the stages' parts of the loss)."""
        if self.pp is None:
            return value
        return spmd.all_reduce_(value.clone(), self.pp)


# ------------------------------------------------------------ pipeline hand-off


def send_next(x: torch.Tensor, plan: Plan) -> None:
    ax = plan.pp
    dist.send(x.detach().contiguous(), dst=ax.global_rank(plan.stage + 1), group=ax.group)


def recv_prev(like_shape, dtype, plan: Plan) -> torch.Tensor:
    ax = plan.pp
    buf = torch.empty(like_shape, dtype=dtype, device=plan.device)
    dist.recv(buf, src=ax.global_rank(plan.stage - 1), group=ax.group)
    return buf


def send_prev(g: torch.Tensor, plan: Plan) -> None:
    ax = plan.pp
    dist.send(g.contiguous(), dst=ax.global_rank(plan.stage - 1), group=ax.group)


def recv_next(like: torch.Tensor, plan: Plan) -> torch.Tensor:
    ax = plan.pp
    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.recv(buf, src=ax.global_rank(plan.stage + 1), group=ax.group)
    return buf


# ------------------------------------------------------------ ZeRO


class ZeroView:
    """The optimizer's view of a rank's trainable tensors under ZeRO-1/2:
    for each leaf that ``tpulab``'s ``_zero1_spec`` shards over dp, this
    dp rank's slice of it (a subset of the layers where the axis is the
    layer axis, else a slice of every tensor); every other leaf whole.
    Without ZeRO (or at dp = 1) every leaf is whole and each method is the
    identity."""

    def __init__(self, model, zero: bool):
        plan = model.plan
        self.plan, self.dp = plan, plan.ax["dp"]
        self.items = []  # (path, n tensors, mode, arg): mode None | "layers" | "dim"
        for path, ts in model.trainable_leaves():
            mode, arg = None, None
            if zero and self.dp is not None:
                stacked = path.startswith("blocks/")
                local = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
                # tpulab's dim is unsplit there, so the port's too: local == global along it
                axis = _zero1_axis(plan.global_shape(path, local), plan.tpulab_spec(path),
                                   plan.shape)
                if axis is not None:
                    if stacked and axis == 0:
                        mode, arg = "layers", len(ts) // self.dp.p
                    else:
                        mode, arg = "dim", axis - 1 if stacked else axis
            self.items.append((path, len(ts), mode, arg))
        self.active = any(m is not None for _, _, m, _ in self.items)
        self.splits = _leaf_splits(model, self)

    def _slices(self, ts, mode, arg):
        r = self.dp.idx if self.dp is not None else 0
        if mode == "layers":
            return list(ts[r * arg:(r + 1) * arg])
        if mode == "dim":
            return [t.narrow(arg, r * (t.shape[arg] // self.dp.p), t.shape[arg] // self.dp.p)
                    for t in ts]
        return list(ts)

    def view(self, flat: List[torch.Tensor]) -> List[torch.Tensor]:
        """This dp rank's part of each tensor of ``flat`` (views)."""
        if not self.active:
            return flat
        out, i = [], 0
        for _, n, mode, arg in self.items:
            out += self._slices(flat[i:i + n], mode, arg)
            i += n
        return out

    def leaves(self) -> List[Tuple[str, int]]:
        """The optimizer's ``(path, tensor count)`` list over the view."""
        return [(p, arg if mode == "layers" else n) for p, n, mode, arg in self.items]

    def split_keys(self) -> List[Tuple[str, ...]]:
        """Per tensor of the view, the axes over which ranks hold different
        elements of it (its leaf's split axes, and dp where it is sliced)."""
        out = []
        for path, n, mode, arg in self.items:
            key = self.plan.split_axes(path)
            if mode is not None:
                key = key + ("dp",)
            out += [key] * (arg if mode == "layers" else n)
        return out

    def gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """The whole local tensors from every dp rank's view of them."""
        if not self.active:
            return parts
        out, i = [], 0
        for _, n, mode, arg in self.items:
            k = arg if mode == "layers" else n
            mine = parts[i:i + k]
            i += k
            if mode == "layers":
                out += list(spmd.gather_dim(torch.stack(mine), self.dp, 0).unbind(0))
            elif mode == "dim":
                out += [spmd.gather_dim(t, self.dp, arg) for t in mine]
            else:
                out += mine
        return out

    def reduce_scatter(self, flat: List[torch.Tensor]) -> List[torch.Tensor]:
        """ZeRO-2: each view tensor summed over dp, from the whole local
        gradients (the other axes already summed)."""
        out, i = [], 0
        for path, n, mode, arg in self.items:
            ts = flat[i:i + n]
            i += n
            if mode == "layers":
                out += list(spmd.reduce_scatter_dim(torch.stack(ts), self.dp, 0).unbind(0))
            elif mode == "dim":
                out += [spmd.reduce_scatter_dim(t, self.dp, arg) for t in ts]
            elif "dp" in self.plan.grad_axes(path):
                out += [spmd.all_reduce_(t.clone(memory_format=torch.contiguous_format),
                                         self.dp) for t in ts]
            else:
                out += list(ts)
        return out


def _leaf_splits(model, zv: ZeroView) -> Optional[Dict[str, optim.Split]]:
    """How each leaf of the optimizer's view lies across the ranks
    (:class:`optim.Split`, for :func:`optim.leaf_splits`): the global shape
    of the one-device layout, and per dim the axes that split it (the
    spec's pp, tp and ep; dp, innermost, where the ZeRO view slices it).
    None where no leaf is split."""
    plan = model.plan
    out: Dict[str, optim.Split] = {}
    for (path, ts), (_, n, mode, arg) in zip(model.trainable_leaves(), zv.items):
        block = path.startswith("blocks/")
        stacked = block and n * plan.n_stages > 1
        spec = plan.spec(path)[0 if stacked or not block else 1:]
        local = ((n,) if stacked else ()) + tuple(ts[0].shape)
        dims = [[plan.axis(a)] if plan.axis(a) is not None else [] for a in spec]
        if mode == "layers":
            dims[0].append(zv.dp)
        elif mode == "dim":
            dims[arg + (1 if stacked else 0)].append(zv.dp)
        shape = tuple(d * math.prod(ax.p for ax in axes if ax is not zv.dp)
                      for d, axes in zip(local, dims))
        out[path] = optim.Split(shape, tuple(tuple(axes) for axes in dims))
    return out if any(s.axes for s in out.values()) else None


def sum_over(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` summed in place over each of ``axes`` (:func:`optim.leaf_splits`'s
    ``sum_over``)."""
    for ax in axes:
        spmd.all_reduce_(t, ax)
    return t


# ------------------------------------------------------------ gradients


def sync_grads(model, grads: List[torch.Tensor], zero2: Optional[ZeroView]) -> List[torch.Tensor]:
    """The gradients summed over the axes each leaf is replicated on (in
    place); with ``zero2``, dp left out where its view slices the leaf,
    which :meth:`ZeroView.reduce_scatter` then sums."""
    plan = model.plan
    pairs, i = [], 0
    for path, ts in model.trainable_leaves():
        key = plan.grad_axes(path)
        if zero2 is not None:
            key = tuple(a for a in key if a != "dp")
        pairs += [(g, key) for g in grads[i:i + len(ts)]]
        i += len(ts)
    spmd.all_reduce_buckets(pairs, plan.ax)
    return grads


def global_sum_over(keys: List[Tuple[str, ...]], plan: Plan):
    """``optim``'s whole-tree sum for this view: each tensor's part summed
    over the axes its elements are split over, once (None where no tensor
    is split: the plain sum)."""
    if not any(keys):
        return None

    def total(parts: List[torch.Tensor]) -> torch.Tensor:
        groups: Dict[Tuple[str, ...], torch.Tensor] = {}
        for part, key in zip(parts, keys):
            groups[key] = part if key not in groups else groups[key] + part
        out = None
        for key, s in groups.items():
            s = s.clone()
            for a in key:
                spmd.all_reduce_(s, plan.axis(a))
            out = s if out is None else out + s
        return out

    return total


# ------------------------------------------------------------ whole optimizer state


def _walk(state, n: int, fn, keyed, leaves, kind: Optional[str] = None):
    """``state`` (a copy) with every per-tensor list of length ``n``
    replaced by ``fn(list)``, each of adafactor's keyed statistics ``t``
    (``optim.KEYED``) by ``keyed(kind, path, t)``, and each transform's
    ``leaves`` list by ``leaves``; counters and other entries kept."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            if kind is not None:  # a dict of keyed statistics: path -> tensor
                out[k] = keyed(kind, k, v)
            elif k == "leaves":
                out[k] = leaves
            else:
                out[k] = _walk(v, n, fn, keyed, leaves, k if k in optim.KEYED else None)
        return out
    if isinstance(state, (list, tuple)):
        if _is_tensor_list(state, n):
            return fn(list(state))
        return [_walk(v, n, fn, keyed, leaves) for v in state]
    return state


@torch.no_grad()
def gather_opt_state(model, opt_state, zv: ZeroView):
    """The optimizer state of the whole model (the one-device layout, CPU
    tensors) from every rank's part: a collective of every rank."""
    plan = model.plan
    n_view = sum(n for _, n in zv.leaves())

    def whole(view_list):
        local = zv.gather([t.to(plan.device) for t in view_list])
        out, i = [], 0
        for path, ts in model.trainable_leaves():
            n = len(ts)
            part = local[i:i + n]
            i += n
            if path.startswith("blocks/"):
                out += [t.cpu() for t in plan.gather(path, torch.stack(part)).unbind(0)]
            else:
                out.append(plan.gather(path, part[0]).cpu())
        return out

    def whole_statistic(kind, path, t):
        split = zv.splits.get(path) if zv.splits else None
        t = t.to(plan.device)
        if split is not None:
            for d, leaf_dim in enumerate(optim.statistic_dims(kind, split.shape)):
                for ax in reversed(split.dims[leaf_dim]):  # innermost first
                    t = spmd.gather_dim(t, ax, d)
        return t.cpu()

    leaves = [[path, len(ts) * (plan.n_stages if path.startswith("blocks/") else 1)]
              for path, ts in model.trainable_leaves()]
    return _walk(opt_state, n_view, whole, whole_statistic, leaves)


@torch.no_grad()
def fill_opt_state(model, live, whole_state, zv: ZeroView, n_whole: int) -> None:
    """Write the whole model's optimizer state into this rank's ``live``
    state in place (its shards, and its dp view under ZeRO; its part of
    each of adafactor's keyed statistics)."""
    plan = model.plan

    def local_of(whole_list):
        local, i = [], 0
        for path, ts in model.trainable_leaves():
            if path.startswith("blocks/"):
                n_glob = len(ts) * plan.n_stages
                local += list(plan.take(path, torch.stack(whole_list[i:i + n_glob])).unbind(0))
            else:
                n_glob = 1
                local.append(plan.take(path, whole_list[i]))
            i += n_glob
        return [t.to(plan.device).clone() for t in zv.view(local)]

    def local_statistic(kind, path, t):
        split = zv.splits.get(path) if zv.splits and kind else None
        if split is not None:
            for d, leaf_dim in enumerate(optim.statistic_dims(kind, split.shape)):
                for ax in split.dims[leaf_dim]:  # outermost first
                    n = t.shape[d] // ax.p
                    t = t.narrow(d, ax.idx * n, n)
        return t.to(plan.device).clone(memory_format=torch.contiguous_format)

    def fill(lv, wv, kind=None):
        if isinstance(lv, dict):
            for k in lv:
                if isinstance(lv[k], (dict, list)):
                    if isinstance(lv[k], list) and _is_tensor_list(wv[k], n_whole):
                        lv[k][:] = local_of(wv[k])
                    else:
                        fill(lv[k], wv[k], k if k in optim.KEYED else None)
                elif isinstance(lv[k], torch.Tensor):  # adafactor's keyed statistics
                    lv[k] = local_statistic(kind, k, wv[k])
                else:
                    lv[k] = wv[k]
        elif isinstance(lv, list):
            if _is_tensor_list(wv, n_whole):
                lv[:] = local_of(wv)
                return
            for i in range(len(lv)):
                if isinstance(lv[i], (dict, list)):
                    fill(lv[i], wv[i])

    fill(live, whole_state)


def _is_tensor_list(x, n: int) -> bool:
    return isinstance(x, (list, tuple)) and len(x) == n and n > 0 and all(
        isinstance(t, torch.Tensor) for t in x)
