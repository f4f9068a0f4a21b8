"""The optimizer stack of ``tpulab``'s trainer, on PyTorch tensors.

``tpulab`` builds its optimizers from optax (``tpulab/train.py:86-147``,
``tpulab/models/labformer.py:720``); this module writes the same
transformations out in plain tensor ops, because ``torch.optim`` differs
from optax where it matters: ``torch.optim.AdamW``'s weight decay
defaults to 1e-2 (optax's ``adamw`` to 1e-4, on every leaf, norms and the
embedding included) and multiplies the parameter by ``1 - lr * wd``
before the step; ``clip_grad_norm_`` divides by ``norm + 1e-6`` (optax by
the norm alone); and optax's schedules start from update count 0, so a
warmup run's first update has learning rate 0.

A :class:`Transform` is optax's ``GradientTransformation`` over a list of
tensors: ``init(params, leaves)`` makes its state, ``update(updates, state,
params)`` returns the transformed updates and advances the state in place.
``leaves`` is the model's ``(path, tensor count)`` list (a per-layer leaf
holds one tensor per layer; ``None``: every tensor is a leaf of its own):
optax takes a block's statistics over the whole leaf, so adafactor's
factored second moment, its clipping RMS and its parameter scale are
taken over the stacked ``(L, ...)`` leaf, as ``tpulab``'s tree holds it.
On a mesh, where a rank holds a part of a leaf, the step says through
:func:`leaf_splits` how each leaf lies across the ranks, and those
statistics are taken over the whole (global) leaf, as GSPMD takes them for
``tpulab``.
Each operation is optax's, in its order and dtype: a Python scalar is
rounded to the tensor's dtype first (optax's weak-typed scalars), moments
keep the parameter's dtype (``mu_dtype=None``), bias corrections are
computed in float64 and rounded to the tensor's dtype, and
the step count lives on the host, so no update waits for the device.
Schedules compute in the precision optax does (float32 for the linear
warmup, float64 for the cosine), and the result is rounded to the
update's dtype.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


class Transform(NamedTuple):
    init: Callable[..., Any]  # (params, leaves=None) -> state
    update: Callable[[List[torch.Tensor], Any, List[torch.Tensor]], List[torch.Tensor]]
    #: keeps statistics over whole leaves (adafactor's), which ``tpulab``'s
    #: ZeRO placement cannot hold: the mesh step refuses it under ZeRO
    whole_leaves: bool = False


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _scalar(x: float, like: torch.Tensor) -> float:
    """``x`` rounded to ``like``'s dtype, as optax's weak-typed scalar is."""
    return _rounded(float(x), like.dtype)


#: how a whole-tree sum is taken: None on one device (a plain sum of the
#: parts), or the mesh step's, which counts each element once across ranks
_GLOBAL_SUM: contextvars.ContextVar = contextvars.ContextVar("optim_global_sum", default=None)


@contextlib.contextmanager
def global_sum(fn: Optional[Callable[[List[torch.Tensor]], torch.Tensor]]):
    """Within the block, whole-tree sums (the global norm) reduce their
    per-tensor parts with ``fn`` (the mesh trainer's)."""
    token = _GLOBAL_SUM.set(fn)
    try:
        yield
    finally:
        _GLOBAL_SUM.reset(token)


def _tree_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    fn = _GLOBAL_SUM.get()
    return sum(parts) if fn is None else fn(parts)


class Split(NamedTuple):
    """How a leaf lies across the ranks of a mesh: its global shape (the
    one-device layout: per-layer tensors stacked on a leading axis where
    the model has more than one layer) and, per dim of it, the mesh axes
    that split the dim, outer first (empty: whole on every rank)."""

    shape: Tuple[int, ...]
    dims: Tuple[Tuple[Any, ...], ...]

    @property
    def axes(self) -> Tuple[Any, ...]:
        """Every axis that splits the leaf, once."""
        return tuple(dict.fromkeys(a for d in self.dims for a in d))


#: None on one device; else ``({leaf path: Split}, sum_over)``, where
#: ``sum_over(t, axes)`` sums ``t`` in place over those mesh axes
_LEAF_SPLITS: contextvars.ContextVar = contextvars.ContextVar("optim_leaf_splits",
                                                              default=None)


@contextlib.contextmanager
def leaf_splits(splits: Optional[Dict[str, Split]],
                sum_over: Optional[Callable[[torch.Tensor, Tuple[Any, ...]], torch.Tensor]]):
    """Within the block, the statistics adafactor takes over a whole leaf
    (its factoring decision and factored means, the block RMS of clipping
    and of the parameter scale) see each leaf named in ``splits`` as the
    whole global leaf: a rank's partial sums are summed with ``sum_over``
    over the axes that split the leaf.  ``splits`` None: every leaf is
    whole (one device), and each statistic is the plain one."""
    token = _LEAF_SPLITS.set(None if splits is None else (splits, sum_over))
    try:
        yield
    finally:
        _LEAF_SPLITS.reset(token)


def _split_of(name: str) -> Optional[Split]:
    """``name``'s split within :func:`leaf_splits`; None where the leaf is
    whole on every rank (or there is no mesh)."""
    ctx = _LEAF_SPLITS.get()
    split = None if ctx is None else ctx[0].get(name)
    return split if split is not None and split.axes else None


def _sum_over(t: torch.Tensor, axes) -> torch.Tensor:
    return _LEAF_SPLITS.get()[1](t, tuple(axes))


def _stacked(n: int, like: torch.Tensor, split: Optional[Split]) -> bool:
    """Whether a leaf of ``n`` local tensors shaped ``like`` stacks them:
    where the one-device layout has a layer axis (a rank under pp may hold
    one layer of several)."""
    return n > 1 if split is None else len(split.shape) == like.dim() + 1


def _mean(x: torch.Tensor, dim: int, split: Optional[Split], leaf_dim: int,
          keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` over the global leaf: where the leaf's dim
    ``leaf_dim`` (``x``'s ``dim``) is split, the ranks' sums summed over its
    axes, then divided by its global size."""
    axes = split.dims[leaf_dim] if split is not None else ()
    if not axes:
        return x.mean(dim=dim, keepdim=keepdim)
    total = _sum_over(x.sum(dim=dim, keepdim=keepdim), axes)
    return total / _scalar(split.shape[leaf_dim], total)


def chain(*transforms: Transform) -> Transform:
    def init(params, leaves=None):
        return [t.init(params, leaves) for t in transforms]

    def update(updates, state, params):
        for t, st in zip(transforms, state):
            updates = t.update(updates, st, params)
        return updates

    return Transform(init, update, any(t.whole_leaves for t in transforms))


def _no_state(params, leaves=None):
    return None


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: scale every update by ``max_norm /
    norm`` when the global norm reaches ``max_norm`` (no epsilon; decided
    on the device)."""

    def update(updates, state, params):
        norm = torch.sqrt(_tree_sum([(u * u).sum() for u in updates]))
        return [torch.where(norm < max_norm, u, (u / norm.to(u.dtype)) * _scalar(max_norm, u))
                for u in updates]

    return Transform(_no_state, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params, leaves=None):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params):
        state["count"] += 1
        count = state["count"]
        out = []
        for i, g in enumerate(updates):
            mu = g * _scalar(1 - b1, g) + state["mu"][i] * _scalar(b1, g)
            nu = (g * g) * _scalar(1 - b2, g) + state["nu"][i] * _scalar(b2, g)
            state["mu"][i], state["nu"][i] = mu, nu
            mu_hat = mu / _scalar(1 - b1 ** count, mu)
            nu_hat = nu / _scalar(1 - b2 ** count, nu)
            out.append(mu_hat / (torch.sqrt(nu_hat) + _scalar(eps, nu_hat)))
        return out

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params):
        return [u + p * _scalar(weight_decay, p) for u, p in zip(updates, params)]

    return Transform(_no_state, update)


def trace(decay: float) -> Transform:
    """Momentum (``optax.trace``, not Nesterov): ``t = g + decay * t``."""

    def init(params, leaves=None):
        return [torch.zeros_like(p) for p in params]

    def update(updates, state, params):
        for i, g in enumerate(updates):
            state[i] = g + state[i] * _scalar(decay, g)
        return list(state)

    return Transform(init, update)


def scale_by_learning_rate(learning_rate: Schedule, flip_sign: bool = True) -> Transform:
    """Multiply by ``-lr`` (``lr`` with ``flip_sign=False``), a schedule
    evaluated at the update count from 0."""
    sign = -1.0 if flip_sign else 1.0

    def init(params, leaves=None):
        return {"count": 0}

    def update(updates, state, params):
        lr = learning_rate(state["count"]) if callable(learning_rate) else learning_rate
        state["count"] += 1
        return [u * _scalar(sign * lr, u) for u in updates]

    return Transform(init, update)


def scale(step_size: float) -> Transform:
    """``optax.scale``: multiply by a constant."""

    def update(updates, state, params):
        return [u * _scalar(step_size, u) for u in updates]

    return Transform(_no_state, update)


def scale_by_lion(b1: float = 0.9, b2: float = 0.99) -> Transform:
    """``optax.scale_by_lion``: the sign of ``(1 - b1) g + b1 m``, then the
    moment ``m = (1 - b2) g + b2 m``, in the parameter's dtype."""

    def init(params, leaves=None):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params):
        state["count"] += 1
        out = []
        for i, g in enumerate(updates):
            mu = state["mu"][i]
            out.append(torch.sign(g * _scalar(1 - b1, g) + mu * _scalar(b1, g)))
            state["mu"][i] = g * _scalar(1 - b2, g) + mu * _scalar(b2, g)
        return out

    return Transform(init, update)


def _groups(params, leaves) -> List[Tuple[str, int, int]]:
    """``(path, first tensor, tensor count)`` of each leaf over the flat list."""
    if leaves is None:
        return [(str(i), i, 1) for i in range(len(params))]
    out, i = [], 0
    for name, n in leaves:
        out.append((name, i, n))
        i += n
    if i != len(params):
        raise ValueError(f"leaves cover {i} tensors; the optimizer was given {len(params)}")
    return out


def _leaf_rms(ts: List[torch.Tensor], split: Optional[Split] = None) -> torch.Tensor:
    """``sqrt(mean(x * x))`` over every tensor of a leaf (a device scalar in
    the leaf's dtype; the sum in float32, as ``jnp.mean`` sums); over the
    global leaf where ``split`` splits it: each element counted once."""
    total = sum((t * t).float().sum() for t in ts)
    if split is None:
        n = sum(t.numel() for t in ts)
    else:
        total, n = _sum_over(total, split.axes), math.prod(split.shape)
    return torch.sqrt((total / n).to(ts[0].dtype))


def _largest_dims(shape) -> Tuple[int, int]:
    """The second largest and the largest axis of ``shape``, in
    ``np.argsort``'s order (ties: the lower axis first)."""
    sorted_dims = np.argsort(shape)
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest axes, when the smaller of
    them is at least ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    d1, d0 = _largest_dims(shape)
    if shape[d1] < min_dim_size_to_factor:
        return None
    return d1, d0


#: adafactor's statistics, each keyed by leaf path: row and column means of
#: a factored leaf, the full second moment of any other
KEYED = ("v_row", "v_col", "v")


def statistic_dims(key: str, shape) -> List[int]:
    """The dims of a leaf of global ``shape`` that its statistic ``key``
    (one of :data:`KEYED`) keeps, in order: ``v_row`` drops the largest,
    ``v_col`` the second largest, ``v`` none."""
    dims = list(range(len(shape)))
    if key != "v":
        d1, d0 = _largest_dims(shape)
        dims.remove(d0 if key == "v_row" else d1)
    return dims


def scale_by_factored_rms(decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                          eps: float = 1e-30) -> Transform:
    """``optax.scale_by_factored_rms`` (``factored=True``), on the stacked
    leaf: a leaf whose two largest axes reach ``min_dim_size_to_factor``
    keeps row and column means of ``g^2 + eps``, any other a full second
    moment; the decay is ``1 - (step + 1)^-0.8`` in float32.  Within
    :func:`leaf_splits` the factoring is decided on the leaf's global
    shape, a mean over a split dim is summed over the ranks, and each
    statistic is this rank's part of the global one (split on the dims it
    keeps)."""

    def init(params, leaves=None):
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for name, i, n in _groups(params, leaves):
            p, split = params[i], _split_of(name)
            shape = ((n,) if _stacked(n, p, split) else ()) + tuple(p.shape)
            dims = _factored_dims(split.shape if split else shape, min_dim_size_to_factor)
            kw = {"dtype": p.dtype, "device": p.device}
            if dims is not None:
                d1, d0 = dims
                state["v_row"][name] = torch.zeros(np.delete(shape, d0).tolist(), **kw)
                state["v_col"][name] = torch.zeros(np.delete(shape, d1).tolist(), **kw)
            else:
                state["v"][name] = torch.zeros(shape, **kw)
        state["leaves"] = [[name, n] for name, _, n in _groups(params, leaves)]
        return state

    def update(updates, state, params):
        t = np.float32(state["count"] + 1)
        decay = np.float32(1.0) - t ** np.float32(-decay_rate)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        state["count"] += 1
        out: List[torch.Tensor] = []
        i = 0
        for name, n in state["leaves"]:
            # the leaf as tpulab's tree holds it: per-layer tensors stacked
            split = _split_of(name)
            stacked = _stacked(n, updates[i], split)
            g = torch.stack(updates[i:i + n]) if stacked else updates[i]
            i += n
            dt = g.dtype
            g_sqr = g * g + _scalar(eps, g)
            if name in state["v_row"]:
                d1, d0 = _largest_dims(split.shape if split else tuple(g.shape))
                # float32 like the decay (optax's strongly typed scalar)
                v_row = (state["v_row"][name].float() * keep
                         + _mean(g_sqr, d0, split, d0).float() * take).to(dt)
                v_col = (state["v_col"][name].float() * keep
                         + _mean(g_sqr, d1, split, d1).float() * take).to(dt)
                state["v_row"][name], state["v_col"][name] = v_row, v_col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = torch.rsqrt(v_row / _mean(v_row, reduced_d1, split, d1,
                                                       keepdim=True))
                u = g * row_factor.unsqueeze(d0) * torch.rsqrt(v_col).unsqueeze(d1)
            else:
                v = (state["v"][name].float() * keep + g_sqr.float() * take).to(dt)
                state["v"][name] = v
                u = g * torch.rsqrt(v)
            out.extend(u.unbind(0) if stacked else [u])
        return out

    return Transform(init, update, whole_leaves=True)


def clip_by_block_rms(threshold: float) -> Transform:
    """``optax.clip_by_block_rms``: divide each leaf's update by
    ``max(1, rms / threshold)``, its RMS over the whole leaf."""

    def init(params, leaves=None):
        return {"leaves": [[name, n] for name, _, n in _groups(params, leaves)]}

    def update(updates, state, params):
        out, i = [], 0
        for name, n in state["leaves"]:
            ts = updates[i:i + n]
            i += n
            rms = _leaf_rms(ts, _split_of(name))
            denom = torch.clamp(rms / _scalar(threshold, ts[0]), min=1.0)
            out.extend(u / denom for u in ts)
        return out

    return Transform(init, update, whole_leaves=True)


def scale_by_param_block_rms(min_scale: float = 1e-3) -> Transform:
    """``optax.scale_by_param_block_rms``: times the parameter leaf's RMS,
    floored at ``min_scale`` (``numerics.safe_root_mean_squares``)."""

    def init(params, leaves=None):
        return {"leaves": [[name, n] for name, _, n in _groups(params, leaves)]}

    def update(updates, state, params):
        out, i = [], 0
        for name, n in state["leaves"]:
            rms = _leaf_rms(params[i:i + n], _split_of(name))
            floor = _scalar(min_scale, rms)
            factor = torch.where(rms <= floor, torch.full_like(rms, floor), rms)
            out.extend(u * factor.to(u.dtype) for u in updates[i:i + n])
            i += n
        return out

    return Transform(init, update, whole_leaves=True)


def adamw(learning_rate: Schedule) -> Transform:
    """``optax.adamw`` with its defaults: b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4."""
    return chain(scale_by_adam(), add_decayed_weights(1e-4),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: Schedule, momentum: Optional[float] = None) -> Transform:
    """``optax.sgd``: the learning rate alone, or after (non-Nesterov)
    momentum."""
    if momentum is None:
        return chain(scale_by_learning_rate(learning_rate))
    return chain(trace(momentum), scale_by_learning_rate(learning_rate))


def lion(learning_rate: Schedule) -> Transform:
    """``optax.lion`` with its defaults: b1 0.9, b2 0.99, weight decay 1e-3."""
    return chain(scale_by_lion(), add_decayed_weights(1e-3),
                 scale_by_learning_rate(learning_rate))


def adafactor(learning_rate: Schedule) -> Transform:
    """``optax.adafactor(learning_rate=...)`` with its defaults, in optax's
    order (``alias.py``): the factored RMS scaling, block-RMS clipping at 1,
    the learning rate, the parameter's block RMS (floor 1e-3), then
    ``scale(-1)``; no momentum and no weight decay."""
    return chain(scale_by_factored_rms(), clip_by_block_rms(1.0),
                 scale_by_learning_rate(learning_rate, flip_sign=False),
                 scale_by_param_block_rms(), scale(-1.0))


@torch.no_grad()
def apply_updates(params: List[torch.Tensor], updates: List[torch.Tensor]) -> None:
    """``p = p + u`` in ``p``'s dtype, in place."""
    for p, u in zip(params, updates):
        p.copy_((p + u).to(p.dtype))


# ------------------------------------------------------------ schedules


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        # in float32, as optax divides its int32 count
        frac = np.float32(1) - (np.float32(min(max(count, 0), transition_steps))
                                / np.float32(transition_steps))
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:  # in float64, as optax's float count
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value``, then cosine decay to ``end_value``
    at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)
