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
tensors: ``init(params)`` makes its state, ``update(updates, state,
params)`` returns the transformed updates and advances the state in place.
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

import functools
import math
from typing import Any, Callable, List, NamedTuple, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


class Transform(NamedTuple):
    init: Callable[[List[torch.Tensor]], Any]
    update: Callable[[List[torch.Tensor], Any, List[torch.Tensor]], List[torch.Tensor]]


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _scalar(x: float, like: torch.Tensor) -> float:
    """``x`` rounded to ``like``'s dtype, as optax's weak-typed scalar is."""
    return _rounded(float(x), like.dtype)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params):
        for t, st in zip(transforms, state):
            updates = t.update(updates, st, params)
        return updates

    return Transform(init, update)


def _no_state(params):
    return None


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: scale every update by ``max_norm /
    norm`` when the global norm reaches ``max_norm`` (no epsilon; decided
    on the device)."""

    def update(updates, state, params):
        norm = torch.sqrt(sum((u * u).sum() for u in updates))
        return [torch.where(norm < max_norm, u, (u / norm.to(u.dtype)) * _scalar(max_norm, u))
                for u in updates]

    return Transform(_no_state, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
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

    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(updates, state, params):
        for i, g in enumerate(updates):
            state[i] = g + state[i] * _scalar(decay, g)
        return list(state)

    return Transform(init, update)


def scale_by_learning_rate(learning_rate: Schedule) -> Transform:
    """Multiply by ``-lr``, a schedule evaluated at the update count from 0."""

    def init(params):
        return {"count": 0}

    def update(updates, state, params):
        lr = learning_rate(state["count"]) if callable(learning_rate) else learning_rate
        state["count"] += 1
        return [u * _scalar(-lr, u) for u in updates]

    return Transform(init, update)


def adamw(learning_rate: Schedule) -> Transform:
    """``optax.adamw`` with its defaults: b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4."""
    return chain(scale_by_adam(), add_decayed_weights(1e-4),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: Schedule, momentum: float) -> Transform:
    """``optax.sgd`` with (non-Nesterov) momentum."""
    return chain(trace(momentum), scale_by_learning_rate(learning_rate))


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
