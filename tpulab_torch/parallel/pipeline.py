"""Microbatched pipeline parallelism (GPipe) over a mesh axis (the
counterpart of ``tpulab.parallel.pipeline``).

The layer stack is sharded over the ``pp`` axis (each rank, a stage, owns
``L / S`` consecutive layers) and the batch is cut into ``M``
microbatches that flow through the stages with one ring shift a tick.
The schedule is ``tpulab``'s GPipe: ``M + S - 1`` ticks; stage 0 takes
microbatch ``clip(t, 0, M - 1)``, every stage computes every tick (the
bubble ticks' results are never stored), and only the last stage stores,
microbatch ``t - (S - 1)`` once that is ``>= 0``.

The schedule is differentiable as ``tpulab``'s scan is: each shift's
backward is the shift the other way (activations flow stage 0 to S-1,
gradients back), each tick's input is a select between the microbatch
and what the shift brought (so every shift leans on the one before it,
on every stage), the last stage's result reaches every rank with
:func:`~tpulab_torch.parallel.spmd.from_rank`, and the stages'
parameter gradients are all-gathered into the full stacked gradient on
every rank.  Bubble ticks compute on data that is masked away, which
reaches no gradient.  :func:`make_pipeline_train_step` is a training step
over it with a :class:`tpulab_torch.optim.Transform` (``tpulab`` takes an
optax optimizer).

Parameters are a pytree of tensors (or host arrays) whose leaves have the
layer dim first: a dict, a list or a tuple, flattened with
``torch.utils._pytree``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from tpulab_torch.parallel import spmd
from tpulab_torch.parallel.mesh import axis_mesh


def _stage_body(local, x_mb: torch.Tensor, stage_fn: Callable, ax: spmd.Axis,
                n_micro: int) -> torch.Tensor:
    """One stage's ticks.  ``local``: this stage's slice of the stacked
    layers (a pytree, leading dim layers-per-stage); ``x_mb`` (M, mb, ...)
    the whole microbatched input.  Returns the last stage's (M, mb, ...)
    result on every rank."""
    s, n_stages = ax.idx, ax.p
    leaves, spec = pytree.tree_flatten(local)
    n_local = leaves[0].shape[0]
    layers = [pytree.tree_unflatten([leaf[i] for leaf in leaves], spec) for i in range(n_local)]
    first = torch.tensor(s == 0, device=x_mb.device)
    act_in = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        act = torch.where(first, x_mb[min(max(t, 0), n_micro - 1)], act_in)
        for layer in layers:
            act = stage_fn(act, layer)
        if s == n_stages - 1 and t >= n_stages - 1:
            outs.append(act)  # microbatch t - (S - 1) is done
        if t < n_micro + n_stages - 2:
            act_in = spmd.ring_shift(act, ax)
    mine = torch.stack(outs) if outs else torch.zeros(
        (n_micro, *act.shape), dtype=act.dtype, device=act.device)
    return spmd.keep(spmd.from_rank(mine, ax, n_stages - 1), act)


def _check(n_layers: int, n_stages: int, batch: int, n_micro: int) -> None:
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by {n_micro} microbatches")


def pipeline_apply(stage_fn: Callable, params_stacked, x, *, mesh=None, axis: str = "pp",
                   n_micro: int = 4, backend: Optional[str] = None) -> torch.Tensor:
    """Apply ``L`` stacked layers to ``x`` with GPipe over ``mesh[axis]``.

    ``stage_fn(activation, layer_params) -> activation`` is one layer;
    ``params_stacked`` is a pytree whose leaves have leading dim ``L``
    (divisible by the axis size); ``x`` is ``(B, ...)`` with ``B``
    divisible by ``n_micro``.  Returns ``stage_fn`` applied through every
    layer, as a sequential loop would, on every rank."""
    mesh = axis_mesh(mesh, axis, backend=backend)
    ax = spmd.mesh_axis(mesh, axis)
    leaves, spec = pytree.tree_flatten(params_stacked)
    _check(leaves[0].shape[0], ax.p, x.shape[0], n_micro)
    leaves = [spmd.stage(leaf, mesh) for leaf in leaves]
    x = spmd.stage(x, mesh)
    shard = (0, spmd.contiguous(ax.p))
    x, *local = spmd.distribute(ax, [None] + [shard] * len(leaves), x, *leaves)
    x_mb = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    out = _stage_body(pytree.tree_unflatten(local, spec), x_mb, stage_fn, ax, n_micro)
    return out.reshape(x.shape)


def make_pipeline_train_step(stage_fn: Callable, loss_head: Callable, optimizer, *, mesh=None,
                             axis: str = "pp", n_micro: int = 4, backend: Optional[str] = None):
    """A GPipe training step over the pipeline schedule.

    ``loss_head(final_activation, targets) -> scalar`` closes the loss;
    ``optimizer`` is a :class:`tpulab_torch.optim.Transform`.  Returns
    ``train_step(params_stacked, opt_state, x, targets) -> (params,
    opt_state, loss)``, where ``opt_state`` is ``optimizer.init`` of the
    parameters' leaves (``torch.utils._pytree.tree_leaves``) and the
    returned parameters are new tensors on the mesh's device; the gradients
    run back through the schedule."""
    mesh = axis_mesh(mesh, axis, backend=backend)

    def train_step(params, opt_state, x, targets):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [spmd.stage(leaf, mesh).detach().requires_grad_() for leaf in leaves]
        out = pipeline_apply(stage_fn, pytree.tree_unflatten(leaves, spec), x, mesh=mesh,
                             axis=axis, n_micro=n_micro)
        loss = loss_head(out, spmd.stage(targets, mesh))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params = [leaf.detach() for leaf in leaves]
            updates = optimizer.update(list(grads), opt_state, params)
            params = [(p + u).to(p.dtype) for p, u in zip(params, updates)]
        return pytree.tree_unflatten(params, spec), opt_state, loss.detach()

    return train_step
