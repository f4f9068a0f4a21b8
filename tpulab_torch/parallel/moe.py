"""Expert parallelism: top-k MoE with all-to-all token dispatch (the
counterpart of ``tpulab.parallel.moe``).

Experts are sharded over a mesh axis, or over a fused axis such as
``("dp", "sp")``; each token travels to its expert's rank through one
all-to-all, runs there in an expert-batched product, and comes back
through a second.  Routing is top-k with a per-expert, per-source
capacity ``C``: ``k = 1`` is the switch formulation (the raw softmax mass
of the argmax), ``k > 1`` renormalizes the selected gates.  Rows over
capacity are dropped (their output is the zero vector).  With ``C >= k *
local tokens`` the result equals the dense-gate oracle,
:func:`switch_moe_reference`.

Per rank (``p`` ranks on the axis, ``E`` experts, ``E_loc = E / p``, ``n``
local tokens)::

    send[e, c, d]            rows bucketed by global expert id
    -> (p, E_loc, C, d), all-to-all over dim 0
    recv[r, e_loc, c, d]     source r's bucket for this rank's experts
    -> (E_loc, p*C, d) expert-batched FFN
    -> the inverse all-to-all, gathered back by (expert, slot), scaled by
       the gate

``jax.lax.top_k`` breaks ties to the lower index: :func:`_route` sorts
stably.  ``jax.nn.gelu`` is the tanh form.  The expert products stay
``einsum``s, as in ``tpulab`` (no Pallas kernel there).  Every input
follows :mod:`~tpulab_torch.parallel.spmd`'s rule: tokens and expert
weights are sharded, the router is whole on every rank (its gradient
summed over the ranks), and the output is gathered.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpulab_torch.parallel import spmd
from tpulab_torch.parallel.mesh import axis_size, make_mesh
from tpulab_torch.runtime.device import resolve_device

AxisName = Union[str, Tuple[str, ...]]


def dispatch_capacity(capacity_factor: float, k: int, n_local: int, n_experts: int) -> int:
    """The per-expert, per-source bucket: ``ceil(cf * k * n_local / E)``,
    floor 1."""
    return max(1, int(np.ceil(capacity_factor * k * n_local / n_experts)))


def _route(gate: torch.Tensor, k: int, dtype: torch.dtype):
    """(eids (n*k,), scales (n*k,)): top-k routing, token-major, equal gates
    in index order (``jax.lax.top_k``'s).  ``k == 1`` keeps the raw softmax
    mass; ``k > 1`` renormalizes over the chosen."""
    top_ids = torch.sort(-gate, dim=-1, stable=True).indices[:, :k]
    top_vals = gate.gather(-1, top_ids)
    if k > 1:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return top_ids.reshape(-1), top_vals.reshape(-1).to(dtype)


def combine_weights(gate: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """Dense (n, E) combine matrix from top-k routing: the one scatter of
    the dense oracle and the model's in-model MoE."""
    n, n_experts = gate.shape
    eid, gval = _route(gate, k, dtype)
    rows = torch.arange(n, device=gate.device).repeat_interleave(k)
    out = torch.zeros((n, n_experts), dtype=dtype, device=gate.device)
    return out.index_put_((rows, eid), gval, accumulate=True)


def _ffn(tok: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, spec: str) -> torch.Tensor:
    hid = F.gelu(torch.einsum(spec[0], tok, w1), approximate="tanh")
    return torch.einsum(spec[1], hid, w2)


def switch_moe_reference(x, router_w, w1, w2, k: int = 1, *,
                         backend: Optional[str] = None) -> torch.Tensor:
    """Dense-gate oracle: every expert on every token, the top-k weighted
    combine (the model's in-model formulation; E-fold compute).  The inputs
    (host arrays or tensors) are staged on ``backend``'s device: the card
    unless ``backend="cpu"``."""
    device = resolve_device(backend)
    x, router_w, w1, w2 = (torch.as_tensor(t).to(device) for t in (x, router_w, w1, w2))
    gate = torch.softmax((x @ router_w).float(), dim=-1)
    out = _ffn(x, w1, w2, ("nd,edf->nef", "nef,efd->ned"))             # (n, E, d)
    return torch.einsum("ned,ne->nd", out, combine_weights(gate, k, x.dtype))


def _moe_body(x, router_w, w1_loc, w2_loc, ax: spmd.Axis, *, n_experts: int, capacity: int,
              k: int = 1, tp: Optional[spmd.Axis] = None) -> torch.Tensor:
    """One rank's top-k MoE over its local tokens: x (n, d); router_w (d, E)
    whole; w1_loc/w2_loc (E_loc, d, ff)/(E_loc, ff, d) this rank's experts.
    A token's slot in its expert's bucket is the count of earlier
    token-major rows routed to that expert; dropped rows add zero.  With
    ``tp``, the experts' ``ff`` is split over it (the mesh trainer's
    layout): the received tokens enter the split product through
    :func:`spmd.copy_to` and its partial sums leave through
    :func:`spmd.reduce_from`."""
    n, d = x.shape
    p, c = ax.p, capacity
    e_loc = n_experts // p
    gate = torch.softmax((x @ router_w).float(), dim=-1)
    eid, gval = _route(gate, k, x.dtype)                               # (n*k,)
    xk = x.repeat_interleave(k, dim=0) if k > 1 else x                 # (n*k, d)
    slot, keep = _bucket_slots(eid, n_experts, c)
    contrib = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    send = torch.zeros((n_experts, c, d), dtype=x.dtype, device=x.device).index_put(
        (eid, slot), contrib, accumulate=True)
    recv = spmd.all_to_all(send.reshape(p, e_loc, c, d), ax)           # (p, E_loc, C, d)
    tok = recv.movedim(1, 0).reshape(e_loc, p * c, d)
    out = spmd.reduce_from(_ffn(spmd.copy_to(tok, tp), w1_loc, w2_loc,
                                ("ekd,edf->ekf", "ekf,efd->ekd")), tp)  # (E_loc, pC, d)
    back = out.reshape(e_loc, p, c, d).movedim(0, 1)
    ret = spmd.all_to_all(back, ax).reshape(n_experts, c, d)
    y = ret[eid, slot] * torch.where(keep, gval, torch.zeros_like(gval))[:, None]
    return y.reshape(n, k, d).sum(dim=1) if k > 1 else y


def _bucket_slots(eid: torch.Tensor, n_experts: int, capacity: int):
    """``(slot, keep)`` of each routed row (token-major): its place in its
    expert's bucket, the count of earlier rows routed to that expert
    (clamped to the bucket), and whether it fits."""
    eoh = F.one_hot(eid, n_experts)                                    # (n*k, E)
    pos = (eoh.cumsum(dim=0) * eoh).sum(dim=-1) - 1
    return pos.clamp(0, capacity - 1), pos < capacity


def dropped_share(x: torch.Tensor, router_w: torch.Tensor, n_experts: int, capacity: int,
                  k: int = 1) -> float:
    """The share of one rank's routed rows (``n * k``) that :func:`_moe_body`
    drops: those past ``capacity`` in their expert's bucket."""
    gate = torch.softmax((x @ router_w).float(), dim=-1)
    _, keep = _bucket_slots(_route(gate, k, x.dtype)[0], n_experts, capacity)
    return float((~keep).float().mean())


def switch_moe(tokens, router_w, w1, w2, *, mesh=None, axis: AxisName = "ep",
               capacity_factor: float = 1.25, k: int = 1,
               backend: Optional[str] = None) -> torch.Tensor:
    """Top-k MoE with expert parallelism over ``mesh[axis]`` (a name or a
    tuple of names fused into one axis).  ``tokens`` (N, d) and ``w1`` (E,
    d, ff), ``w2`` (E, ff, d) are sharded over the axis, ``router_w`` (d,
    E) is whole; N and E must divide by the axis size.  ``capacity_factor``
    scales the per-expert, per-source bucket (:func:`dispatch_capacity`);
    overflow rows output zero.  ``backend`` shapes the mesh made when
    ``mesh`` is None (every rank over ``axis``)."""
    n_experts = int(w1.shape[0])
    if not 1 <= k <= n_experts:
        raise ValueError(f"k={k} outside [1, {n_experts} experts]")
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    mesh = mesh if mesh is not None else make_mesh(axes=axes, backend=backend)
    p = int(np.prod([axis_size(mesh, a) for a in axes]))
    if n_experts % p:
        raise ValueError(f"{n_experts} experts not divisible by axis size {p}")
    if tokens.shape[0] % p:
        raise ValueError(f"{tokens.shape[0]} tokens not divisible by axis size {p}")
    capacity = dispatch_capacity(capacity_factor, k, tokens.shape[0] // p, n_experts)
    ax = spmd.mesh_axis(mesh, axes)
    shard = (0, spmd.contiguous(p))
    x, rw, w1, w2 = spmd.distribute(ax, [shard, None, shard, shard],
                                    *(spmd.stage(t, mesh) for t in (tokens, router_w, w1, w2)))
    body = functools.partial(_moe_body, n_experts=n_experts, capacity=capacity, k=k)
    return spmd.collect(body(x, rw, w1, w2, ax), ax, 0, spmd.contiguous(p))
