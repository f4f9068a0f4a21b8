"""Sample sort over a mesh axis (hw2's and lab5's sort at scale; the
counterpart of ``tpulab.parallel.dsort``).

1. Floats become keys whose integer order is IEEE-754's total order
   (:func:`_encode_keys`, NaNs first made the positive quiet NaN, so they
   sort last as ``np.sort`` puts them); uint8 widens to int32.  The array
   is padded to a multiple of the axis with a sentinel above every key
   (``iinfo.max`` of the key type), so ``finfo.max`` and ``+inf`` stay
   real values.
2. Each rank sorts its block, gathers ``p`` evenly spaced samples from
   every rank, and takes ``p - 1`` splitters from their sort (the same on
   every rank).
3. Each rank cuts its block at the splitters into ``p`` buckets, each
   padded to the block's length with the sentinel, and the buckets and
   their true counts cross with ``all_to_all_single``.
4. Each rank sorts what it received; the rows and counts are gathered,
   trimmed by the counts, concatenated in rank order and decoded.

``tpulab``'s keys are unsigned; torch sorts no uint32 or uint64 on every
device, and gloo carries neither, so the port flips the unsigned key's
top bit and sorts it as the signed integer of the same width: the same
order, and the unsigned sentinel becomes the signed ``iinfo.max``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpulab_torch.parallel.collectives import (check_dtype, gather_axis, pad_to_multiple,
                                               shard_of, to_host)
from tpulab_torch.parallel.mesh import axis_mesh, axis_size

_KEY_DTYPE = {np.dtype(np.float32): np.uint32, np.dtype(np.float64): np.uint64}
_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}


def _encode_keys(x: np.ndarray) -> np.ndarray:
    """Monotone bijection float -> unsigned int (IEEE total order), NaNs
    first made the positive quiet NaN (``tpulab``'s, a copy)."""
    udtype = np.dtype(_KEY_DTYPE[x.dtype])
    nbits = udtype.itemsize * 8
    topbit = np.asarray(1, udtype) << np.asarray(nbits - 1, udtype)
    allones = np.asarray(~np.asarray(0, udtype), udtype)
    x = np.where(np.isnan(x), np.asarray(np.nan, x.dtype), x)
    u = np.ascontiguousarray(x).view(udtype)
    return u ^ np.where(u >> np.asarray(nbits - 1, udtype) == 1, allones, topbit)


def _decode_keys(k: np.ndarray, fdtype) -> np.ndarray:
    fdtype = np.dtype(fdtype)
    udtype = np.dtype(_KEY_DTYPE[fdtype])
    nbits = udtype.itemsize * 8
    topbit = np.asarray(1, udtype) << np.asarray(nbits - 1, udtype)
    allones = np.asarray(~np.asarray(0, udtype), udtype)
    k = np.ascontiguousarray(k).astype(udtype, copy=False)
    u = k ^ np.where(k >> np.asarray(nbits - 1, udtype) == 1, topbit, allones)
    return u.view(fdtype)


def _signed(keys: np.ndarray) -> np.ndarray:
    """Unsigned keys as the signed integers of the same order."""
    top = np.asarray(1, keys.dtype) << np.asarray(keys.dtype.itemsize * 8 - 1, keys.dtype)
    return (keys ^ top).view(_SIGNED[keys.dtype])


def _unsigned(keys: np.ndarray) -> np.ndarray:
    u = keys.view(np.dtype(f"u{keys.dtype.itemsize}"))
    return u ^ (np.asarray(1, u.dtype) << np.asarray(u.dtype.itemsize * 8 - 1, u.dtype))


def _sentinel(dtype) -> np.ndarray:
    return np.asarray(np.iinfo(dtype).max, dtype)


def stage_sort(values, *, mesh, axis: str = "x") -> Tuple[torch.Tensor, dict]:
    """Encode, pad and shard ``values``: ``(this rank's block on its
    device, meta)``; pass ``meta`` to :func:`finish_sort`."""
    x = to_host(values)
    if x.ndim != 1:
        raise ValueError(f"expected 1-D array, got shape {x.shape}")
    meta = {"n": x.shape[0], "dtype": x.dtype, "p": axis_size(mesh, axis)}
    if x.dtype == np.uint8:
        x = x.astype(np.int32)
    elif x.dtype.kind == "f":
        if x.dtype not in _KEY_DTYPE:
            raise TypeError(f"unsupported float dtype for distributed sort: {x.dtype}")
        x = _signed(_encode_keys(x))
    elif x.dtype.kind != "i":
        raise TypeError(f"unsupported dtype for distributed sort: {x.dtype}")
    x = pad_to_multiple(x, meta["p"], _sentinel(x.dtype))
    return shard_of(x, mesh, axis), meta


def sample_sort_staged(x: torch.Tensor, *, mesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The collective sort of a staged block: every rank's sorted bucket
    row ``(p, p * m)`` (sentinel-padded) and its true count ``(p,)``."""
    p = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    check_dtype(x.dtype, group, "all_to_all_single")
    fill = torch.iinfo(x.dtype).max
    m = x.shape[0]
    s = torch.sort(x).values
    idx = (torch.arange(p, device=x.device) * max(1, m // p)).clamp(0, m - 1)
    samples = torch.sort(gather_axis(s[idx], mesh, axis)).values
    splitters = samples[torch.arange(1, p, device=x.device) * p]
    bucket = torch.searchsorted(splitters, s, right=True)                    # in [0, p)
    onehot = bucket[None, :] == torch.arange(p, device=x.device)[:, None]   # (p, m)
    outgoing = torch.where(onehot, s[None, :], torch.full_like(s[None, :], fill))
    counts = onehot.sum(dim=1).to(torch.int64)
    recv = torch.empty_like(outgoing)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv, outgoing, group=group)
    dist.all_to_all_single(recv_counts, counts, group=group)
    merged = torch.sort(recv.reshape(-1)).values                            # padding last
    return gather_axis(merged[None], mesh, axis), gather_axis(recv_counts.sum()[None],
                                                              mesh, axis)


def finish_sort(rows, counts, meta: dict) -> np.ndarray:
    """Trim the buckets' padding, decode the keys, restore the dtype."""
    rows, counts = to_host(rows), to_host(counts)
    out = np.concatenate([rows[i, : counts[i]] for i in range(meta["p"])])[: meta["n"]]
    if np.dtype(meta["dtype"]).kind == "f":
        out = _decode_keys(_unsigned(out), meta["dtype"])
    return out.astype(meta["dtype"])


def distributed_sort(values, *, mesh=None, axis: str = "x", num_devices: Optional[int] = None,
                     backend: Optional[str] = None) -> np.ndarray:
    """Ascending sample sort of a 1-D array over ``mesh[axis]``: every
    rank gets the whole sorted array."""
    mesh = axis_mesh(mesh, axis, num_devices, backend)
    staged, meta = stage_sort(values, mesh=mesh, axis=axis)
    rows, counts = sample_sort_staged(staged, mesh=mesh, axis=axis)
    return finish_sort(rows, counts, meta)
