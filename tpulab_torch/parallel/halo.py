"""Roberts cross over a row-sharded image with a one-row halo (lab2 at
scale; the counterpart of ``tpulab.parallel.halo``).

The image's rows are padded, by repeating the last row, to a multiple of
the mesh axis and cut into one block a rank.  The Roberts cross at row
``r`` reads row ``r + 1``, so each rank needs the first row of the rank
below it: ranks swap it with their neighbours (``batch_isend_irecv``),
and the bottom rank, which has none, repeats its own last row: the
reference's clamp at the image's border.

``tpulab`` sends the row's luminance and computes the cross from its
luminance plane; here each rank runs the single-device path on its block
with the halo row appended, so on the card each block runs kernel B1
(:func:`tpulab_torch.ops.cuda.stencil.roberts_u32`; its plain version on
the CPU).  B1 takes packed RGBA pixels and computes the luminance itself,
so the halo is the neighbour's first row of pixels (``4 * w`` bytes, as
many as the f32 luminance row), whose luminance is the one that row's own
rank computes.  The appended row's output is dropped, and the blocks are
gathered: the bytes of the single-device path.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.distributed as dist

from tpulab_torch.ops.cuda.stencil import roberts_u32
from tpulab_torch.ops.roberts import pack_rgba, unpack_rgba
from tpulab_torch.parallel.collectives import check_dtype, gather_axis, shard_of, to_host
from tpulab_torch.parallel.mesh import axis_mesh, axis_size


def halo_below(block: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The first row of the next rank's block along ``axis`` (the bottom
    rank: its own last row); each rank sends its first row up."""
    p, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    halo = block[-1].clone()
    ops = []
    if r > 0:
        ops.append(dist.P2POp(dist.isend, block[0].contiguous(),
                              dist.get_global_rank(group, r - 1), group))
    if r < p - 1:
        ops.append(dist.P2POp(dist.irecv, halo, dist.get_global_rank(group, r + 1), group))
    if ops:
        check_dtype(block.dtype, group, "batch_isend_irecv")
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return halo


def roberts_sharded(pixels_u8, *, mesh=None, axis: str = "x") -> np.ndarray:
    """Roberts edges of an (h, w, 4) uint8 RGBA image, its rows sharded
    over ``mesh[axis]``; any height works on any mesh."""
    mesh = axis_mesh(mesh, axis)
    img = to_host(pixels_u8)
    if img.ndim != 3 or img.shape[-1] != 4:
        raise ValueError(f"expected (h, w, 4) RGBA, got {img.shape}")
    h = img.shape[0]
    p = axis_size(mesh, axis)
    pad = (-h) % p
    if pad:
        img = np.concatenate([img, np.repeat(img[-1:], pad, axis=0)], axis=0)
    block = shard_of(pack_rgba(img).numpy(), mesh, axis)
    halo = halo_below(block, mesh, axis)
    edges = roberts_u32(torch.cat([block, halo[None]]))[:-1]
    return unpack_rgba(gather_axis(edges, mesh, axis))[:h]
