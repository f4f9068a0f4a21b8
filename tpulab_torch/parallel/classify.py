"""lab3's per-pixel classification over a row-sharded image (the
counterpart of ``tpulab.parallel.classify``).

Each rank classifies its block of rows with the single-device lab3 path
(:func:`tpulab_torch.ops.mahalanobis.classify_staged`: kernel B3 on the
card, its plain version on the CPU), the class statistics staged whole on
every rank (the reference's ``__constant__`` memory), and the labelled
blocks are gathered.  No collective runs in the classification itself.
"""

from __future__ import annotations

import numpy as np

from tpulab_torch.ops.mahalanobis import ClassStats, classify_staged
from tpulab_torch.ops.roberts import unpack_rgba
from tpulab_torch.parallel.collectives import gather_axis, to_host
from tpulab_torch.parallel.mesh import axis_mesh, axis_size, mesh_anchor


def classify_sharded(pixels_u8, stats: ClassStats, *, mesh=None, axis: str = "x",
                     compute_dtype: str = "float32") -> np.ndarray:
    """lab3 over ``mesh[axis]``: labels in the alpha channel, RGB kept;
    the bytes of the single-device path in ``compute_dtype``
    (``tpulab``'s default here is float32, the TPU kernel's)."""
    mesh = axis_mesh(mesh, axis)
    img = to_host(pixels_u8)
    if img.ndim != 3 or img.shape[-1] != 4:
        raise ValueError(f"expected (h, w, 4) RGBA, got {img.shape}")
    h = img.shape[0]
    p, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    pad = (-h) % p
    if pad:
        img = np.concatenate([img, np.repeat(img[-1:], pad, axis=0)], axis=0)
    m = img.shape[0] // p
    fn, args = classify_staged(img[r * m:(r + 1) * m], stats, device=mesh_anchor(mesh),
                               compute_dtype=compute_dtype)
    return unpack_rgba(gather_axis(fn(*args), mesh, axis))[:h]
