"""Kernel B7's plain version and the engine's gather attention, held
against ``tpulab`` on the CPU.

``paged_attend_plain`` is held against ``tpulab.ops.pallas.paged.
paged_attend_pallas`` in interpret mode, element by element:

- float32 within ``2e-5 + 2e-5 * |want|`` (the limit of
  ``tests/test_paged_kernel.py``: the same products summed in another
  order, the Pallas kernel's online softmax against one pass);
- bfloat16 within ``attention.o_tolerance``: two bf16 ulps of the element
  plus two of the largest ``|want|`` of its (slot, head) row;
- a length-0 slot is NaN in both.

The port's gather path ``_paged_attend`` keeps ``tpulab``'s own rounding
(scores formed in q's dtype) and is held to the same limits against
``tpulab.models.paged._paged_attend``.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.models import paged as jpaged
from tpulab.ops.pallas.paged import paged_attend_pallas

from tpulab_torch.models import paged as tpaged
from tpulab_torch.models.labformer import _to_torch
from tpulab_torch.ops.cuda.paged import (
    paged_attend_kernel,
    paged_attend_plain,
    paged_over_tolerance,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(S=3, M=4, BS=16, d=64, P=32, h=8, kvh=8, seed=0, dtype="float32", int8=False):
    """q, pools and tables as numpy; int8 pools quantized by tpulab's recipe."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    q = np.asarray(jnp.asarray(rng.standard_normal((S, 1, h, d)), jdt))
    kf = rng.standard_normal((P, BS, kvh, d)).astype(np.float32)
    vf = rng.standard_normal((P, BS, kvh, d)).astype(np.float32)
    if int8:
        kp = tuple(np.asarray(a) for a in jpaged._kv_quant(jnp.asarray(kf)))
        vp = tuple(np.asarray(a) for a in jpaged._kv_quant(jnp.asarray(vf)))
    else:
        kp, vp = np.asarray(jnp.asarray(kf, jdt)), np.asarray(jnp.asarray(vf, jdt))
    tables = rng.choice(P, (S, M), replace=False).reshape(S, M).astype(np.int32)
    return q, kp, vp, tables


def _jax(x):
    return tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple) else jnp.asarray(x)


def _torch(x):
    return tuple(_to_torch(a) for a in x) if isinstance(x, tuple) else _to_torch(x)


def _both(fn_jax, fn_torch, q, kp, vp, tables, lengths, bs, window):
    want = fn_jax(_jax(q), _jax(kp), _jax(vp), jnp.asarray(tables),
                  jnp.asarray(lengths, jnp.int32), bs, window)
    got = fn_torch(_torch(q), _torch(kp), _torch(vp), torch.from_numpy(tables),
                   torch.tensor(lengths, dtype=torch.int32), bs, window)
    return got, _to_torch(np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh,window", [(8, 8, 0), (8, 2, 0), (8, 2, 5), (4, 4, 0),
                                          (16, 4, 7), (24, 2, 0), (24, 2, 9)])
def test_plain_matches_pallas(h, kvh, window, dtype):
    q, kp, vp, tables = _case(h=h, kvh=kvh, dtype=dtype)
    got, want = _both(paged_attend_pallas, paged_attend_plain, q, kp, vp, tables,
                      [1, 30, 64], 16, window)
    assert got.dtype == want.dtype == DTYPES[dtype][1] and got.shape == (3, 1, h, 64)
    assert paged_over_tolerance(got, want) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 11])
def test_plain_matches_pallas_int8_pools(dtype, window):
    """In-kernel dequantization: (int8 -> f32) * scale rounded to q's dtype."""
    q, kp, vp, tables = _case(kvh=2, seed=5, dtype=dtype, int8=True)
    got, want = _both(paged_attend_pallas, paged_attend_plain, q, kp, vp, tables,
                      [1, 30, 64], 16, window)
    assert paged_over_tolerance(got, want) <= 1


@pytest.mark.parametrize("lengths", [[16, 32, 48], [15, 17, 64], [1, 1, 1], [0, 16, 33]])
def test_plain_matches_pallas_at_block_edges(lengths):
    """Lengths at block edges and 1; a length-0 slot is NaN in both."""
    q, kp, vp, tables = _case(kvh=2, seed=1)
    got, want = _both(paged_attend_pallas, paged_attend_plain, q, kp, vp, tables,
                      lengths, 16, 0)
    assert paged_over_tolerance(got, want) <= 1
    dead = torch.tensor(lengths) == 0
    assert bool(torch.isnan(got[dead]).all()) and not bool(torch.isnan(got[~dead]).any())


def test_block_size_and_pool_mismatches_refused():
    q, kp, vp, tables = _case()
    args = (_torch(q), _torch(kp), _torch(vp), torch.from_numpy(tables),
            torch.tensor([1, 2, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="block size"):
        paged_attend_kernel(*args, 8)
    with pytest.raises(ValueError, match="both"):
        paged_attend_kernel(args[0], (args[1].to(torch.int8), args[1][..., 0]), *args[2:], 16)
    with pytest.raises(ValueError, match="int32"):
        paged_attend_kernel(*args[:3], args[3].long(), args[4], 16)


@pytest.mark.parametrize("window", [0, 64])
def test_skipped_block_misses_the_limit(window):
    """The limit rejects what a kernel that skipped one live table block
    would give: the plain version over the table without that block."""
    q, kp, vp, tables = _case(kvh=2, seed=2)
    tq, tk, tv, tt = _torch(q), _torch(kp), _torch(vp), torch.from_numpy(tables)
    lengths = torch.tensor([40, 64, 50], dtype=torch.int32)
    want = paged_attend_plain(tq, tk, tv, tt, lengths, 16, window)
    cut = torch.cat([tt[:, :1], tt[:, 2:], torch.zeros_like(tt[:, :1])], dim=1)
    skipped = paged_attend_plain(tq, tk, tv, cut, lengths - 16, 16, max(window - 16, 0))
    assert paged_over_tolerance(skipped, want) > 10


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("dtype,window,int8", [("float32", 0, False), ("float32", 6, False),
                                               ("bfloat16", 0, False), ("float32", 0, True)])
def test_gather_attend_matches_tpulab(W, dtype, window, int8):
    """The gather path, its W-row verify window included, on tpulab's rounding."""
    q, kp, vp, tables = _case(S=2, h=8, kvh=2, seed=3, dtype=dtype, int8=int8)
    q = np.concatenate([q] * W, axis=1)
    got, want = _both(jpaged._paged_attend, tpaged._paged_attend, q, kp, vp, tables,
                      [9, 40], 16, window)
    assert got.shape == (2, W, 8, 64)
    assert paged_over_tolerance(got, want) <= 1
