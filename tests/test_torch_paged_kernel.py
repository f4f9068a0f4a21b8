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

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.models import paged as jpaged
from tpulab.ops.pallas.paged import paged_attend_pallas

from tpulab_torch.models import paged as tpaged
from tpulab_torch.models.labformer import _to_torch
from tpulab_torch.ops.cuda import _build
from tpulab_torch.ops.cuda.paged import (
    MAX_SPAN_CHUNKS,
    NEG_INF,
    SMS,
    chunk_positions,
    paged_attend_kernel,
    paged_attend_plain,
    paged_over_tolerance,
    pool_gather,
    prescale_divisor,
    row_blocks,
    shared_bytes,
    split_plan,
    table_entries,
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
    would give: the plain version over the table without that block; and
    what one that skipped a whole split (a span of 4 table blocks) would."""
    q, kp, vp, tables = _case(kvh=2, seed=2)
    tq, tk, tv, tt = _torch(q), _torch(kp), _torch(vp), torch.from_numpy(tables)
    lengths = torch.tensor([40, 64, 50], dtype=torch.int32)
    want = paged_attend_plain(tq, tk, tv, tt, lengths, 16, window)
    cut = torch.cat([tt[:, :1], tt[:, 2:], torch.zeros_like(tt[:, :1])], dim=1)
    skipped = paged_attend_plain(tq, tk, tv, cut, lengths - 16, 16, max(window - 16, 0))
    assert paged_over_tolerance(skipped, want) > 10

    q, kp, vp, tables = _case(M=16, P=64, kvh=2, seed=3)
    tq, tk, tv, tt = _torch(q), _torch(kp), _torch(vp), torch.from_numpy(tables)
    splits, span = split_plan(3, 2, 256, 64)
    assert (splits, span) == (4, 64)
    lengths = torch.tensor([140, 256, 200], dtype=torch.int32)
    want = _split_order(tq, tk, tv, tt, lengths, 16, window)
    cut = torch.cat([tt[:, :4], tt[:, 8:], torch.zeros_like(tt[:, :4])], dim=1)
    skipped = _split_order(tq, tk, tv, cut, lengths - span, 16, max(window - span, 0))
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


# ------------------------------------------------- B7's split order (flash-decoding)


def _split_order(q, kpool_l, vpool_l, tables, lengths, bs, window=0):
    """Kernel B7's function summed in the kernel's order, in plain PyTorch:
    each split of ``split_plan`` runs, per warp, chunk by chunk over the
    quarter of each chunk that warp reads, with its own running (m, l,
    acc); the 4 warps are merged in warp order, then the splits in
    split-index order (not the order blocks finish)."""
    S, _, h, d = q.shape
    data = kpool_l[0] if isinstance(kpool_l, tuple) else kpool_l
    kvh, M = data.shape[2], tables.shape[1]
    g = h // kvh
    splits, span = split_plan(S, kvh, M * bs, d, row_blocks(g))
    ck = chunk_positions(d)
    n = splits * span
    idx = tables.long()
    k = pool_gather(kpool_l, idx, q.dtype).reshape(S, M * bs, kvh, d).float()
    v = pool_gather(vpool_l, idx, q.dtype).reshape(S, M * bs, kvh, d).float()
    pad = torch.zeros(S, n - M * bs, kvh, d)
    k, v = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    qs = (q / prescale_divisor(d, q.dtype)).reshape(S, kvh, g, d).float()
    s = torch.einsum("scgd,skcd->scgk", qs, k)
    pos = torch.arange(n)[None, :]
    ln = lengths.long()[:, None]
    valid = (pos < ln) & (pos < M * bs)
    if window:
        valid = valid & (pos > ln - 1 - window)
    # positions as (split, chunk, warp, key of the warp)
    shape = (splits, span // ck, 4, ck // 4)
    s = s.reshape(S, kvh, g, *shape)
    valid = valid.reshape(S, 1, 1, *shape).expand_as(s)
    v = v.permute(0, 2, 1, 3).reshape(S, kvh, 1, *shape, d).expand(-1, -1, g, *shape, d)
    m = torch.full((S, kvh, g, splits, 4), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(S, kvh, g, splits, 4, d)
    for c in range(span // ck):
        sc, ok = s[:, :, :, :, c], valid[:, :, :, :, c]
        tmax = torch.where(ok, sc, NEG_INF).amax(-1)
        m_new = torch.maximum(m, tmax)
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("scgtwk,scgtwkd->scgtwd", p,
                                                    v[:, :, :, :, c])
        m = m_new

    def merge(m, l, acc):  # over the last axis of m and l (acc's next-to-last), in order
        top = m.amax(-1)
        tl = torch.zeros_like(top)
        ta = torch.zeros_like(acc[..., 0, :])
        for i in range(m.shape[-1]):
            w = torch.exp(m[..., i] - top)
            tl = tl + l[..., i] * w
            ta = ta + acc[..., i, :] * w[..., None]
        return top, tl, ta

    m, l, acc = merge(m, l, acc)          # the warps of each split
    _, l, acc = merge(m, l, acc)          # the splits
    return (acc / l[..., None]).reshape(S, 1, h, d).to(q.dtype)


#: (lengths of 4 slots, window) at a span of 64 positions (d64, 3 splits):
#: lengths at split edges; a window across a split edge; a slot whose
#: splits below the window are all empty, and a length-0 slot
SPLIT_CASES = {"edges": ([63, 64, 65, 129], 0), "window_across": ([100, 130, 192, 70], 40),
               "empty_below_window": ([190, 180, 129, 0], 20)}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 2), (24, 2)], ids=["g1", "g4", "g12"])
@pytest.mark.parametrize("dtype,int8", [("float32", False), ("bfloat16", False),
                                        ("float32", True), ("bfloat16", True)],
                         ids=["f32", "bf16", "f32-int8", "bf16-int8"])
def test_split_order_matches_pallas(case, h, kvh, dtype, int8):
    lengths, window = SPLIT_CASES[case]
    q, kp, vp, tables = _case(S=4, M=12, h=h, kvh=kvh, P=64, seed=h + window, dtype=dtype,
                              int8=int8)
    assert split_plan(4, kvh, 192, 64, row_blocks(h // kvh)) == (3, 64)
    got, want = _both(paged_attend_pallas, _split_order, q, kp, vp, tables, lengths, 16, window)
    assert got.dtype == want.dtype == DTYPES[dtype][1]
    assert paged_over_tolerance(got, want) <= 1
    dead = torch.tensor(lengths) == 0
    assert bool(torch.isnan(got[dead]).all()) and not bool(torch.isnan(got[~dead]).any())


@pytest.mark.parametrize("window,int8", [(0, False), (300, False), (0, True)])
def test_split_order_matches_plain_at_4096(window, int8):
    """Many splits of one chunk each, against the one-pass plain version
    in f32 (interpret mode would be slow at 4096 positions)."""
    q, kp, vp, tables = _case(S=2, M=256, h=8, kvh=2, P=512, seed=7, int8=int8)
    tq, tk, tv, tt = _torch(q), _torch(kp), _torch(vp), torch.from_numpy(tables)
    lengths = torch.tensor([4096, 3000], dtype=torch.int32)
    assert split_plan(2, 2, 4096, 64)[0] > 8
    got = _split_order(tq, tk, tv, tt, lengths, 16, window)
    want = paged_attend_plain(tq, tk, tv, tt, lengths, 16, window)
    assert paged_over_tolerance(got, want) <= 1


def test_split_plan_depends_on_shapes_alone():
    assert list(inspect.signature(split_plan).parameters) == [
        "slots", "kv_heads", "positions", "d", "row_blocks", "sms"]
    assert split_plan(3, 2, 64, 64) == (1, 64)          # tiny: one split
    assert split_plan(2, 1, 16, 8) == (1, 512)
    assert split_plan(8, 2, 256, 64) == (4, 64)         # the paged bench: 64 blocks
    splits, span = split_plan(64, 2, 4096, 64)          # at scale
    assert 64 * 2 * splits >= 2 * SMS and span % 64 == 0
    assert (splits - 1) * span < 4096 <= splits * span


@pytest.mark.parametrize("slots,kvh,positions,d,rb", [
    (1, 1, 1, 8, 1), (1, 1, 65536, 64, 1), (8, 2, 256, 128, 1), (64, 2, 4096, 64, 1),
    (32, 2, 2048, 64, 1), (256, 8, 4096, 128, 1), (4, 2, 4100, 16, 3), (3, 5, 777, 32, 2)])
def test_split_plan_covers_every_position(slots, kvh, positions, d, rb):
    """Spans are whole chunks, at most MAX_SPAN_CHUNKS of them; no split
    lies wholly past the table; at most one split per chunk; the block's
    shared memory fits."""
    splits, span = split_plan(slots, kvh, positions, d, rb)
    ck = chunk_positions(d)
    assert span % ck == 0 and ck <= span <= MAX_SPAN_CHUNKS * ck
    assert (splits - 1) * span < positions <= splits * span
    assert splits <= -(-positions // ck)
    for itemsize, quantized in ((4, False), (2, False), (1, True)):
        assert shared_bytes(d, itemsize, quantized, table_entries(span, 16, 10**6)) <= \
            _build.MAX_SHARED
