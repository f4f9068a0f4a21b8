"""tpulab_torch's radix prefix index, int4 packing and host spill tier held
against tpulab's on the CPU.

The radix index is pure Python in both packages: over one seeded stream
of insert, lookup and evict operations every return value and both counts
must be equal, and the radix cases of ``tests/test_kvcache.py`` rerun on
the port.  The int4 packing and the spill tier's encodings are numpy in
both: the port's bytes must equal tpulab's, for float32 and bfloat16
payloads (a bfloat16 payload is a torch tensor in the port and an
``ml_dtypes`` array in tpulab), dense and int8-quantized.  No tolerance
applies: every comparison is exact.
"""

import random

import ml_dtypes
import numpy as np
import pytest
import torch

from tpulab.kvcache import radix as jradix
from tpulab.kvcache import spill as jspill
from tpulab.models import quant as jquant

from tpulab_torch.kvcache import DEFAULT_WATERMARK, SPILL_DTYPES, HostSpillTier, SpillPolicy
from tpulab_torch.kvcache import radix as tradix
from tpulab_torch.kvcache import spill as tspill
from tpulab_torch.models import quant as tquant

torch.set_num_threads(2)


# ------------------------------------------------------------ the radix index


@pytest.mark.parametrize("bs,alphabet,seed", [(4, 3, 1234), (2, 2, 7), (8, 4, 99)])
def test_radix_equals_tpulab_over_random_ops(bs, alphabet, seed):
    """Thousands of mixed operations from one seeded stream: lookups,
    adopted blocks, eviction victims and both counts equal tpulab's."""
    rng = random.Random(seed)
    port, ref = tradix.RadixPrefixIndex(bs), jradix.RadixPrefixIndex(bs)
    next_block = 1
    for step in range(2000):
        op = rng.random()
        tokens = [rng.randrange(alphabet) for _ in range(bs * rng.randrange(0, 5)
                                                         + rng.randrange(bs))]
        if op < 0.45:
            need = len(tokens) // bs
            blocks = list(range(next_block, next_block + need))
            next_block += need
            assert port.insert(tokens, blocks) == ref.insert(tokens, blocks), step
        elif op < 0.8:
            assert port.lookup(tokens) == ref.lookup(tokens), step
        else:
            assert port.evict_leaf() == ref.evict_leaf(), step
        assert (port.n_blocks, port.n_entries, len(port)) == (
            ref.n_blocks, ref.n_entries, len(ref)), step
    assert sorted(port.blocks()) == sorted(ref.blocks())
    while True:  # the whole surviving tree drains in the same order
        a, b = port.evict_leaf(), ref.evict_leaf()
        assert a == b
        if a is None:
            break


def test_radix_first_writer_wins_and_partial_hits():
    t = tradix.RadixPrefixIndex(2)
    assert t.insert([1, 2, 3, 4], [10, 11]) == [10, 11]
    assert t.insert([1, 2, 9, 9], [77, 12]) == [12]  # the shared chunk keeps 10
    assert t.n_blocks == 3 and t.n_entries == 2
    assert t.lookup([1, 2, 8, 8, 5, 5]) == ([10], 1)
    assert t.lookup([1, 2, 3, 4, 5, 5]) == ([10, 11], 2)
    assert t.lookup([9, 9]) == ([], 0)
    assert t.lookup([1]) == ([], 0)  # less than a chunk never matches


def test_radix_leaf_only_lru_eviction():
    t = tradix.RadixPrefixIndex(1)
    t.insert([1, 2, 3], [10, 11, 12])
    t.insert([1, 9], [0, 13])
    t.lookup([1, 9])  # freshen the sibling branch
    assert t.evict_leaf() == (12, (1, 2, 3))  # interior 10 and 11 wait
    assert t.evict_leaf() == (11, (1, 2))
    assert t.evict_leaf() == (13, (1, 9))
    assert t.evict_leaf() == (10, (1,))
    assert t.evict_leaf() is None


def test_radix_validation():
    with pytest.raises(ValueError, match="block_size"):
        tradix.RadixPrefixIndex(0)
    t = tradix.RadixPrefixIndex(2)
    with pytest.raises(ValueError, match="one block per chunk"):
        t.insert([1, 2, 3, 4], [10])
    t.insert([1, 2], [10])
    t.clear()
    assert t.n_blocks == 0 and t.lookup([1, 2]) == ([], 0)


# ------------------------------------------------------------ int4 packing


@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 33, 256, 1001])
def test_int4_pack_bytes_equal_tpulab(n):
    q = np.random.default_rng(n).integers(-8, 8, size=(n,)).astype(np.int8)
    packed, odd = tquant.pack_int4(q)
    want, want_odd = jquant.pack_int4(q)
    assert packed.dtype == np.uint8 and packed.tobytes() == want.tobytes()
    assert odd == want_odd == bool(n % 2) and packed.size == (n + 1) // 2
    out = tquant.unpack_int4(packed, odd)
    assert out.dtype == np.int8 and np.array_equal(out, q)
    assert out.tobytes() == jquant.unpack_int4(want, want_odd).tobytes()


@pytest.mark.parametrize("bad", [8, -9, 127])
def test_int4_pack_refuses_out_of_range(bad):
    q = np.array([0, bad, 1], np.int8)
    for pack in (tquant.pack_int4, jquant.pack_int4):
        with pytest.raises(ValueError, match="int4"):
            pack(q)


# ------------------------------------------------------------ the spill tier


def _payload(kind: str, seed: int, shape=(2, 4, 2, 8)):
    """(port payload, tpulab payload) holding the same values: a dense f32
    or bf16 block, or an int8 pool's (data, scale) pair."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    if kind == "f32":
        return torch.from_numpy(x.copy()), x
    if kind == "bf16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return t, t.float().numpy().astype(ml_dtypes.bfloat16)
    q = rng.integers(-127, 128, size=shape).astype(np.int8)
    s = (rng.random(shape[:-1]) + 0.1).astype(np.float32)
    return (torch.from_numpy(q.copy()), torch.from_numpy(s.copy())), (q, s)


def _raw(x):
    """(shape, itemsize, bytes) of an array or tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.element_size(), x.contiguous().view(torch.uint8).numpy().tobytes()
    x = np.asarray(x)
    return x.shape, x.dtype.itemsize, x.tobytes()


def _arrays(entry):
    """An encoded entry's arrays as (shape, itemsize, bytes), in order."""
    kind, payload = entry
    if kind == "q4":
        return [_raw(payload[0]), _raw(payload[1])]
    parts = payload if isinstance(payload, tuple) else (payload,)
    return [_raw(p) for p in parts]


@pytest.mark.parametrize("kind", ["f32", "bf16", "q8pool"])
@pytest.mark.parametrize("dtype", SPILL_DTYPES)
def test_spill_encodings_bytes_equal_tpulab(kind, dtype):
    """Each encoding of each payload kind: the same entry kind, shapes,
    dtypes and bytes as tpulab's, the same byte charge, and a decode back to
    the pool's representation equal to tpulab's."""
    port, ref = _payload(kind, 3)
    got, want = tspill._encode(port, dtype), jspill._encode(ref, dtype)
    assert got[0] == want[0]
    if got[0] == "q4":
        assert got[1][2:] == want[1][2:]  # shape and padding flag
    assert _arrays(got) == _arrays(want)
    assert tspill._entry_nbytes(got) == jspill._entry_nbytes(want)
    quantized = kind == "q8pool"
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "q8pool": torch.int8}[kind]
    jdt = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "q8pool": np.int8}[kind]
    dec, jdec = tspill._decode(got, quantized, tdt), jspill._decode(want, quantized, jdt)
    for a, b in zip(dec if quantized else (dec,), jdec if quantized else (jdec,)):
        assert isinstance(a, torch.Tensor) and _raw(a) == _raw(b)


def test_spill_native_roundtrip_is_the_payload():
    k, _ = _payload("bf16", 0)
    v, _ = _payload("bf16", 1)
    tier = HostSpillTier(4, "native")
    assert tier.put(b"a", k, v) == 2 * k.numel() * 2
    kk, vv = tier.get(b"a", pool_is_quantized=False, pool_dtype=torch.bfloat16)
    assert torch.equal(kk, k) and torch.equal(vv, v)
    pair, _ = _payload("q8pool", 2)
    tier.put(b"b", pair, pair)
    (q, s), _ = tier.get(b"b", pool_is_quantized=True, pool_dtype=torch.int8)
    assert torch.equal(q, pair[0]) and torch.equal(s, pair[1])
    assert b"a" in tier and len(tier) == 2 and tier.get(b"zz", pool_is_quantized=False,
                                                        pool_dtype=torch.bfloat16) is None


@pytest.mark.parametrize("dtype", SPILL_DTYPES)
def test_spill_lru_capacity_and_dropped_equal_tpulab(dtype):
    """One sequence of puts, gets and refreshes through both tiers at
    capacity 3: the same keys held, ``dropped``, ``nbytes`` and every put's
    byte charge."""
    rng = random.Random(5)
    port, ref = HostSpillTier(3, dtype), jspill.HostSpillTier(3, dtype)
    for step in range(60):
        key = bytes([rng.randrange(6)])
        if rng.random() < 0.6:
            (pk, jk), (pv, jv) = _payload("f32", step), _payload("f32", step + 1000)
            assert port.put(key, pk, pv) == ref.put(key, jk, jv), step
        else:
            hit = port.get(key, pool_is_quantized=False, pool_dtype=torch.float32)
            want = ref.get(key, pool_is_quantized=False, pool_dtype=np.float32)
            assert (hit is None) == (want is None), step
            if hit is not None:
                assert [_raw(a) for a in hit] == [_raw(b) for b in want]
        assert (len(port), port.dropped, port.nbytes) == (len(ref), ref.dropped, ref.nbytes)
        assert all((k in port) == (k in ref) for k in (bytes([i]) for i in range(6)))
    assert port.dropped > 0
    port.clear()
    assert len(port) == 0 and port.nbytes == 0


def test_spill_validation():
    with pytest.raises(ValueError, match="spill dtype"):
        HostSpillTier(2, "fp7")
    with pytest.raises(ValueError, match="capacity_blocks"):
        HostSpillTier(0)
    with pytest.raises(ValueError, match="watermark"):
        SpillPolicy(watermark=0.0)
    with pytest.raises(ValueError, match="batch"):
        SpillPolicy(batch=0)
    assert DEFAULT_WATERMARK == jspill.DEFAULT_WATERMARK == 0.90
    assert SPILL_DTYPES == jspill.SPILL_DTYPES


@pytest.mark.parametrize("watermark,batch", [(0.90, 8), (0.5, 2), (1.0, 3), (0.25, 100)])
def test_spill_policy_overage_equals_tpulab(watermark, batch):
    port, ref = SpillPolicy(watermark, batch), jspill.SpillPolicy(watermark, batch)
    for total in (0, 1, 7, 10, 128, 255):
        for used in range(0, total + 1):
            assert port.overage(used, total) == ref.overage(used, total), (used, total)
    if (watermark, batch) == (0.90, 8):  # tests/test_kvcache.py's cases
        assert [port.overage(u, 128) for u in (100, 116, 128)] == [0, 1, 8]
