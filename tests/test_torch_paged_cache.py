"""The PagedEngine's cache tier in tpulab_torch held against tpulab's on the
CPU: the radix prefix index and the host spill tier (``prefix_index=
"radix"``, ``spill_blocks``, ``spill_dtype``).

Both engines get the same weights (tpulab's ``trained_small``, whose wide
greedy margins keep an argmax from flipping under the f32 rounding in
which XLA and PyTorch differ) and the same requests, across ``attn`` in
{gather, pallas} (kernel B7's plain version here; tpulab's Pallas kernel in
interpret mode) and ``kv_dtype`` in {native, int8}.  Greedy streams must be
bit identical, and so must the counters of
``tests/test_torch_paged_engine.py`` with the cache tier's own:
evictions, preemptions, blocks spilled, prefetched and hit, and the tier's
stats (blocks and bytes held, capacity, drops).  The scenarios are those
of ``tests/test_kvcache.py``: exact-hit traces through the dict and the
radix index, partial hits, the spill round trip, and a steady window with
the tier armed that uploads nothing.  After every run no block has
leaked.
"""

import numpy as np
import pytest
import torch

from tpulab.models import generate as jgen
from tpulab.models import labformer as jlf
from tpulab.models import paged as jpaged

from tpulab_torch.models import labformer as tlf
from tpulab_torch.models import paged as tpaged
from tpulab_torch.models.labformer import Labformer

torch.set_num_threads(2)

COUNTERS = ("ticks", "tokens_out", "requests_done", "prefix_hits", "prefix_misses",
            "evictions", "admissions", "prefill_chunks", "stall_ticks", "blocks_retired",
            "host_syncs", "h2d_ticks", "blocks_free", "cache_entries", "cache_bytes",
            "kv_pool_bytes", "compile_buckets_dense", "compile_buckets_extend",
            "preemptions", "spill_spilled", "spill_prefetched", "spill_hits",
            "spill_host_blocks", "spill_host_bytes", "spill_capacity_blocks", "spill_dropped")
MODES = [("gather", "native"), ("pallas", "native"), ("gather", "int8"), ("pallas", "int8")]
SPILL = dict(prefix_index="radix", spill_blocks=16)


def _cycle(p):
    return (np.arange(p) % 7).astype(np.int32)


@pytest.fixture(scope="module")
def small(trained_small, trained_small_cfg):
    """(tpulab params, tpulab cfg, the port's CPU model)."""
    cfg = trained_small_cfg
    return trained_small, cfg, Labformer.from_numpy(
        trained_small, tlf.cfg_from_dict(jlf.cfg_to_dict(cfg)), "cpu")


def _drive(eng, plan):
    """Run ``plan`` (("submit", (prompt, max_new)) | ("run", None)); then
    ``run()``.  The streams by submission order."""
    rids, out = [], {}
    for op, arg in plan:
        if op == "submit":
            rids.append(eng.submit(arg[0], max_new=arg[1]))
        else:
            out.update(eng.run())
    out.update(eng.run())
    return [out[r] for r in rids]


def cached_blocks(eng):
    """Blocks the prefix cache holds, and its references on them."""
    if eng._radix is not None:
        blocks = list(eng._radix.blocks())
        return set(blocks), len(blocks)
    return ({b for bl in eng.prefix_cache.values() for b in bl},
            sum(len(b) for b in eng.prefix_cache.values()))


def no_leak(eng):
    """Every usable block is free or held by the cache alone, once."""
    cached, refs = cached_blocks(eng)
    assert len(eng.free) + len(cached) == eng.n_usable_blocks
    assert sorted(set(eng.free)) == sorted(eng.free) and not cached & set(eng.free)
    assert int(eng.block_refs.sum()) == refs
    assert np.all(eng.tables == tpaged.TRASH) and eng.inflight_depth == 0


def _compare(small, plan, geo, **kw):
    """The plan through tpulab's engine and the port's: streams bit-equal,
    the counters equal, no leak; (the port's streams, its stats)."""
    params, jcfg, model = small
    jeng = jpaged.PagedEngine(params, jcfg, obs=False, **geo, **kw)
    teng = tpaged.PagedEngine(model, model.cfg, **geo, **kw)
    want, got = _drive(jeng, plan), _drive(teng, plan)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.int32 and np.array_equal(a, b), (i, a, b)
    jst, tst = jeng.stats(), teng.stats()
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    no_leak(teng)
    return got, tst


@pytest.mark.parametrize("attn,kv_dtype", MODES)
def test_dict_radix_bit_equality_exact_hit_traces(small, attn, kv_dtype):
    """Repeated prompts over three waves through a dict and a radix engine
    of each package: streams bit-equal to tpulab's and across the indexes,
    the exact hits recorded by both; greedy streams equal plain
    ``generate``'s."""
    params, jcfg, _ = small
    plan = []
    for _ in range(3):  # waves 2 and 3 hit exactly
        plan += [("submit", (_cycle(9), 5)), ("submit", (_cycle(17), 5)), ("run", None)]
    geo = dict(slots=2, n_blocks=24, block_size=8, max_seq=64)
    outs = {}
    for index in ("dict", "radix"):
        outs[index], st = _compare(small, plan, geo, attn=attn, kv_dtype=kv_dtype,
                                   prefix_index=index)
        assert st["prefix_hits"] >= 4, index
    for a, b in zip(outs["dict"], outs["radix"]):
        assert np.array_equal(a, b)
    if kv_dtype == "native":
        for p, toks in zip((9, 17), outs["radix"]):
            want = jgen.generate(params, _cycle(p)[None, :], jcfg, steps=5, temperature=0.0)[0]
            assert np.array_equal(toks, np.asarray(want))


@pytest.mark.parametrize("attn,kv_dtype", MODES)
def test_radix_partial_hit(small, attn, kv_dtype):
    """Only a two-block prefix registered: a prompt diverging inside its
    second block reuses the first through the radix index, and misses
    through the dict."""
    div = np.concatenate([_cycle(8), np.full(9, 5, np.int32)]).astype(np.int32)
    plan = [("submit", (_cycle(17), 5)), ("run", None), ("submit", (div, 5))]
    geo = dict(slots=1, n_blocks=24, block_size=8, max_seq=64)
    for index, hits in (("dict", 0), ("radix", 1)):
        _, st = _compare(small, plan, geo, attn=attn, kv_dtype=kv_dtype, prefix_index=index)
        assert st["prefix_hits"] == hits, index


@pytest.mark.parametrize("attn,kv_dtype", MODES)
def test_spill_roundtrip_bit_equality(small, attn, kv_dtype):
    """A 7-block pool churns: A's prefix is evicted to the host tier under
    filler pressure and restored when A returns; every stream equals
    tpulab's and the spill-free engine's."""
    a = _cycle(17)
    fillers = [(np.arange(i, i + 17) % 11).astype(np.int32) for i in (1, 2, 3)]
    plan = []
    for p in [a, *fillers, a]:
        plan += [("submit", (p, 5)), ("run", None)]
    geo = dict(slots=1, n_blocks=8, block_size=8, max_seq=64, attn=attn, kv_dtype=kv_dtype)
    got, st = _compare(small, plan, geo, **SPILL)
    assert st["spill_spilled"] >= 1 and st["spill_prefetched"] >= 1 and st["spill_hits"] >= 1
    assert st["spill_capacity_blocks"] == 16 and st["spill_host_bytes"] > 0
    ref, _ = _compare(small, plan, geo)
    for x, y in zip(got, ref):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("spill_dtype", ["int8", "int4"])
def test_lossy_spill_dtypes_charge_tpulabs_bytes(small, spill_dtype):
    """The int8 and int4 host formats: the host tier's bytes and every
    counter equal tpulab's after the same churn (the streams of a lossy
    restore are not held to the spill-free ones)."""
    params, jcfg, model = small
    a = _cycle(17)
    seq = [a, *[(np.arange(i, i + 17) % 11).astype(np.int32) for i in (1, 2, 3)]]
    geo = dict(slots=1, n_blocks=8, block_size=8, max_seq=64, prefix_index="radix",
               spill_blocks=16, spill_dtype=spill_dtype)
    jeng = jpaged.PagedEngine(params, jcfg, obs=False, **geo)
    teng = tpaged.PagedEngine(model, model.cfg, **geo)
    for eng in (jeng, teng):
        for p in seq:
            eng.submit(p, max_new=5)
            eng.run()
    jst, tst = jeng.stats(), teng.stats()
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert tst["spill_spilled"] >= 1
    no_leak(teng)


@pytest.mark.parametrize("mode", ["dict", "radix", "radix+spill"])
def test_evict_prefixes_never_frees_live_slot_blocks(small, mode):
    """A second wave re-admits over the cached prefix (a cache and a slot
    reference on the same blocks); an over-demand eviction then drains the
    whole index: the slot's blocks stay off the free list and its stream
    is tpulab's."""
    params, jcfg, model = small
    kw = {"prefix_index": "radix"} if "radix" in mode else {}
    if mode == "radix+spill":
        kw["spill_blocks"] = 8
    p = _cycle(17)
    streams = []
    for eng in (jpaged.PagedEngine(params, jcfg, obs=False, slots=1, n_blocks=16,
                                   block_size=8, max_seq=64, **kw),
                tpaged.PagedEngine(model, model.cfg, slots=1, n_blocks=16, block_size=8,
                                   max_seq=64, **kw)):
        eng.submit(p, max_new=5)
        eng.run()
        rid = eng.submit(p, max_new=8)
        for _ in range(2):
            eng.step()
        live = {int(b) for b in np.asarray(eng.tables).ravel() if b != tpaged.TRASH}
        assert live
        eng._evict_prefixes(eng.n_usable_blocks + 1)
        assert (eng._radix.n_blocks if "radix" in mode else len(eng.prefix_cache)) == 0
        for b in live:
            assert b not in eng.free and eng.block_refs[b] >= 1, (mode, b)
        streams.append(eng.run()[rid])
    assert np.array_equal(streams[0], streams[1])


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_spill_armed_steady_window_flat_h2d(small, attn):
    """With the radix index and the tier armed, a steady window uploads
    nothing (no call to the engine's upload at all), keeps h2d_ticks and
    host_syncs flat, and the greedy stream is tpulab's."""
    params, jcfg, model = small
    geo = dict(slots=2, n_blocks=32, block_size=8, max_seq=64, attn=attn, **SPILL)
    eng = tpaged.PagedEngine(model, model.cfg, **geo)
    g = eng.submit(_cycle(4), max_new=30)
    eng.submit(_cycle(6), max_new=30, temperature=1.5, seed=3)
    for _ in range(4):
        eng.step()
    before = eng.stats()
    uploads = []
    real = eng._to_device
    eng._to_device = lambda t: uploads.append(t) or real(t)
    for _ in range(8):
        eng.step()
    eng._to_device = real
    st = eng.stats()
    assert uploads == [] and st["ticks"] == before["ticks"] + 8
    assert st["h2d_ticks"] == before["h2d_ticks"] and st["host_syncs"] == before["host_syncs"]
    assert eng.kv_fetches == 0
    jeng = jpaged.PagedEngine(params, jcfg, obs=False, **geo)
    jg = jeng.submit(_cycle(4), max_new=30)
    assert np.array_equal(eng.run()[g], jeng.run()[jg])


def test_engine_validation(small):
    _, _, model = small
    geo = dict(slots=1, n_blocks=8, block_size=8, max_seq=32)
    for kw, match in ((dict(prefix_index="btree"), "prefix_index"),
                      (dict(spill_blocks=-1), "spill_blocks"),
                      (dict(spill_blocks=4), "radix"),
                      (dict(prefix_index="radix", spill_blocks=4, spill_dtype="fp8"),
                       "spill_dtype")):
        with pytest.raises(ValueError, match=match):
            tpaged.PagedEngine(model, model.cfg, **geo, **kw)
    st = tpaged.PagedEngine(model, model.cfg, **geo).stats()
    assert st["spill_capacity_blocks"] == st["spill_host_blocks"] == st["spill_dropped"] == 0
    eng = tpaged.PagedEngine(model, model.cfg, **geo, prefix_index="radix", spill_blocks=4,
                             spill_dtype="int4")
    assert eng.stats()["spill_capacity_blocks"] == 4 and eng._spill.dtype == "int4"


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_spill_read_and_restore_round_trip(small, kv_dtype):
    """The read and write legs alone: blocks read out (tpulab's layout,
    block by block), written to other blocks, read back equal; the pool's
    other blocks untouched."""
    params, jcfg, model = small
    kp, vp = tpaged.init_pools(model.cfg, 10, 8, kv_dtype, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for pool in (kp, vp):
        for t in (pool if isinstance(pool, tuple) else (pool,)):
            t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    jk = tuple(np.asarray(t) for t in kp) if kv_dtype == "int8" else np.asarray(kp)
    jv = tuple(np.asarray(t) for t in vp) if kv_dtype == "int8" else np.asarray(vp)
    src = torch.tensor([3, 7, 5])
    kb, vb = tpaged._spill_read(kp, vp, src)
    for i, b in enumerate(src.tolist()):
        want_k, _ = jpaged._spill_read(jk, jv, np.int32(b))
        for got, want in zip(kb if kv_dtype == "int8" else (kb,),
                             want_k if kv_dtype == "int8" else (want_k,)):
            assert np.array_equal(got[i].numpy(), np.asarray(want))
    before = [t.clone() for pool in (kp, vp) for t in (pool if isinstance(pool, tuple)
                                                         else (pool,))]
    dst = torch.tensor([1, 2, 9])
    tpaged._spill_restore(kp, vp, kb, vb, dst)
    kb2, vb2 = tpaged._spill_read(kp, vp, dst)
    for a, b in zip(kb2 + vb2 if kv_dtype == "int8" else (kb2, vb2),
                    kb + vb if kv_dtype == "int8" else (kb, vb)):
        assert torch.equal(a, b)
    after = [t for pool in (kp, vp) for t in (pool if isinstance(pool, tuple) else (pool,))]
    keep = [0, 3, 4, 5, 6, 7, 8]  # blocks 1, 2 and 9 were written
    for a, b in zip(after, before):
        assert torch.equal(a[:, keep], b[:, keep])


def test_chip_smoke_phase10_rehearses_on_the_cpu():
    """chip_smoke.py's phase 10 on the CPU (B7's plain version), with the
    card's request lengths and pool cuts on a narrow model: blocks spill,
    come back and hit, a slot is preempted, the handoff carries bytes, the
    steady window moves nothing, and the small labformer's streams are
    bit-equal to their uninterrupted runs."""
    import chip_smoke

    sizes = dict(chip_smoke.FULL_SIZES)
    sizes["paged"] = dict(d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
                          max_seq=1024)
    out = chip_smoke.run_cache_path(sizes, torch.device("cpu"), "cpu")
    width = out["width"]
    assert min(width["spill_spilled"], width["spill_prefetched"], width["spill_hits"],
               width["preemptions"]) >= 1 and width["handoff_bytes"] > 0
    assert width["kv_read_waits"]["prefill"] == 1 and width["kv_read_waits"]["decode"] == 0
    assert width["steady_window"]["h2d_ticks"] == 0 and width["requests"] == 33
    small = out["small_trained"]
    assert small["preempt_sampled"] == small["preempt_greedy"] == "bit-equal"
    assert small["handoff"]["blocks"] == 5 and small["spill"]["spill_hits"] >= 1
