"""tpulab_torch's PagedEngine held against tpulab's on the CPU.

Both engines get the same weights (``Labformer.from_numpy`` of tpulab's
parameter tree) and the same requests.  Greedy streams must be bit
identical, and so must the counters that describe what the engine did
(ticks, tokens, admissions, prefix hits, prefill chunks, stalls, retired
blocks, host syncs and host-to-device ticks).  The models are sharpened by
training, as in ``tests/test_paged*.py``, so an argmax cannot flip under
the f32 rounding in which XLA and PyTorch differ.  After every run no block
has leaked: the free list and the cached prefix blocks make up the pool.

Sampled streams are not ``jax.random``'s: they are held to their
distribution (a chi-square bound), to their seed, and to leaving their
greedy neighbours alone; next to tpulab only their lengths are compared.
Pool contents written by the model (``paged_extend``) are held within
``rtol = atol = 1e-5`` in f32; quantization and scatters bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpulab.models import labformer as jlf
from tpulab.models import paged as jpaged

from tpulab_torch.models import labformer as tlf
from tpulab_torch.models import paged as tpaged
from tpulab_torch.models.labformer import Labformer, _to_torch

torch.set_num_threads(2)

COUNTERS = ("ticks", "tokens_out", "requests_done", "prefix_hits", "prefix_misses",
            "evictions", "admissions", "prefill_chunks", "stall_ticks", "blocks_retired",
            "host_syncs", "h2d_ticks", "blocks_free", "cache_entries", "kv_pool_bytes",
            "compile_buckets_dense", "compile_buckets_extend")


def _port_cfg(jcfg):
    return tlf.cfg_from_dict(jlf.cfg_to_dict(jcfg))


def _cycle(p):
    return (np.arange(p) % 7).astype(np.int32)


def _sharpened(cfg, steps, seed=0):
    params, opt, step = jlf.init_train_state(cfg, None, seed=seed)
    tok = np.tile(np.arange(33, dtype=np.int32) % 7, (8, 1))
    for _ in range(steps):
        params, opt, _ = step(params, opt, tok)
    return jax.device_get(params)


@pytest.fixture(scope="module")
def models(trained_small, trained_small_cfg):
    """name -> (tpulab params, tpulab cfg, the port's CPU model)."""
    gqa_cfg = jlf.LabformerConfig(d_model=64, n_heads=8, n_kv_heads=4, n_layers=2, d_ff=128,
                                  max_seq=64)
    win_cfg = dataclasses.replace(trained_small_cfg, attn_window=6)
    out = {}
    for name, params, cfg in (("small", trained_small, trained_small_cfg),
                              ("gqa", _sharpened(gqa_cfg, 40), gqa_cfg),
                              ("window", _sharpened(win_cfg, 20), win_cfg)):
        out[name] = (params, cfg, Labformer.from_numpy(params, _port_cfg(cfg), "cpu"))
    return out


SYS = (np.arange(16) % 7).astype(np.int32)  # 2 full blocks at BS=8


def _jobs_matrix():
    return [
        dict(prompt=np.concatenate([SYS, [1, 2]]).astype(np.int32), max_new=10),  # miss
        dict(prompt=np.concatenate([SYS, [3]]).astype(np.int32), max_new=8),      # hit
        dict(prompt=_cycle(40), max_new=8),                                       # chunks
        dict(prompt=_cycle(5), max_new=10, temperature=1.5, seed=3),              # sampled
        dict(prompt=_cycle(4), max_new=10, stop_byte=4),                          # stop
        dict(prompt=_cycle(6), max_new=8, repetition_penalty=4.0),                # penalty
        dict(prompt=_cycle(3), max_new=6),
        dict(prompt=np.concatenate([SYS, [5]]).astype(np.int32), max_new=4),    # later hit
    ]


def _waves():
    return [dict(prompt=_cycle(p), max_new=n)
            for p, n in [(3, 6), (5, 9), (9, 4), (2, 7), (12, 5)]]


def _submit(eng, job):
    return eng.submit(job["prompt"], max_new=job["max_new"],
                      temperature=job.get("temperature", 0.0), seed=job.get("seed", 0),
                      repetition_penalty=job.get("repetition_penalty", 1.0),
                      stop_byte=job.get("stop_byte", -1))


def _drive(eng, plan):
    """Run ``plan`` (("submit", job) | ("step", n) | ("cancel", i)) then
    ``run()``; (outputs by job index, None for a request dropped while
    pending; stats)."""
    rids, out = [], {}
    for op, arg in plan:
        if op == "submit":
            rids.append(_submit(eng, arg))
        elif op == "step":
            for _ in range(arg):
                eng.step()
        else:
            eng.cancel(rids[arg])
    out.update(eng.run())
    return [out.get(r) for r in rids], eng.stats()


def _no_leak(eng):
    cached = {b for blocks in eng.prefix_cache.values() for b in blocks}
    assert len(eng.free) + len(cached) == eng.n_usable_blocks
    assert sorted(set(eng.free)) == sorted(eng.free) and not cached & set(eng.free)
    assert int(eng.block_refs.sum()) == sum(len(b) for b in eng.prefix_cache.values())
    assert np.all(eng.tables == tpaged.TRASH) and eng.inflight_depth == 0


def _compare(models, name, plan, attn="gather", **kw):
    params, jcfg, model = models[name]
    jeng = jpaged.PagedEngine(params, jcfg, attn=attn, obs=False, **kw)
    teng = tpaged.PagedEngine(model, model.cfg, attn=attn, **kw)
    want, jst = _drive(jeng, plan)
    got, tst = _drive(teng, plan)
    jobs = [arg for op, arg in plan if op == "submit"]
    for i, (job, a, b) in enumerate(zip(jobs, got, want)):
        if b is None:
            assert a is None, (i, a)
        elif job.get("temperature", 0.0) > 0:
            assert len(a) == len(b), (i, a, b)
        else:
            assert a.dtype == np.int32 and np.array_equal(a, b), (i, a, b)
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    _no_leak(teng)
    return got, tst


G = dict(slots=3, n_blocks=48, block_size=8, max_seq=64)


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_waves_of_plain_admissions(models, attn):
    """More requests than slots, dense cache-miss prefills, blocks recycled."""
    _, st = _compare(models, "small", [("submit", j) for j in _waves()], attn, **G)
    assert st["requests_done"] == st["admissions"] == 5


@pytest.mark.parametrize("attn,chunk,interleave,overlap",
                         [("gather", 16, True, 1), ("gather", 16, False, 1),
                          ("gather", 0, True, 1), ("gather", 0, False, 1),
                          ("pallas", 16, True, 1), ("pallas", 0, False, 0),
                          ("gather", 16, True, 0)])
def test_admission_matrix(models, attn, chunk, interleave, overlap):
    """Prefix miss and hit, a multi-chunk prompt, a sampled slot, a stop
    byte and a penalized slot under every admission mode."""
    _, st = _compare(models, "small", [("submit", j) for j in _jobs_matrix()], attn,
                     prefill_chunk=chunk, interleave=interleave, overlap=overlap, **G)
    assert st["prefix_hits"] >= 1 and st["requests_done"] == 8
    if interleave:
        assert st["stall_ticks"] == 0


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_int8_kv(models, attn):
    shared = (np.arange(16) % 7).astype(np.int32)
    plan = [("submit", dict(prompt=np.concatenate([shared, _cycle(4)]), max_new=6)),
            ("step", 4),
            ("submit", dict(prompt=np.concatenate([shared, [3, 3, 3]]).astype(np.int32),
                            max_new=6)),
            ("submit", dict(prompt=_cycle(9), max_new=5))]
    _, st = _compare(models, "small", plan, attn, kv_dtype="int8", prefill_chunk=8, **G)
    assert st["prefix_hits"] >= 1


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_sliding_window_retires_blocks(models, attn):
    """Blocks behind the window free mid-decode; a later request with the
    same prompt still hits the cached prefix."""
    shared = (np.arange(16) % 7).astype(np.int32)
    plan = [("submit", dict(prompt=_cycle(10), max_new=40)),
            ("submit", dict(prompt=shared, max_new=24)),
            ("submit", dict(prompt=shared, max_new=24))]
    _, st = _compare(models, "window", plan, attn, slots=1, n_blocks=32, block_size=8,
                     max_seq=128)
    assert st["blocks_retired"] > 0 and st["prefix_hits"] >= 1


@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_gqa_model(models, attn):
    plan = [("submit", dict(prompt=p, max_new=6)) for p in
            (_cycle(5), _cycle(9), np.full(3, 2, np.int32))]
    _compare(models, "gqa", plan, attn, slots=2, n_blocks=16, block_size=8, max_seq=64)


def test_pool_capacity_gates_admission(models):
    """Three usable blocks, two requests of two blocks: served one at a time."""
    plan = [("submit", dict(prompt=_cycle(6), max_new=8))] * 2
    got, st = _compare(models, "small", plan, slots=2, n_blocks=4, block_size=8, max_seq=32)
    assert np.array_equal(got[0], got[1])


def test_prefix_eviction_under_pool_pressure(models):
    """A finished request's cached prefix is evicted (LRU) to admit a
    request that needs its blocks."""
    plan = [("submit", dict(prompt=_cycle(17), max_new=4)),
            ("submit", dict(prompt=np.full(20, 3, np.int32), max_new=8)),
            ("submit", dict(prompt=_cycle(17), max_new=4))]
    _, st = _compare(models, "small", plan, slots=1, n_blocks=6, block_size=8, max_seq=32)
    assert st["evictions"] >= 1


def test_single_token_prompt(models):
    _compare(models, "small", [("submit", dict(prompt=_cycle(1), max_new=4))], "pallas",
             slots=1, n_blocks=8, block_size=8, max_seq=32)


@pytest.mark.parametrize("interleave", [True, False])
def test_cancels(models, interleave):
    """A request cancelled mid-prefill (interleaved) emits nothing and returns its blocks;
    one cancelled mid-decode ends at the next tick; a pending one is
    dropped; the neighbours' streams are untouched."""
    plan = [("submit", dict(prompt=_cycle(5), max_new=20)), ("step", 3),
            ("submit", dict(prompt=_cycle(80), max_new=8)), ("step", 3), ("cancel", 1),
            ("submit", dict(prompt=_cycle(7), max_new=12)), ("step", 4), ("cancel", 2),
            ("submit", dict(prompt=_cycle(4), max_new=3)),
            ("submit", dict(prompt=_cycle(6), max_new=3)), ("cancel", 4)]
    got, st = _compare(models, "small", plan, "pallas", slots=2, n_blocks=32, block_size=8,
                       max_seq=128, prefill_chunk=8, interleave=interleave)
    # without interleave the long prompt prefilled at admission: cancelled mid-decode
    assert len(got[1]) == 0 if interleave else 0 < len(got[1]) < 8
    assert 0 < len(got[2]) < 12 and got[4] is None


def test_oversized_request_and_bad_knobs_rejected(models):
    _, _, model = models["small"]
    eng = tpaged.PagedEngine(model, model.cfg, slots=1, n_blocks=4, block_size=8, max_seq=32)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(_cycle(20), max_new=20)
    for kw, match in ((dict(temperature=-1.0), "temperature"),
                      (dict(repetition_penalty=0.0), "repetition_penalty"),
                      (dict(stop_byte=256), "stop_byte"), (dict(max_new=0), "max_new")):
        with pytest.raises(ValueError, match=match):
            eng.submit(_cycle(3), **{"max_new": 2, **kw})
    for kw in (dict(attn="wat"), dict(kv_dtype="fp4"), dict(overlap=2),
               dict(max_seq=30), dict(prefill_chunk=-1)):
        with pytest.raises(ValueError):
            tpaged.PagedEngine(model, model.cfg, **{**dict(slots=1, n_blocks=4, block_size=8,
                                                           max_seq=32), **kw})
    full = tpaged.PagedEngine(model, model.cfg, slots=1, n_blocks=8, block_size=8,
                              max_seq=32, max_pending=1)
    full.submit(_cycle(3), max_new=2)
    with pytest.raises(tpaged.QueueFullError):
        full.submit(_cycle(3), max_new=2)


@pytest.mark.parametrize("what,item", [
    pytest.param(dict(mesh=object()), "A12", id="what4-A12"),
    pytest.param(dict(obs=True), "A11", id="what5-A11"),
    ("rid", "A11"), ("publish_metrics", "A11")])
def test_unported_knobs_refused(models, what, item):
    _, _, model = models["small"]
    geo = dict(slots=1, n_blocks=8, block_size=8, max_seq=32)
    with pytest.raises(NotImplementedError, match=item):
        if isinstance(what, dict):
            tpaged.PagedEngine(model, model.cfg, **geo, **what)
        eng = tpaged.PagedEngine(model, model.cfg, **geo)
        calls = {
            "rid": lambda: eng.submit(_cycle(3), max_new=2, rid=7),
            "publish_metrics": eng.publish_metrics,
        }
        calls[what]()


# ------------------------------------------------------------ the programs


@pytest.mark.parametrize("shape", [(5, 4, 16), (2, 3, 2, 64), (7, 8)])
def test_kv_quant_and_pool_write_bit_equal(shape):
    """Against tpulab's jitted quantize-on-write, the form every engine
    program runs (XLA turns ``amax / 127.0`` into ``amax * f32(1/127)``)."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3
    x[0] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, js = jax.jit(jpaged._kv_quant)(jnp.asarray(x))
    tq, ts = tpaged._kv_quant(torch.from_numpy(x))
    assert torch.equal(tq, _to_torch(np.asarray(jq)))
    assert torch.equal(ts.view(torch.int32), _to_torch(np.asarray(js)).view(torch.int32))
    P, rows = 6, x.reshape(-1, x.shape[-1])[:4]
    jpool = (jnp.zeros((P, 2, rows.shape[-1]), jnp.int8), jnp.zeros((P, 2), jnp.float32))
    idx = (np.array([1, 4, 2, 5]), np.array([0, 1, 1, 0]))
    jd, jsc = jax.jit(jpaged._pool_write)(jpool, (jnp.asarray(idx[0]), jnp.asarray(idx[1])),
                                 jnp.asarray(rows))
    tpool = (torch.zeros((P, 2, rows.shape[-1]), dtype=torch.int8),
             torch.zeros((P, 2), dtype=torch.float32))
    tpaged._pool_write(tpool, tuple(torch.from_numpy(i) for i in idx), torch.from_numpy(rows))
    assert torch.equal(tpool[0], _to_torch(np.asarray(jd)))
    assert torch.equal(tpool[1], _to_torch(np.asarray(jsc)))


def test_init_pools_default_device_is_the_card(models, monkeypatch):
    """Like every entry point, init_pools puts its pools on the card unless
    asked for the CPU, and raises where no card is visible."""
    cfg = models["small"][2].cfg
    kp, vp = tpaged.init_pools(cfg, 4, 8, device="cpu")
    assert kp.device.type == vp.device.type == "cpu"
    assert kp.shape == (cfg.n_layers, 4, 8, cfg.kv_heads, cfg.head_dim)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpaged.init_pools(cfg, 4, 8)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_scatter_prefill_bit_equal(models, kv_dtype):
    _, jcfg, model = models["small"]
    L, bucket, bs = jcfg.n_layers, 32, 8
    rng = np.random.default_rng(1)
    k = rng.standard_normal((L, bucket, jcfg.kv_heads, jcfg.head_dim)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    row = np.array([3, 7, 1, 9, 0, 0, 0, 0], np.int32)
    jk, jv = jpaged.init_pools(jcfg, 12, bs, kv_dtype)
    jk, jv = jpaged._scatter_prefill(jk, jv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(row),
                                     8, 27, bucket, bs)
    tk, tv = tpaged.init_pools(model.cfg, 12, bs, kv_dtype, device="cpu")
    tpaged._scatter_prefill(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(row), 8, 27, bucket, bs)
    for jp, tp in ((jk, tk), (jv, tv)):
        for a, b in zip(jax.tree_util.tree_leaves(jp), tp if kv_dtype == "int8" else [tp]):
            # TRASH (block 0) holds whichever padding row landed last
            assert torch.equal(b[:, 1:], _to_torch(np.asarray(a))[:, 1:])


@pytest.mark.parametrize("case", ["prefix_hit", "chunk"])
def test_paged_extend_pools_match(models, case):
    """Pool contents after paged_extend: a tail over a shared prefix, and a
    middle chunk that leaves padding rows to TRASH."""
    params, jcfg, model = models["small"]
    bs = 8
    prompt = _cycle(30)
    row = np.array([5, 2, 8, 6, 0, 0, 0, 0], np.int32)
    start, n, bucket = (16, 13, 16) if case == "prefix_hit" else (8, 8, 16)
    jk, jv = jpaged.init_pools(jcfg, 12, bs)
    tk, tv = tpaged.init_pools(model.cfg, 12, bs, device="cpu")
    # the earlier positions first, as admission leaves them
    jk, jv = jpaged.paged_extend(params, jnp.asarray(prompt[None, :16]), jk, jv,
                                 jnp.asarray(row), 0, start, jcfg, bs, 16)
    tpaged.paged_extend(model, torch.from_numpy(prompt[None, :16]).long(), tk, tv,
                        torch.from_numpy(row), 0, start, model.cfg, bs, 16)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt[start:start + n]
    jk, jv = jpaged.paged_extend(params, jnp.asarray(padded), jk, jv, jnp.asarray(row),
                                 start, n, jcfg, bs, bucket)
    tpaged.paged_extend(model, torch.from_numpy(padded).long(), tk, tv,
                        torch.from_numpy(row), start, n, model.cfg, bs, bucket)
    for a, b in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(b[:, 1:].numpy(), np.asarray(a)[:, 1:], rtol=1e-5,
                                   atol=1e-5)
    assert float(tk[:, row[:4]].abs().sum()) > 0


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("attn", ["gather", "pallas"])
def test_decode_step_logits_match(models, kv_dtype, attn):
    """Standalone decode steps over warmed pools: logits within 1e-4."""
    params, jcfg, model = models["gqa"]
    rng = np.random.default_rng(0)
    tables = rng.choice(np.arange(1, 9), (2, 4), replace=False).reshape(2, 4).astype(np.int32)
    lengths = np.array([5, 11], np.int32)
    toks = np.array([3, 4], np.int32)
    jk, jv = jpaged.init_pools(jcfg, 16, 8, kv_dtype)
    tk, tv = tpaged.init_pools(model.cfg, 16, 8, kv_dtype, device="cpu")
    for i in range(3):
        jl, jk, jv = jpaged.paged_decode_step(params, jnp.asarray(toks + i), jk, jv,
                                              jnp.asarray(tables), jnp.asarray(lengths + i),
                                              jcfg, 8, attn)
        tl, _, _ = tpaged.paged_decode_step(model, torch.from_numpy(toks + i).long(), tk, tv,
                                            torch.from_numpy(tables),
                                            torch.from_numpy(lengths + i), model.cfg, 8, attn)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_rope_at_matches_tpulab():
    x = np.random.default_rng(2).standard_normal((3, 2, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1], [7, 8], [130, 131]], np.int32)
    want = np.asarray(jpaged._rope_at(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tpaged._rope_at(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ sampled slots


def test_sampler_fits_the_softmax():
    """20000 draws of one slot's stream (its draw counter 0..19999) against
    softmax(logits / T); the bound is the chi-square quantile at 1 - 1e-6
    (Wilson-Hilferty), so a right sampler fails it once in a million."""
    n, vocab, temp = 20000, 12, 0.8
    row = torch.from_numpy(np.random.default_rng(5).standard_normal(vocab).astype(np.float32))
    logits = row.expand(n, vocab).contiguous()
    seeds = torch.full((n,), 7, dtype=torch.int64)
    draws = torch.arange(n, dtype=torch.int64)
    toks = tpaged._sample_core(logits, torch.full((n,), temp), seeds, draws, torch.ones(n),
                               torch.zeros(n, vocab, dtype=torch.bool))
    probs = torch.softmax(row / temp, -1).numpy()
    counts = np.bincount(toks.numpy(), minlength=vocab)
    expected = n * probs
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    dof = vocab - 1
    z = 4.753  # standard normal quantile at 1 - 1e-6
    bound = dof * (1 - 2 / (9 * dof) + z * np.sqrt(2 / (9 * dof))) ** 3
    assert chi2 < bound, (chi2, bound)
    # seeds are independent streams: draw 0 of 20000 seeds fits as well
    toks2 = tpaged._sample_core(logits, torch.full((n,), temp), torch.arange(n) * 7919,
                                torch.zeros(n, dtype=torch.int64), torch.ones(n),
                                torch.zeros(n, vocab, dtype=torch.bool))
    counts2 = np.bincount(toks2.numpy(), minlength=vocab)
    assert float(((counts2 - expected) ** 2 / expected).sum()) < bound


def test_sampled_streams_are_seeded_and_leave_greedy_alone(models):
    params, jcfg, model = models["small"]

    def run(seed):
        eng = tpaged.PagedEngine(model, model.cfg, **G)
        g = eng.submit(_cycle(5), max_new=8)
        s = eng.submit(_cycle(4), max_new=12, temperature=1.5, seed=seed)
        out = eng.run()
        return out[g], out[s]

    (g1, a), (g2, b), (_, c) = run(7), run(7), run(8)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    want = jpaged.PagedEngine(params, jcfg, obs=False, **G)
    rid = want.submit(_cycle(5), max_new=8)
    assert np.array_equal(g1, want.run()[rid]) and np.array_equal(g1, g2)


def test_engine_state_lives_on_the_model_device(models):
    _, _, model = models["small"]
    eng = tpaged.PagedEngine(model, model.cfg, slots=1, n_blocks=8, block_size=8, max_seq=32)
    assert eng.device.type == "cpu" and eng.kpool.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in eng._dev.values())
    assert eng.kpool.shape == (2, 8, 8, model.cfg.kv_heads, model.cfg.head_dim)


@pytest.mark.parametrize("overlap", [0, 1])
def test_steady_state_ticks_upload_nothing(models, overlap):
    """Once every slot decodes, a tick moves no host data to the device (no
    upload at all) and h2d_ticks stays flat while ticks climb."""
    _, _, model = models["small"]
    eng = tpaged.PagedEngine(model, model.cfg, overlap=overlap, attn="pallas", **G)
    for p in (5, 9, 12):
        eng.submit(_cycle(p), max_new=20)
    for _ in range(3):
        eng.step()
    uploads = []
    real = eng._upload
    eng._upload = lambda arr: uploads.append(arr) or real(arr)
    st0 = eng.stats()
    for _ in range(8):
        eng.step()
    st = eng.stats()
    assert uploads == [] and st["h2d_ticks"] == st0["h2d_ticks"]
    assert st["ticks"] == st0["ticks"] + 8 and st["host_syncs"] == st0["host_syncs"]
