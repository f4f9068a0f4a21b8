"""The port's tp-sharded ``PagedEngine`` (``mesh=``) over 2 and 4 gloo ranks
on the CPU, held against ``tpulab``'s engine on its CPU mesh of the same
shape (the conftest's 8 devices), against the port's ``mesh=None`` engine
and against its mesh of one, on ``trained_small`` and ``tpulab``'s mixed
workload (``tests/test_mesh_serving.py``).  Shapes: ``serving_mesh(1, 2)``,
``(2, 1)``, ``(2, 2)`` and the legacy ``{"tp": 2}``.

Each world size is one :func:`~tpulab_torch.parallel.mesh.shared_pool`
for the module: :func:`~tpulab_torch.parallel.mesh.run_on_mesh` calls a
rank function in every rank and returns rank 0's result.  The ranks
import this module, so it imports neither JAX nor ``tpulab`` at its top:
the ``J`` fixture does.

Bars: greedy, penalized and prompt-lookup streams (with the prefix-hit
second wave) equal to all three; sampled streams equal to the port's
one-device streams of the same seed (the Gumbel noise is a function of the
seed, the draw and the vocabulary index), their lengths to ``tpulab``'s;
``stats()`` equal to one device's apart from the byte fields and
``mesh_devices``; decode-step logits within ``rtol = atol = 1e-4`` of
``tpulab``'s one-device step; spill and handoff bit-identical; every
``tpulab`` refusal with its message; the pool bytes as ``tpulab`` counts
them.
"""

import sys
import types

import numpy as np
import pytest
import torch

from tpulab_torch.kvcache.spill import HostSpillTier
from tpulab_torch.models import labformer as LF
from tpulab_torch.models import paged as P
from tpulab_torch.models.generate import local_heads
from tpulab_torch.models.sharded import Plan
from tpulab_torch.obs import compilestats as cstats
from tpulab_torch.parallel import spmd
from tpulab_torch.parallel.mesh import run_on_mesh

torch.set_num_threads(2)

SHAPES = {"1x2": {"batch": 1, "model": 2}, "2x1": {"batch": 2, "model": 1},
          "2x2": {"batch": 2, "model": 2}, "tp2": {"tp": 2}}
MESH22 = SHAPES["2x2"]
#: the stats keys a mesh changes: the physical pool bytes and the rank count
BYTE_KEYS = {"kv_pool_device_bytes", "kv_pool_bytes_per_shard", "mesh_devices"}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _cycle(p):
    return (np.arange(p) % 7).astype(np.int32)


def _mixed_workload(eng):
    """``tpulab``'s two waves (``tests/test_mesh_serving.py``): plain greedy,
    sampled, prompt-lookup speculative and penalized slots in one batch, then
    the same prompts again on prefix-cache hits; ``{wave: [stream, ...]}``."""
    prompts = [_cycle(9), _cycle(17), (np.arange(24) % 5).astype(np.int32), _cycle(12)]
    waves = {}
    for w in range(2):
        rids = [
            eng.submit(prompts[0], max_new=8),
            eng.submit(prompts[1], max_new=8, temperature=0.9, seed=3),
            eng.submit(prompts[2], max_new=10, spec="lookup", spec_k=4, spec_ngram=3),
            eng.submit(prompts[3], max_new=8, repetition_penalty=1.3),
        ]
        res = eng.run()
        waves[w] = [np.asarray(res[r]).tolist() for r in rids]
    return waves


def _engine(params, cfg, mesh, **kw):
    """The engine on ``mesh``, or on one CPU device where it is None."""
    geo = dict(slots=4, n_blocks=32, block_size=8, max_seq=72, spec_k=4)
    geo.update(kw)
    if mesh is None:
        geo["device"] = "cpu"
    return P.PagedEngine(params, cfg, mesh=mesh, **geo)


# ------------------------------------------------------------ rank functions


def rank_workload(mesh, params, cfg):
    eng = _engine(params, cfg, mesh)
    return _mixed_workload(eng), eng.stats()


def _mine(model, n: int) -> slice:
    """This batch rank's rows of ``n`` slots."""
    b = model.plan.batch
    k = n // (b.p if b is not None else 1)
    lo = (b.idx if b is not None else 0) * k
    return slice(lo, lo + k)


def rank_decode_logits(mesh, params, cfg, kv_dtype, toks, tables, lengths):
    """Three standalone decode steps over this rank's slots and heads; the
    logits of every slot."""
    model = LF.Labformer(params, cfg, plan=Plan(mesh, cfg, serving=True))
    kp, vp = P.init_pools(cfg, 16, 8, kv_dtype, model.device, local_heads(model)[1])
    mine, out = _mine(model, len(toks)), []
    for i in range(3):
        lg, _, _ = P.paged_decode_step(model, torch.from_numpy(toks[mine] + i).long(), kp, vp,
                                       torch.from_numpy(tables[mine]),
                                       torch.from_numpy(lengths[mine] + i), cfg, 8)
        out.append(spmd.gather_dim(lg, model.plan.batch, 0).numpy())
    return out


def _spin(eng, prompts, max_new=5):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = eng.run()
    return [np.asarray(res[r]).tolist() for r in rids]


def rank_spill(mesh, params, cfg, kv_dtype, spill_dtype):
    """``tpulab``'s spill round trip: a 17-token prompt, three fillers that
    churn a pool of 7 usable blocks, the first again; (streams without and
    with the tier, the armed engine's counters)."""
    a = _cycle(17)
    fillers = [(np.arange(i, i + 17) % 11).astype(np.int32) for i in (1, 2, 3)]
    outs, counters = {}, None
    for spill in (False, True):
        kw = dict(prefix_index="radix", spill_blocks=16, spill_dtype=spill_dtype) if spill \
            else {}
        eng = _engine(params, cfg, mesh, slots=2, n_blocks=8, spec_k=0, kv_dtype=kv_dtype, **kw)
        outs[spill] = [_spin(eng, [p]) for p in [a, *fillers, a]]
        counters = {k: eng.counters[k] for k in ("spill_spilled", "spill_prefetched",
                                                 "spill_hits")}
    return outs[False], outs[True], counters


def _whole_pools(cfg, kv_dtype, n_blocks: int, bs: int, seed: int):
    """Seeded whole pool contents: (K, V), each an array or a (data, scale) pair."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n_blocks, bs, cfg.kv_heads, cfg.head_dim)

    def one():
        if kv_dtype == "int8":
            return (rng.integers(-127, 128, shape).astype(np.int8),
                    rng.random(shape[:-1]).astype(np.float32) + 0.01)
        return rng.standard_normal(shape).astype(np.float32)
    return one(), one()


def _fill(eng, whole) -> None:
    """Write whole pool contents into ``eng``'s pools: this rank's kv heads."""
    tp = eng.model.plan.tp
    kvh = local_heads(eng.model)[1]
    for pool, src in zip((eng.kpool, eng.vpool), whole):
        for t, s in zip(pool if isinstance(pool, tuple) else (pool,),
                        src if isinstance(src, tuple) else (src,)):
            s = torch.from_numpy(s)
            t.copy_(s if tp is None else s.narrow(3, tp.idx * kvh, kvh))


def rank_payloads(mesh, params, cfg, kv_dtype, spill_dtype, blocks):
    """Host payloads of ``blocks`` of seeded pools (``_read_blocks``), and
    the spill tier's decoded entries and encoded bytes."""
    eng = _engine(params, cfg, mesh, slots=2, n_blocks=8, spec_k=0, kv_dtype=kv_dtype)
    _fill(eng, _whole_pools(cfg, kv_dtype, 8, 8, seed=5))
    kparts, vparts = eng._read_blocks(blocks)
    tier = HostSpillTier(16, spill_dtype)
    nbytes = [tier.put(bytes([i]), k, v) for i, (k, v) in enumerate(zip(kparts, vparts))]
    pool_dtype = (eng.kpool[0] if kv_dtype == "int8" else eng.kpool).dtype
    got = [tier.get(bytes([i]), pool_is_quantized=kv_dtype == "int8", pool_dtype=pool_dtype)
           for i in range(len(blocks))]
    return kparts, vparts, nbytes, got


def rank_handoff(mesh, params, cfg):
    """``tpulab``'s handoff between two mesh engines, against unified mesh
    serving."""
    kw = dict(slots=2, n_blocks=16, spec_k=0, prefix_index="radix", spill_blocks=16)
    prompt = _cycle(17)
    uni = _engine(params, cfg, mesh, **kw)
    rid = uni.submit(prompt, max_new=8)
    want = np.asarray(uni.run()[rid]).tolist()
    engp, engd = _engine(params, cfg, mesh, **kw), _engine(params, cfg, mesh, **kw)
    engp.handoff_at_boundary = True
    engp.submit(prompt, max_new=8)
    while not engp.handoff_ready:
        engp.step()
    (req, payload), = engp.export_handoff()
    imported = engd.import_handoff(payload)
    engd.resubmit(req, fresh_id=True)
    (got,) = engd.run().values()
    return {"want": want, "got": np.asarray(got).tolist(), "n_blocks": len(payload),
            "imported": imported, "prefetched": engd.counters["spill_prefetched"],
            "exporter_done": engp.counters["requests_done"],
            "accounted": [len(e.free) + len(set(e._radix.blocks())) == e.n_usable_blocks
                          for e in (engp, engd)]}


def _no_upload(*_):
    raise AssertionError("host->device upload in steady-state decode")


def rank_steady(mesh, params, cfg):
    """A steady window of 8 ticks after 4: no upload (the engine's upload
    paths raise), no sync, no build (under ``compilestats.strict()``)."""
    eng = _engine(params, cfg, mesh, slots=2, spec_k=0)
    eng.submit(_cycle(4), max_new=30)
    eng.submit(_cycle(6), max_new=30, temperature=1.5, seed=3)
    for _ in range(4):
        eng.step()
    before = eng.stats()
    upload, to_device = eng._upload, eng._to_device
    eng._upload = eng._to_device = _no_upload
    with cstats.strict():
        for _ in range(8):
            eng.step()
    eng._upload, eng._to_device = upload, to_device
    after = eng.stats()
    return before, after, eng._steady, [np.asarray(v).tolist() for v in eng.run().values()]


def _caught(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # the refusal's type and message are the result
        return type(e).__name__, str(e)
    return None, ""


def rank_refusals(mesh, params, cfg, cfg_kv1):
    """Each refusal on the mesh: (exception type, message)."""
    geo = dict(slots=2, n_blocks=8, block_size=8, max_seq=72)
    eng = P.PagedEngine(params, cfg, **geo, spec_k=4, mesh=mesh)
    whole = LF.Labformer.from_numpy(params, cfg, "cpu")
    return {
        "pallas": _caught(lambda: P.PagedEngine(params, cfg, **geo, mesh=mesh, attn="pallas")),
        "slots": _caught(lambda: P.PagedEngine(params, cfg, **{**geo, "slots": 3}, mesh=mesh)),
        "kv_heads": _caught(lambda: P.PagedEngine(params, cfg_kv1, mesh=mesh)),
        "draft": _caught(lambda: eng.set_draft(params, cfg)),
        "device": _caught(lambda: P.PagedEngine(params, cfg, **geo, mesh=mesh, device="cuda")),
        "whole_model": _caught(lambda: P.PagedEngine(whole, cfg, **geo, mesh=mesh)),
    }


def rank_bytes(mesh, params, cfg):
    """stats, shard_stats, the estimate and the published per-shard gauges."""
    from tpulab_torch.obs.registry import REGISTRY

    eng = _engine(params, cfg, mesh, slots=2, n_blocks=8, spec_k=0)
    eng.submit(_cycle(9), max_new=3)
    eng.run()
    eng.publish_metrics()
    gauges = {i: (REGISTRY.get(f"engine_hbm_bytes_in_use_shard{i}").value,
                  REGISTRY.get(f"engine_kv_pool_bytes_shard{i}").value)
              for i in eng.shard_stats()}
    state = sum(t.numel() * t.element_size() for t in eng._dev.values())
    return eng.stats(), eng.shard_stats(), eng.device_bytes_estimate(), gauges, state


def rank_helpers(mesh, params, cfg):
    """The serving helpers' answers on this mesh, and rank 0's parts."""
    from tpulab_torch.models.sharded import param_specs
    from tpulab_torch.parallel import mesh as pmesh

    specs = param_specs(cfg)
    flat = {k: v for k, v in specs.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v for k, v in specs["blocks"].items()})
    parts = pmesh.shard_serving_params(params, cfg, mesh)
    return {"model_axis": pmesh.model_axis(mesh), "batch_axis": pmesh.batch_axis(mesh),
            "sizes": [pmesh.axis_size(mesh, pmesh.model_axis(mesh)),
                      pmesh.axis_size(mesh, pmesh.batch_axis(mesh)),
                      pmesh.axis_size(None, "model")],
            "pool": pmesh.pool_spec(mesh), "scale": pmesh.pool_scale_spec(mesh),
            "slot": [pmesh.slot_spec(mesh, n) for n in (1, 2)],
            "params": {k: pmesh.serving_param_spec(v, mesh) for k, v in flat.items()},
            "parts": {**{k: v for k, v in parts.items() if k != "blocks"},
                      **{f"blocks/{k}": v for k, v in parts["blocks"].items()}}}


def rank_imports(mesh, params, cfg):
    """The JAX and ``tpulab`` modules this rank holds after serving."""
    _spin(_engine(params, cfg, mesh, slots=4, spec_k=0), [_cycle(9)])
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "tpulab"))


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module", autouse=True)
def _isolated_compile_cache():
    """``tests/test_mesh_serving.py``'s isolation for ``tpulab``'s GSPMD
    engines built here: the persistent compile cache off for the module (a
    warm cache cross-loads single-device and partitioned executables), and
    ``jax.clear_caches()`` at teardown (mesh executables hold code mappings
    for the process's life, which pushed the suite past
    ``vm.max_map_count``)."""
    import jax
    from jax._src import compilation_cache as _cc

    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    _cc.reset_cache()
    try:
        yield
    finally:
        jax.clear_caches()
        jax.config.update("jax_enable_compilation_cache", old)
        _cc.reset_cache()


@pytest.fixture(scope="module")
def J(trained_small, trained_small_cfg):
    """tpulab's side: its engine on its CPU serving mesh of a shape."""
    from tpulab.models import labformer as jlf
    from tpulab.models import paged as jpaged
    from tpulab.parallel.mesh import make_mesh, serving_mesh

    def mesh_of(axes):
        if "tp" in axes:
            return make_mesh({"tp": axes["tp"]}, backend="cpu")
        return serving_mesh(axes["batch"], axes["model"], backend="cpu")

    def engine(axes, **kw):
        geo = dict(slots=4, n_blocks=32, block_size=8, max_seq=72, spec_k=4)
        geo.update(kw)
        return jpaged.PagedEngine(trained_small, trained_small_cfg, mesh=mesh_of(axes), **geo)

    return types.SimpleNamespace(lf=jlf, paged=jpaged, mesh_of=mesh_of, engine=engine)


@pytest.fixture(scope="module")
def model(trained_small, trained_small_cfg):
    """(the whole parameter tree, the port's config of ``trained_small``)."""
    from tpulab.models import labformer as jlf

    return trained_small, LF.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))


@pytest.fixture(scope="module")
def one_device(model):
    """The port's mixed workload on one device and on a mesh of one."""
    params, cfg = model
    return {"none": rank_workload(None, params, cfg),
            "1x1": run_on_mesh(rank_workload, {"batch": 1, "model": 1}, params, cfg,
                               device_type="cpu")}


# ------------------------------------------------------------ streams


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_streams_match_tpulab_and_one_device(J, model, one_device, shape):
    params, cfg = model
    waves, stats = run_on_mesh(rank_workload, SHAPES[shape], params, cfg, device_type="cpu")
    jwaves = _mixed_workload(J.engine(SHAPES[shape]))
    one, one_stats = one_device["none"]
    mesh1, mesh1_stats = one_device["1x1"]
    assert mesh1 == one and mesh1_stats == one_stats, "the mesh of one left one device"
    for w in (0, 1):
        for i in (0, 2, 3):  # greedy, prompt lookup, penalized
            assert waves[w][i] == jwaves[w][i] == one[w][i], (shape, w, i)
        assert waves[w][1] == one[w][1], (shape, w, "sampled")
        assert len(waves[w][1]) == len(jwaves[w][1])
    assert {k for k in stats if stats[k] != one_stats[k]} <= BYTE_KEYS
    assert stats["prefix_hits"] >= 1 and stats["spec_accepted"] >= 1
    assert stats["mesh_devices"] == int(np.prod(list(SHAPES[shape].values())))


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_decode_step_logits_match(J, shape, kv_dtype):
    """Standalone decode steps of a GQA model (8 heads, 4 kv) over two
    slots, each batch rank its own, against ``tpulab``'s one-device step."""
    import jax.numpy as jnp

    jcfg = J.lf.LabformerConfig(d_model=64, n_heads=8, n_kv_heads=4, n_layers=2, d_ff=128,
                                max_seq=64)
    cfg = LF.cfg_from_dict(J.lf.cfg_to_dict(jcfg))
    params = J.lf.init_params(jcfg, seed=0)
    rng = np.random.default_rng(0)
    tables = rng.choice(np.arange(1, 9), (2, 4), replace=False).astype(np.int32)
    lengths = np.array([5, 11], np.int32)
    toks = np.array([3, 4], np.int64)
    got = run_on_mesh(rank_decode_logits, SHAPES[shape], params, cfg, kv_dtype, toks, tables,
                      lengths, device_type="cpu")
    jk, jv = J.paged.init_pools(jcfg, 16, 8, kv_dtype)
    for i in range(3):
        jl, jk, jv = J.paged.paged_decode_step(params, jnp.asarray(toks + i), jk, jv,
                                               jnp.asarray(tables), jnp.asarray(lengths + i),
                                               jcfg, 8, "gather")
        np.testing.assert_allclose(got[i], np.asarray(jl), **LOGIT_TOL)


# ------------------------------------------------------------ spill and handoff


@pytest.mark.parametrize("kv_dtype,spill_dtype,exact", [
    ("native", "native", True), ("int8", "native", True), ("int8", "int8", True),
    ("native", "int8", False), ("native", "int4", False)])
def test_spill_round_trip_on_the_mesh(model, kv_dtype, spill_dtype, exact):
    """Evict to the host tier through ``_read_blocks`` (kv heads gathered
    over the model axis), restore through ``_write_blocks`` (each rank its
    heads): bit-identical to the tier-less mesh engine where the host
    format is lossless for the pool, served to length where it is not
    (int8 host payloads of f32 pools, int4)."""
    params, cfg = model
    ref, got, counters = run_on_mesh(rank_spill, MESH22, params, cfg, kv_dtype, spill_dtype,
                                     device_type="cpu")
    assert counters["spill_spilled"] >= 1 and counters["spill_prefetched"] >= 1
    assert counters["spill_hits"] >= 1
    if exact:
        assert got == ref
    else:
        assert [len(s[0]) for s in got] == [5] * len(ref)


@pytest.mark.parametrize("kv_dtype,spill_dtype", [
    ("native", "native"), ("native", "int8"), ("native", "int4"), ("int8", "native"),
    ("int8", "int8")])
def test_host_payloads_byte_equal_one_device(model, kv_dtype, spill_dtype):
    """The same pool contents on the mesh (each rank its heads) and on one
    device read back to the same host bytes, and encode and decode to the
    same spill entries."""
    params, cfg = model
    blocks = [3, 1, 6]
    got = run_on_mesh(rank_payloads, MESH22, params, cfg, kv_dtype, spill_dtype, blocks,
                      device_type="cpu")
    want = rank_payloads(None, params, cfg, kv_dtype, spill_dtype, blocks)

    def flat(x):
        if isinstance(x, (tuple, list)):
            return [y for z in x for y in flat(z)]
        return [x]

    for g, w in zip(flat(got[:2]) + flat(got[3]), flat(want[:2]) + flat(want[3])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[2] == want[2]
    whole = got[0][0] if kv_dtype == "native" else got[0][0][0]
    assert whole.shape[2] == cfg.kv_heads  # (L, BS, kv, d): every head


def test_handoff_between_mesh_engines_bit_identical(model):
    params, cfg = model
    out = run_on_mesh(rank_handoff, MESH22, params, cfg, device_type="cpu")
    one = rank_handoff(None, params, cfg)
    assert out["got"] == out["want"] == one["want"]
    assert out["n_blocks"] == 2 and out["imported"] == one["imported"] > 0
    assert out["prefetched"] >= 1 and out["exporter_done"] == 0
    assert all(out["accounted"])


# ------------------------------------------------------------ steady ticks


def test_steady_ticks_upload_and_build_nothing(model):
    params, cfg = model
    before, after, steady, streams = run_on_mesh(rank_steady, MESH22, params, cfg,
                                                 device_type="cpu")
    assert steady
    assert after["ticks"] == before["ticks"] + 8
    assert after["h2d_ticks"] == before["h2d_ticks"], "steady tick uploaded"
    assert after["host_syncs"] == before["host_syncs"], "steady tick synced"
    assert after["recompiles"] == before["recompiles"] == 0
    one = rank_steady(None, params, cfg)
    assert streams[0] == one[3][0]  # the greedy stream, as one device's


# ------------------------------------------------------------ refusals


def test_refusals_carry_tpulabs_messages(J, model, trained_small, trained_small_cfg):
    """``tpulab``'s refusals on a (2, 2) mesh, with its exception types and
    messages; and the port's own: a card device on a CPU mesh, and a
    whole-device model on four ranks (never a silent move)."""
    import dataclasses

    params, cfg = model
    cfg_kv1 = dataclasses.replace(cfg, n_kv_heads=1)
    got = run_on_mesh(rank_refusals, MESH22, params, cfg, cfg_kv1, device_type="cpu")
    mesh = J.mesh_of(MESH22)
    geo = dict(slots=2, n_blocks=8, block_size=8, max_seq=72)
    jcfg_kv1 = dataclasses.replace(trained_small_cfg, n_kv_heads=1)
    jeng = J.paged.PagedEngine(trained_small, trained_small_cfg, **geo, spec_k=4, mesh=mesh)
    want = {
        "pallas": _caught(lambda: J.paged.PagedEngine(trained_small, trained_small_cfg, **geo,
                                                      mesh=mesh, attn="pallas")),
        "slots": _caught(lambda: J.paged.PagedEngine(trained_small, trained_small_cfg,
                                                     **{**geo, "slots": 3}, mesh=mesh)),
        "kv_heads": _caught(lambda: J.paged.PagedEngine(trained_small, jcfg_kv1, mesh=mesh)),
        "draft": _caught(lambda: jeng.set_draft(trained_small, trained_small_cfg)),
    }
    for k, w in want.items():
        assert w[0] == "EngineConfigError" and got[k] == w, (k, got[k], w)
    assert got["device"][0] == "ValueError" and "cuda" in got["device"][1]
    assert got["whole_model"][0] == "ValueError" and "4 ranks" in got["whole_model"][1]


# ------------------------------------------------------------ bytes


@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2"])
def test_byte_accounting_follows_tpulab(J, model, shape):
    """``kv_pool_*``, ``mesh_devices`` and each shard's pool bytes equal
    ``tpulab``'s on the same shape, and the published gauges equal
    ``shard_stats``.  A shard's ``hbm_bytes_in_use`` differs from
    ``tpulab``'s by two stated terms: the embedding, which the port keeps
    whole on every rank where ``tpulab`` splits its ``d_model`` over the
    model axis (``Plan.spec``), and the per-slot state, whose ``last_tok``,
    seeds and draws are int64 in the port where ``tpulab`` holds int32
    tokens and two uint32 key words (12 bytes a slot)."""
    params, cfg = model
    stats, shards, est, gauges, state = run_on_mesh(rank_bytes, SHAPES[shape], params, cfg,
                                                    device_type="cpu")
    jeng = J.engine(SHAPES[shape], slots=2, n_blocks=8, spec_k=0)
    jstats, jshards = jeng.stats(), jeng.shard_stats()
    for k in ("kv_pool_bytes", "kv_pool_device_bytes", "kv_pool_bytes_per_shard",
              "mesh_devices"):
        assert stats[k] == jstats[k], k
    assert set(shards) == set(jshards) == set(range(stats["mesh_devices"]))
    m, b = SHAPES[shape]["model"], SHAPES[shape]["batch"]
    embed = cfg.vocab * cfg.d_model * 4
    for i in shards:
        assert shards[i]["kv_pool_bytes"] == jshards[i]["kv_pool_bytes"]
        assert gauges[i] == (shards[i]["hbm_bytes_in_use"], shards[i]["kv_pool_bytes"])
        extra = embed - embed // m + 12 * (2 // b)
        assert shards[i]["hbm_bytes_in_use"] - jshards[i]["hbm_bytes_in_use"] == extra, i
    assert est == sum(s["hbm_bytes_in_use"] for s in shards.values())


@pytest.mark.parametrize("shape", ["2x2", "tp2"])
def test_serving_helpers_match_tpulab(J, model, trained_small, trained_small_cfg, shape):
    """``model_axis``, ``batch_axis``, ``axis_size``, the pool, scale, slot
    and parameter specs as ``tpulab``'s ``PartitionSpec`` entries, and rank
    0's parts of ``shard_serving_params`` equal to ``tpulab``'s first
    shard of each leaf, but the embedding, which the port keeps whole
    (``sharded.Plan.spec``)."""
    from tpulab.parallel import mesh as jmesh

    params, cfg = model
    got = run_on_mesh(rank_helpers, SHAPES[shape], params, cfg, device_type="cpu")
    mesh = J.mesh_of(SHAPES[shape])
    assert got["model_axis"] == jmesh.model_axis(mesh)
    assert got["batch_axis"] == jmesh.batch_axis(mesh)
    assert got["sizes"] == [jmesh.axis_size(mesh, jmesh.model_axis(mesh)),
                            jmesh.axis_size(mesh, jmesh.batch_axis(mesh)), 1]
    assert got["pool"] == tuple(jmesh.pool_spec(mesh))
    assert got["scale"] == tuple(jmesh.pool_scale_spec(mesh))
    assert got["slot"] == [tuple(jmesh.slot_spec(mesh, n)) for n in (1, 2)]
    jspecs = J.lf.param_specs(trained_small_cfg)
    jflat = {k: v for k, v in jspecs.items() if k != "blocks"}
    jflat.update({f"blocks/{k}": v for k, v in jspecs["blocks"].items()})
    assert got["params"] == {k: tuple(jmesh.serving_param_spec(v, mesh))
                             for k, v in jflat.items()}
    sharded = jmesh.shard_serving_params(trained_small, trained_small_cfg, mesh)
    jparts = {k: v for k, v in sharded.items() if k != "blocks"}
    jparts.update({f"blocks/{k}": v for k, v in sharded["blocks"].items()})
    for k, part in got["parts"].items():
        want = np.asarray(trained_small[k] if k == "embed" else
                          jparts[k].addressable_shards[0].data)
        assert part.numpy().tobytes() == want.tobytes(), k


def test_ranks_import_no_jax(model):
    params, cfg = model
    assert run_on_mesh(rank_imports, MESH22, params, cfg, device_type="cpu") == []


# ------------------------------------------------------------ bench and phase 16


def test_mesh_tick_overhead_row_on_the_cpu(monkeypatch):
    """The bench row with two ranks (a (1, 2) mesh, windows in turns
    across the pool and this process) and with one (both sides on one mesh
    of one, stepped in turns), as on the one-card machine."""
    from tpulab_torch import bench
    from tpulab_torch.parallel import mesh as pmesh

    for n, shape in ((2, "1x2"), (1, "1x1")):
        monkeypatch.setattr(pmesh, "device_type_count", lambda kind, n=n: n)
        row = bench.bench_mesh_tick_overhead(slots=2, steps=4, reps=1, backend="cpu")
        assert row["metric"] == f"mesh_tick_{n}dev_ticks_per_s" and row["unit"] == "ticks/s"
        assert row["mesh"] == shape and row["n_devices"] == n and row["value"] > 0
        assert row["ref_1x1_ticks_per_s"] > 0 and row["mesh_over_1x1"] > 0


def test_chip_smoke_phase16_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 16 at a tiny size on the CPU (B4 and B7's plain
    versions, which count no launch): 16a's mesh of one bit-equal to
    mesh=None, 16b's spill round trip, 16c's refusal, 16d's row on one rank."""
    import chip_smoke
    from tpulab_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "device_type_count", lambda kind: 1)
    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(paged=dict(d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
                           max_seq=128),
                paged_slots=4, paged_blocks=32, paged_bs=8, paged_max_seq=64,
                paged_prompts=(5, 9, 3, 12), paged_new=6,
                mesh_bench=dict(slots=2, steps=4, reps=1))
    out = chip_smoke.run_mesh_serving(tiny, torch.device("cpu"), "cpu", "cpu")
    assert out["a"]["streams_equal"] and out["a"]["ticks"] > 0
    assert out["b"]["spill_prefetched"] >= 1
    assert out["c"] == "attn='pallas' does not support mesh serving"
    assert out["d"]["mesh"] == "1x1" and out["d"]["value"] > 0
