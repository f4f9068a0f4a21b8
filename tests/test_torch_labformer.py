"""tpulab_torch's labformer held against tpulab's on the CPU.

Parameters come from the same seed through both packages' ``init_params``
(bit-equal, checked here) and tokens from numpy.  Tolerances:

* float32 logits: rtol = atol = 1e-4.  XLA and PyTorch order the sums of
  their matmuls differently and XLA:CPU contracts multiply-adds, so the
  two drift by f32 roundings through every layer.
* bfloat16 logits: compared in float32 within atol = rtol = 2**-6, about
  four bf16 ulps at the logits' magnitude (~0.45).  Both packages round
  each op to bf16, but at different places (XLA may keep an elementwise
  chain in f32; PyTorch rounds after each op), and such roundings compound
  through two layers and the tied head (measured: two ulps at most).
* scalars (loss, router aux): rtol 1e-5.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpulab.models import labformer as jlf

from tpulab_torch.models import labformer as tlf
from tpulab_torch.models.labformer import Labformer
from tpulab_torch.ops.cuda.attention import flash_attention_with_lse

torch.set_num_threads(2)

BASE = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=128)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)

CONFIGS = {
    "dense": dict(attn_impl="dense"),
    "flash": dict(attn_impl="flash"),
    "auto": dict(attn_impl="auto"),
    "gqa": dict(n_kv_heads=2, attn_impl="flash"),
    "gqa_dense": dict(n_kv_heads=2, attn_impl="dense"),
    "window": dict(attn_window=8, attn_impl="flash"),
    "window_dense": dict(attn_window=8, attn_impl="dense"),
    "moe_k1": dict(n_experts=4, moe_top_k=1),
    "moe_k2": dict(n_experts=4, moe_top_k=2, attn_impl="flash"),
}


def _cfgs(dtype="float32", **kw):
    jcfg = jlf.LabformerConfig(**BASE, **kw, dtype=getattr(jnp, dtype))
    tcfg = tlf.LabformerConfig(**BASE, **kw, dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _tokens(seed, b=2, s=24):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _bits(a):
    """The bytes of a leaf as unsigned ints (numpy bf16 or torch)."""
    if isinstance(a, torch.Tensor):
        a = a.view({4: torch.int32, 2: torch.int16}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, dict(n_kv_heads=2), dict(n_experts=4),
                                dict(lora_rank=4)], ids=["mha", "gqa", "moe", "lora"])
def test_init_params_bit_equal(dtype, kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    want, got = jlf.init_params(jcfg, seed=3), tlf.init_params(tcfg, seed=3)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))


@pytest.mark.parametrize("kw", [{}, dict(n_experts=4, moe_top_k=2, lora_rank=2,
                                         attn_window=16, dtype="bfloat16")])
def test_cfg_json_equals_tpulab(kw):
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    jcfg, tcfg = _cfgs(dtype, **kw)
    want = json.dumps(jlf.cfg_to_dict(jcfg), sort_keys=True)
    assert json.dumps(tlf.cfg_to_dict(tcfg), sort_keys=True) == want
    assert tlf.cfg_from_dict(json.loads(want)) == tcfg
    with pytest.raises(ValueError):
        tlf.cfg_from_dict({**json.loads(want), "future_field": 1})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, dict(n_experts=4, lora_rank=2)], ids=["dense", "moe_lora"])
def test_bridge_round_trip_is_exact(dtype, kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    params = jlf.init_params(jcfg, seed=5)
    model = Labformer.from_numpy(params, tcfg, "cpu")
    assert len(model.blocks) == tcfg.n_layers
    assert all(not p.requires_grad for p in model.parameters())
    back = model.to_numpy()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for (path, w), (_, g) in zip(_leaves(params), _leaves(back)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))


def _lora_params(jcfg, seed):
    """Params with non-zero adapter B (init makes it zero)."""
    params = jlf.init_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for name in ("wq_lora_b", "wv_lora_b"):
        leaf = params["blocks"][name]
        params["blocks"][name] = np.asarray(rng.standard_normal(leaf.shape) * 0.1, leaf.dtype)
    return params


def _both(name, dtype="float32"):
    jcfg, tcfg = _cfgs(dtype, **CONFIGS[name])
    params = jlf.init_params(jcfg, seed=11)
    return jcfg, tcfg, params, Labformer.from_numpy(params, tcfg, "cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_tpulab(name):
    jcfg, tcfg, params, model = _both(name)
    tokens = _tokens(1)
    before = flash_attention_with_lse.launches
    want_logits, want_aux = jlf.forward_with_aux(params, jnp.asarray(tokens), jcfg)
    got_logits, got_aux = model.forward_with_aux(tokens)
    assert flash_attention_with_lse.launches == before  # the CPU runs the plain version
    assert got_logits.shape == (2, 24, 256) and got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **F32_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(model(tokens).numpy(), got_logits.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["dense", "moe_k1", "moe_k2"])
def test_loss_and_expert_load_match_tpulab(name):
    jcfg, tcfg, params, model = _both(name)
    tokens = _tokens(2, s=25)
    want = float(jlf.loss_fn(params, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(float(model.loss_fn(tokens)), want, rtol=1e-5)
    want_load = np.asarray(jlf.expert_load(params, jnp.asarray(tokens), jcfg))
    got_load = model.expert_load(tokens).numpy()
    assert got_load.shape == want_load.shape
    # the same argmax counts; the mean divides them in another way (one ulp)
    n = tokens.size
    np.testing.assert_array_equal(np.rint(got_load * n), np.rint(want_load * n))
    np.testing.assert_allclose(got_load, want_load, rtol=1e-6, atol=0)


def test_lora_forward_and_merge_match_tpulab():
    jcfg, tcfg = _cfgs(lora_rank=4, attn_impl="flash")
    params = _lora_params(jcfg, 13)
    tokens = _tokens(3)
    want = np.asarray(jlf.forward(params, jnp.asarray(tokens), jcfg))
    got = Labformer.from_numpy(params, tcfg, "cpu")(tokens).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)

    jmerged, jmcfg = jlf.merge_lora(params, jcfg)
    tmerged, tmcfg = tlf.merge_lora(params, tcfg)
    assert tmcfg.lora_rank == 0 and set(tmerged["blocks"]) == set(jmerged["blocks"])
    for name in ("wq", "wv"):
        np.testing.assert_allclose(tmerged["blocks"][name].numpy(),
                                   np.asarray(jmerged["blocks"][name]), rtol=1e-6, atol=1e-6)
    merged_got = Labformer.from_numpy(tmerged, tmcfg, "cpu")(tokens).numpy()
    np.testing.assert_allclose(merged_got, np.asarray(jlf.forward(jmerged, jnp.asarray(tokens),
                                                                  jmcfg)), **F32_TOL)
    np.testing.assert_allclose(merged_got, got, **F32_TOL)


@pytest.mark.parametrize("name", ["dense", "flash", "gqa", "moe_k2"])
def test_forward_bf16_matches_tpulab(name):
    jcfg, tcfg, params, model = _both(name, "bfloat16")
    tokens = _tokens(4)
    want = np.asarray(jlf.forward(params, jnp.asarray(tokens), jcfg), np.float32)
    got = model(tokens)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_config_checks_and_mesh_paths():
    for bad in (dict(attn_impl="flsh"), dict(n_kv_heads=3), dict(attn_window=-1),
                dict(lora_rank=-1), dict(n_experts=2, moe_top_k=3),
                dict(remat_policy="dots")):
        with pytest.raises(ValueError):
            tlf.LabformerConfig(**BASE, **bad)
        with pytest.raises(ValueError):
            jlf.LabformerConfig(**BASE, **bad)
    tcfg = tlf.LabformerConfig(**BASE, n_experts=4, moe_impl="dispatch")
    with pytest.raises(NotImplementedError, match="A12"):
        Labformer.from_numpy(tlf.init_params(tcfg), tcfg, "cpu")
    assert tlf.LabformerConfig(**BASE).head_dim == 8
    assert dataclasses.replace(tcfg, n_kv_heads=2).kv_heads == 2
