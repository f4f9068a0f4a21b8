"""The rest of tpulab_torch's trainer held against tpulab's on the CPU: the
``[train] metrics`` line, ``trace_dir``, ``sanitize`` and remat policy
``"dots"``.

* metrics: the lines come at the same places among the ``[train]`` and
  ``[eval]`` lines as tpulab's (every eval and save boundary and the end),
  with the same fields in the same order; their values are host times and
  a process-cumulative registry, so only their form is compared, and
  ``train_mfu_pct`` is 0 on the CPU (no peak), as tpulab's on its CPU.
* remat "dots" keeps the blocks' weight products and recomputes the rest:
  losses and gradients bit-equal to remat "none" and to no remat in the
  port; against tpulab's "dots", losses within 2e-6 and gradients within
  ``tests/test_torch_train.py``'s limit (the same f32 reorderings).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpulab import train as jtrain
from tpulab.models import labformer as jlf

from tpulab_torch import train as ttrain
from tpulab_torch.models import labformer as tlf

torch.set_num_threads(2)

BASE = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
LOSS_RTOL = 2e-6
FIELDS = ["dispatch_ms_p50", "dispatch_ms_p99", "loss_lag_ms_p50", "loss_lag_ms_p99",
          "blocks", "train_mfu_pct"]


def _shape(lines):
    """Each line's kind: metrics lines by their field names, the others by
    their words up to the numbers."""
    out = []
    for ln in lines:
        if ln.startswith("[train] metrics"):
            out.append(("metrics", tuple(w.split("=")[0] for w in ln.split()[2:])))
        elif ln.startswith(("[train] step", "[eval]")):
            out.append(tuple(ln.split()[:4]))
        elif ln.startswith("[train] counters"):
            out.append(tuple(ln.split()))
    return out


@pytest.mark.parametrize("kw", [dict(eval_every=2), dict(save_every=3, ckpt=True),
                                dict(eval_every=3, save_every=2, ckpt=True)],
                         ids=["eval", "save", "eval_and_save"])
def test_metrics_lines_where_and_as_tpulab(kw, tmp_path):
    kw = dict(kw)
    ckpt = kw.pop("ckpt", False)
    run = dict(steps=6, batch=2, seq=16, seed=4, **kw)
    tout, jout = [], []
    ttrain.train(**run, cfg=tlf.LabformerConfig(**BASE), log=tout.append, device="cpu",
                 ckpt_dir=str(tmp_path / "t") if ckpt else None)
    jtrain.train(**run, cfg=jlf.LabformerConfig(**BASE), log=jout.append,
                 ckpt_dir=str(tmp_path / "j") if ckpt else None)
    assert _shape(tout) == _shape(jout)
    metrics = [ln for ln in tout if ln.startswith("[train] metrics")]
    assert metrics and tout[-1] == metrics[-1]
    for ln in metrics:
        fields = dict(w.split("=") for w in ln.split()[2:])
        assert list(fields) == FIELDS
        assert float(fields["train_mfu_pct"]) == 0.0  # no peak on the CPU
        assert int(fields["blocks"]) >= 1 and float(fields["dispatch_ms_p99"]) >= 0


def test_metrics_histograms_and_mfu_window():
    from tpulab_torch.obs import REGISTRY, roofline

    before = REGISTRY.get("train_dispatch_seconds")
    n0 = before.count if before is not None else 0
    flops0 = roofline._TRAIN_ACCUM["flops"]
    cfg = tlf.LabformerConfig(**BASE)
    ttrain.train(steps=3, batch=2, seq=16, cfg=cfg, log=lambda _: None, device="cpu")
    assert REGISTRY.get("train_dispatch_seconds").count == n0 + 3
    assert REGISTRY.get("train_loss_lag_seconds").count >= 3
    assert roofline._TRAIN_ACCUM["flops"] - flops0 == pytest.approx(
        3 * 3 * roofline.labformer_fwd_flops(cfg, 2, 16))
    assert REGISTRY.get("train_mfu").value == 0.0  # no peak on the CPU


def test_trace_dir_writes_a_trace(tmp_path):
    out = tmp_path / "trace"
    ttrain.train(steps=2, batch=2, seq=16, cfg=tlf.LabformerConfig(**BASE),
                 log=lambda _: None, device="cpu", trace_dir=str(out))
    files = list(out.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::mm" in n for n in names)  # the step's ops were traced


def _nan_block_params(monkeypatch, layer: int):
    real = tlf.init_params

    def planted(cfg, seed=0):
        params = real(cfg, seed)
        params["blocks"]["w1"][layer, 0, 0] = float("nan")
        return params

    monkeypatch.setattr(tlf, "init_params", planted)


def test_sanitize_traps_a_planted_nan_in_its_block(monkeypatch):
    _nan_block_params(monkeypatch, 1)
    cfg = tlf.LabformerConfig(**BASE)
    out = []
    with pytest.raises(FloatingPointError, match=r"output of blocks\.1 at step 0"):
        ttrain.train(steps=3, batch=2, seq=16, cfg=cfg, log=out.append, device="cpu",
                     sanitize=True)
    assert not any(ln.startswith("[train] step") for ln in out)  # before any loss check
    # unsanitized, the NaN reaches the loss check
    with pytest.raises(FloatingPointError, match="non-finite loss nan at step 0"):
        ttrain.train(steps=3, batch=2, seq=16, cfg=cfg, log=lambda _: None, device="cpu")


def test_sanitize_traps_a_nan_made_in_the_backward(monkeypatch):
    """A finite loss whose gradient is NaN (sqrt's derivative at 0 is inf,
    times the 0 of the product before it): anomaly mode names the backward
    op that made it and the loop the step; without sanitize the step's
    loss is finite and the loss check sees nothing."""
    real = tlf.Labformer._head

    def head(self, x):
        return real(self, x) + (self.top.final_norm * 0).sqrt().sum()

    monkeypatch.setattr(tlf.Labformer, "_head", head)
    cfg = tlf.LabformerConfig(**BASE)
    with pytest.raises(FloatingPointError, match=r"backward of step 0:.*'MulBackward0'"):
        ttrain.train(steps=2, batch=2, seq=16, cfg=cfg, log=lambda _: None, device="cpu",
                     sanitize=True)
    _, loss = ttrain.train(steps=1, batch=2, seq=16, cfg=cfg, log=lambda _: None,
                           device="cpu")
    assert np.isfinite(loss)


def test_sanitized_clean_run_is_bit_equal():
    runs = []
    for sanitize in (False, True):
        out = []
        _, loss = ttrain.train(steps=4, batch=2, seq=16, seed=2, eval_every=2,
                               cfg=tlf.LabformerConfig(**BASE, attn_impl="flash"),
                               log=out.append, device="cpu", sanitize=sanitize)
        runs.append((loss, [ln.split(" (")[0] for ln in out
                            if ln.startswith(("[train] step", "[eval]"))]))
    assert runs[0] == runs[1]


# ------------------------------------------------------------------ remat "dots"


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _port_grads(attn, **kw):
    cfg = tlf.LabformerConfig(**BASE, attn_impl=attn, **kw)
    model, _, _ = tlf.init_train_state(cfg, None, seed=2, device="cpu")
    tokens = ttrain.batches(256, 2, 20, 4)(0)
    loss = model.loss_fn(tokens)
    ops = _CountOps()
    with ops:
        loss.backward()
    return float(loss), model.to_numpy(grads=True), ops.n


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_remat_dots_is_bit_equal_and_keeps_the_products(attn):
    off = _port_grads(attn)
    none = _port_grads(attn, remat=True)
    dots = _port_grads(attn, remat=True, remat_policy="dots")
    for other in (none, dots):
        assert other[0] == off[0]
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(off[1]),
                                     jax.tree_util.tree_leaves_with_path(other[1])):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    # "none" recomputes the 5 weight products of each layer in the backward;
    # "dots" keeps them (no more 2-D products than without remat) and
    # recomputes the batched ones as "none" does
    assert none[2]["mm"] == off[2]["mm"] + 5 * BASE["n_layers"]
    assert dots[2]["mm"] == off[2]["mm"]
    assert dots[2]["bmm"] == none[2]["bmm"] > off[2]["bmm"]


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_remat_dots_matches_tpulab(attn):
    kw = dict(remat=True, remat_policy="dots", attn_impl=attn)
    jcfg = jlf.LabformerConfig(**BASE, **kw)
    tokens = ttrain.batches(256, 2, 20, 4)(0)
    params = jlf.init_params(jcfg, seed=2)
    jloss, jgrads = jax.value_and_grad(lambda p: jlf.loss_fn(p, jnp.asarray(tokens), jcfg))(
        params)
    loss, grads, _ = _port_grads(attn, remat=True, remat_policy="dots")
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                 jax.tree_util.tree_leaves_with_path(grads)):
        w = np.asarray(w, np.float64)
        limit = 1e-4 * np.abs(w) + 1e-5 * np.abs(w).max()
        assert np.all(np.abs(np.asarray(g, np.float64) - w) <= limit), path


def test_train_with_remat_dots_matches_tpulab():
    run = dict(steps=3, batch=2, seq=16, seed=1, remat=True, remat_policy="dots")
    tout, jout = [], []
    _, tloss = ttrain.train(**run, log=tout.append, device="cpu")
    _, jloss = jtrain.train(**run, log=jout.append)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert os.environ.get("JAX_PLATFORMS") == "cpu"


def test_chip_smoke_phases_5e_6e_6f_rehearse_on_the_cpu():
    """chip_smoke.py's beam search (5e), the rest of training (6e) and
    labvision (6f) at a tiny size on the CPU, where the wrappers run their
    plain versions: every check of the phases runs."""
    import chip_smoke

    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(serving=dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=64),
                beam_prompt=24, beam_steps=8, beam_width=3, beam_reps=2,
                train=dict(d_model=64, n_heads=4, n_layers=2, d_ff=128),
                train_f32_batch=1, train_f32_seq=32, train_f32_steps=2,
                train_batch=2, train_seq=32, remat_steps=2, train_cli_seq=32,
                train_cli_batch=2, vision_bench_batch=2, vision_bench_reps=1,
                vision_f32_batch=4, vision_f32_steps=2)
    cpu = torch.device("cpu")
    beam = chip_smoke.beam_run(tiny, cpu, "cpu")
    assert beam["f32"]["seed0_embed_x4"]["steps_equal"] >= 1 and beam["beams1_equals_greedy"]
    rest = chip_smoke.run_train_rest(tiny, cpu, "cpu", "cpu")
    assert rest["bf16"]["remat_dots"]["losses"] == rest["bf16"]["remat_off"]["losses"]
    assert "blocks.2" in rest["tools"]["sanitize_message"]
    vision = chip_smoke.run_labvision(tiny, cpu, "cpu", "cpu")
    assert vision["accuracy"] > 0.9
    assert vision["bench_row"]["metric"] == "labvision_train_b2_64x64_images_per_s"
