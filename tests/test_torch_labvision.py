"""tpulab_torch's labvision CNN (``tpulab_torch/models/labvision.py``) and
``train(model="labvision")`` held against tpulab's on the CPU, in float32.

Both sides start from the same ``init_params`` seed (bit-equal leaves) and
see the same ``synth_batch`` images (bit-equal).  Tolerances, with their
reasons:

* logits: 1e-5 absolute (measured: at most 1.2e-7 on logits of magnitude
  ~0.5).  XLA and oneDNN sum a convolution's 9 * C_in products in other
  orders, and the two GELUs round their tanh differently.
* losses: rtol 2e-6 (``PERF.md`` section 2), as the labformer's.
* parameters after each step: atol 2e-5, as ``tests/test_torch_train.py``:
  adamw moves a parameter by about ``lr * sign(g)``, so gradients that
  differ by rounding move it by a small fraction of lr.

``padding="SAME"`` pads 0 before and 1 after an even side at stride 2; a
planted symmetric pad of 1 must fail the logits check.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab import train as jtrain
from tpulab.models import labvision as jlv

from tpulab_torch import train as ttrain
from tpulab_torch.models import labvision as tlv

torch.set_num_threads(2)

LOGIT_ATOL = 1e-5
LOSS_RTOL = 2e-6
PARAM_ATOL = 2e-5
CFG = dict(n_classes=4, img_size=16, channels=(8, 16))


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return jlv.LabvisionConfig(**kw), tlv.LabvisionConfig(**kw)


def _logits(side, seed=0):
    jcfg, tcfg = _cfgs(img_size=side)
    params = jlv.init_params(jcfg, seed=seed)
    imgs, _ = jlv.synth_batch(jcfg, 6, np.random.default_rng(seed))
    want = np.asarray(jlv.forward(params, jnp.asarray(imgs), jcfg))
    got = tlv.Labvision.from_numpy(jax.device_get(params), tcfg, "cpu")(imgs)
    return got.detach().numpy(), want


def test_init_params_bit_equal():
    jcfg, tcfg = _cfgs(channels=(8, 16, 32))
    want = jlv.init_params(jcfg, seed=3)
    got = tlv.init_params(tcfg, seed=3)
    for jc, tc in zip(want["convs"], got["convs"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["head"][k].numpy(), np.asarray(want["head"][k]))


@pytest.mark.parametrize("side", [32, 33, 16])
def test_forward_logits_match_tpulab(side):
    got, want = _logits(side)
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_symmetric_padding_fails_the_logits_check(monkeypatch):
    """``F.conv2d(padding=1)``'s pad (1 before, 1 after) shifts every
    output of an even side: the check above must reject it."""
    monkeypatch.setattr(tlv, "_same_pad", lambda side: (1, 1))
    got, want = _logits(32)
    assert np.abs(got - want).max() > 100 * LOGIT_ATOL


def test_same_pad_is_tpulabs():
    for side in (1, 2, 3, 15, 16, 32, 33, 64):
        out = -(-side // 2)
        total = max((out - 1) * 2 + 3 - side, 0)
        assert tlv._same_pad(side) == (total // 2, total - total // 2)
    assert tlv._same_pad(32) == (0, 1) and tlv._same_pad(33) == (1, 1)


def test_uint8_equals_float_input():
    _, tcfg = _cfgs()
    model = tlv.Labvision.from_numpy(tlv.init_params(tcfg, seed=0), tcfg, "cpu")
    imgs, _ = tlv.synth_batch(tcfg, 4, np.random.default_rng(1))
    a = model(imgs)
    b = model(imgs.astype(np.float32) / np.float32(255.0))
    assert torch.equal(a, b)


def test_synth_batch_and_color_means_bit_equal():
    for n in (4, 8, 11):
        jcfg, tcfg = _cfgs(n_classes=n)
        np.testing.assert_array_equal(tlv.class_color_means(tcfg), jlv.class_color_means(jcfg))
        ji, jl = jlv.synth_batch(jcfg, 5, np.random.default_rng(n))
        ti, tl = tlv.synth_batch(tcfg, 5, np.random.default_rng(n))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        assert ti.dtype == np.uint8 and tl.dtype == np.int32


def test_train_steps_match_tpulab():
    jcfg, tcfg = _cfgs()
    params, opt_state, jstep = jlv.init_train_state(jcfg, seed=0)
    model, tstate, tstep = tlv.init_train_state(tcfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    for i in range(3):
        imgs, labels = jlv.synth_batch(jcfg, 16, rng)
        params, opt_state, jloss = jstep(params, opt_state, jnp.asarray(imgs),
                                         jnp.asarray(labels))
        model, tstate, tloss = tstep(model, tstate, imgs, labels)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL, err_msg=str(i))
        got = model.to_numpy()
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
            mine = got
            for k in keys:
                mine = mine[k]
            np.testing.assert_allclose(mine, np.asarray(leaf), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"step {i} {keys}")


def test_the_cnn_learns_the_lab3_task():
    """As ``tests/test_labvision.py`` asks of tpulab: which colour class
    made the image, above 0.9 on fresh data."""
    _, tcfg = _cfgs()
    model, state, step = tlv.init_train_state(tcfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(150):
        model, state, loss = step(model, state, *tlv.synth_batch(tcfg, 64, rng))
    assert np.isfinite(float(loss))
    imgs, labels = tlv.synth_batch(tcfg, 256, rng)
    assert tlv.accuracy(model, imgs, labels) > 0.9


LOOP = dict(model="labvision", steps=4, batch=8, eval_every=2, seed=3)


def _loss_lines(lines):
    return [ln for ln in lines if ln.startswith(("[train] step", "[eval]"))]


def _values(lines):
    return [float(ln.split()[4]) for ln in _loss_lines(lines)]


def test_train_labvision_matches_tpulab():
    jcfg, tcfg = _cfgs()
    tout, jout = [], []
    tstep, tloss = ttrain.train(**LOOP, cfg=tcfg, log=tout.append, device="cpu")
    jstep, jloss = jtrain.train(**LOOP, cfg=jcfg, log=jout.append)
    assert tstep == jstep == 4
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert [ln.split()[:4] for ln in _loss_lines(tout)] == \
        [ln.split()[:4] for ln in _loss_lines(jout)]
    np.testing.assert_allclose(_values(tout), _values(jout), rtol=1e-4)  # 4 decimals
    assert len([ln for ln in tout if ln.startswith("[eval]")]) == 2
    metrics = [ln for ln in tout if ln.startswith("[train] metrics")]
    assert len(metrics) == len([ln for ln in jout if ln.startswith("[train] metrics")]) == 3
    # the default lr is 1e-3 for labvision, as tpulab's: an explicit 1e-3
    # gives the same losses
    again = []
    ttrain.train(**LOOP, cfg=tcfg, log=again.append, device="cpu", lr=1e-3, clip_norm=0.0,
                 opt_name="sgd")
    jagain = []
    jtrain.train(**LOOP, cfg=jcfg, log=jagain.append, lr=1e-3, opt_name="sgd")
    np.testing.assert_allclose(_values(again), _values(jagain), rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(steps_per_call=2), dict(zero1=True), dict(zero2=True),
                                dict(lora_rank=4), dict(init_from="x"), dict(tokenizer="t"),
                                dict(data_dir="d")], ids=lambda kw: next(iter(kw)))
def test_labvision_refusals_equal_tpulab(kw):
    msgs = []
    for fn, extra in ((jtrain.train, {}), (ttrain.train, dict(device="cpu"))):
        with pytest.raises(ValueError) as e:
            fn(model="labvision", steps=1, batch=2, log=lambda _: None, **kw, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_labvision_resume_is_bit_equal(tmp_path):
    _, tcfg = _cfgs()
    kw = dict(model="labvision", batch=8, seed=1, cfg=tcfg, device="cpu", save_every=2)
    straight = []
    ttrain.train(steps=6, ckpt_dir=str(tmp_path / "a"), log=straight.append, **kw)
    ttrain.train(steps=4, ckpt_dir=str(tmp_path / "b"), log=lambda _: None, **kw)
    resumed = []
    ttrain.train(steps=6, ckpt_dir=str(tmp_path / "b"), resume=True, log=resumed.append, **kw)
    assert resumed[0] == "[train] resumed from step 4"

    def losses(lines):
        return [ln.split(" (")[0] for ln in lines if ln.startswith("[train] step")]

    assert losses(resumed) == losses(straight)[4:]
    a = torch.load(tmp_path / "a" / "6" / "state.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "6" / "state.pt", weights_only=True)
    for key, t in a["params"].items():
        assert torch.equal(t, b["params"][key]), key
    meta = json.loads((tmp_path / "a" / "6" / "meta.json").read_text())
    assert meta["leaves"]["params/convs/0/w"]["shape"] == [3, 3, 3, 8]  # HWIO, tpulab's
    assert not (tmp_path / "a" / "tpulab_config.json").exists()  # tpulab writes none either
