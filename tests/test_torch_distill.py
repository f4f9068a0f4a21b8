"""tpulab_torch's distillation against tpulab's on the CPU: the loss on
the same weights and logits, the student after the same steps, and
``distill`` through the CLI into a servable checkpoint.

Tolerances, with their reasons: the loss on the same inputs within rtol
1e-5 (the KL sums vocab-wide products of exponentials, in other orders in
XLA and PyTorch); the student's last loss after 4 steps within rtol
2e-6, and its parameters within atol 2e-5, as ``tests/test_torch_train.py``
holds its training steps (adamw moves a parameter by a fraction of lr
when a gradient differs by rounding).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.models import distill as jdist
from tpulab.models import labformer as jlf

from tpulab_torch import ckpt
from tpulab_torch.models import distill as tdist
from tpulab_torch.models import generate as tgen
from tpulab_torch.models import labformer as tlf

from test_torch_ckpt import write_both

torch.set_num_threads(2)

TEACHER = jlf.LabformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=128)
STUDENT = jlf.LabformerConfig(d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq=128)


def _port(cfg, **kw):
    """The port's config of a tpulab config, through the sidecar JSON."""
    return tlf.cfg_from_dict({**jlf.cfg_to_dict(cfg), **kw})


@pytest.mark.parametrize("temperature,alpha", [(2.0, 0.5), (1.0, 1.0), (3.5, 0.0)])
def test_distill_loss_equals_tpulab(trained_small, temperature, alpha):
    student = jax.device_get(jlf.init_params(STUDENT, seed=3))
    tokens = np.random.default_rng(0).integers(0, 256, (4, 25)).astype(np.int32)
    t_logits = np.asarray(jlf.forward(trained_small, jnp.asarray(tokens[:, :-1]), TEACHER))
    want = float(jdist.distill_loss_fn(student, jnp.asarray(tokens), jnp.asarray(t_logits),
                                       STUDENT, temperature, alpha))
    model = tlf.Labformer.from_numpy(student, _port(STUDENT), "cpu")
    got = float(tdist.distill_loss_fn(model, model.tokens(tokens), torch.from_numpy(t_logits.copy()),
                                      temperature, alpha))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_distill_steps_match_tpulab(trained_small):
    def cycle(step):
        return np.tile(np.arange(33, dtype=np.int32) % 7, (8, 1))

    jlog, tlog = [], []
    jstudent, jloss = jdist.distill(trained_small, TEACHER, STUDENT, steps=4, seed=2,
                                    batch_at=cycle, log=jlog.append)
    tstudent, tloss = tdist.distill(trained_small, _port(TEACHER), _port(STUDENT), steps=4,
                                    seed=2, batch_at=cycle, log=tlog.append, device="cpu")
    np.testing.assert_allclose(tloss, jloss, rtol=2e-6)
    assert [ln.split()[:3] for ln in tlog] == [ln.split()[:3] for ln in jlog]
    got = tstudent.to_numpy()
    for path, w in jax.tree_util.tree_leaves_with_path(jstudent):
        keys = [k.key for k in path]
        g = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2e-5, err_msg=str(keys))
    with pytest.raises(ValueError, match="share a vocabulary"):
        tdist.make_distill_step(tstudent, _port(STUDENT, vocab=300))


def test_distill_cli_writes_a_servable_student_as_tpulab(tmp_path, trained_small):
    from tpulab.models.generate import load_sidecar as jload_sidecar

    from tpulab_torch.cli.main import main as cli_main

    write_both(trained_small, TEACHER, tmp_path / "j", tmp_path / "t")
    argv = ["--steps", "3", "--batch", "2", "--seq", "24", "--student-layers", "1"]
    outs = {}
    for tag, main, pre in (("j", jdist.main, []), ("t", cli_main, ["distill", "--backend",
                                                                   "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([*pre, "--teacher", str(tmp_path / tag), "--out",
                         str(tmp_path / f"s{tag}"), *argv]) == 0
        lines = buf.getvalue().splitlines()
        outs[tag] = (lines[:2], json.loads(lines[-1]))
    assert outs["t"][0] == outs["j"][0]
    np.testing.assert_allclose(outs["t"][1].pop("final_loss"), outs["j"][1].pop("final_loss"),
                               atol=1e-4)  # 4 printed decimals
    assert outs["t"][1].pop("out") == str(tmp_path / "st")
    outs["j"][1].pop("out")
    assert outs["t"][1] == outs["j"][1]
    assert (tmp_path / "st" / ckpt.SIDECAR).read_bytes() == \
        (tmp_path / "sj" / ckpt.SIDECAR).read_bytes()
    cfg, tok = tgen.load_sidecar(str(tmp_path / "st"))
    assert cfg.n_layers == 1 and tok is None
    assert jlf.cfg_to_dict(jload_sidecar(str(tmp_path / "st"))[0])["n_layers"] == 1
    params, step = tgen.load_params(cfg, str(tmp_path / "st"))
    assert step == 3 and ckpt.snapshot_steps(str(tmp_path / "st")) == [3]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli_main(["generate", "--backend", "cpu", "--ckpt-dir", str(tmp_path / "st"),
                         "--prompt", "ab", "--steps", "4", "--temperature", "0"]) == 0
    assert "[generate] loaded checkpoint step 3" in buf.getvalue()
    with pytest.raises(SystemExit, match="already exists"):
        cli_main(["distill", "--backend", "cpu", "--teacher", str(tmp_path / "t"), "--out",
                  str(tmp_path / "st")])
