"""A dispatch-MoE snapshot served and evaluated on one device (ROADMAP C18).

``train(mesh_devices=2, moe_impl="dispatch")`` over two gloo ranks writes a
snapshot whose sidecar records ``"moe_impl": "dispatch"``.  The one-device
loaders build the model from that sidecar without a mesh, where ``tpulab``
runs the dense MoE (``tpulab/models/labformer.py:496`` takes the dispatch
path only on a mesh).  So ``generate --ckpt-dir``, ``evaluate`` and the
daemon's ``ckpt_dir`` request must give what the same parameters give under
a sidecar that says ``"dense"`` (bit for bit: the same arithmetic), and the
forward must stay within the f32 logit limits (rtol = atol = 1e-4) of
``tpulab``'s ``forward`` with no mesh on the same parameters.
"""

import contextlib
import io
import json
import shutil
import time

import numpy as np
import pytest
import torch

from tpulab_torch.models import labformer as LF

torch.set_num_threads(2)

TINY = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64, n_experts=4, moe_top_k=2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """(the dispatch snapshot, a copy whose sidecar says dense)."""
    from tpulab_torch.train import train

    root = tmp_path_factory.mktemp("c18")
    cfg = LF.LabformerConfig(**TINY, moe_impl="dispatch")
    train(steps=2, batch=4, seq=32, cfg=cfg, mesh_devices=2, ckpt_dir=str(root / "dispatch"),
          save_every=2, log=lambda _: None, device="cpu")
    shutil.copytree(root / "dispatch", root / "dense")
    side = root / "dense" / "tpulab_config.json"
    doc = json.loads(side.read_text())
    doc["config"]["moe_impl"] = "dense"
    side.write_text(json.dumps(doc, indent=2))
    return str(root / "dispatch"), str(root / "dense")


def _loaded(path):
    from tpulab_torch.models.generate import load_params, load_sidecar

    cfg, _ = load_sidecar(path)
    params, step = load_params(cfg, path)
    return cfg, params, step


def test_forward_runs_dense_as_tpulab_without_a_mesh(snapshots):
    from tpulab.models import labformer as jlf

    cfg, params, step = _loaded(snapshots[0])
    assert cfg.moe_impl == "dispatch" and step == 2
    dense_cfg, dense_params, _ = _loaded(snapshots[1])
    tokens = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(np.int32)
    with torch.no_grad():
        got = LF.Labformer(params, cfg, "cpu")(tokens)
        dense = LF.Labformer(dense_params, dense_cfg, "cpu")(tokens)
    assert torch.equal(got, dense)
    jcfg = jlf.cfg_from_dict(LF.cfg_to_dict(cfg))
    assert jcfg.moe_impl == "dispatch"
    tree = LF.Labformer(params, cfg, "cpu").to_numpy()
    want = np.asarray(jlf.forward(tree, tokens, jcfg))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_generate_ckpt_dir_equals_dense(snapshots):
    from tpulab_torch.cli.main import main as cli_main

    outs = []
    for path in snapshots:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["generate", "--backend", "cpu", "--prompt", "abcabc", "--steps", "12",
                           "--temperature", "0", "--ckpt-dir", path])
        outs.append((rc, out.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert "[generate] loaded checkpoint step 2" in outs[0][1]


def test_evaluate_equals_dense(snapshots):
    """The report equals the dense sidecar's; its loss is ``tpulab``'s
    mesh-less loss of the same windows (the trainer's eval stream), to the
    report's 4 decimals."""
    from tpulab.models import labformer as jlf

    from tpulab_torch.evaluate import evaluate
    from tpulab_torch.train import batches

    got, want = (evaluate(p, batches=2, batch=2, seq=32, device="cpu") for p in snapshots)
    assert got.pop("ckpt_dir") == snapshots[0] and want.pop("ckpt_dir") == snapshots[1]
    assert got == want
    cfg, params, _ = _loaded(snapshots[0])
    tree = LF.Labformer(params, cfg, "cpu").to_numpy()
    jcfg = jlf.cfg_from_dict(LF.cfg_to_dict(cfg))
    window_at = batches(cfg.vocab, 2, 32, 104729)
    jloss = np.mean([float(jlf.loss_fn(tree, np.asarray(window_at(j)), jcfg)) for j in range(2)])
    assert abs(got["loss_nats_per_token"] - jloss) <= 1e-4


def _idle(td, timeout=60):
    """Wait until every warm fleet of the port's daemon has no work left."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with td._FLEET_SERVICE.lock:
            fleets = [v[1] for v in td._FLEETS.values()]
        busy = False
        for fleet in fleets:
            for r in fleet.replicas:
                with r.cond:
                    eng = r.engine
                    busy |= eng is not None and bool(
                        eng.pending or eng.inflight_depth or any(a is not None
                                                                 for a in eng.active))
        if not busy:
            return
        time.sleep(0.02)
    raise AssertionError("fleet never went idle")


def test_daemon_ckpt_dir_request_equals_dense(snapshots, monkeypatch, tmp_path):
    import tpulab_torch.daemon as td
    from tpulab_torch.obs import flightrec

    monkeypatch.setattr(td, "BACKEND", "cpu")
    monkeypatch.setattr(td, "_SERVE_MAX_SEQ", 128)
    monkeypatch.setattr(td, "_FLEETS", {})
    flightrec.configure_flightrec(tmp_path / "pm")
    try:
        prompt = bytes((np.arange(20) % 7).astype(np.uint8))
        got = [td.handle_request({"lab": "generate", "config": {"ckpt_dir": p, "steps": 10}},
                                 prompt) for p in snapshots]
        _idle(td)
    finally:
        flightrec.configure_flightrec(None)
    assert got[0] == got[1] and len(got[0]) > 0
