"""``tpulab_torch selftest`` — a one-minute end-to-end sanity check.

The JAX package's checks (``tpulab/selftest.py:153``) against the port's
modules, each on the resolved device (the card unless ``--backend cpu``),
one PASS/FAIL line each: the workload kernels (lab1/lab2/lab3 against
their NumPy and C-semantics oracles), lab5's reductions and hw2's sort
against NumPy, flash attention against dense, the paged serving engine
against solo decode, and two training steps.  The JAX package's check
also resumes from a checkpoint; the port has no checkpoint format yet
(ROADMAP A8.1), so its training check stops at the steps.

Usage: python -m tpulab_torch selftest [--backend cpu] [--skip NAME ...]
"""

from __future__ import annotations

import argparse
import time
import traceback
from typing import Callable, List, Tuple

import numpy as np
import torch

from tpulab_torch.runtime.device import BACKENDS, resolve_device


def _check_lab1(device):
    from tpulab_torch.ops.cuda.elementwise import binary

    rng = np.random.default_rng(0)
    a = rng.standard_normal(4097).astype(np.float32)
    b = rng.standard_normal(4097).astype(np.float32)
    got = binary("subtract", torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
    np.testing.assert_allclose(got.cpu().numpy(), a - b, rtol=1e-6)


def roberts_oracle_np(pixels: np.ndarray) -> np.ndarray:
    """NumPy f32 restatement of the C reference semantics (reference
    lab2/src/main.c:14-59): clamp addressing, f32 luminance, sqrt,
    clamp-then-truncate."""
    h, w = pixels.shape[:2]
    rgb = pixels[..., :3].astype(np.float32)
    y = (np.float32(0.299) * rgb[..., 0]
         + np.float32(0.587) * rgb[..., 1]
         + np.float32(0.114) * rgb[..., 2])
    ypad = np.pad(y, ((0, 1), (0, 1)), mode="edge")
    gx = ypad[1:h + 1, 1:w + 1] - ypad[:h, :w]
    gy = ypad[:h, 1:w + 1] - ypad[1:h + 1, :w]
    g = np.sqrt(gx * gx + gy * gy, dtype=np.float32)
    g8 = np.clip(g, np.float32(0.0), np.float32(255.0)).astype(np.uint8)
    return np.stack([g8, g8, g8, pixels[..., 3]], axis=-1)


def classify_oracle_np(pixels: np.ndarray, mean, inv_cov) -> np.ndarray:
    """Vectorized f64 restatement of the lab3 classify kernel
    (reference lab3/src/main.cu:40-76): strict-< Mahalanobis argmin;
    NaN distances never win."""
    p = pixels[..., :3].astype(np.float64)
    d = p[..., None, :] - np.asarray(mean)              # (h, w, nc, 3)
    q = np.einsum("...cd,cde,...ce->...c", d, np.asarray(inv_cov), d)
    q = np.where(np.isnan(q), np.inf, q)
    return np.argmin(q, axis=-1).astype(np.uint8)


def _check_lab2(device):
    from tpulab_torch.ops.roberts import roberts_staged, unpack_rgba

    img = np.random.default_rng(1).integers(0, 256, (33, 45, 4), np.uint8)
    fn, args = roberts_staged(img, device=device)
    got, want = unpack_rgba(fn(*args)), roberts_oracle_np(img)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"{int((got != want).sum())} mismatched bytes vs the C-semantics oracle")


def _check_lab3(device):
    from tpulab_torch.ops.mahalanobis import class_statistics, classify_staged
    from tpulab_torch.ops.roberts import unpack_rgba

    img = np.random.default_rng(2).integers(0, 256, (17, 19, 4), np.uint8)
    classes = [np.array([[1, 1], [2, 3], [4, 2]]), np.array([[5, 5], [6, 6]])]
    stats = class_statistics(img, classes)
    fn, args = classify_staged(img, stats, device=device)
    labels = unpack_rgba(fn(*args))[..., 3]
    want = classify_oracle_np(img, stats.mean, stats.inv_cov)
    if not np.array_equal(labels, want):
        raise AssertionError(
            f"{int((labels != want).sum())} mismatched labels vs the f64 oracle")


def _check_lab5(device):
    from tpulab_torch.ops.reduction import reduce_values
    from tpulab_torch.ops.sortops import sort_ascending

    rng = np.random.default_rng(4)
    ints = rng.integers(-10000, 10000, 4099).astype(np.int32)
    x = torch.from_numpy(ints).to(device)
    for op, want in (("sum", ints.astype(np.int64).sum()), ("min", ints.min()),
                     ("max", ints.max())):
        got = int(reduce_values(x, op))
        assert got == int(want), (op, got, int(want))
    floats = rng.standard_normal(4099).astype(np.float32)
    got = sort_ascending(torch.from_numpy(floats).to(device)).cpu().numpy()
    np.testing.assert_array_equal(got, np.sort(floats))


def _check_flash(device):
    from tpulab_torch.ops.cuda.attention import flash_attention
    from tpulab_torch.parallel.ring import attention_reference

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, 2, 64)).astype(np.float32))
               .to(device) for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    want = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=2e-5)


def _small_config():
    from tpulab_torch.models.labformer import LabformerConfig

    return LabformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64)


def _check_serving(device):
    from tpulab_torch.models.generate import generate
    from tpulab_torch.models.labformer import Labformer, init_params
    from tpulab_torch.models.paged import PagedEngine

    cfg = _small_config()
    model = Labformer.from_numpy(init_params(cfg, seed=0), cfg, device=device)
    prompt = (np.arange(5) % 7).astype(np.int32)
    eng = PagedEngine(model, cfg, slots=2, n_blocks=16, block_size=8, max_seq=64,
                      device=device)
    rid = eng.submit(prompt, max_new=4)
    got = eng.run()[rid]
    want = generate(model, torch.from_numpy(prompt[None, :]).to(device), steps=4,
                    temperature=0.0)[0]
    assert np.array_equal(got, np.asarray(want)), (got, want)


def _check_train(device):
    from tpulab_torch.train import train

    step, loss = train(steps=2, batch=2, seq=32, log=lambda *a: None, device=device,
                       cfg=_small_config())
    assert step == 2 and np.isfinite(loss), (step, loss)


CHECKS: List[Tuple[str, Callable[[torch.device], None]]] = [
    ("lab1 elementwise vs oracle", _check_lab1),
    ("lab2 roberts bit-exact vs C semantics", _check_lab2),
    ("lab3 mahalanobis classify", _check_lab3),
    ("lab5 reductions and hw2 sort vs numpy", _check_lab5),
    ("flash attention vs dense", _check_flash),
    ("paged serving == solo decode", _check_serving),
    ("train steps (checkpoint resume: ROADMAP A8.1)", _check_train),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="cuda (default) or cpu")
    ap.add_argument("--skip", action="append", default=[],
                    metavar="SUBSTR", help="skip checks matching SUBSTR")
    args = ap.parse_args(argv)

    device = resolve_device(args.backend)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"[selftest] backend: {device.type} ({kind})")
    failed = skipped = 0
    for name, fn in CHECKS:
        if any(s in name for s in args.skip):
            skipped += 1
            print(f"[selftest] SKIP  {name}")
            continue
        t0 = time.perf_counter()
        try:
            fn(device)
        except Exception:
            failed += 1
            print(f"[selftest] FAIL  {name}")
            traceback.print_exc()
            continue
        print(f"[selftest] pass  {name} "
              f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    ran = len(CHECKS) - skipped
    print(f"[selftest] {'FAILED' if failed else 'OK'} "
          f"({ran - failed}/{ran} run"
          + (f", {skipped} skipped" if skipped else "") + ")")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
