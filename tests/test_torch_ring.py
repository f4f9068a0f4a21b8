"""The port's sequence parallelism (``tpulab_torch.parallel.ring``) over 2
and 4 gloo ranks on the CPU, held against ``tpulab.parallel.ring`` on a
mesh of the same size from the conftest's 8 CPU devices: the cases of
``tests/test_ring.py``, gradients of q, k and v included.

Each world size is one :class:`~tpulab_torch.parallel.mesh.RankPool`,
spawned once for the module; every case calls a function on every rank
with the same full arrays and reads rank 0's result.  The ranks import
this module, so it imports neither JAX nor ``tpulab`` at its top: the
``J`` fixture does.  On the CPU the flash bodies run B4's plain version
(``flash_attention_plain``); ``tpulab``'s run its Pallas kernel in
interpret mode.

Bars (``tests/test_ring.py``'s): outputs within rtol 1e-4, atol 1e-5;
gradients within rtol 2e-4, atol 2e-4.  The one-process helpers are held
to the distributed path's bytes.
"""

import re
import types

import numpy as np
import pytest
import torch

from tpulab_torch.parallel import RankPool
from tpulab_torch.parallel import ring as R

torch.set_num_threads(2)

WORLDS = (2, 4)
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
FNS = {"ring": "ring_attention", "zigzag": "zigzag_ring_attention",
       "ulysses": "ulysses_attention"}


@pytest.fixture(scope="module")
def J():
    """tpulab's side: its ring module, ``jax`` and an ``sp`` mesh of each
    world size."""
    import jax
    import jax.numpy as jnp
    from tpulab import parallel
    from tpulab.parallel import ring

    return types.SimpleNamespace(ring=ring, jax=jax, jnp=jnp,
                                 mesh={n: parallel.make_mesh({"sp": n}) for n in WORLDS})


@pytest.fixture(scope="module")
def pools():
    made = {}

    def pool(n):
        if n not in made:
            made[n] = RankPool(n, "cpu")
        return made[n]

    try:
        yield pool
    finally:
        for pool in made.values():
            pool.close()


def qkv(seed: int, b=2, s=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4))


def jax_side(J, kind, world, q, k, v, kw, do=None):
    """tpulab's output, and with ``do`` its q, k, v gradients of sum(o * do)."""
    fn = getattr(J.ring, FNS[kind])
    mesh = J.mesh[world]
    if do is None:
        return np.asarray(fn(q, k, v, mesh=mesh, **kw))

    def loss(q, k, v):
        return J.jnp.sum(fn(q, k, v, mesh=mesh, **kw) * do)

    return tuple(np.asarray(g) for g in J.jax.grad(loss, argnums=(0, 1, 2))(
        *(J.jnp.asarray(x) for x in (q, k, v))))


# ------------------------------------------------------------ rank side


def _attention(kind, q, k, v, kw, do=None):
    """Rank side: the port's function on the full arrays; with ``do``, the
    output and the q, k, v gradients of sum(o * do)."""
    fn = getattr(R, FNS[kind])
    if do is None:
        return fn(q, k, v, **kw)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fn(q, k, v, **kw)
    (o * torch.from_numpy(do)).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def _in_process_and_group(kind, q, k, v, kw):
    """Rank side: the distributed result and the one-process helper's over
    as many ranks, each rank running the helper alone."""
    import torch.distributed as dist

    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    group = getattr(R, FNS[kind])(q, k, v, **kw)
    local = getattr(R, FNS[kind] + "_in_process")(q, k, v, dist.get_world_size(), **kw)
    return group, local


def _loaded_reference_modules():
    import sys

    return sorted(m for m in sys.modules
                  if m in ("jax", "tpulab") or m.startswith(("jax.", "tpulab.")))


# ------------------------------------------------------------ outputs


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_equals_tpulab(J, pools, world, impl, causal):
    q, k, v, _ = qkv(1)
    kw = dict(causal=causal, local_impl=impl)
    got = pools(world).run(_attention, "ring", q, k, v, kw).numpy()
    np.testing.assert_allclose(got, jax_side(J, "ring", world, q, k, v, kw), **OUT_TOL)


# windows (shard 8 at world 4): the self-only window, inside one shard, at
# the shard's edge, across two shards, across most of the ring, the whole
# sequence
@pytest.mark.parametrize("window", [1, 5, 8, 13, 27, 32])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_windowed_ring_equals_tpulab(J, pools, window, impl):
    q, k, v, _ = qkv(2)
    kw = dict(causal=True, local_impl=impl, window=window)
    got = pools(4).run(_attention, "ring", q, k, v, kw).numpy()
    np.testing.assert_allclose(got, jax_side(J, "ring", 4, q, k, v, kw), **OUT_TOL,
                               err_msg=f"{impl} w={window}")


def test_n_live_rotations_equals_tpulab_and_the_brute_force(J):
    for shard in (1, 4, 8):
        for p in (1, 2, 4, 8):
            for window in (1, 2, 3, shard, shard + 1, 2 * shard + 3, 3 * shard, 10**6):
                live = [t for t in range(1, p)
                        if any(0 <= t * shard + i - j < window
                               for i in range(shard) for j in range(shard))]
                assert live == list(range(1, len(live) + 1))
                assert R.n_live_rotations(window, shard, p) == len(live) == \
                    J.ring.n_live_rotations(window, shard, p), (window, shard, p)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_zigzag_equals_tpulab(J, pools, world, impl):
    q, k, v, _ = qkv(3, s=48)  # 48 = 2 * 4 * 6: halves that are not powers of 2
    kw = dict(local_impl=impl)
    got = pools(world).run(_attention, "zigzag", q, k, v, kw).numpy()
    np.testing.assert_allclose(got, jax_side(J, "zigzag", world, q, k, v, kw), **OUT_TOL)


ULYSSES = [dict(local_impl="dense", causal=True), dict(local_impl="dense", causal=False),
           dict(local_impl="flash", causal=True), dict(local_impl="flash", causal=False),
           dict(local_impl="dense", window=11), dict(local_impl="flash", window=11)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kw", ULYSSES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_ulysses_equals_tpulab(J, pools, world, kw):
    q, k, v, _ = qkv(4)
    got = pools(world).run(_attention, "ulysses", q, k, v, kw).numpy()
    np.testing.assert_allclose(got, jax_side(J, "ulysses", world, q, k, v, kw), **OUT_TOL)


def test_flash_ring_at_a_local_length_no_default_block_divides(J, pools):
    """1536 local tokens, non-causal: ``tpulab`` picks a 512 block there;
    the public wrapper refuses the length (its default 1024 block would
    pad), the ring's partial entry does not."""
    from tpulab_torch.ops.cuda.attention import flash_attention_with_lse

    q, k, v, _ = qkv(5, b=1, s=3072, h=1, d=8)
    kw = dict(causal=False, local_impl="flash")
    got = pools(2).run(_attention, "ring", q, k, v, kw).numpy()
    np.testing.assert_allclose(got, jax_side(J, "ring", 2, q, k, v, kw), **OUT_TOL)
    half = torch.from_numpy(q[:, :1536])
    with pytest.raises(NotImplementedError, match="non-causal flash requires seq % block"):
        flash_attention_with_lse(half, half, half, causal=False)


# ------------------------------------------------------------ gradients


GRADS = [("ring", 4, dict(local_impl="dense")),
         ("ring", 2, dict(local_impl="flash")),
         ("ring", 4, dict(local_impl="flash", causal=False)),
         ("ring", 4, dict(local_impl="dense", window=13)),
         ("ring", 4, dict(local_impl="flash", window=13)),
         ("ring", 2, dict(local_impl="flash", window=5)),
         ("zigzag", 2, dict(local_impl="dense")),
         ("zigzag", 4, dict(local_impl="flash")),
         ("ulysses", 4, dict(local_impl="dense")),
         ("ulysses", 2, dict(local_impl="flash", window=11))]


@pytest.mark.parametrize("kind,world,kw", GRADS,
                         ids=[f"{c[0]}-{c[1]}-" + "-".join(map(str, c[2].values()))
                              for c in GRADS])
def test_gradients_equal_tpulab(J, pools, kind, world, kw):
    """q, k and v gradients of sum(o * do): each rank's gradient is the
    single-device one, not ``world`` times it."""
    q, k, v, do = qkv(6, s=32, h=4, d=8)
    got = pools(world).run(_attention, kind, q, k, v, kw, do)
    want = jax_side(J, kind, world, q, k, v, kw, do)
    np.testing.assert_allclose(got[0].numpy(), jax_side(J, kind, world, q, k, v, kw),
                               **OUT_TOL)
    for name, g, w in zip("qkv", got[1:], want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=f"d{name}")


# ------------------------------------------------------------ refusals


REFUSALS = [("ring", 4, dict(s=30), {}, "ValueError: seq 30 not divisible by mesh axis 4"),
            ("ring", 2, {}, dict(causal=False, window=4), None),
            ("ring", 2, {}, dict(window=-1), None),
            ("zigzag", 4, dict(s=36), {}, None),
            ("ulysses", 4, dict(h=6), {}, None),
            ("ulysses", 4, dict(s=30), {}, None),
            ("ulysses", 2, {}, dict(causal=False, window=4), None),
            ("ulysses", 2, dict(b=1, s=1536, h=2), dict(causal=False, local_impl="flash"), None)]


@pytest.mark.parametrize("kind,world,shape,kw,own", REFUSALS)
def test_refusals_equal_tpulabs(J, pools, kind, world, shape, kw, own):
    """The port raises ``tpulab``'s exception with its message; where
    ``tpulab``'s ``device_put`` refuses an indivisible sequence before its
    own check can (the ring), the port raises that check's message
    (``own``)."""
    q, k, v, _ = qkv(7, **shape)
    with pytest.raises(Exception) as want:
        jax_side(J, kind, world, q, k, v, kw)
    expected = own or f"{type(want.value).__name__}: {want.value}"
    assert expected.startswith(type(want.value).__name__ + ": ")
    with pytest.raises(RuntimeError, match=re.escape(expected)):
        pools(world).run(_attention, kind, q, k, v, kw)


# ------------------------------------------------------------ one process


IN_PROCESS = [("ring", dict(local_impl="dense")), ("ring", dict(local_impl="flash")),
              ("ring", dict(local_impl="flash", causal=False)),
              ("ring", dict(local_impl="flash", window=13)),
              ("ring", dict(local_impl="dense", window=13)),
              ("zigzag", dict(local_impl="dense")), ("zigzag", dict(local_impl="flash")),
              ("ulysses", dict(local_impl="flash")), ("ulysses", dict(local_impl="dense"))]


@pytest.mark.parametrize("kind,kw", IN_PROCESS,
                         ids=[f"{c[0]}-" + "-".join(map(str, c[1].values())) for c in IN_PROCESS])
def test_in_process_helper_is_bit_equal_to_the_gloo_path(pools, kind, kw):
    q, k, v, _ = qkv(8)
    group, local = pools(4).run(_in_process_and_group, kind, q, k, v, kw)
    assert group.dtype == local.dtype and torch.equal(group, local)


def test_in_process_gradients_equal_tpulab(J):
    q, k, v, do = qkv(9)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = R.ring_attention_in_process(*ts, 4, local_impl="flash", window=13)
    (o * torch.from_numpy(do)).sum().backward()
    want = jax_side(J, "ring", 4, q, k, v, dict(local_impl="flash", window=13), do)
    for name, t, w in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, **GRAD_TOL, err_msg=f"d{name}")


def test_flash_paths_run_the_plain_b4_and_never_sdpa(monkeypatch):
    """On the CPU each flash body's local attention is B4's plain version,
    once for each block a rank computes (a causal ring skips the later
    blocks), and ``scaled_dot_product_attention`` never runs."""
    from tpulab_torch.ops.cuda import attention

    calls = []
    plain = attention.flash_attention_plain
    monkeypatch.setattr(attention, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        lambda *a, **kw: pytest.fail("SDPA ran"))
    q, k, v = (torch.from_numpy(x) for x in qkv(10)[:3])
    p = 4
    for fn, kw, want in ((R.ring_attention_in_process, dict(causal=False), p * p),
                         (R.ring_attention_in_process, {}, p * (p + 1) // 2),
                         (R.ring_attention_in_process, dict(window=13), 1 + 2 + 3 + 3),
                         (R.zigzag_ring_attention_in_process, {}, p * (3 + 2 * (p - 1))),
                         (R.ulysses_attention_in_process, {}, p)):
        calls.clear()
        fn(q, k, v, p, local_impl="flash", **kw)
        assert len(calls) == want, (fn.__name__, kw)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_neither_jax_nor_tpulab(pools, world):
    q, k, v, _ = qkv(11)
    pools(world).run(_attention, "ulysses", q, k, v, dict(local_impl="flash"))
    assert pools(world).run(_loaded_reference_modules) == []


_UNLAUNCHED = """
import numpy as np, torch
from tpulab_torch.parallel import pipeline_apply, ring_attention, switch_moe
from tpulab_torch.parallel.ring import attention_reference
rng = np.random.default_rng(0)
q, k, v = (rng.standard_normal((1, 16, 2, 8)).astype(np.float32) for _ in range(3))
o = ring_attention(q, k, v, backend="cpu")
want = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
print(o.device.type, bool(torch.allclose(o, want, rtol=1e-5, atol=1e-6)))
x = rng.standard_normal((8, 4)).astype(np.float32)
print(switch_moe(x, np.ones((4, 2), np.float32), np.ones((2, 4, 8), np.float32),
                 np.ones((2, 8, 4), np.float32), backend="cpu").device.type)
print(pipeline_apply(torch.matmul, np.ones((2, 4, 4), np.float32), x, n_micro=2,
                     backend="cpu").shape == (8, 4))
try:
    ring_attention(q, k, v)
except ValueError as e:
    print(e)
"""


def test_unlaunched_calls_run_on_the_card_unless_asked_for_the_cpu():
    """In one process with no group, ``backend="cpu"`` makes a gloo group of
    one and the functions run; a later call that asks for the card (by
    default) raises, and does not run on the group's CPU."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _UNLAUNCHED], cwd=root, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "cpu True", "cpu", "True",
        "backend None asks for cuda, but this process's group is gloo on cpu"]
