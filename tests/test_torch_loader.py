"""tpulab_torch's native token loader: its library is built from the
checkout's ``native/loader/tpulab_loader.cpp`` into ``build/tpulab_torch/``
(never ``native/lib/``), and its streams equal tpulab's, value for value,
for several (seed, start_step, threads).  The tpulab side is built with
``tools/build_native.py``'s own command (the same source and flags) into
the test's temporary directory, so it races no other test over
``native/lib/``.  Then the trainer's ``data_dir`` path against tpulab's
(losses within rtol 1e-4, the printed decimals)."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpulab.io import loader as jloader
from tpulab import train as jtrain

from tpulab_torch import train as ttrain
from tpulab_torch.io import loader as tloader
from tpulab_torch.ops.cuda import _build

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tpulab_loader(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ in environment")
    out = tmp_path_factory.mktemp("native") / "libtpulab_loader.so"
    subprocess.run(["g++", *tloader.CXX_FLAGS, "-o", str(out), str(tloader.SOURCE)],
                   check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jloader, "_LIB_PATH", out)
    mp.setattr(jloader, "_lib", None)
    yield jloader.TokenLoader
    mp.undo()


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "a.bin").write_bytes(bytes(range(256)) * 8)
    (tmp_path / "b.bin").write_bytes(b"\x07" * 1024)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "c.txt").write_bytes(rng.integers(0, 256, 3000).astype(np.uint8)
                                             .tobytes())
    return tmp_path


def test_library_is_built_from_the_checkout_source():
    lib = tloader.build()
    assert lib.is_file() and lib.parent.parent == _build.BUILD_ROOT
    assert lib.parent == tloader.library_dir() and lib.parent.name.startswith("loader-")
    assert tloader.SOURCE.name == "tpulab_loader.cpp" and tloader.SOURCE.parent.name == "loader"
    assert "native/lib" not in str(lib)
    assert tloader.CXX_FLAGS == ["-std=c++17", "-shared", "-fPIC", "-O2", "-Wall", "-pthread"]


@pytest.mark.parametrize("seed,start,threads", [(0, 0, 1), (9, 0, 4), (9, 3, 2), (123, 17, 3),
                                                (2**40 + 5, 1, 1)])
def test_streams_equal_tpulab(tpulab_loader, corpus, seed, start, threads):
    kw = dict(batch=4, row_tokens=33, seed=seed, start_step=start, threads=threads)
    with tloader.TokenLoader.from_dir(str(corpus), **kw) as got, \
            tpulab_loader.from_dir(str(corpus), **kw) as want:
        for i in range(5):
            a, b = got.next(), want.next()
            assert a.shape == (4, 33) and a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            assert got.last_step == want.last_step == start + i
        assert got.short_reads() == want.short_reads() == 0


def test_rows_come_from_files_and_errors_equal_tpulab(tpulab_loader, tmp_path):
    (tmp_path / "x.bin").write_bytes(b"\x2a" * 500)
    with tloader.TokenLoader.from_dir(str(tmp_path), batch=3, row_tokens=17) as ld:
        assert np.all(ld.next() == 0x2A)
    ld = tloader.TokenLoader.from_dir(str(tmp_path), batch=1, row_tokens=8)
    ld.close()
    assert ld.short_reads() is None
    with pytest.raises(RuntimeError, match="closed"):
        ld.next()
    (tmp_path / "empty").mkdir()
    for cls in (tloader.TokenLoader, tpulab_loader):
        with pytest.raises(RuntimeError, match="no files under"):
            cls.from_dir(str(tmp_path / "empty"), batch=1, row_tokens=8)
    (tmp_path / "small").mkdir()
    (tmp_path / "small" / "s.bin").write_bytes(b"ab")
    msgs = []
    for cls in (tloader.TokenLoader, tpulab_loader):
        with pytest.raises(RuntimeError, match="tl_open failed") as err:
            cls.from_dir(str(tmp_path / "small"), batch=1, row_tokens=8)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_train_data_dir_matches_tpulab(tpulab_loader, corpus):
    kw = dict(steps=4, batch=2, seq=32, eval_every=2, seed=5, data_dir=str(corpus))
    jout, tout = [], []
    jtrain.train(**kw, log=jout.append)
    ttrain.train(**kw, log=tout.append, device="cpu")

    def parse(lines):
        return [(ln.split()[:4], float(ln.split()[4])) for ln in lines
                if ln.startswith(("[train] step", "[eval]"))]

    got, want = parse(tout), parse(jout)
    assert [w for w, _ in got] == [w for w, _ in want] and len(got) == 6
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)
