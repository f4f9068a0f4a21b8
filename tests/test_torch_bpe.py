"""tpulab_torch's BPE tokenizer against tpulab's on seeded corpora: merges,
encoded ids, the saved JSON and the CLI output are equal bit for bit (no
tolerance: the algorithm is integer work), and the trainer's BPE path
against tpulab's (losses within rtol 1e-4, the four printed decimals)."""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpulab import train as jtrain
from tpulab.io import bpe as jbpe

from tpulab_torch import train as ttrain
from tpulab_torch.io import bpe as tbpe

torch.set_num_threads(2)


def zipf_text(n_words: int, seed: int, vocab: int = 300) -> bytes:
    """Words drawn Zipf-like from a seeded word list: text with structure."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = [bytes(rng.choice(letters, rng.integers(1, 9))) for _ in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    idx = rng.choice(vocab, n_words, p=p / p.sum())
    return b" ".join(words[i] for i in idx)


@pytest.mark.parametrize("seed,vocab,cap", [(0, 400, 32), (1, 600, 32), (2, 500, 4),
                                            (3, 256, 32)])
def test_merges_ids_and_json_equal_tpulab(tmp_path, seed, vocab, cap):
    corpus = zipf_text(6000, seed)
    want = jbpe.train_bpe(corpus, vocab, max_token_bytes=cap)
    got = tbpe.train_bpe(corpus, vocab, max_token_bytes=cap)
    assert got.merges == want.merges and got.vocab == want.vocab
    for text in (corpus, zipf_text(500, seed + 100), bytes(range(256)), b"", b"a"):
        ids = got.encode(text)
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, want.encode(text))
        assert got.decode(ids) == text
    got.save(str(tmp_path / "t.json"))
    want.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    # a table trained by either package loads in both
    assert tbpe.BPETokenizer.load(str(tmp_path / "j.json")).merges == want.merges
    assert jbpe.BPETokenizer.load(str(tmp_path / "t.json")).merges == got.merges


@settings(max_examples=40, deadline=None)
@given(data=st.binary(min_size=0, max_size=400), vocab=st.integers(256, 330),
       probe=st.binary(min_size=0, max_size=200))
def test_arbitrary_bytes_equal_tpulab(data, vocab, probe):
    want = jbpe.train_bpe(data, vocab)
    got = tbpe.train_bpe(data, vocab)
    assert got.merges == want.merges
    for text in (data, probe, data + probe):
        np.testing.assert_array_equal(got.encode(text), want.encode(text))
        assert got.decode(got.encode(text)) == text


def test_heap_encode_equals_pass_encode_and_tpulab():
    corpus = zipf_text(3000, 5)
    tok = tbpe.train_bpe(corpus, 700)
    jtok = jbpe.BPETokenizer(tok.merges)
    for text in (corpus[:5000], zipf_text(300, 9), b"zzzz" * 50):
        np.testing.assert_array_equal(tok._encode_heap(text), tok.encode(text))
        np.testing.assert_array_equal(tok._encode_heap(text), jtok._encode_heap(text))


def test_load_refuses_foreign_files_as_tpulab(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"format": "other", "vocab": 256, "merges": []}))
    for mod in (tbpe, jbpe):
        with pytest.raises(ValueError, match="not a tpulab-bpe-v1 tokenizer file"):
            mod.BPETokenizer.load(str(path))
    path.write_text(json.dumps({"format": "tpulab-bpe-v1", "vocab": 300, "merges": []}))
    for mod in (tbpe, jbpe):
        with pytest.raises(ValueError, match="merge count disagrees"):
            mod.BPETokenizer.load(str(path))
    for mod in (tbpe, jbpe):
        with pytest.raises(ValueError, match="vocab must be >= 256"):
            mod.train_bpe(b"abc", 100)
        with pytest.raises(ValueError, match="outside vocab"):
            mod.BPETokenizer([]).decode([300])


def test_corpus_from_dir_equals_tpulab(tmp_path):
    (tmp_path / "sub").mkdir()
    for name, data in (("b.txt", b"bbb" * 100), ("a.txt", b"aa" * 50), ("sub/c", b"c" * 999)):
        (tmp_path / name).write_bytes(data)
    for limit in (1 << 24, 150, 300):
        assert tbpe.corpus_from_dir(str(tmp_path), limit) == jbpe.corpus_from_dir(
            str(tmp_path), limit)
    for mod in (tbpe, jbpe):
        with pytest.raises(FileNotFoundError, match="no files"):
            mod.corpus_from_dir(str(tmp_path / "sub" / "missing"))


def _cli(main, argv, stdin=b""):
    out = io.StringIO()
    old = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        sys.stdin = old
    return rc, out.getvalue()


def test_tokenizer_cli_equals_tpulab(tmp_path):
    from tpulab_torch.cli.main import main as cli_main

    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "t.txt").write_bytes(zipf_text(4000, 7))
    outs = {}
    for tag, main, pre in (("t", cli_main, ["tokenizer"]), ("j", jbpe.main, [])):
        out = str(tmp_path / f"{tag}.json")
        rc, text = _cli(main, [*pre, "train", "--data-dir", str(tmp_path / "data"), "--vocab",
                               "320", "--out", out])
        assert rc == 0
        rc_i, info = _cli(main, [*pre, "info", out])
        rc_e, enc = _cli(main, [*pre, "encode", out], b"the quick words\n")
        assert rc_i == rc_e == 0
        outs[tag] = (json.loads(text), info, enc)
        outs[tag][0].pop("out")
    assert outs["t"] == outs["j"]
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_train_with_tokenizer_matches_tpulab(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        (data / f"p{i}.txt").write_bytes(zipf_text(3000, 20 + i))
    tok = str(tmp_path / "tok.json")
    tbpe.train_bpe(tbpe.corpus_from_dir(str(data)), 300).save(tok)
    kw = dict(steps=4, batch=2, seq=32, eval_every=2, seed=3, data_dir=str(data), tokenizer=tok)
    jout, tout = [], []
    jtrain.train(**kw, log=jout.append)
    ttrain.train(**kw, log=tout.append, device="cpu")

    def parse(lines):
        return [(ln.split()[:4], float(ln.split()[4])) for ln in lines
                if ln.startswith(("[train] step", "[eval]"))]

    got, want = parse(tout), parse(jout)
    assert [w for w, _ in got] == [w for w, _ in want] and len(got) == 6
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)


def test_tokenizer_errors_equal_tpulab(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    (data / "p.txt").write_bytes(zipf_text(300, 1))
    tok = str(tmp_path / "tok.json")
    tbpe.train_bpe(zipf_text(300, 1), 300).save(tok)
    cases = [
        (dict(tokenizer=tok), "--tokenizer encodes a corpus"),
        (dict(tokenizer=tok, data_dir=str(data), seq=512), "corpus encodes to"),
    ]
    for kw, match in cases:
        for fn, extra in ((jtrain.train, {}), (ttrain.train, dict(device="cpu"))):
            with pytest.raises(ValueError, match=match):
                fn(steps=1, batch=2, log=lambda _: None, **{"seq": 16, **kw}, **extra)
