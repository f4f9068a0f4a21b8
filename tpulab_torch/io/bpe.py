"""Byte-pair encoding over raw bytes (the counterpart of ``tpulab.io.bpe``).

``train_bpe`` learns ``vocab - 256`` greedy pair merges from a corpus;
``BPETokenizer`` encodes bytes to ids (merges applied in learned order)
and decodes ids to bytes losslessly for any input.  The merges, the ids
and the saved JSON (format ``"tpulab-bpe-v1"``) equal ``tpulab``'s bit for
bit, so a table trained by either package works in both.  The one
difference is inside :meth:`BPETokenizer.encode`: the set of ids present,
which lets a merge whose ids are absent skip its pass, is a count array
(``np.bincount``) rather than a Python set, an O(n) pass in C instead of
building a set of n Python ints after every merge that applies.

CLI: ``python -m tpulab_torch tokenizer train --data-dir D --vocab 512 --out
tok.json``, then ``tpulab_torch train --tokenizer tok.json --data-dir D``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, List, Optional, Tuple

import numpy as np

FORMAT = "tpulab-bpe-v1"


def train_bpe(corpus: bytes, vocab: int,
              max_token_bytes: int = 32) -> "BPETokenizer":
    """Learn ``vocab - 256`` merges by greedy pair frequency.

    Ties break on the lower pair ids (deterministic across runs and
    platforms).  Training operates on the id sequence directly — no
    word pre-segmentation — so the tokenizer is byte-faithful over
    arbitrary binary data, matching the loader's byte-stream model.

    ``max_token_bytes`` caps a merged token's byte expansion: without
    it, a corpus with long exact repeats (source files, templated logs)
    lets merges chain exponentially — line, line², line⁴ — until the
    whole corpus is a handful of memorized mega-tokens that never match
    fresh text.  Word-scale tokens generalize; corpus-scale ones don't.
    """
    if vocab < 256:
        raise ValueError(f"vocab must be >= 256 (the byte base), got {vocab}")
    if vocab > 65536:
        raise ValueError(f"vocab {vocab} > 65536: ids no longer fit int32 "
                         f"embedding tables comfortably; unsupported")
    ids = np.frombuffer(corpus, np.uint8).astype(np.int32)
    merges: List[Tuple[int, int]] = []
    nbytes: List[int] = [1] * 256
    for new_id in range(256, vocab):
        if len(ids) < 2:
            break
        # pair histogram in C: pack (left, right) into one int64 key
        pairs = ids[:-1].astype(np.int64) * 65536 + ids[1:]
        uniq, counts = np.unique(pairs, return_counts=True)
        left = (uniq >> 16).astype(np.int64)
        right = (uniq & 0xFFFF).astype(np.int64)
        lens = np.asarray(nbytes, np.int64)
        ok = lens[left] + lens[right] <= max_token_bytes
        if not ok.any():
            break
        uniq, counts, left, right = uniq[ok], counts[ok], left[ok], right[ok]
        best = np.lexsort((uniq, -counts))[0]  # max count, lowest pair tie
        if counts[best] < 2:
            break  # nothing repeats: further merges memorize the corpus
        a, b = int(left[best]), int(right[best])
        merges.append((a, b))
        nbytes.append(nbytes[a] + nbytes[b])
        ids = _apply_merge(ids, a, b, new_id)
    return BPETokenizer(merges)


def _apply_merge(ids: np.ndarray, a: int, b: int, new_id: int) -> np.ndarray:
    """Replace every non-overlapping (a, b) with ``new_id``, leftmost
    first — vectorized except the (rare, short) overlap-resolution loop
    over match positions."""
    mask = (ids[:-1] == a) & (ids[1:] == b)
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return ids
    if a == b:
        # aaa -> (aa)a: drop matches that overlap a kept earlier match
        keep, last = [], -2
        for i in idx.tolist():
            if i > last + 1:
                keep.append(i)
                last = i
        idx = np.asarray(keep, idx.dtype)
    out = ids.copy()
    out[idx] = new_id
    return np.delete(out, idx + 1)


class BPETokenizer:
    """Merges-ordered byte-pair tokenizer; ids 0..255 are raw bytes."""

    def __init__(self, merges: List[Tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        # merged id -> byte expansion (built bottom-up: merge i may only
        # reference ids < 256 + i)
        self._bytes: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self._rank_of: Optional[dict] = None  # lazy pair->rank (heap path)

    @property
    def vocab(self) -> int:
        return 256 + len(self.merges)

    # Above this many merges the rank-priority-queue encode wins: the
    # vectorized per-merge passes cost O(applied_merges × n) numpy scans
    # (cheap constant), the heap costs O(n log n) PYTHON heap ops
    # (expensive constant).  ~2k merges is where the scan count starts
    # to dominate for typical inputs; both paths are equivalence-tested.
    _HEAP_ENCODE_FROM = 2048
    # ...but only for bounded inputs: the heap path builds O(n) Python
    # objects (ids/nxt/prv/alive lists + heap tuples), so a whole-corpus
    # encode (train/evaluate/distill feed tens of MB) would trade numpy
    # scans for GBs of interpreter objects.  Above this size the pass
    # path always runs — chunking is NOT an option, a chunk boundary
    # would change the segmentation across it.
    _HEAP_MAX_BYTES = 1 << 20

    def encode(self, data: bytes) -> np.ndarray:
        """bytes -> int32 ids, applying merges in learned order.

        Semantics: one pass per merge, in rank order — exactly the
        sequence of ``_apply_merge`` calls training performed, so encode
        reproduces the training segmentation.  (Equivalent to the
        lowest-rank-applicable-pair-first scheme: merging (a,b)->c only
        creates pairs containing c, and every merge involving c was
        learned later, so applicable ranks increase monotonically —
        which is also why the heap encode below computes the same
        segmentation.)
        """
        if (len(self.merges) >= self._HEAP_ENCODE_FROM
                and len(data) <= self._HEAP_MAX_BYTES):
            return self._encode_heap(data)
        ids = np.frombuffer(bytes(data), np.uint8).astype(np.int32)
        # a merge (a, b) can only fire if both ids are present: skip
        # absent pairs in O(1), and count the ids again only when a pass
        # merged something (the output length changed)
        present = np.bincount(ids, minlength=self.vocab) > 0
        for rank, (a, b) in enumerate(self.merges):
            if len(ids) < 2:
                break
            if not (present[a] and present[b]):
                continue
            merged = _apply_merge(ids, a, b, 256 + rank)
            if merged.shape != ids.shape:
                ids = merged
                present = np.bincount(ids, minlength=self.vocab) > 0
        return ids

    def _encode_heap(self, data: bytes) -> np.ndarray:
        """Rank-priority-queue encode: O(n log n) heap ops instead of a
        scan per learned merge — the large-vocab path.

        Doubly-linked token list + a min-heap of (rank, position)
        candidates.  Popping the lowest rank (leftmost on ties) then
        pushing the two neighbor pairs of the merged node is exactly
        lowest-rank-applicable-first, which the monotone-rank argument
        in :meth:`encode` shows equals the per-merge pass order.  Stale
        heap entries (node consumed, or its pair changed since push)
        are detected by re-deriving the pair's rank at pop time.
        """
        import heapq

        if self._rank_of is None:
            self._rank_of = {tuple(m): r for r, m in enumerate(self.merges)}
        rank_of = self._rank_of
        ids = list(data)
        n = len(ids)
        if n < 2:
            return np.asarray(ids, np.int32)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            r = rank_of.get((ids[i], ids[i + 1]))
            if r is not None:
                heap.append((r, i))
        heapq.heapify(heap)
        while heap:
            r, i = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j == -1:
                continue
            if rank_of.get((ids[i], ids[j])) != r:
                continue  # stale: one side merged since this was pushed
            ids[i] = 256 + r
            alive[j] = False
            nj = nxt[j]
            nxt[i] = nj
            if nj != -1:
                prv[nj] = i
            p = prv[i]
            if p != -1:
                rp = rank_of.get((ids[p], ids[i]))
                if rp is not None:
                    heapq.heappush(heap, (rp, p))
            if nj != -1:
                rn = rank_of.get((ids[i], ids[nj]))
                if rn is not None:
                    heapq.heappush(heap, (rn, i))
        return np.asarray([t for t, a in zip(ids, alive) if a], np.int32)

    def decode(self, ids: Iterable[int]) -> bytes:
        n = self.vocab
        out = []
        for i in ids:
            i = int(i)
            if not 0 <= i < n:
                raise ValueError(f"id {i} outside vocab {n}")
            out.append(self._bytes[i])
        return b"".join(out)

    # ---------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        payload = {"format": FORMAT, "vocab": self.vocab,
                   "merges": [list(m) for m in self.merges]}
        pathlib.Path(path).write_text(json.dumps(payload))

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        payload = json.loads(pathlib.Path(path).read_text())
        if payload.get("format") != FORMAT:
            raise ValueError(
                f"{path}: not a {FORMAT} tokenizer file "
                f"(format={payload.get('format')!r})"
            )
        tok = cls([tuple(m) for m in payload["merges"]])
        if tok.vocab != payload["vocab"]:
            raise ValueError(
                f"{path}: merge count disagrees with declared vocab "
                f"({tok.vocab} != {payload['vocab']})"
            )
        return tok


def corpus_from_dir(data_dir: str, limit_bytes: int = 1 << 24) -> bytes:
    """Concatenate the dir's files (sorted, the loader's order) up to
    ``limit_bytes`` — the training corpus mirror of TokenLoader's
    stream."""
    root = pathlib.Path(data_dir)
    files = sorted(p for p in root.rglob("*") if p.is_file())
    if not files:
        raise FileNotFoundError(f"no files under {data_dir}")
    chunks, total = [], 0
    for p in files:
        # bounded read: a single huge file must not be slurped whole
        # just to keep its first few MB
        with open(p, "rb") as f:
            data = f.read(limit_bytes - total)
        chunks.append(data)
        total += len(data)
        if total >= limit_bytes:
            break
    return b"".join(chunks)


def main(argv: Optional[list] = None) -> int:
    """``tpulab_torch tokenizer``: train / inspect / roundtrip a BPE table."""
    import argparse

    ap = argparse.ArgumentParser(prog="tpulab_torch tokenizer", description=main.__doc__)
    sub = ap.add_subparsers(dest="command", required=True)
    tr = sub.add_parser("train", help="learn merges from a corpus dir")
    tr.add_argument("--data-dir", required=True)
    tr.add_argument("--vocab", type=int, default=512)
    tr.add_argument("--out", required=True)
    tr.add_argument("--limit-bytes", type=int, default=1 << 24)
    ins = sub.add_parser("info", help="print vocab/merge stats")
    ins.add_argument("tokenizer")
    enc = sub.add_parser("encode", help="encode stdin text to ids")
    enc.add_argument("tokenizer")
    args = ap.parse_args(argv)

    if args.command == "train":
        corpus = corpus_from_dir(args.data_dir, args.limit_bytes)
        tok = train_bpe(corpus, args.vocab)
        tok.save(args.out)
        sample = corpus[:65536]
        print(json.dumps({
            "vocab": tok.vocab, "merges": len(tok.merges),
            "corpus_bytes": len(corpus),
            "compression_sample_64k": round(
                len(sample) / max(len(tok.encode(sample)), 1), 3),
            "out": args.out,
        }))
        return 0
    if args.command == "info":
        tok = BPETokenizer.load(args.tokenizer)
        print(json.dumps({"vocab": tok.vocab, "merges": len(tok.merges)}))
        return 0
    if args.command == "encode":
        import sys

        tok = BPETokenizer.load(args.tokenizer)
        ids = tok.encode(sys.stdin.buffer.read())
        print(" ".join(map(str, ids.tolist())))
        return 0
    return 2
