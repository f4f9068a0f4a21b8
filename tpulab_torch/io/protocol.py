"""stdin/stdout text protocols of every workload.

Each workload binary in the reference reads its parameters and payload from
stdin with ``scanf`` and emits results on stdout or into a ``.data`` file.
The grammars (whitespace-separated tokens, so any mix of spaces/newlines
parses) are:

* lab1       : ``n  a_1..a_n  b_1..b_n``      (doubles; reference lab1/src/main.cu)
* lab1 sweep : ``grid block`` prefix          (reference lab1/src/to_plot.cu:33-40)
* lab2       : ``in_path out_path``           (reference lab2/src/main.cu:58-59)
* lab2 sweep : ``bx by gx gy`` prefix         (reference lab2/src/to_plot.cu:57-64)
* lab3       : ``in_path out_path nc { np {x y}*np }*nc``
               (grammar documented by reference lab3/src/test_read_input.c)
* lab3 sweep : ``blocks threads`` prefix      (reference lab3/src/to_plot.cu:76-81)
* hw1        : ``a b c``                      (floats; reference hw1/src/main.c:6)
* hw2        : ``n  v_1..v_n``                (floats; reference hw2/src/main.c:18-30)

Output payload formats: lab1 prints results as ``%.10e`` space-separated
(reference lab1/src/to_plot.cu:86-88); hw2 prints ``%.6e`` space-separated
plus trailing newline (hw2/src/main.c:34-37); hw1 prints ``%.6f`` roots or a
keyword (hw1/src/main.c:8-32).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class TokenReader:
    """scanf-style whitespace-delimited token stream."""

    def __init__(self, text: str):
        self._it: Iterator[str] = iter(text.split())

    def _next(self) -> str:
        try:
            return next(self._it)
        except StopIteration:
            raise ValueError("truncated input: token stream exhausted") from None

    def read_int(self) -> int:
        return int(self._next())

    def read_float(self) -> float:
        return float(self._next())

    def read_str(self) -> str:
        return self._next()

    def read_floats(self, n: int, dtype=np.float64) -> np.ndarray:
        return np.array([float(self._next()) for _ in range(n)], dtype=dtype)

    def read_ints(self, n: int) -> np.ndarray:
        return np.array([int(self._next()) for _ in range(n)], dtype=np.int64)


# ----------------------------------------------------------------------------- lab1


@dataclass
class Lab1Input:
    a: np.ndarray  # float64
    b: np.ndarray  # float64
    launch: Tuple[int, int] | None = None  # (grid, block) in sweep mode


def parse_lab1(text: str, sweep: bool = False) -> Lab1Input:
    r = TokenReader(text)
    launch = (r.read_int(), r.read_int()) if sweep else None
    n = r.read_int()
    a = r.read_floats(n)
    b = r.read_floats(n)
    return Lab1Input(a=a, b=b, launch=launch)


def format_lab1_input(a: Sequence[float], b: Sequence[float], launch=None) -> str:
    parts: List[str] = []
    if launch is not None:
        parts += [str(launch[0]), str(launch[1])]
    parts.append(str(len(a)))
    parts.append(" ".join(f"{v:.10e}" for v in a))
    parts.append(" ".join(f"{v:.10e}" for v in b))
    return "\n".join(parts) + "\n"


def format_vector_10e(values: np.ndarray) -> str:
    """lab1 stdout payload: ``%.10e `` per element (trailing space, no newline).

    Widened to f64 for formatting: ml_dtypes scalars (bfloat16) don't
    implement the ``e`` format code, and the widening is value-exact.
    """
    return "".join(f"{v:.10e} " for v in np.asarray(values, dtype=np.float64).ravel())


# ----------------------------------------------------------------------------- lab2


@dataclass
class Lab2Input:
    input_path: str
    output_path: str
    launch: Tuple[int, int, int, int] | None = None  # (bx, by, gx, gy)


def parse_lab2(text: str, sweep: bool = False) -> Lab2Input:
    r = TokenReader(text)
    launch = None
    if sweep:
        launch = (r.read_int(), r.read_int(), r.read_int(), r.read_int())
    return Lab2Input(input_path=r.read_str(), output_path=r.read_str(), launch=launch)


def format_lab2_input(input_path: str, output_path: str, launch=None) -> str:
    parts: List[str] = []
    if launch is not None:
        parts += [str(v) for v in launch]
    parts += [input_path, output_path]
    return "\n".join(parts) + "\n"


# ----------------------------------------------------------------------------- lab3


@dataclass
class ClassDef:
    points: np.ndarray  # int (np, 2) of (x, y) coordinates


@dataclass
class Lab3Input:
    input_path: str
    output_path: str
    classes: List[ClassDef] = field(default_factory=list)
    launch: Tuple[int, int] | None = None  # (blocks, threads)


def parse_lab3(text: str, sweep: bool = False) -> Lab3Input:
    r = TokenReader(text)
    launch = (r.read_int(), r.read_int()) if sweep else None
    inp, out = r.read_str(), r.read_str()
    nc = r.read_int()
    classes = []
    for _ in range(nc):
        npts = r.read_int()
        pts = r.read_ints(2 * npts).reshape(npts, 2)
        classes.append(ClassDef(points=pts))
    return Lab3Input(input_path=inp, output_path=out, classes=classes, launch=launch)


def format_lab3_input(
    input_path: str,
    output_path: str,
    classes: Sequence[np.ndarray],
    launch=None,
) -> str:
    parts: List[str] = []
    if launch is not None:
        parts += [str(v) for v in launch]
    parts += [input_path, output_path, str(len(classes))]
    for pts in classes:
        pts = np.asarray(pts).reshape(-1, 2)
        row = [str(len(pts))] + [f"{x} {y}" for x, y in pts]
        parts.append(" ".join(row))
    return "\n".join(parts) + "\n"


# ----------------------------------------------------------------------------- hw1 / hw2


def parse_hw1(text: str) -> Tuple[float, float, float]:
    r = TokenReader(text)
    return r.read_float(), r.read_float(), r.read_float()


def parse_hw2(text: str) -> np.ndarray:
    r = TokenReader(text)
    n = r.read_int()
    return r.read_floats(n, dtype=np.float32)


def format_hw2_input(values: Sequence[float]) -> str:
    values = np.asarray(values)
    vals = " ".join(f"{v:.6e}" for v in values)
    return f"{values.size}\n{vals}\n"


def format_vector_6e(values: np.ndarray) -> str:
    """hw2 stdout payload: ``%.6e `` per element then newline (hw2/src/main.c:34-37)."""
    return "".join(f"{v:.6e} " for v in np.asarray(values).ravel()) + "\n"
