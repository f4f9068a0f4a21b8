"""Binary typed-array format of the lab5 datasets.

Format (established by byte-level inspection of the reference's
``lab5/data/{int10,float10,uchar10}`` files): a little-endian ``int32``
element count followed by ``count`` packed values of the element type —
``int32`` (``int10``), ``float32`` (``float10``) or ``uint8`` (``uchar10``).
"""

from __future__ import annotations

import struct

import numpy as np

DTYPES = {
    "int32": np.dtype("<i4"),
    "float32": np.dtype("<f4"),
    "uint8": np.dtype("u1"),
}

_SUFFIX_DTYPES = {
    "int": np.dtype("<i4"),
    "float": np.dtype("<f4"),
    "uchar": np.dtype("u1"),
}


def dtype_for_path(path: str) -> np.dtype:
    """Infer element dtype from a lab5-style filename (``int10`` -> int32)."""
    name = path.rsplit("/", 1)[-1]
    for prefix, dt in _SUFFIX_DTYPES.items():
        if name.startswith(prefix):
            return dt
    raise ValueError(f"cannot infer dtype from filename: {name}")


def load_typed_array(path: str, dtype=None) -> np.ndarray:
    """Read ``int32 count`` + payload; dtype inferred from filename if omitted."""
    dt = np.dtype(dtype) if dtype is not None else dtype_for_path(path)
    with open(path, "rb") as f:
        blob = f.read()
    (count,) = struct.unpack_from("<i", blob, 0)
    arr = np.frombuffer(blob, dtype=dt, count=count, offset=4)
    return arr.copy()


def save_typed_array(path: str, values: np.ndarray) -> None:
    values = np.ascontiguousarray(values)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", values.size))
        f.write(values.tobytes())
