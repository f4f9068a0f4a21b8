"""RGBA image file formats of the lab suite.

Three interconvertible on-disk representations (format spec established by
the reference's ``utils/converter.py:16-148`` and the committed fixtures):

* ``.data`` — binary: little-endian ``int32 w``, ``int32 h``, then
  ``w*h`` RGBA byte quadruples, row-major (y outer, x inner).
* ``.txt``  — lowercase hex of the exact ``.data`` byte stream, split into
  8-hex-char groups (one group = one pixel or one header int32); any
  whitespace layout parses, groups are space-separated on write.
* ``.png``  — standard RGBA PNG; importing a PNG forces alpha to 255
  (reference converter.py:111 behavior — round-trips are deliberately
  not alpha-preserving for PNGs).  Pillow is imported only for ``.png``.

Arrays are numpy ``uint8`` of shape ``(h, w, 4)`` (R, G, B, A).
"""

from __future__ import annotations

import binascii
import os
import struct
from dataclasses import dataclass

import numpy as np

HEX_GROUP = 8  # hex chars per group == one little-endian 32-bit word


def get_size(blob: bytes) -> float:
    """Size of a byte stream in KB (reference converter.py:11-13 parity)."""
    return len(blob) / 1024.0


@dataclass(eq=False)
class Image4:
    """An RGBA image: numpy ``uint8`` pixels of shape ``(h, w, 4)``."""

    pixels: np.ndarray

    def __post_init__(self) -> None:
        pix = np.asarray(self.pixels, dtype=np.uint8)
        if pix.ndim != 3 or pix.shape[2] != 4:
            raise ValueError(f"expected (h, w, 4) uint8 array, got {pix.shape}")
        self.pixels = pix

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    def tobytes(self) -> bytes:
        return pack_image(self.pixels)

    def tohex(self) -> str:
        return bytes_to_hex(self.tobytes())

    def size_kb(self) -> float:
        return get_size(self.tobytes())

    def __eq__(self, other) -> bool:
        if isinstance(other, Image4):
            return np.array_equal(self.pixels, other.pixels)
        return NotImplemented

    def __hash__(self):
        return hash(self.tobytes())


def pack_image(pixels: np.ndarray) -> bytes:
    """numpy (h, w, 4) uint8 -> ``.data`` byte stream."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w = pixels.shape[:2]
    return struct.pack("<ii", w, h) + pixels.tobytes()


def unpack_image(blob: bytes) -> np.ndarray:
    """``.data`` byte stream -> numpy (h, w, 4) uint8."""
    if len(blob) < 8:
        raise ValueError("image blob shorter than 8-byte header")
    w, h = struct.unpack_from("<ii", blob, 0)
    need = 8 + 4 * w * h
    if w < 0 or h < 0 or len(blob) < need:
        raise ValueError(f"image blob truncated: header says {w}x{h}, have {len(blob)} bytes")
    arr = np.frombuffer(blob, dtype=np.uint8, count=4 * w * h, offset=8)
    return arr.reshape(h, w, 4).copy()


def bytes_to_hex(blob: bytes) -> str:
    """Byte stream -> space-separated lowercase 8-char hex groups."""
    hx = binascii.hexlify(blob).decode("ascii")
    return " ".join(hx[i : i + HEX_GROUP] for i in range(0, len(hx), HEX_GROUP))


def hex_to_bytes(text: str) -> bytes:
    """Whitespace-tolerant hex -> byte stream."""
    return binascii.unhexlify("".join(text.split()))


def _load_png(path: str) -> np.ndarray:
    from PIL import Image  # local import: Pillow only needed for .png

    img = Image.open(path).convert("RGBA")
    arr = np.asarray(img, dtype=np.uint8).copy()
    arr[..., 3] = 255  # PNG import forces opaque alpha (reference converter.py:111)
    return arr


def _save_png(path: str, pixels: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(pixels, dtype=np.uint8), "RGBA").save(path)


def load_image(path: str) -> np.ndarray:
    """Load any of the three formats by extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".data":
        with open(path, "rb") as f:
            return unpack_image(f.read())
    if ext == ".txt":
        with open(path, "r") as f:
            return unpack_image(hex_to_bytes(f.read()))
    if ext == ".png":
        return _load_png(path)
    raise ValueError(f"unsupported image extension: {path}")


def save_image(path: str, pixels: np.ndarray) -> None:
    """Save to any of the three formats by extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".data":
        with open(path, "wb") as f:
            f.write(pack_image(pixels))
    elif ext == ".txt":
        with open(path, "w") as f:
            f.write(bytes_to_hex(pack_image(pixels)))
    elif ext == ".png":
        _save_png(path, pixels)
    else:
        raise ValueError(f"unsupported image extension: {path}")

