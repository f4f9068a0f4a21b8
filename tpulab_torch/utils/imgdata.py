"""``ImgData`` — the eager tri-format image object.

Behavioral equivalent of the reference's ``utils/converter.py:16-148``:
loading any of ``.data``/``.txt``/``.png`` immediately materializes the
other two formats on disk next to the source (the golden directories are
self-converting caches), exposes the packed byte stream and its hex
rendering, and reports size in KB.  PNG import forces alpha to 255
(reference converter.py:111).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from tpulab_torch.io.imagefile import (
    Image4,
    bytes_to_hex,
    get_size,
    hex_to_bytes,
    load_image,
    pack_image,
    save_image,
)


# Directories the framework must never write into, even for the
# sibling-format cache (the read-only reference snapshot may be mounted rw).
# Read per call, not at import: the guard must honor TPULAB_PROTECTED_DIRS
# changes made after tpulab_torch is imported (tests, embedding applications).
def _protected_prefixes() -> tuple:
    return tuple(
        os.path.abspath(p)
        for p in os.environ.get("TPULAB_PROTECTED_DIRS", "/root/reference").split(":")
        if p
    )


def _is_protected(directory: str) -> bool:
    directory = os.path.abspath(directory)
    return any(
        directory == p or directory.startswith(p + os.sep)
        for p in _protected_prefixes()
    )


class ImgData(Image4):
    """Load an image file and eagerly write its sibling formats.

    Parameters
    ----------
    path2data:
        Path to a ``.data``, ``.txt`` or ``.png`` file.
    idx:
        Optional dataset index carried through for harness bookkeeping.
    materialize:
        When true (default, matching the reference), write the missing
        sibling formats next to the source file.
    """

    def __init__(self, path2data: str, idx: Optional[int] = None, materialize: bool = True):
        if not os.path.exists(path2data):
            raise FileNotFoundError(path2data)
        self.path = path2data
        self.idx = idx
        self.dir2save = os.path.dirname(os.path.abspath(path2data))
        self.data_name, self.ext = os.path.splitext(os.path.basename(path2data))

        super().__init__(load_image(path2data))
        self.c_data_bytes: bytes = pack_image(self.pixels)
        self.hex: str = bytes_to_hex(self.c_data_bytes)
        self.size: float = get_size(self.c_data_bytes)

        if materialize and not _is_protected(self.dir2save):
            self._materialize_siblings()

    def _materialize_siblings(self) -> None:
        # Fill in missing-or-stale siblings (stale = older than the source,
        # so editing a fixture refreshes its converted caches), and write
        # each atomically (temp + rename): concurrent harness runs read
        # these files while another run's pre_process may be materializing.
        try:
            src_mtime = os.path.getmtime(self.path)
        except OSError:
            src_mtime = 0.0
        for ext in (".data", ".txt", ".png"):
            if ext == self.ext.lower():
                continue
            sib = os.path.join(self.dir2save, self.data_name + ext)
            try:
                if os.path.getmtime(sib) >= src_mtime:
                    continue
            except OSError:
                pass  # missing sibling: materialize it
            tmp = os.path.join(
                self.dir2save, f".{self.data_name}.tmp{os.getpid()}{ext}"
            )
            try:
                save_image(tmp, self.pixels)
                os.replace(tmp, sib)
            except OSError:
                pass  # read-only directories: skip the cache write
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass

    @classmethod
    def from_pixels(cls, pixels: np.ndarray) -> "Image4":
        return Image4(np.asarray(pixels, dtype=np.uint8))
