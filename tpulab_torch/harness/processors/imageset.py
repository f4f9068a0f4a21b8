"""Shared image-dataset machinery for the lab2/lab3 processors.

Reference behavior (lab2/lab2_processor.py:36-118): scan a data directory
for images, load goldens from a ``data_out_gt`` directory matched by
filename stem with extension priority ``.txt`` > ``.data`` > ``.png``,
recreate the ``data_out`` directory per run, iterate the dataset
round-robin under an asyncio lock, and key per-run output files by the
``device_info`` string so concurrent configs never collide.
"""

from __future__ import annotations

import os
import re
import shutil
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from tpulab_torch.io.imagefile import save_image
from tpulab_torch.utils.download import download_file
from tpulab_torch.utils.imgdata import ImgData, _is_protected

IMAGE_EXTS = (".txt", ".data", ".png")  # golden lookup priority


def scan_images(directory: str) -> List[str]:
    """Unique image stems in ``directory``, one path per stem by priority."""
    by_stem: Dict[str, str] = {}
    if not os.path.isdir(directory):
        return []
    for name in sorted(os.listdir(directory)):
        if name.startswith("."):
            continue  # dotfiles, incl. orphaned ImgData atomic-write temps
        stem, ext = os.path.splitext(name)
        if ext.lower() not in IMAGE_EXTS:
            continue
        cur = by_stem.get(stem)
        if cur is None or IMAGE_EXTS.index(ext.lower()) < IMAGE_EXTS.index(
            os.path.splitext(cur)[1].lower()
        ):
            by_stem[stem] = os.path.join(directory, name)
    return [by_stem[s] for s in sorted(by_stem)]


def find_golden(golden_dir: str, stem: str) -> Optional[str]:
    for ext in IMAGE_EXTS:
        p = os.path.join(golden_dir, stem + ext)
        if os.path.exists(p):
            return p
    return None


def safe_run_dir(base_out: str, device_info: str) -> str:
    sub = re.sub(r"[^A-Za-z0-9_.-]+", "_", device_info) or "run"
    path = os.path.join(base_out, sub)
    os.makedirs(path, exist_ok=True)
    return path


class ImageDataset:
    """Round-robin dataset of images with optional goldens."""

    def __init__(
        self,
        dir_to_data: str,
        dir_to_data_out: Optional[str] = None,
        dir_to_data_out_gt: Optional[str] = None,
        reset_out: bool = True,
        extra_links_to_png: Optional[Sequence[str]] = None,
    ):
        self.dir_to_data = dir_to_data
        self.dir_to_data_out = dir_to_data_out or os.path.join(dir_to_data, "..", "data_out")
        self.dir_to_data_out_gt = dir_to_data_out_gt or os.path.join(
            dir_to_data, "..", "data_out_gt"
        )
        # reset the out dir BEFORE downloading: a protected data dir
        # redirects downloads under dir_to_data_out, which the reset wipes
        if reset_out and not _is_protected(self.dir_to_data_out):
            shutil.rmtree(self.dir_to_data_out, ignore_errors=True)
        os.makedirs(self.dir_to_data_out, exist_ok=True)
        self.paths = scan_images(dir_to_data)
        self.paths += self._download_extras(extra_links_to_png or ())
        if not self.paths:
            raise FileNotFoundError(f"no images found in {dir_to_data!r}")
        self._idx = 0
        self._load_cache: Dict[str, Tuple[str, ImgData]] = {}

    def _download_extras(self, links: Sequence[str]) -> List[str]:
        """Downloaded PNGs extend the dataset (reference
        lab2_processor.py:68-73: each extra link lands in the data dir
        under a uuid name).  A protected or read-only data dir redirects
        the download next to the outputs; a failed download is skipped
        with a log line, not fatal."""
        if isinstance(links, str):  # a bare --extra_links_to_png URL
            links = [links]
        if not links:
            return []
        save_dir = self.dir_to_data
        if _is_protected(save_dir) or not os.access(save_dir, os.W_OK):
            save_dir = os.path.join(self.dir_to_data_out, "_downloads")
        got = []
        for url in links:
            path = download_file(url, save_dir, filename=f"{uuid.uuid4()}.png")
            if path:
                got.append(path)
        return got

    def next_item(self) -> Tuple[str, Optional[str]]:
        """(input path, golden path or None), round-robin.

        Call while holding the processor lock."""
        path = self.paths[self._idx % len(self.paths)]
        self._idx += 1
        stem = os.path.splitext(os.path.basename(path))[0]
        golden = find_golden(self.dir_to_data_out_gt, stem)
        return path, golden

    def out_path_for(self, input_path: str, device_info: str) -> str:
        stem = os.path.splitext(os.path.basename(input_path))[0]
        return os.path.join(
            safe_run_dir(self.dir_to_data_out, device_info), stem + ".data"
        )

    def input_as_data_file(self, path: str) -> Tuple[str, ImgData]:
        """Ensure a ``.data`` sibling exists (binaries consume ``.data``);
        returns ``(data_path, loaded image)``.  Loads are cached per path
        so repeated sweep runs don't re-parse the same fixture, and
        protected (read-only) source dirs fall back to materializing the
        ``.data`` copy under ``dir_to_data_out/_materialized``."""
        cached = self._load_cache.get(path)
        if cached is not None:
            return cached
        if path.lower().endswith(".data"):
            result = path, ImgData(path, materialize=False)
        else:
            img = ImgData(path)  # materializes missing siblings next to source
            sibling = os.path.join(img.dir2save, img.data_name + ".data")
            if not os.path.exists(sibling):
                # read-only source dir: materialize into data_out instead
                mat_dir = os.path.join(self.dir_to_data_out, "_materialized")
                os.makedirs(mat_dir, exist_ok=True)
                sibling = os.path.join(mat_dir, img.data_name + ".data")
                if not os.path.exists(sibling):
                    # tmp keeps the .data suffix (save_image dispatches on it)
                    tmp = os.path.join(
                        mat_dir, f".{img.data_name}.tmp{os.getpid()}.data"
                    )
                    save_image(tmp, img.pixels)
                    os.replace(tmp, sibling)
            result = sibling, img
        self._load_cache[path] = result
        return result

    def verify_golden(
        self,
        result: ImgData,
        golden_path: Optional[str],
        in_path: str,
        log=print,
        verbose_diff: bool = True,
    ) -> bool:
        """Exact-bytes comparison against the golden image; golden-less
        images are benchmark-only and pass automatically (reference
        lab2_processor.py:136-139, :142-160)."""
        if golden_path is None:
            return True
        expect = ImgData(golden_path, materialize=False)
        ok = result.c_data_bytes == expect.c_data_bytes
        if not ok and verbose_diff:
            log(
                f"[verify_result] mismatch for {in_path}\n"
                f"  actual:   {result.hex[:160]}...\n"
                f"  expected: {expect.hex[:160]}..."
            )
        return ok
