"""lab3 processor: image dataset + class definitions + exact golden check.

Reference behavior (lab3/lab3_processor.py): the golden fixture's class
definition points are pinned (MAP_TO_INIT_POINTS, :42-51 — 2 classes x 4
points); other images get seeded-random class points bounded by
``MAX_CLASSES`` (:119-126); stdin appends ``nc`` then per-class
``"np x1 y1 x2 y2 ..."`` rows; verification is exact-bytes vs golden.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from tpulab_torch.harness.base import PreparedRun, WorkloadProcessor
from tpulab_torch.harness.processors.imageset import ImageDataset
from tpulab_torch.io import protocol
from tpulab_torch.ops.mahalanobis import MAX_CLASSES
from tpulab_torch.utils.imgdata import ImgData

DEFAULT_DATA_DIR = os.path.join(os.path.dirname(__file__), "../../../data/lab3/data")

#: pinned class definitions for golden fixtures: stem -> list of (np, 2)
#: coordinate arrays.  ``test_01_lab3`` reproduces the reference harness's
#: hard-coded points (lab3/lab3_processor.py:42-51); the rest belong to
#: this repo's own fixtures (tools/gen_fixtures.py keeps goldens in sync).
PINNED_CLASS_POINTS: Dict[str, List[np.ndarray]] = {
    "test_01_lab3": [
        np.array([[1, 2], [1, 0], [2, 2], [2, 1]]),
        np.array([[0, 0], [0, 1], [1, 1], [2, 0]]),
    ],
    "checker_6x6": [
        np.array([[0, 0], [2, 0], [4, 2], [0, 4]]),
        np.array([[1, 0], [3, 0], [5, 2], [1, 4]]),
    ],
    "blobs_8x8": [
        np.array([[0, 0], [1, 0], [0, 1], [1, 1]]),
        np.array([[6, 6], [7, 6], [6, 7], [7, 7]]),
        np.array([[6, 0], [7, 0], [6, 1], [7, 1]]),
    ],
}


class Lab3Processor(WorkloadProcessor):

    def __init__(
        self,
        seed: int = 42,
        dir_to_data: Optional[str] = None,
        dir_to_data_out: Optional[str] = None,
        dir_to_data_out_gt: Optional[str] = None,
        count_classes: int = 2,
        count_pts: int = 4,
        pinned_points: Optional[Dict[str, List[np.ndarray]]] = None,
        verbose_diff: bool = True,
        extra_links_to_png: Optional[List[str]] = None,
        log=print,
        **_ignored,
    ):
        super().__init__(seed=seed)
        if count_classes > MAX_CLASSES:
            raise ValueError(f"count_classes > MAX_CLASSES ({MAX_CLASSES})")
        self.dataset = ImageDataset(
            os.path.normpath(dir_to_data or DEFAULT_DATA_DIR),
            dir_to_data_out,
            dir_to_data_out_gt,
            extra_links_to_png=extra_links_to_png,
        )
        self.count_classes = count_classes
        self.count_pts = max(2, count_pts)  # 1 point -> degenerate /(np-1)
        self.pinned_points = dict(PINNED_CLASS_POINTS)
        if pinned_points:
            self.pinned_points.update(pinned_points)
        self.verbose_diff = verbose_diff
        self.log = log

    def get_attrs(self):
        return {
            "seed": self.seed,
            "count_classes": self.count_classes,
            "n_images": len(self.dataset.paths),
        }

    def _points_for(self, stem: str, w: int, h: int) -> List[np.ndarray]:
        if stem in self.pinned_points:
            return self.pinned_points[stem]
        pts = []
        for _ in range(self.count_classes):
            xs = self.rng.integers(0, w, size=self.count_pts)
            ys = self.rng.integers(0, h, size=self.count_pts)
            pts.append(np.stack([xs, ys], axis=1))
        return pts

    async def pre_process(self, device_info: str = "", **kwargs) -> PreparedRun:
        async with self._lock:
            in_path, golden = self.dataset.next_item()
        in_data, img = self.dataset.input_as_data_file(in_path)
        out_path = self.dataset.out_path_for(in_path, device_info)
        stem = os.path.splitext(os.path.basename(in_path))[0]
        async with self._lock:
            classes = self._points_for(stem, img.width, img.height)
        text = protocol.format_lab3_input(in_data, out_path, classes)
        return PreparedRun(
            stdin_text=text,
            verify_ctx={"golden": golden, "out_path": out_path, "in_path": in_data},
            metadata={
                "image": os.path.basename(in_path),
                "wh": f"{img.width}x{img.height}",
                "nc": len(classes),
            },
        )

    async def load_result(self, stdout_payload: str, prepared: PreparedRun) -> Any:
        return ImgData(prepared.verify_ctx["out_path"], materialize=False)

    async def verify(self, result: Any, prepared: PreparedRun) -> bool:
        return self.dataset.verify_golden(
            result,
            prepared.verify_ctx["golden"],
            prepared.verify_ctx["in_path"],
            log=self.log,
            verbose_diff=self.verbose_diff,
        )
