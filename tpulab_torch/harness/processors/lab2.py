"""lab2 processor: image dataset + exact-bytes golden verification.

Reference behavior (lab2/lab2_processor.py): stdin is
``"<input.data>\\n<output path>"``; verification is **exact hex equality**
of the produced image against the golden (lab2_processor.py:142-144) with
a verbose diff dump on mismatch; images without a golden are
benchmark-only and pass automatically (lab2_processor.py:136-139).
"""

from __future__ import annotations

import os
from typing import Any, Optional

from tpulab_torch.harness.base import PreparedRun, WorkloadProcessor
from tpulab_torch.harness.processors.imageset import ImageDataset
from tpulab_torch.utils.imgdata import ImgData

DEFAULT_DATA_DIR = os.path.join(os.path.dirname(__file__), "../../../data/lab2/data")


class Lab2Processor(WorkloadProcessor):

    def __init__(
        self,
        seed: int = 42,
        dir_to_data: Optional[str] = None,
        dir_to_data_out: Optional[str] = None,
        dir_to_data_out_gt: Optional[str] = None,
        verbose_diff: bool = True,
        extra_links_to_png: Optional[list] = None,
        log=print,
        **_ignored,
    ):
        super().__init__(seed=seed)
        self.dataset = ImageDataset(
            os.path.normpath(dir_to_data or DEFAULT_DATA_DIR),
            dir_to_data_out,
            dir_to_data_out_gt,
            extra_links_to_png=extra_links_to_png,
        )
        self.verbose_diff = verbose_diff
        self.log = log

    def get_attrs(self):
        return {"seed": self.seed, "n_images": len(self.dataset.paths)}

    async def pre_process(self, device_info: str = "", **kwargs) -> PreparedRun:
        async with self._lock:
            in_path, golden = self.dataset.next_item()
        in_data, img = self.dataset.input_as_data_file(in_path)
        out_path = self.dataset.out_path_for(in_path, device_info)
        return PreparedRun(
            stdin_text=f"{in_data}\n{out_path}\n",
            verify_ctx={"golden": golden, "out_path": out_path, "in_path": in_data},
            metadata={
                "image": os.path.basename(in_path),
                "size_kb": round(img.size, 2),
                "wh": f"{img.width}x{img.height}",
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
