"""gpu_info — device introspection (the reference's ``gpu_info`` tool).

Reference ``gpu_info/src/main.cu:4-19`` prints compute capability, memory
sizes, launch limits and SM count for device 0; this prints the same
fields, read through ``torch.cuda.get_device_properties``, for every
visible card (or the host, with ``--backend cpu``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpulab_torch.runtime.device import format_device_info, resolve_device


def run(
    text: str = "",
    sweep: bool = False,
    backend: Optional[str] = None,
    **_ignored,
) -> str:
    device = resolve_device(backend)
    if device.type == "cpu":
        return f"Device cpu:\n{format_device_info(device)}\n"
    blocks = [
        f"Device {i}:\n{format_device_info(torch.device('cuda', i))}"
        for i in range(torch.cuda.device_count())
    ]
    return "\n\n".join(blocks) + "\n"
