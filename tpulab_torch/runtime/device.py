"""Device selection and introspection.

``--backend`` picks the device: ``cuda`` (the default) or ``cpu``.  With
no card visible and no ``cpu`` request, :func:`resolve_device` raises —
nothing falls back to the CPU on its own.

:func:`device_info` is the reference's ``gpu_info`` tool (reference
``gpu_info/src/main.cu:4-19``: compute capability, memory sizes, launch
limits, SM count), read from ``torch.cuda.get_device_properties``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

BACKENDS = ("cuda", "cpu")

#: Launch limits of every CUDA card of compute capability 3.0 and later
#: (CUDA C++ Programming Guide, "Technical Specifications per Compute
#: Capability").  The kernel wrappers refuse a geometry outside them
#: before they launch.
LAUNCH_LIMITS = {
    "max_threads_per_block": 1024,
    "max_block_dim": (1024, 1024, 64),
    "max_grid_dim": (2**31 - 1, 65535, 65535),
}


def resolve_device(backend: Optional[str] = None) -> torch.device:
    """Map a ``--backend`` value to a ``torch.device``.

    ``None`` and ``"cuda"`` mean the current CUDA card; ``"cpu"`` is the
    only way onto the host.
    """
    name = "cuda" if backend is None else str(backend).lower()
    if name == "cpu":
        from tpulab_torch.runtime.fpenv import ensure_nearest

        ensure_nearest()  # ROADMAP C7: the CPU path's bits assume round-to-nearest
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass --backend cpu (backend='cpu') "
            "to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def device_count(device: torch.device) -> int:
    """Devices of ``device``'s type that a multi-device run could use."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def device_label(device: torch.device) -> str:
    """Device word of the timing line: ``CUDA`` (the reference's own) or ``CPU``."""
    return "CUDA" if device.type == "cuda" else "CPU"


def device_info(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Structured device description (the ``gpu_info`` payload)."""
    device = resolve_device() if device is None else torch.device(device)
    if device.type == "cpu":
        return {"platform": "cpu", "num_threads": torch.get_num_threads()}
    index = device.index if device.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    info: Dict[str, Any] = {
        "platform": "cuda",
        "id": index,
        "name": props.name,
        "compute_capability": f"{props.major}.{props.minor}",
        "total_global_mem_bytes": props.total_memory,
        "multiprocessor_count": props.multi_processor_count,
        "num_devices": torch.cuda.device_count(),
        "cuda_runtime": torch.version.cuda,
    }
    # fields whose presence depends on the torch version
    for key in (
        "shared_memory_per_block",
        "shared_memory_per_block_optin",
        "shared_memory_per_multiprocessor",
        "regs_per_multiprocessor",
        "max_threads_per_multi_processor",
        "warp_size",
        "L2_cache_size",
    ):
        value = getattr(props, key, None)
        if value is not None:
            info[key] = value
    info.update(LAUNCH_LIMITS)
    return info


def format_device_info(device: Optional[torch.device] = None) -> str:
    """Human-readable multi-line report, one ``key: value`` pair per line."""
    lines: List[str] = [f"{k}: {v}" for k, v in device_info(device).items()]
    return "\n".join(lines)
