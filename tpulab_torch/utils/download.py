"""Streaming file download (the counterpart of ``tpulab.utils.download``;
reference ``utils/download_files.py:5-35``).

Used only for pulling optional extra benchmark PNGs; where the fetch
cannot happen (no ``requests``, no network) the function reports the
failure and returns None.
"""

from __future__ import annotations

import os
from typing import Optional


def download_file(url: str, save_dir: str, filename: Optional[str] = None) -> Optional[str]:
    """Download ``url`` into ``save_dir``; the path, or None on failure.
    An existing file of that name is returned without a fetch; a failed
    fetch leaves no partial file."""
    os.makedirs(save_dir, exist_ok=True)
    name = filename or url.rstrip("/").rsplit("/", 1)[-1]
    dest = os.path.join(save_dir, name)
    if os.path.exists(dest):
        return dest
    tmp = dest + ".part"
    try:
        import requests

        with requests.get(url, stream=True, timeout=30) as resp:
            resp.raise_for_status()
            with open(tmp, "wb") as f:
                for chunk in resp.iter_content(chunk_size=1 << 16):
                    f.write(chunk)
            os.replace(tmp, dest)
        return dest
    except Exception as exc:  # no requests, offline, HTTP errors
        if os.path.exists(tmp):
            os.remove(tmp)
        print(f"[download_file] skipped {url}: {exc}")
        return None
