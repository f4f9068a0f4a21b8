"""Open CLI-kwargs config tier.

The reference forwards any unknown ``--key value`` flag to the workload
processor constructor after type coercion (reference ``arg_parsing.py:1-31``,
``run_test.py:52``); this module is the equivalent coercion layer with a
fixed bool/int/float/json/str priority.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

_BOOL = {"true": True, "false": False, "yes": True, "no": False}


def coerce_value(raw: str) -> Any:
    low = raw.strip().lower()
    if low in _BOOL:
        return _BOOL[low]
    if low in ("none", "null"):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if raw[:1] in "[{":
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            pass
    return raw


def coerce_cli_kwargs(unknown: List[str]) -> Dict[str, Any]:
    """``["--seed", "7", "--flag"]`` -> ``{"seed": 7, "flag": True}``."""
    kwargs: Dict[str, Any] = {}
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected positional token: {tok!r}")
        if "=" in tok:
            key, _, raw = tok[2:].partition("=")
            kwargs[key.replace("-", "_")] = coerce_value(raw)
            i += 1
        else:
            key = tok[2:].replace("-", "_")
            if i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
                kwargs[key] = coerce_value(unknown[i + 1])
                i += 2
            else:
                kwargs[key] = True  # bare flag
                i += 1
    return kwargs
