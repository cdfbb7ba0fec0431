"""Structured per-frame logging (JSONL).

The port's copy of ``rgbid_tpu/utils/logging.py``: one JSON object per
frame (pose, residual stats, timing), plus run metadata with the config
hash so every result is attributable to an exact configuration.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

import numpy as np


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class JsonlLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f: Optional[IO] = open(path, "w") if path else None

    def write(self, record: dict) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(_jsonable(record)) + "\n")

    def header(self, config, intrinsics) -> None:
        self.write(
            {
                "type": "run_header",
                "time": time.time(),
                "config_hash": config.config_hash(),
                "config": config.to_dict(),
                "intrinsics": list(intrinsics),
            }
        )

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
