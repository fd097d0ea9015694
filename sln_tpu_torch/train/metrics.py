"""Structured metrics logging (counterpart of sln_tpu/train/metrics.py):
an append-only JSONL stream per run, plus helpers to read and summarize
it."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, step: int, **values: float) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_metrics(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize(records: Iterable[Dict[str, Any]], key: str
              ) -> Dict[str, float]:
    vals = [r[key] for r in records if key in r]
    if not vals:
        return {}
    return {"first": vals[0], "last": vals[-1], "min": min(vals),
            "max": max(vals), "count": len(vals)}
