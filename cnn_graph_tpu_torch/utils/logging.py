"""Experiment metrics logging.

Counterpart of ``cnn_graph_tpu/utils/logging.py MetricsLogger`` (:19):
an append-only JSONL stream with the same lines, a ``start`` event, a
``params`` event, one line per ``log(step, ...)`` and an ``end`` event,
with the same keys.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only JSONL metrics writer.

    Each ``log(step, **metrics)`` call writes one line ``{"step": ...,
    "time": ..., **metrics}``; ``scalars`` keeps each key's history in
    memory.  Without a ``path`` nothing is written.
    """

    def __init__(self, path: str | None = None, run_name: str = "run"):
        self.path = path
        self.run_name = run_name
        self.scalars: dict[str, list] = {}
        self._t0 = time.time()
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
            self._write({"event": "start", "run": run_name})

    def _write(self, record: dict):
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def log(self, step: int, **metrics):
        for k, v in metrics.items():
            self.scalars.setdefault(k, []).append((step, v))
        self._write({"step": step,
                     "time": round(time.time() - self._t0, 3), **metrics})

    def log_params(self, params: dict):
        self._write({"event": "params", **params})

    def close(self):
        if self._fh:
            self._write({"event": "end"})
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
