"""Completion notifications for long-running experiments.

Counterpart of ``cnn_graph_tpu/utils/notify.py`` (``send_notification``
:21), its own copy.  Sinks are pluggable: ``file:<path>`` appends one
JSON line per notification, ``print`` (the default) writes to stdout,
``http:``/``https:`` URLs get the JSON posted.  A failing sink never
breaks the experiment.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["send_notification"]


def send_notification(message: str, sink: str | None = None, **fields):
    """Best-effort notification; never raises.  Returns whether the sink
    took it.

    ``sink``: ``print`` (default), ``file:<path>`` or ``http(s):<url>``;
    the ``CNN_GRAPH_NOTIFY`` environment variable sets it globally."""
    sink = sink or os.environ.get("CNN_GRAPH_NOTIFY", "print")
    record = {"time": time.strftime("%Y-%m-%d %H:%M:%S"),
              "message": message, **fields}
    try:
        if sink.startswith("file:"):
            with open(sink[5:], "a") as f:
                f.write(json.dumps(record) + "\n")
        elif sink.startswith("http:") or sink.startswith("https:"):
            import urllib.request

            req = urllib.request.Request(
                sink, data=json.dumps(record).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5)
        else:
            print(f"[notify] {record}")
        return True
    except Exception:
        return False
