"""Device ms per request or step in the tap work of ``ops/filters.py``:
the ``conv.taps``, ``conv.dW`` and ``conv.injections`` spans, each timed
by CUDA events (layer: conv and optimizer; ``harness/spans.py``)."""

from harness import spans

TAPS = {"conv.taps", "conv.dW", "conv.injections"}


def read(ctx):
    return spans.device_ms(ctx, TAPS)
