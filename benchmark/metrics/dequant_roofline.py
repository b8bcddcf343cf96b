"""The int8 carries' dequantisation, ``ops/laplacian.py QuantOpMixin.
dequantize``: the least time of the bytes its elements need (the
program's ``dequant_bytes`` counter, 1 read and 4 written an element) at
3.35 TB/s over the device time of its ``dequantize`` spans, % (layer:
conv and optimizer; ``harness/spans.py``)."""

from harness import spans
from harness.work import PEAK_BYTES


def read(ctx):
    nbytes = spans.counter(ctx, "dequant_bytes")
    if nbytes is None:
        return None
    ms = spans.device_ms(ctx, {"dequantize"})
    if ms is None:
        return None
    return 100.0 * nbytes / PEAK_BYTES / (ms * 1e-3)
