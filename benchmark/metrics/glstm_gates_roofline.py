"""The gLSTM cells' gate math against its least traffic: the program's
``glstm_gate_bytes`` counter (44 H bytes a node and sample a cell step:
both filters' outputs and c read, c and h written, f32) at 3.35 TB/s
over the device time of the ``glstm.gates`` spans, % (layer:
recurrence; ``harness/spans.py``)."""

from harness import spans
from harness.work import PEAK_BYTES


def read(ctx):
    nbytes = spans.counter(ctx, "glstm_gate_bytes")
    if not nbytes:
        ctx.note("no glstm_gate_bytes counted in the window's units")
        return None
    ms = spans.device_ms(ctx, {"glstm.gates"})
    if ms is None:
        return None
    return 100.0 * nbytes / PEAK_BYTES / (ms * 1e-3)
