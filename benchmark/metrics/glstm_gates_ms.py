"""Device ms per training step in the gLSTM cells' gate math, the
``glstm.gates`` spans of ``models/gconv_lstm.py GConvLSTMCell.step`` (the
sum of the two filters' outputs and the bias, the four gates and the
``(c, h)`` update), each timed by CUDA events; forward only, as the
spans are (layer: recurrence; ``harness/spans.py``)."""

from harness import spans

GATES = {"glstm.gates"}


def read(ctx):
    return spans.device_ms(ctx, GATES)
