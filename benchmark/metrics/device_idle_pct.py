"""Share of the traced window (%) in which no kernel, copy or set ran on
the device (layer: device)."""

from harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
