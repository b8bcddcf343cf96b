"""Model FLOP utilization (%): the work of each request or step counted
from the configuration's shapes and the graph's nonzeros
(harness/work.py), at the data-sheet peak rate of its type, over the
traced time (layer: models)."""

from harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
