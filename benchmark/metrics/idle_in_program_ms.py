"""Device idle ms per request or step in the stretches whose middle falls
inside the unit's span (``serve.request``, ``train.step``): idle that
the program's host code holds, as against the harness's loop (layer:
device; the trace's idle stretches, ``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.idle_in_program_ms(ctx)
