"""Median host ms of a request's ``serve.request`` span: the program's own
dispatch, from the handle's entry to its return, before the harness
waits for the device (layer: dispatch; read from the program's spans,
``harness/spans.py``)."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx)
