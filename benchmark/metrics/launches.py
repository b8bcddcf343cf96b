"""Device kernels launched per request or step, all kernels counted (layer:
dispatch)."""

from harness import readers


def read(ctx):
    return readers.launches(ctx)
