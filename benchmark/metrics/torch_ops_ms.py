"""Device ms per request or step in kernels that are not the port's
hand-written ones: taps, dW, casts, (de)quantization, pooling, the
optimizer (layer: conv and optimizer)."""

from harness import readers

# The port's hand-written kernels (csrc/*.cu), by the names the trace gives.
HANDWRITTEN = ("band_rows_kernel", "bsr_rows_kernel", "cheby_conv_kernel")


def read(ctx):
    return readers.other_kernels_ms(ctx, HANDWRITTEN)
