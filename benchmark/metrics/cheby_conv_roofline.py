"""K2/K3, csrc/cheby_fused.cu cheby_conv_kernel: the least time of the
convs its launches carry, hops plus taps (and dW), over their device
time, % (layer: kernel cheby_conv_kernel)."""

from harness import readers

KERNEL = "cheby_conv_kernel"  # csrc/cheby_fused.cu (K2, K3)


def read(ctx):
    return readers.roofline_pct(ctx, KERNEL)
