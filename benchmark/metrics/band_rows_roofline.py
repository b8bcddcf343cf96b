"""K1, csrc/band.cu band_rows_kernel: the least time of the hops its
launches carry (harness/work.py) over their device time, % (layer:
kernel band_rows_kernel)."""

from harness import readers

KERNEL = "band_rows_kernel"  # csrc/band.cu (K1, K5, K6)


def read(ctx):
    return readers.roofline_pct(ctx, KERNEL)
