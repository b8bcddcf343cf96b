"""Device operators, the banded kernel wrappers and the spectral filters."""

from cnn_graph_tpu_torch.ops.band import (
    band_cheby_hop,
    band_cheby_hop_c,
    band_spmm,
    banded_dkw,
    banded_dkw_reference,
)
from cnn_graph_tpu_torch.ops.filters import (
    cheby_basis,
    cheby_conv,
    cheby_conv_banded,
)
from cnn_graph_tpu_torch.ops.laplacian import (
    BandedLaplacian,
    DenseLaplacian,
    QuantBandedLaplacian,
    device_laplacian,
    quantize_banded,
)

__all__ = [
    "band_cheby_hop",
    "band_cheby_hop_c",
    "band_spmm",
    "banded_dkw",
    "banded_dkw_reference",
    "cheby_basis",
    "cheby_conv",
    "cheby_conv_banded",
    "BandedLaplacian",
    "DenseLaplacian",
    "QuantBandedLaplacian",
    "device_laplacian",
    "quantize_banded",
]
