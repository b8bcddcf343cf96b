"""Device operators, the kernel wrappers, the spectral filters and
pooling."""

from cnn_graph_tpu_torch.ops.band import (
    band_cheby_hop,
    band_cheby_hop_c,
    band_spmm,
    banded_dkw,
    banded_dkw_reference,
)
from cnn_graph_tpu_torch.ops.cheby import (
    cheby_conv_fused,
    cheby_conv_fused_reference,
    cheby_dw_fused,
    cheby_dw_fused_reference,
    fused_filter,
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
from cnn_graph_tpu_torch.ops.pooling import avg_pool, max_pool

__all__ = [
    "band_cheby_hop",
    "band_cheby_hop_c",
    "band_spmm",
    "banded_dkw",
    "banded_dkw_reference",
    "cheby_basis",
    "cheby_conv_fused",
    "cheby_conv_fused_reference",
    "cheby_dw_fused",
    "cheby_dw_fused_reference",
    "fused_filter",
    "cheby_conv",
    "cheby_conv_banded",
    "BandedLaplacian",
    "DenseLaplacian",
    "QuantBandedLaplacian",
    "device_laplacian",
    "quantize_banded",
    "avg_pool",
    "max_pool",
]
