"""Device operators, the kernel wrappers and their custom ops
(``library``), the spectral filters (Chebyshev, Lanczos, Fourier) and
pooling."""

from cnn_graph_tpu_torch.ops.band import (
    band_cheby_hop,
    band_cheby_hop_c,
    band_spmm,
    banded_dkw,
    banded_dkw_reference,
    banded_ragged,
    banded_ragged_reference,
    banded_rows_reference,
    banded_uniform,
    banded_uniform_reference,
)
from cnn_graph_tpu_torch.ops.bsr import (
    bsr_call_quant,
    bsr_cheby_hop,
    bsr_colstream,
    bsr_colstream_reference,
    bsr_csr,
    bsr_csr_reference,
    bsr_rows_reference,
    bsr_spmm,
)
from cnn_graph_tpu_torch.ops.cheby import (
    cheby_conv_fused,
    cheby_conv_fused_reference,
    cheby_dw_fused,
    cheby_dw_fused_reference,
    conv_geometry,
    conv_resources,
    fused_filter,
)
from cnn_graph_tpu_torch.ops.filters import (
    cheby_basis,
    cheby_conv,
    cheby_conv_banded,
    cheby_weights_from_flat,
    fourier_conv,
    lanczos_basis_device,
    lanczos_conv,
)
from cnn_graph_tpu_torch.ops.laplacian import (
    BandedLaplacian,
    BlockSparseLaplacian,
    DenseLaplacian,
    QuantBandedLaplacian,
    QuantBlockSparseLaplacian,
    QuantDenseLaplacian,
    cheby_finals,
    device_laplacian,
    quantize_banded,
    quantize_block_sparse,
    quantize_dense,
)
from cnn_graph_tpu_torch.ops.pooling import avg_pool, max_pool

# Registers the kernels as torch custom ops, which the wrappers call.
from cnn_graph_tpu_torch.ops import library  # noqa: E402,F401

__all__ = [
    "band_cheby_hop",
    "band_cheby_hop_c",
    "band_spmm",
    "banded_dkw",
    "banded_dkw_reference",
    "banded_ragged",
    "banded_ragged_reference",
    "banded_rows_reference",
    "banded_uniform",
    "banded_uniform_reference",
    "bsr_call_quant",
    "bsr_cheby_hop",
    "bsr_colstream",
    "bsr_colstream_reference",
    "bsr_csr",
    "bsr_csr_reference",
    "bsr_rows_reference",
    "bsr_spmm",
    "cheby_basis",
    "cheby_conv_fused",
    "cheby_conv_fused_reference",
    "cheby_dw_fused",
    "cheby_dw_fused_reference",
    "conv_geometry",
    "conv_resources",
    "fused_filter",
    "cheby_conv",
    "cheby_conv_banded",
    "cheby_weights_from_flat",
    "fourier_conv",
    "lanczos_basis_device",
    "lanczos_conv",
    "BandedLaplacian",
    "BlockSparseLaplacian",
    "DenseLaplacian",
    "QuantBandedLaplacian",
    "QuantBlockSparseLaplacian",
    "QuantDenseLaplacian",
    "cheby_finals",
    "device_laplacian",
    "quantize_banded",
    "quantize_block_sparse",
    "quantize_dense",
    "avg_pool",
    "max_pool",
]
