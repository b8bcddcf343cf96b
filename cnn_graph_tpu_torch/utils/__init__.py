"""Measurement helpers: device timing and rooflines (``profiling``);
the evaluation metrics (``metrics``) and the JSONL metrics stream
(``logging``) are imported from their modules."""

from cnn_graph_tpu_torch.utils.profiling import (
    H100_BYTES_PER_S,
    H100_OPS_PER_S,
    roofline,
    slope_time,
    sparse_roofline,
    spmm_roofline,
)

__all__ = ["H100_BYTES_PER_S", "H100_OPS_PER_S", "roofline", "slope_time",
           "sparse_roofline", "spmm_roofline"]
