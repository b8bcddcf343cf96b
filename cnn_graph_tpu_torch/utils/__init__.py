"""Measurement helpers: step timers, traces, device timing and
rooflines (``profiling``); the evaluation metrics (``metrics``), the
JSONL metrics stream (``logging``), the experiment harness
(``harness``), notifications (``notify``) and plots (``plots``) are
imported from their modules."""

from cnn_graph_tpu_torch.utils.profiling import (
    H100_BYTES_PER_S,
    H100_OPS_PER_S,
    StepTimer,
    roofline,
    slope_time,
    sparse_roofline,
    spmm_roofline,
    trace,
)

__all__ = ["H100_BYTES_PER_S", "H100_OPS_PER_S", "StepTimer", "roofline",
           "slope_time", "sparse_roofline", "spmm_roofline", "trace"]
