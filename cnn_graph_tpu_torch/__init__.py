"""cnn_graph_tpu_torch: the PyTorch and CUDA port of cnn_graph_tpu.

Runs the spectral graph convolution framework on an NVIDIA H100.  The
JAX package ``cnn_graph_tpu`` beside it is the reference each part is
tested against; this package imports ``torch`` and never ``jax``.

Ported so far: the banded NodeClassifier, served (bf16, int8) and
trained, in the banded operator's three layouts on the CUDA kernels of
``csrc/band.cu``, and the ``cheby_finals`` chain; the paper's ChebNet on
the coarsened MNIST grid graph (``graphs``, ``data``), served and
trained, its fused dense Chebyshev conv and weight gradient on the CUDA
kernels of ``csrc/cheby_fused.cu``; the NodeClassifier on scattered
graphs through the BSR kernels of ``csrc/bsr.cu``;
``serve.compile_serving`` and the serving artifact
(``serve.export_serving``/``load_serving`` through ``torch.export``,
every kernel a torch custom op of ``ops.library``); the ``Trainer`` with its optax-equal
optimizer chain, checkpoints and metrics stream (``train``,
``utils.metrics``, ``utils.logging``); the 20NEWS/RCV1 text pipeline
(``data.text``); the Fourier, spline and Lanczos filters
(``ops.filters``, ``models.ChebNet``); the flow-forecasting family
(``models`` ResGNN, the gLSTM cell and forecasters, GConvRNN,
PerNodeLSTM; ``data.humantraffic``, ``data.stl``, ``data.rdata``); the
drivers of ``experiments``, the node-classification one included; and
the timers of ``utils.profiling``.  ROADMAP.md lists what is still to
come.
"""

__version__ = "0.1.0"
