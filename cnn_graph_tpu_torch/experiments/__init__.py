"""The experiment drivers of the port, run as modules:

    python -m cnn_graph_tpu_torch.experiments.mnist
    python -m cnn_graph_tpu_torch.experiments.text20news --synthetic
    python -m cnn_graph_tpu_torch.experiments.rcv1
    python -m cnn_graph_tpu_torch.experiments.humanflow
    python -m cnn_graph_tpu_torch.experiments.node_classification
    python -m cnn_graph_tpu_torch.experiments.usage_demo
    python -m cnn_graph_tpu_torch.experiments.gconv_sweep
    python -m cnn_graph_tpu_torch.experiments.multichip {wrapper,chain,comm}

Each is the JAX package's driver of the same name (``experiments/``)
on the port, on the card unless ``--device cpu`` is given.
"""
