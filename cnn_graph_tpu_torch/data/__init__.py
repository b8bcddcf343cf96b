"""Datasets: the MNIST grid-graph data (synthetic digits) and its
preprocessing."""

from cnn_graph_tpu_torch.data.mnist import mnist_graph_data, synthetic_mnist

__all__ = ["mnist_graph_data", "synthetic_mnist"]
