"""Datasets: the MNIST grid-graph data (synthetic digits) and its
preprocessing, and the text datasets of the 20NEWS and RCV1 word
graphs."""

from cnn_graph_tpu_torch.data.mnist import mnist_graph_data, synthetic_mnist
from cnn_graph_tpu_torch.data.text import (
    Text20News,
    TextDataset,
    TextRCV1,
    synthetic_text_dataset,
)

__all__ = ["Text20News", "TextDataset", "TextRCV1", "mnist_graph_data",
           "synthetic_mnist", "synthetic_text_dataset"]
