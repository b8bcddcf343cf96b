"""Datasets: the MNIST grid-graph data and its preprocessing, the text
datasets of the 20NEWS and RCV1 word graphs, the HumanTraffic flow
datasets with their STL normalization, the synthetic generators, and
the RData reader."""

from cnn_graph_tpu_torch.data.humantraffic import FlowSplits, HumanTraffic
from cnn_graph_tpu_torch.data.mnist import (
    load_mnist,
    mnist_graph_data,
    synthetic_mnist,
)
from cnn_graph_tpu_torch.data.synthetic import (
    community_classification,
    synthetic_flow,
)
from cnn_graph_tpu_torch.data.text import (
    Text20News,
    TextDataset,
    TextRCV1,
    synthetic_text_dataset,
)

__all__ = ["FlowSplits", "HumanTraffic", "Text20News", "TextDataset",
           "TextRCV1", "community_classification", "load_mnist",
           "mnist_graph_data", "synthetic_flow", "synthetic_mnist",
           "synthetic_text_dataset"]
