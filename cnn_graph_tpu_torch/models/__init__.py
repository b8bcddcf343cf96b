"""Models of the port: the transductive NodeClassifier and the ChebNet
graph-CNN classifier."""

from cnn_graph_tpu_torch.models.chebnet import ChebNet
from cnn_graph_tpu_torch.models.node_classifier import NodeClassifier

__all__ = ["ChebNet", "NodeClassifier"]
