"""Training loops."""

from cnn_graph_tpu_torch.train.node_classification import train_node_classifier

__all__ = ["train_node_classifier"]
