"""Training loops."""

from cnn_graph_tpu_torch.train.classification import (
    adam_steps,
    train_classifier,
)
from cnn_graph_tpu_torch.train.node_classification import train_node_classifier

__all__ = ["adam_steps", "train_classifier", "train_node_classifier"]
