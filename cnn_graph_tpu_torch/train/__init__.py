"""Training: the Trainer and its config, checkpoints, and the adam loops
that chip_smoke.py drives."""

from cnn_graph_tpu_torch.train.classification import (
    adam_steps,
    train_classifier,
)
from cnn_graph_tpu_torch.train.node_classification import train_node_classifier
from cnn_graph_tpu_torch.train.trainer import TrainConfig, Trainer

__all__ = ["TrainConfig", "Trainer", "adam_steps", "train_classifier",
           "train_node_classifier"]
