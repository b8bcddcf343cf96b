"""Models of the port: the transductive NodeClassifier, the ChebNet
graph-CNN classifier, and the flow-forecasting family (ResGNN, the gLSTM
cell and its stack, the 12 GConvForecaster variants, GConvRNN and the
graph-free PerNodeLSTM baseline)."""

from cnn_graph_tpu_torch.models.chebnet import ChebNet, bspline_basis
from cnn_graph_tpu_torch.models.forecasting import (
    FORECAST_VARIANTS,
    GConvForecaster,
)
from cnn_graph_tpu_torch.models.gconv_lstm import (
    GConvLSTMCell,
    glstm_stack_apply,
    glstm_stack_init,
)
from cnn_graph_tpu_torch.models.gconv_rnn import GConvRNN
from cnn_graph_tpu_torch.models.node_classifier import NodeClassifier
from cnn_graph_tpu_torch.models.node_lstm import (
    PerNodeLSTM,
    stack_lstm_collection,
)
from cnn_graph_tpu_torch.models.resgnn import ResGNN

__all__ = [
    "ChebNet",
    "bspline_basis",
    "FORECAST_VARIANTS",
    "GConvForecaster",
    "GConvLSTMCell",
    "GConvRNN",
    "NodeClassifier",
    "PerNodeLSTM",
    "glstm_stack_apply",
    "glstm_stack_init",
    "ResGNN",
    "stack_lstm_collection",
]
