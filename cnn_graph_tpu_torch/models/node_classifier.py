"""Transductive node classification over a Chebyshev conv stack.

Counterpart of ``cnn_graph_tpu/models/node_classifier.py:30``.  The whole
graph is one sample: features ``[M, Fin]`` become activations
``[1, M, Fin]`` so the spectral ops apply unchanged; logits are
``[M, classes]``.

Parameters use the JAX package's layout, ``{"convs": [{"w": [K, Fin,
Fout], "b": [Fout]}, ...]}``; ``apply(params, features)`` runs on any
such tree (``convert.node_classifier_params_from_jax`` makes one from
JAX weights) and ``forward(features)`` on the module's own parameters,
in eval mode.  ``train.train_node_classifier`` trains it with adam.
"""

from __future__ import annotations

import torch
from torch import nn

from cnn_graph_tpu_torch.models import common
from cnn_graph_tpu_torch.ops.filters import cheby_conv

__all__ = ["NodeClassifier"]


class NodeClassifier(nn.Module):
    """Per-node softmax classifier over a Chebyshev conv stack.

    ``hidden``: list of hidden widths; ``K``: polynomial order per layer;
    ``dropout``: keep probability after each hidden layer in training;
    ``residual``: add a hidden layer's input to its output where the
    widths match.  Weights are drawn from ``generator`` (truncated normal,
    std 0.1), biases start at zero; they live on ``device``, by default
    the operator's.  Note that ``apply`` here is the
    JAX-style functional forward and shadows ``nn.Module.apply``.

    ``input_grad`` (default False): layer 0 declares that no gradient
    with respect to the input features is consumed, so on banded
    operators its backward skips the adjoint chain.  Then ``features``
    gets no gradient at all (``features.grad`` stays ``None``; the JAX
    model returns zeros there).  Pass ``input_grad=True`` for saliency
    maps or a differentiable front end feeding the features.  Other
    formats ignore it, as in JAX: there autograd runs no backward hop for
    features that need no gradient.
    """

    def __init__(self, operator, input_features: int, num_classes: int,
                 hidden=(64,), K: int = 3, dropout: float = 1.0,
                 residual: bool = False, input_grad: bool = False, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if device is None:
            device = common.operator_device(operator)
        self.op = operator
        self.Fin = input_features
        self.C = num_classes
        self.hidden = list(hidden)
        self.K = K
        self.dropout = dropout
        self.residual = residual
        self.input_grad = input_grad
        widths = [self.Fin] + self.hidden + [self.C]
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for fin, fout in zip(widths[:-1], widths[1:]):
            self.weights.append(nn.Parameter(common.trunc_normal(
                (K, fin, fout), generator=generator, device=device)))
            self.biases.append(nn.Parameter(
                torch.zeros(fout, device=device)))

    def param_tree(self) -> dict:
        """The module's parameters in the JAX package's layout."""
        return {"convs": [{"w": w, "b": b}
                          for w, b in zip(self.weights, self.biases)]}

    def apply(self, params, features: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """``features``: ``[M, Fin]`` -> logits ``[M, classes]``.
        ``train`` turns dropout on, drawing from ``generator``."""
        x = features[None]
        n = len(params["convs"])
        if train and common.is_sharded(self.op) and generator is not None:
            # The unsharded mask, this rank's rows of it.
            generator = common.shard_draw(generator, 1, self.op.row_range[0],
                                          self.op.m_padded)
        for i, layer in enumerate(params["convs"]):
            h = cheby_conv(x, self.op, layer["w"],
                           input_grad=(i > 0 or self.input_grad)) + layer["b"]
            if i < n - 1:
                h = torch.relu(h)
                if self.residual and h.shape[-1] == x.shape[-1]:
                    h = h + x
                h = common.dropout(h, self.dropout, train, generator)
            x = h
        return x[0]

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.apply(self.param_tree(), features)

    def loss(self, params, features, labels, mask=None, *,
             train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Masked mean cross-entropy: ``labels`` ``[M]`` int, ``mask``
        ``[M]`` bool selects the labeled nodes (None: all).  On a
        node-sharded operator the arguments are this rank's rows, and
        the masked sum and count are summed over the ``nodes`` axis
        before the division (the gradients are this rank's share)."""
        logp = torch.log_softmax(
            self.apply(params, features, train=train, generator=generator),
            dim=1)
        picked = logp.gather(1, labels[:, None].long())[:, 0]
        if not common.is_sharded(self.op):
            if mask is None:
                return -picked.mean()
            mask = mask.to(picked.dtype)
            return -(picked * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        from cnn_graph_tpu_torch.parallel.mesh import node_sum

        mask = (torch.ones_like(picked) if mask is None
                else mask.to(picked.dtype))
        total = node_sum(-(picked * mask).sum(), self.op.mesh)
        count = self.op.mesh.all_reduce(mask.sum().detach(), "nodes")
        return total / torch.clamp_min(count, 1.0)

    def accuracy(self, params, features, labels, mask=None) -> torch.Tensor:
        """The masked share of nodes whose argmax is the label, over every
        rank's rows of a node-sharded operator."""
        pred = self.apply(params, features).argmax(dim=1)
        correct = (pred == labels).to(torch.float32)
        if not common.is_sharded(self.op):
            if mask is None:
                return correct.mean()
            mask = mask.to(torch.float32)
            return (correct * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        mask = (torch.ones_like(correct) if mask is None
                else mask.to(torch.float32))
        pair = self.op.mesh.all_reduce(
            torch.stack([(correct * mask).sum(), mask.sum()]), "nodes")
        return pair[0] / torch.clamp_min(pair[1], 1.0)
