"""Full-batch adam training of the transductive NodeClassifier.

Counterpart of the loop that ``experiments/node_classification.py:146-176``
and ``bench.py:276-297`` run with ``optax.adam``: each step takes the
masked cross-entropy and its gradient at the current parameters, then
one adam update.  ``train.adam_steps`` runs the update, ``optax.adam``'s, so
the JAX trajectory is the reference.  On a node-sharded operator every
rank runs the loop on its rows, and the gradients are summed over the
mesh's ``nodes`` axis (and averaged over ``data``) before each update.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.train.classification import adam_steps

__all__ = ["train_node_classifier"]


def train_node_classifier(model, params, features, labels, mask, *,
                          steps: int, learning_rate: float,
                          generator: torch.Generator | None = None):
    """Run ``steps`` adam steps on ``model.loss(params, features, labels,
    mask, train=True)``.  ``params`` is left untouched; ``generator``
    draws the dropout masks.  Returns ``(trained params, losses)``: the
    params in the same tree layout, detached, and a ``[steps]`` f32
    tensor of each step's loss before its update.  Nothing here waits
    for the device."""
    return adam_steps(
        params,
        lambda p, _: model.loss(p, features, labels, mask, train=True,
                                generator=generator),
        steps=steps, learning_rate=learning_rate,
        mesh=getattr(model.op, "mesh", None))
