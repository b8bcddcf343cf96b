"""Full-batch adam training of the transductive NodeClassifier.

Counterpart of the loop that ``experiments/node_classification.py:146-176``
and ``bench.py:276-297`` run with ``optax.adam``: each step takes the
masked cross-entropy and its gradient at the current parameters, then
one adam update.  ``torch.optim.Adam`` with ``betas=(0.9, 0.999)`` and
``eps=1e-8`` (added outside the square root) is ``optax.adam``'s update,
so the JAX trajectory is the reference.  The full ``TrainConfig`` /
``Trainer`` surface (trainer.py:38-238) is not ported yet.
"""

from __future__ import annotations

import torch

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
    params = {"convs": [{k: v.detach().clone().requires_grad_()
                         for k, v in layer.items()}
                        for layer in params["convs"]]}
    leaves = [t for layer in params["convs"] for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, features, labels, mask, train=True,
                          generator=generator)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    trained = {"convs": [{k: v.detach() for k, v in layer.items()}
                         for layer in params["convs"]]}
    return trained, torch.stack(losses)
