"""Minibatch adam training of a graph classifier such as ChebNet.

The loop that ``cnn_graph_tpu/train/trainer.py`` runs with
``optax.adam``, cut to its core: each step takes the loss and its
gradient on one batch at the current parameters, then one adam update.
``torch.optim.Adam`` with ``betas=(0.9, 0.999)`` and ``eps=1e-8`` (added
outside the square root) is ``optax.adam``'s update, so the JAX
trajectory is the reference.  ``train.Trainer`` is the full loop
(decay, EMA, evaluation, checkpoints); chip_smoke.py times this core
one beside it.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.models.common import tree_leaves, tree_map
from cnn_graph_tpu_torch.utils.profiling import span

__all__ = ["adam_steps", "train_classifier"]


def adam_steps(params, loss_of, *, steps: int, learning_rate: float,
               mesh=None):
    """Run ``steps`` adam steps on ``loss_of(params, step)``.  ``params``
    (a tree of tensors) is left untouched.  Returns ``(trained params,
    losses)``: the params in the same tree layout, detached, and a
    ``[steps]`` f32 tensor of each step's loss before its update.
    With a ``parallel.Mesh`` the gradients are made global
    (``Mesh.sync_grads``) before each update.  Nothing here waits for
    the device.  Each step is the unit span ``train.step``, its update
    the span ``train.optimizer``, timed on the card."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    opt = torch.optim.Adam(tree_leaves(params), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for step in range(steps):
        with span("train.step", unit=True):
            opt.zero_grad(set_to_none=True)
            loss = loss_of(params, step)
            loss.backward()
            if mesh is not None:
                mesh.sync_grads([p.grad for p in tree_leaves(params)])
            with span("train.optimizer", device=True):
                opt.step()
            losses.append(loss.detach())
    return tree_map(torch.Tensor.detach, params), torch.stack(losses)


def train_classifier(model, params, x: torch.Tensor, y: torch.Tensor, *,
                     batch_size: int, steps: int, learning_rate: float,
                     generator: torch.Generator | None = None):
    """``steps`` adam steps on ``model.loss(params, xb, yb, train=True)``.
    Step i takes rows ``[i*batch_size, (i+1)*batch_size)`` of ``(x, y)``,
    wrapping around; ``generator`` draws the dropout masks.  Returns
    ``(trained params, losses)`` as ``adam_steps`` does."""
    n = x.shape[0]

    def loss_of(p, step):
        rows = torch.arange(step * batch_size, (step + 1) * batch_size,
                            device=x.device) % n
        return model.loss(p, x[rows], y[rows], train=True,
                          generator=generator)

    return adam_steps(params, loss_of, steps=steps,
                      learning_rate=learning_rate)
