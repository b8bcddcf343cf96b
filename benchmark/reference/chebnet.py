"""Plain reference of the paper's ChebNet (Defferrard et al., NIPS 2016,
Sec. 5.2: GC32-P4-GC64-P4-FC512 with Chebyshev filters of order K,
bias and ReLU, max pooling over the coarsening's binary tree, a
fully-connected ReLU layer with dropout, softmax cross-entropy and an L2
penalty on the fully-connected layers) in float64 PyTorch with autograd.

It takes the benchmark's per-level scipy Laplacians and rescales them
itself (``2 L / lmax - I``, ``lmax`` 2), densely: the coarsened graphs
have at most 976 nodes.  ``precision="tf32"`` is the control: every
matrix product's operands are rounded to TF32 (10 mantissa bits), as
the tensor cores round float32 with TF32 on.  It imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.graphs import rescale_laplacian
from reference.rounding import round_tf32 as _tf32

__all__ = ["dense_operators", "forward", "logits", "train_steps",
           "epoch_batches", "dropout_masks"]


class _TF32MM(torch.autograd.Function):
    """``a @ b`` with TF32 operands, forward and backward, as the tensor
    cores compute every float32 product with TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).t(), _tf32(a).t() @ g


def _mm(a, b, precision):
    if precision == "tf32":
        return _TF32MM.apply(a, b)
    return a @ b


def dense_operators(Ls, device) -> list:
    """The rescaled Laplacians as dense float64 matrices."""
    return [torch.from_numpy(rescale_laplacian(L).toarray().astype(
        np.float64)).to(device) for L in Ls]


@torch.no_grad()
def logits(ops, levels, p_sizes, params, x, precision="float64"):
    """``forward`` without dropout or gradients: the served logits."""
    return forward(ops, levels, p_sizes, params, x, precision=precision)


def forward(ops, levels, p_sizes, params, x, *, keep=1.0, masks=None,
            precision="float64"):
    """Logits ``[B, classes]`` for ``x`` ``[B, M0]``.  ``levels[i]``: the
    operator of conv layer i; ``masks``: the dropout keep masks of the
    hidden fc layers (None: no dropout)."""
    params = {k: v.to(torch.float64) for k, v in params.items()}
    h = x.to(torch.float64)[:, :, None]
    n_conv = len(levels)
    for i in range(n_conv):
        Lm = ops[levels[i]]
        w, b = params[f"gconv.{i}.w"], params[f"gconv.{i}.b"]
        B, M, F = h.shape
        T = [h]
        if w.shape[0] > 1:
            T.append(_mm(Lm, h.permute(1, 0, 2).reshape(M, B * F),
                         precision).reshape(M, B, F).permute(1, 0, 2))
        for _ in range(2, w.shape[0]):
            hop = _mm(Lm, T[-1].permute(1, 0, 2).reshape(M, B * F),
                      precision).reshape(M, B, F).permute(1, 0, 2)
            T.append(2.0 * hop - T[-2])
        y = sum(_mm(t.reshape(B * M, F), w[k], precision)
                for k, t in enumerate(T)).reshape(B, M, -1)
        h = torch.relu(y + b)
        pk = p_sizes[i]
        h = h.reshape(B, M // pk, pk, h.shape[-1]).amax(dim=2)
    h = h.reshape(h.shape[0], -1)
    n_fc = len([k for k in params if k.startswith("fc.") and k.endswith(".w")])
    for j in range(n_fc):
        h = _mm(h, params[f"fc.{j}.w"], precision) + params[f"fc.{j}.b"]
        if j < n_fc - 1:
            h = torch.relu(h)
            if masks is not None:
                h = torch.where(masks[j], h / keep, 0.0)
    return h


def epoch_batches(n: int, batch: int, seed: int, steps: int) -> list:
    """The first ``steps`` batches of an epoch-permutation sampler: every
    sample once per epoch, each epoch a fresh ``default_rng(seed)``
    permutation."""
    rng = np.random.default_rng(seed)
    buf = np.empty((0,), np.int64)
    out = []
    for _ in range(steps):
        while len(buf) < batch:
            buf = np.concatenate([buf, rng.permutation(n)])
        out.append(buf[:batch].astype(np.int64))
        buf = buf[batch:]
    return out


def dropout_masks(shape, keep: float, seed: int, device, steps: int) -> list:
    """One keep mask a step from a ``torch.Generator`` seeded with
    ``seed``: ``U[0, 1) < keep``, one float32 draw of ``shape`` a step."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32) < keep for _ in range(steps)]


def train_steps(ops, levels, p_sizes, params, data, labels, batches, masks,
                *, keep, regularization, learning_rate, decay_rate,
                decay_steps, precision="float64") -> dict:
    """Adam steps (optax's update: bias-corrected moments, eps 1e-8
    outside the square root; the staircase rate ``lr decay^floor(count /
    decay_steps)``) on one batch each.  Returns each step's loss, the
    first gradient's norm per leaf and each leaf's change over the
    steps."""
    p = {k: v.detach().to(torch.float64).clone() for k, v in params.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad_norms = [], None
    for count, (rows, mask) in enumerate(zip(batches, masks)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        idx = torch.as_tensor(rows, device=data.device)
        logits = forward(ops, levels, p_sizes, leaves, data[idx], keep=keep,
                         masks=[mask], precision=precision)
        y = labels[idx].long()
        ce = -torch.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]
        loss = ce.mean() + regularization * sum(
            0.5 * (leaves[k] ** 2).sum() for k in leaves
            if k.startswith("fc."))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        n = count + 1
        lr = learning_rate * decay_rate ** (count // decay_steps)
        for k in p:
            mu[k] = (1 - b1) * grads[k] + b1 * mu[k]
            nu[k] = (1 - b2) * grads[k] ** 2 + b2 * nu[k]
            u = (mu[k] / (1 - b1 ** n)) / ((nu[k] / (1 - b2 ** n)).sqrt()
                                           + eps)
            p[k] = p[k] - lr * u
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": {k: float((p[k] - p0[k]).norm()) for k in p}}
