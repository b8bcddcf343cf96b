"""The Trainer's optimizer chain: optax's, as plain tensor updates.

``cnn_graph_tpu/train/trainer.py`` (:90-123) builds ``optax.adam``,
``optax.sgd`` (with momentum) or ``optax.rmsprop(decay=0.9)`` on a
staircase ``exponential_decay`` schedule, chained after
``clip_by_global_norm`` and wrapped in ``apply_if_finite(..., 100)``.
``torch.optim`` differs from optax in three of these places (rmsprop's
eps, the clip's scale, and the skipped update), so the chain is written
out here on flat lists of tensors, its state and step count tensors on
the parameters' device; nothing waits for the host.

* adam: ``optax.scale_by_adam`` (eps outside the square root,
  bias-corrected);
* sgd: ``optax.trace``, ``t = g + momentum t``;
* rmsprop: ``optax.scale_by_rms``, ``g rsqrt(nu + eps)`` (eps inside);
* the schedule ``lr rate^floor(count / decay_steps)``, ``count`` the
  updates applied before this one, so the first step takes ``lr``;
* the clip: ``g max_norm / |g|`` only where ``|g| >= max_norm``;
* the guard: a step whose gradients hold a NaN or an inf updates
  nothing, the moments and the count included, until the 101st such
  step in a row, which applies.
"""

from __future__ import annotations

import torch

__all__ = ["Optimizer"]

_ADAM = (0.9, 0.999, 1e-8)  # optax.adam's b1, b2, eps
_RMS = (0.9, 1e-8)  # optax.rmsprop(decay=0.9)'s decay and eps
MAX_CONSECUTIVE_ERRORS = 100  # trainer.py:122


class Optimizer:
    """Built from a ``TrainConfig``: ``init(leaves) -> state`` and
    ``update(grads, state) -> (updates, state)`` on flat lists of
    tensors; the state is a dict of tensors and lists of tensors, which
    ``CheckpointManager`` saves as it is."""

    def __init__(self, config):
        if config.optimizer not in ("adam", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
        self.name = config.optimizer
        self.learning_rate = config.learning_rate
        self.staircase = (config.decay_rate != 1
                          and bool(config.decay_steps))
        self.decay_rate = config.decay_rate
        self.decay_steps = config.decay_steps
        self.momentum = config.momentum
        self.grad_clip = config.grad_clip
        self.check_numerics = config.check_numerics

    def init(self, leaves: list) -> dict:
        dev = leaves[0].device
        zeros = [torch.zeros_like(p) for p in leaves]
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.name == "adam":
            state.update(mu=zeros, nu=[z.clone() for z in zeros])
        elif self.name == "rmsprop":
            state.update(nu=zeros)
        elif self.momentum:
            state.update(trace=zeros)
        if self.check_numerics:
            state.update(
                notfinite_count=torch.zeros((), dtype=torch.int32, device=dev),
                last_finite=torch.ones((), dtype=torch.bool, device=dev),
                total_notfinite=torch.zeros((), dtype=torch.int32,
                                            device=dev))
        return state

    def _rate(self, count: torch.Tensor) -> torch.Tensor:
        """optax.exponential_decay(staircase=True) at ``count``, in f32."""
        lr = torch.tensor(self.learning_rate, dtype=torch.float32,
                          device=count.device)
        if not self.staircase:
            return lr
        p = torch.floor(count.to(torch.float32) / self.decay_steps)
        rate = torch.tensor(self.decay_rate, dtype=torch.float32,
                            device=count.device)
        return torch.where(count <= 0, lr, lr * torch.pow(rate, p))

    def _inner(self, g: list, state: dict):
        """Clip, then the optimizer and the learning rate."""
        if self.grad_clip:
            norm = torch.sqrt(sum((t * t).sum() for t in g))
            keep = norm < self.grad_clip
            g = [torch.where(keep, t, (t / norm.to(t.dtype)) * self.grad_clip)
                 for t in g]
        new = dict(state)
        count = state["count"]
        if self.name == "adam":
            b1, b2, eps = _ADAM
            mu = [(1 - b1) * t + b1 * m for t, m in zip(g, state["mu"])]
            nu = [(1 - b2) * (t * t) + b2 * v for t, v in zip(g, state["nu"])]
            n = (count + 1).to(torch.float32)
            c1, c2 = 1 - torch.pow(b1, n), 1 - torch.pow(b2, n)
            u = [(m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + eps)
                 for m, v in zip(mu, nu)]
            new.update(mu=mu, nu=nu)
        elif self.name == "rmsprop":
            decay, eps = _RMS
            nu = [(1 - decay) * (t * t) + decay * v
                  for t, v in zip(g, state["nu"])]
            u = [torch.rsqrt(v + eps) * t for t, v in zip(g, nu)]
            new.update(nu=nu)
        elif self.momentum:
            u = [t + self.momentum * tr for t, tr in zip(g, state["trace"])]
            new.update(trace=u)
        else:
            u = g
        step = -self._rate(count)
        new["count"] = count + 1
        return [step.to(t.dtype) * t for t in u], new

    def update(self, grads: list, state: dict):
        """``(updates, new state)``: add the updates to the parameters."""
        if not self.check_numerics:
            return self._inner(list(grads), state)
        finite = torch.stack([torch.isfinite(t).all() for t in grads]).all()
        bad = torch.where(finite, torch.zeros_like(state["notfinite_count"]),
                          state["notfinite_count"] + 1)
        apply = finite | (bad > MAX_CONSECUTIVE_ERRORS)
        updates, new = self._inner(list(grads), state)
        updates = [torch.where(apply, u, torch.zeros_like(u)) for u in updates]
        for key, v in new.items():
            if isinstance(v, list):
                new[key] = [torch.where(apply, a, b)
                            for a, b in zip(v, state[key])]
            else:
                new[key] = torch.where(apply, v, state[key])
        new.update(notfinite_count=bad, last_finite=finite,
                   total_notfinite=torch.where(
                       finite, state["total_notfinite"],
                       state["total_notfinite"] + 1))
        return updates, new
