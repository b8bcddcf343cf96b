"""Checkpoint and resume with ``torch.save``.

Counterpart of ``cnn_graph_tpu/train/checkpoint.py CheckpointManager``
(:20), which wraps Orbax: periodic saves of ``(params, opt_state,
step)`` with retention, and restart-resume.  Each step is one file,
``step_<step>.pt`` in the directory, written under a temporary name and
renamed into place, so a save cut short leaves the previous step
readable.  Files are read with ``torch.load(weights_only=True)``: trees
of dicts and lists holding tensors and numbers, nothing executable.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

from cnn_graph_tpu_torch.models.common import tree_map

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Saves and restores the train state as ``{"params", "opt_state",
    "step"}``: ``max_to_keep`` newest steps are kept, and a step is saved
    only when it is a multiple of ``save_interval_steps``, as Orbax's
    options do."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def save(self, step: int, params: Any, opt_state: Any) -> bool:
        """Write ``step``'s state; False when the interval skips it."""
        if step % self.save_interval_steps:
            return False
        state = {"params": tree_map(_host, params),
                 "opt_state": tree_map(_host, opt_state), "step": int(step)}
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        return True

    def restore(self, params_like: Any, opt_state_like: Any,
                step: int | None = None):
        """``(params, opt_state, step)``; each tensor goes to the device
        and dtype of its place in the templates.  ``step=None`` restores
        the latest."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        state = torch.load(self._path(step), weights_only=True)
        return (_like(state["params"], params_like),
                _like(state["opt_state"], opt_state_like), int(state["step"]))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open."""


def _host(v):
    return v.detach().cpu() if isinstance(v, torch.Tensor) else v


def _like(tree, template):
    """``tree`` with each tensor on the device and in the dtype of the
    template's tensor at the same place (dict keys, list positions)."""
    if isinstance(tree, dict):
        if set(tree) != set(template):
            raise ValueError(f"checkpoint keys {sorted(tree)} against "
                             f"template keys {sorted(template)}")
        return {k: _like(tree[k], t) for k, t in template.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(template):
            raise ValueError(f"checkpoint list of {len(tree)} against "
                             f"template list of {len(template)}")
        return [_like(v, t) for v, t in zip(tree, template)]
    if isinstance(template, torch.Tensor):
        if tuple(tree.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf {tuple(tree.shape)} against "
                             f"template {tuple(template.shape)}")
        return tree.to(device=template.device, dtype=template.dtype)
    return tree
