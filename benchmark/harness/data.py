"""The benchmark's own inputs: synthetic digits and the planted-partition
node features.

``synthetic_mnist`` is a frozen copy of ``cnn_graph_tpu_torch/data/
mnist.py synthetic_mnist`` (the same draws for the same seed).
``patch_labels`` and ``planted_features`` split ``bench.py:140-149``'s
maker into its deterministic part (each node's class is its 8 x 8
spatial patch, modulo the class count) and its draws (a class signature
plus unit noise), which the benchmark makes on the device from the run's
seed with a ``torch.Generator``, in one call per matrix.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["synthetic_mnist", "patch_labels", "planted_features",
           "weights_from_seed"]


def synthetic_mnist(n_train: int, n_val: int, n_test: int,
                    seed: int) -> dict:
    """Class-structured fake 28x28 digits: per class a blob-and-ring
    template, scaled by U(0.7, 1.3), plus N(0, 0.3) noise, clipped at 0."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, 28), np.linspace(-1, 1, 28))
    templates = []
    for c in range(10):
        cx, cy = np.cos(2 * np.pi * c / 10), np.sin(2 * np.pi * c / 10)
        blob = np.exp(-(((xs - 0.5 * cx) ** 2 + (ys - 0.5 * cy) ** 2) / 0.15))
        ring = np.exp(-((np.hypot(xs, ys) - 0.3 - 0.05 * c) ** 2) / 0.02)
        templates.append((blob + 0.5 * ring).ravel())
    templates = np.asarray(templates, np.float32)

    def make(n):
        y = rng.integers(0, 10, n)
        x = templates[y] * rng.uniform(0.7, 1.3, (n, 1)).astype(np.float32)
        x += rng.normal(0, 0.3, (n, 784)).astype(np.float32)
        return np.clip(x, 0, None).astype(np.float32), y.astype(np.int64)

    train, val, test = make(n_train), make(n_val), make(n_test)
    return {"train_data": train[0], "train_labels": train[1],
            "val_data": val[0], "val_labels": val[1],
            "test_data": test[0], "test_labels": test[1]}


def patch_labels(positions: np.ndarray, n_classes: int,
                 patches: int = 8) -> np.ndarray:
    """Each node's class: its ``patches x patches`` spatial patch of the
    square grid, modulo ``n_classes`` (bench.py:139-143)."""
    side = int(np.sqrt(positions.shape[0]))
    patch = (positions[:, 0] // (side / patches)).astype(int) * patches + (
        positions[:, 1] // (side / patches)).astype(int)
    return (patch % n_classes).astype(np.int64)


def planted_features(labels: torch.Tensor, n_classes: int, features: int,
                     count: int, generator: torch.Generator) -> list:
    """``count`` feature matrices ``[M, features]`` f32 on the generator's
    device: one N(0, 1) class signature per class, shared, plus fresh
    N(0, 1) noise per matrix (bench.py:144-147)."""
    dev = generator.device
    signatures = torch.randn((n_classes, features), generator=generator,
                             device=dev)
    base = signatures[labels.to(dev)]
    return [base + torch.randn(base.shape, generator=generator, device=dev)
            for _ in range(count)]


def weights_from_seed(shapes: dict, generator: torch.Generator,
                      std: float = 0.1) -> dict:
    """Truncated-normal weights, the model zoo's initializer (N(0, std)
    folded into ``[-2 std, 2 std]``), drawn in one call for all of
    ``shapes`` (name -> shape) on the generator's device."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator,
                       device=generator.device)
    flat = torch.fmod(flat, 2.0) * std
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[at:at + n].reshape(shape).clone()
        at += n
    return out
