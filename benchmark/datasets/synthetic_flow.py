"""``synthetic_flow``: HumanTraffic-style region flows and their
closeness / period / trend windows, for the forecaster family.

Frozen copies, so that a change to the program cannot change the
benchmark's data:

* the flows of ``cnn_graph_tpu_torch/data/synthetic.py synthetic_flow``
  (the same draws for the same seed: a daily sine of period ``day``
  scaled per node, N(0, 5) noise, out-flows a quarter day behind,
  clipped at 0); its random edge matrix, drawn after the flows, is not
  made, since the configuration's graph kind gives the graph;
* ``data/humantraffic.py``'s pipeline as ``load_ln_data_period`` runs
  it: the flows over their global maximum (float64), the windows of
  ``HumanTraffic.make_windows`` (closeness ``in[t-Tc..t), out[t-Tc..t)``,
  period centred at ``t - day``, trend at ``t - 7 day``, each width as
  the configuration says; the label ``(in[t], out[t])``) gathered at
  once by index, and ``dataset_split`` (the last 168 windows are the
  test set, the rest 80/20 train and validation), cast to float32 as
  ``experiments/humanflow.py`` casts them.

``benchmark/tests/test_bench_forecast.py`` holds both equal to the
program's at small sizes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["flows", "windows", "make", "TEST_STEPS"]

TEST_STEPS = 168


def flows(n_nodes: int, n_steps: int, period: int, seed: int):
    """In- and out-flow matrices ``[M, T]`` (float64)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_steps)
    base = 50 + 30 * np.sin(2 * np.pi * t / period)[None, :]
    node_scale = rng.uniform(0.5, 2.0, (n_nodes, 1))
    in_m = node_scale * base + rng.normal(0, 5, (n_nodes, n_steps))
    out_m = node_scale * np.roll(base, period // 4, axis=1) + rng.normal(
        0, 5, (n_nodes, n_steps))
    return np.clip(in_m, 0, None), np.clip(out_m, 0, None)


def windows(in_m, out_m, tc: int, tp: int, tt: int, day: int):
    """``(samples [N, M, 2 (tc + tp + tt)], labels [N, M, 2])`` in the
    matrices' dtype, every window from the earliest whose deepest lookback
    (the trend window's) is in range."""
    week = 7 * day
    T = in_m.shape[1]
    t = np.arange((week - tc) + tt // 2, T - tc) + tc
    idx = [t[:, None] - tc + np.arange(tc)[None, :]]
    for width, back in ((tp, day), (tt, week)):
        idx.append(t[:, None] - back - width // 2 + np.arange(width)[None, :])
    parts = []
    for ix in idx:
        parts += [in_m[:, ix], out_m[:, ix]]  # [M, N, width] each
    samples = np.concatenate(parts, axis=2).transpose(1, 0, 2)
    labels = np.stack([in_m[:, t], out_m[:, t]], axis=2).transpose(1, 0, 2)
    return np.ascontiguousarray(samples), np.ascontiguousarray(labels)


def make(spec: dict, sizes: tuple, seed: int) -> dict:
    """``{"train"|"val"|"test": (x [n, M, C] f32, y [n, M, 2] f32)}``
    for ``sizes`` = ``(nodes, slots)`` and the configuration's windows."""
    n_nodes, n_steps = sizes
    in_m, out_m = flows(n_nodes, n_steps, spec["day"], seed)
    top = float(max(np.amax(in_m), np.amax(out_m)))
    in_m = (in_m / top).astype(np.float32)
    out_m = (out_m / top).astype(np.float32)
    x, y = windows(in_m, out_m, spec["seq_closeness"], spec["seq_period"],
                   spec["seq_trend"], spec["day"])
    n = len(x)
    n_train = int((n - TEST_STEPS) * 0.8)
    n_val = n - TEST_STEPS - n_train
    cut = n_train + n_val
    return {"train": (x[:n_train], y[:n_train]),
            "val": (x[n_train:cut], y[n_train:cut]),
            "test": (x[cut:], y[cut:])}
