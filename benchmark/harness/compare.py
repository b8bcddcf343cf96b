"""The numbers that decide ``correct``, each held against its limit.

* ``logit_gap``: of a served answer against the reference's, the largest
  absolute difference over the reference's largest magnitude, the worst
  over the sampled answers.
* ``loss_gap``: the largest relative gap of the first steps' losses.
* ``grad_gap`` and ``change_gap``: per parameter leaf, the gap between the
  program's norm and the reference's (of the first gradient, as the
  optimizer holds it after one step, and of the parameters' change over
  the checked steps), over the reference's norm of that leaf or of the
  median leaf, whichever is larger; the worst leaf.  Leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone under adam and are left out.
"""

from __future__ import annotations

import statistics

__all__ = ["logit_gap", "loss_gap", "leaf_gaps", "named_leaves",
           "train_readings", "verdict"]

NEGLIGIBLE_GRAD = 1e-3  # a leaf's gradient norm under this share of the median


def named_leaves(tree, prefix: str = "") -> list:
    """``(dotted name, leaf)`` of a tree of dicts and lists, in insertion
    order, the order in which the program's optimizers keep their state."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += named_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def logit_gap(out, ref) -> float:
    """``max|out - ref| / max|ref|`` in float64 (inf for a non-finite or
    mis-shaped answer)."""
    import torch

    out = out.to(torch.float64)
    ref = ref.to(device=out.device, dtype=torch.float64)
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        return float("inf")
    scale = float(ref.abs().max())
    return float((out - ref).abs().max()) / max(scale, 1e-30)


def loss_gap(losses, ref_losses) -> float:
    """The worst step's relative gap (inf where a step's loss is missing)."""
    if len(losses) != len(ref_losses):
        return float("inf")
    gaps = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
            for a, b in zip(losses, ref_losses)]
    return max(gaps) if all(g == g for g in gaps) else float("inf")


def leaf_gaps(norms: dict, ref_norms: dict, ref_grad_norms: dict) -> tuple:
    """``(worst gap, worst leaf, leaves left out)`` over the leaves of
    ``ref_norms`` whose reference gradient is not negligible."""
    med_g = statistics.median(ref_grad_norms.values())
    kept = {k: v for k, v in ref_norms.items()
            if ref_grad_norms[k] >= NEGLIGIBLE_GRAD * med_g}
    out = sorted(set(ref_norms) - set(kept))
    med = statistics.median(kept.values())
    worst, worst_leaf = 0.0, None
    for k, r in kept.items():
        gap = abs(float(norms[k]) - r) / max(r, med, 1e-30)
        if not gap == gap:
            gap = float("inf")
        if gap >= worst:
            worst, worst_leaf = gap, k
    return worst, worst_leaf, out


def train_readings(got: dict, want: dict, detail=None) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of a training run's
    ``losses``, ``grad_norms`` and ``change_norms`` against the
    reference's."""
    g = want["grad_norms"]
    if detail is not None:
        detail.append(f"losses {got['losses']} reference {want['losses']}")
        for key in ("grad_norms", "change_norms"):
            detail.append(f"{key} " + ", ".join(
                f"{k} {got[key].get(k)!r}/{v!r}"
                for k, v in want[key].items()))
    return {"loss_gap": loss_gap(got["losses"], want["losses"]),
            "grad_gap": leaf_gaps(got["grad_norms"], g, g)[0],
            "change_gap": leaf_gaps(got["change_norms"],
                                    want["change_norms"], g)[0]}


def verdict(readings: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every reading at or under its limit, and the
    readings with their limits in the order of ``limits``."""
    checks = {}
    for name, limit in limits.items():
        value = readings.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
