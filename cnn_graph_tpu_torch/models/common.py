"""Shared model building blocks: initializers, bias+activation variants,
fully-connected layers, dropout, the one-call int8 conversion of a
model's graph operators, a model's graph data as leaves, and maps over
parameter trees.

Counterpart of ``cnn_graph_tpu/models/common.py`` (``trunc_normal`` :125,
``uniform_init`` :131, ``bias_init`` :136, ``bias_act_init`` :140, ``bias_act`` :155,
``fc_init`` :163, ``fc_apply`` :171, ``dropout`` :176,
``graph_arrays`` :43, ``with_graph_arrays`` :52,
``quantize_model_operators`` :63, with the sharded branches
:90-112).  ``ShardedDraw``, ``is_sharded`` and ``node_mean`` are the
port's: on a node-sharded operator each rank holds its rows, and a
dropout mask or a mean over nodes needs the whole array's.  Parameter
trees are the JAX package's: nested dicts and lists with tensors at the
leaves; ``ParamTree`` registers such a tree's leaves as an
``nn.Module``'s parameters.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.utils.profiling import span

__all__ = [
    "ParamTree",
    "trunc_normal",
    "uniform_init",
    "operator_device",
    "bias_init",
    "bias_act_init",
    "bias_act",
    "fc_init",
    "fc_apply",
    "dropout",
    "ShardedDraw",
    "shard_draw",
    "is_sharded",
    "node_mean",
    "graph_arrays",
    "with_graph_arrays",
    "map_operators",
    "quantize_model_operators",
    "tree_map",
    "tree_leaves",
]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def trunc_normal(shape, std: float = 0.1, *, generator=None,
                 device=None) -> torch.Tensor:
    """Truncated normal(0, std) on ``[-2 std, 2 std]``, the reference's
    default weight initializer, drawn from ``generator`` by the inverse
    CDF of one uniform draw per entry, on the generator's device (the
    CPU without one), then moved to ``device``.  The same seed gives the
    same weights under every torch version (``nn.init.trunc_normal_``
    changed its sampler between releases) and on every device."""
    lo, hi = (math.erf(z / math.sqrt(2.0)) for z in (-2.0, 2.0))
    src = "cpu" if generator is None else generator.device
    t = torch.empty(shape, dtype=torch.float32, device=src)
    t.uniform_(lo, hi, generator=generator)
    t = t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    return t if device is None else t.to(device)


def uniform_init(shape, scale: float = 0.1, *, generator=None,
                 device=None) -> torch.Tensor:
    """Uniform(-scale, scale), the gLSTM family's weight initializer, drawn
    from ``generator`` on its device (the CPU without one), then moved to
    ``device``."""
    src = "cpu" if generator is None else generator.device
    t = torch.empty(shape, dtype=torch.float32, device=src)
    t.uniform_(-scale, scale, generator=generator)
    return t if device is None else t.to(device)


class ParamTree(nn.Module):
    """A parameter tree (dicts and lists with tensors at the leaves) whose
    leaves are this module's parameters, named by their path joined with
    ``__`` (``res__0__w1``); ``tree()`` gives the tree back, holding the
    parameters themselves."""

    def __init__(self, tree):
        super().__init__()

        def register(node, prefix):
            if isinstance(node, dict):
                return {k: register(v, f"{prefix}{k}__")
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [register(v, f"{prefix}{i}__")
                        for i, v in enumerate(node)]
            name = prefix[:-2]
            self.register_parameter(name, nn.Parameter(node))
            return name

        self._names = register(tree, "")

    def tree(self):
        return tree_map(lambda name: getattr(self, name), self._names)


def operator_device(op) -> torch.device:
    """The device a graph operator's tensors live on (its first tensor
    field's)."""
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
    raise TypeError(f"{type(op).__name__} holds no tensor")


def bias_init(shape, value: float = 0.1, *, device=None) -> torch.Tensor:
    """A constant bias, 0.1 like every reference bias."""
    return torch.full(shape, value, dtype=torch.float32, device=device)


def bias_act_init(variant: str, m: int, f: int, *, device=None) -> dict:
    """``b1relu``/``b1tanh``: one bias per filter; ``b2relu``: one per
    vertex per filter."""
    if variant in ("b1relu", "b1tanh"):
        return {"b": bias_init((1, 1, f), device=device)}
    if variant == "b2relu":
        return {"b": bias_init((1, m, f), device=device)}
    raise ValueError(f"unknown bias/activation variant {variant!r}")


def bias_act(params, x: torch.Tensor, variant: str) -> torch.Tensor:
    if variant in ("b1relu", "b2relu"):
        return torch.relu(x + params["b"])
    if variant == "b1tanh":
        return torch.tanh(x + params["b"])
    raise ValueError(f"unknown bias/activation variant {variant!r}")


def fc_init(m_in: int, m_out: int, *, generator=None, device=None) -> dict:
    """Dense layer: truncated-normal ``[m_in, m_out]`` weights, 0.1 bias."""
    return {"w": trunc_normal((m_in, m_out), generator=generator,
                              device=device),
            "b": bias_init((m_out,), device=device)}


def fc_apply(params, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    with full_f32_matmul(), span("fc"):
        y = torch.matmul(x, params["w"]) + params["b"]
    return torch.relu(y) if relu else y


@dataclasses.dataclass(frozen=True)
class ShardedDraw:
    """A generator whose draws are those of the unsharded array, sliced
    to this rank's part: ``slices`` holds ``(axis, lo, total)`` per
    sharded axis.  ``dropout`` draws the whole ``total``-long mask from
    ``generator`` on every rank and keeps ``[lo, lo + size)``, so that
    sharded and single-device training draw the same masks."""

    generator: torch.Generator
    slices: tuple = ()


def shard_draw(generator, axis: int, lo: int, total: int) -> ShardedDraw:
    """``generator`` (or a ``ShardedDraw``) with one more sharded axis."""
    if isinstance(generator, ShardedDraw):
        return ShardedDraw(generator.generator,
                           generator.slices + ((axis, lo, total),))
    return ShardedDraw(generator, ((axis, lo, total),))


def dropout(x: torch.Tensor, keep_prob: float, train: bool,
            generator=None) -> torch.Tensor:
    """Inverted dropout with a KEEP probability: kept entries are scaled
    by ``1 / keep_prob``, the rest zeroed.  Identity at ``keep_prob``
    1.0 or outside training.  The mask is drawn from ``generator``, which
    must live on x's device (a ``ShardedDraw``: this rank's slice of the
    unsharded array's mask); its bits are not ``jax.random``'s."""
    if not train or keep_prob >= 1.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    slices = ()
    if isinstance(generator, ShardedDraw):
        generator, slices = generator.generator, generator.slices
    shape = list(x.shape)
    for axis, _, total in slices:
        shape[axis] = total
    keep = torch.rand(shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep_prob
    for axis, lo, _ in slices:
        keep = keep.narrow(axis, lo, x.shape[axis])
    return torch.where(keep, x / keep_prob, 0.0)


def is_sharded(op) -> bool:
    """Whether ``op`` is a node-sharded operator (it carries a mesh)."""
    return getattr(op, "mesh", None) is not None


def node_mean(t: torch.Tensor, op, axis: int = -2) -> torch.Tensor:
    """The mean of ``t`` over all its entries, ``axis`` being the node
    axis.  On a node-sharded operator ``t`` holds this rank's rows: the
    sum over its real rows, summed over the ``nodes`` axis, over the
    global count, differentiable as every rank's global value."""
    if not is_sharded(op):
        return t.mean()
    from cnn_graph_tpu_torch.parallel.mesh import node_sum

    real = t.narrow(axis, 0, op.real_rows)
    count = t.numel() // t.shape[axis] * op.m
    return node_sum(real.sum(), op.mesh) / count


# Model attributes holding graph data (operators, Fourier eigenbases,
# spline bases), as in JAX (common.py:40): a trace takes them as inputs,
# never as constants baked into the program.
GRAPH_ARRAY_FIELDS = ("op", "operators", "fourier_u", "_bases")


def graph_arrays(model) -> dict:
    """The model's graph data as a tree of tensors: each operator as its
    ``operator_leaves`` (a list of them for ``operators``), the bases as
    they are.  Pair with ``with_graph_arrays`` inside the trace."""
    from cnn_graph_tpu_torch.ops.laplacian import operator_leaves

    out = {}
    for f in GRAPH_ARRAY_FIELDS:
        v = getattr(model, f, None)
        if v is None:
            continue
        if f == "op":
            v = operator_leaves(v)
        elif f == "operators":
            v = [operator_leaves(o) for o in v]
        out[f] = v
    return out


def with_graph_arrays(model, tree: dict):
    """A shallow copy of ``model`` whose graph data are ``tree``'s
    (``graph_arrays``' layout, possibly traced tensors).  The models read
    their operators per call, so the swap reaches every layer."""
    from cnn_graph_tpu_torch.ops.laplacian import with_operator_leaves

    clone = copy.copy(model)
    for f, v in tree.items():
        if f == "op":
            v = with_operator_leaves(model.op, v)
        elif f == "operators":
            v = [with_operator_leaves(o, t)
                 for o, t in zip(model.operators, v)]
        setattr(clone, f, v)
    return clone


def map_operators(model, fn):
    """A shallow copy of ``model`` with ``fn`` applied to each graph
    operator, whether it sits in ``op`` or in an ``operators`` list."""
    clone = copy.copy(model)
    for field in ("op", "operators"):
        v = getattr(model, field, None)
        if v is not None:
            setattr(clone, field,
                    [fn(o) for o in v] if isinstance(v, list) else fn(v))
    return clone


def quantize_model_operators(model, sample_x: float = 1.0,
                             headroom: float = 2.0):
    """A shallow copy of ``model`` whose graph operators are replaced by
    their int8 twins: banded, block-sparse, dense, banded halo and sparse
    halo (sharded) operators are quantized, an already quantized operator
    passes through, and so does BCOO, as in JAX (common.py:78: the
    library fallback has no twin); any other format raises rather than
    serving unquantized."""
    from cnn_graph_tpu_torch.ops.laplacian import (
        BandedLaplacian,
        BCOOLaplacian,
        BlockSparseLaplacian,
        DenseLaplacian,
        QuantBandedLaplacian,
        QuantBlockSparseLaplacian,
        QuantDenseLaplacian,
        quantize_banded,
        quantize_block_sparse,
        quantize_dense,
    )
    from cnn_graph_tpu_torch.parallel.banded_halo import (
        BandedHaloLaplacian,
        QuantBandedHaloLaplacian,
        quantize_banded_halo,
    )
    from cnn_graph_tpu_torch.parallel.sparse_halo import (
        BandedSparseHaloLaplacian,
        QuantBandedSparseHaloLaplacian,
        QuantSparseHaloLaplacian,
        SparseHaloLaplacian,
        quantize_sparse_halo,
    )

    def q(op):
        if isinstance(op, BandedHaloLaplacian):
            return quantize_banded_halo(op, headroom=headroom,
                                        sample_x=sample_x)
        if isinstance(op, (SparseHaloLaplacian, BandedSparseHaloLaplacian)):
            return quantize_sparse_halo(op, headroom=headroom,
                                        sample_x=sample_x)
        if isinstance(op, BandedLaplacian):
            return quantize_banded(op, headroom=headroom, sample_x=sample_x)
        if isinstance(op, DenseLaplacian):
            return quantize_dense(op, headroom=headroom, sample_x=sample_x)
        if isinstance(op, BlockSparseLaplacian):
            return quantize_block_sparse(op, headroom=headroom,
                                         sample_x=sample_x)
        if isinstance(op, (QuantBandedLaplacian, QuantBlockSparseLaplacian,
                           QuantDenseLaplacian, QuantBandedHaloLaplacian,
                           QuantSparseHaloLaplacian,
                           QuantBandedSparseHaloLaplacian, BCOOLaplacian)):
            return op
        raise NotImplementedError(
            f"no int8 twin for {type(op).__name__} in cnn_graph_tpu_torch yet"
        )

    return map_operators(model, q)
