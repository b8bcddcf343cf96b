"""ChebNet: spectral graph-CNN classifier (conv -> pool stacks, fc head).

Counterpart of ``cnn_graph_tpu/models/chebnet.py:70``, the reference's
``cgcnn`` (nips2016/mnist.ipynb): per layer a spectral filter over that
layer's coarsened Laplacian, bias + activation and binary-tree pooling,
then fully-connected layers with dropout and a softmax cross-entropy
head whose fc weights carry an L2 penalty.  The filter is Chebyshev
(``[K, Fin, Fout]`` weights), Lanczos (the same weights, a per-signal
Krylov basis computed on the device), Fourier (``[M, Fout, Fin]``
per-frequency weights in the Laplacian's eigenbasis) or spline (``[K,
Fout, Fin]`` control points interpolated over the eigenvalues by
``bspline_basis``, chebnet.py:34).

Parameters use the JAX package's layout, ``{"gconv": [{"w": [K, Fin,
Fout], "b": [1, 1, Fout]}], "fc": [{"w": [m_in, m_out], "b":
[m_out]}]}``; ``apply(params, x)`` runs on any such tree
(``convert.chebnet_params_from_jax`` makes one from JAX weights) and
``forward(x)`` on the module's own parameters, in eval mode.  On dense
operators built with ``use_pallas=True`` the convs that ``cheby_conv``
finds eligible run the fused kernels K2 and K3.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cnn_graph_tpu_torch.graphs import construction as gc
from cnn_graph_tpu_torch.models import common
from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.ops.filters import (
    cheby_conv,
    fourier_conv,
    lanczos_conv,
)
from cnn_graph_tpu_torch.ops.pooling import avg_pool, max_pool

__all__ = ["ChebNet", "bspline_basis"]

FILTERS = ("chebyshev", "fourier", "spline", "lanczos")


def bspline_basis(K: int, x: np.ndarray, degree: int = 3) -> np.ndarray:
    """Cox-de Boor B-spline basis: K basis functions of ``degree`` at the
    points ``x`` (the Laplacian's eigenvalues), on the open uniform knot
    vector over ``[x.min(), x.max()]``; float32 ``[len(x), K]``.  The
    same float64 arithmetic as the JAX package's."""
    x = np.asarray(x, np.float64)
    lo, hi = float(x.min()), float(x.max())
    n_inner = K - degree + 1
    inner = np.linspace(lo, hi, max(n_inner, 2))
    knots = np.concatenate([[lo] * degree, inner, [hi] * degree])
    B = np.zeros((len(x), len(knots) - 1))
    for j in range(len(knots) - 1):
        B[:, j] = (x >= knots[j]) & (x < knots[j + 1])
    B[x == hi, np.searchsorted(knots, hi, "left") - 1] = 1.0
    for d in range(1, degree + 1):
        nb = len(knots) - 1 - d
        Bn = np.zeros((len(x), nb))
        for j in range(nb):
            left_den = knots[j + d] - knots[j]
            right_den = knots[j + d + 1] - knots[j + 1]
            left = ((x - knots[j]) / left_den * B[:, j] if left_den > 0
                    else 0.0)
            right = ((knots[j + d + 1] - x) / right_den * B[:, j + 1]
                     if right_den > 0 else 0.0)
            Bn[:, j] = left + right
        B = Bn
    if B.shape[1] != K:
        raise ValueError(f"{K} spline basis functions of degree {degree} "
                         f"need K > degree, got a basis of {B.shape[1]}")
    return B.astype(np.float32)


class ChebNet(nn.Module):
    """Graph CNN classifier.

    ``operators``: one device operator per coarsening level, finest
    first; layer i uses level ``sum(log2 p[:i])``.  ``F``, ``K``, ``p``:
    per-layer filter counts, polynomial orders and pooling sizes (powers
    of two).  ``M``: fc widths, ``M[-1]`` the class count.
    ``laplacians``: the host Laplacians per level (SciPy), which the
    Fourier and spline filters need for their eigenbases (``graphs.
    fourier``, computed here once).  ``filter``: ``chebyshev``,
    ``fourier``, ``spline`` (``spline_degree``) or ``lanczos``.  ``brelu``:
    ``b1relu``, ``b2relu`` or ``b1tanh``; ``pool``: ``max`` or
    ``average``; ``dropout``: keep probability on the fc layers in
    training; ``regularization``: weight of the fc L2 term.  Weights are
    drawn from ``generator`` (truncated normal, std 0.1), biases are 0.1;
    they live on ``device``, by default the first operator's.
    ``apply`` is the JAX-style functional forward and shadows
    ``nn.Module.apply``.

    ``input_grad`` (default False): layer 0 declares that no gradient
    with respect to the input is consumed, so on a banded operator its
    backward skips the adjoint chain and ``x`` gets no gradient at all
    (``None``; the JAX model returns zeros there).  Dense operators
    compute dx only when ``x`` requires a gradient.
    """

    def __init__(self, operators, F, K, p, M, input_features: int = 1,
                 laplacians=None, filter: str = "chebyshev",
                 brelu: str = "b1relu", pool: str = "max",
                 dropout: float = 1.0, regularization: float = 0.0,
                 spline_degree: int = 3, input_grad: bool = False, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if filter not in FILTERS:
            raise ValueError(f"unknown filter {filter!r}; one of {FILTERS}")
        if filter in ("fourier", "spline") and laplacians is None:
            raise ValueError(f"the {filter} filter needs the host "
                             "laplacians for its eigenbases")
        if not len(operators) >= len(F) == len(K) == len(p):
            raise ValueError("need one F, K and p per layer and an operator "
                             "per level")
        p_log2 = np.log2(np.maximum(np.asarray(p, dtype=float), 1.0))
        if np.any(np.asarray(p) < 1) or np.any(np.mod(p_log2, 1)):
            raise ValueError(f"pool sizes {p} must be powers of 2")
        if len(operators) < 1 + int(np.sum(p_log2)):
            raise ValueError("not enough coarsening levels for the pooling")
        levels = np.concatenate([[0], np.cumsum(p_log2[:-1])]).astype(int)
        if device is None:
            device = common.operator_device(operators[0])
        self.operators = [operators[j] for j in levels]
        self.F, self.K, self.p, self.M = list(F), list(K), list(p), list(M)
        self.input_features = input_features
        self.filter = filter
        self.brelu = brelu
        self.pool_fn = {"max": max_pool, "average": avg_pool}[pool]
        self.dropout = dropout
        self.regularization = regularization
        self.input_grad = input_grad

        # The eigenbasis U (and the spline interpolation) of each layer's
        # level: graph data, not parameters.
        self._bases = []
        if filter in ("fourier", "spline"):
            for j, k in zip(levels, K):
                lam, U = gc.fourier(laplacians[j])
                Bmat = (torch.from_numpy(bspline_basis(k, lam, spline_degree))
                        .to(device) if filter == "spline" else None)
                self._bases.append((torch.as_tensor(
                    U, dtype=torch.float32).to(device), Bmat))

        self.gconv = nn.ModuleList()
        fin = input_features
        for op, fout, k in zip(self.operators, self.F, self.K):
            shape = {"fourier": (op.m, fout, fin),
                     "spline": (k, fout, fin)}.get(filter, (k, fin, fout))
            layer = {"w": common.trunc_normal(shape, generator=generator,
                                              device=device)}
            layer.update(common.bias_act_init(brelu, op.m, fout,
                                              device=device))
            self.gconv.append(_params(layer))
            fin = fout
        m_in = (self.operators[-1].m * F[-1] // p[-1] if F
                else operators[0].m * input_features)
        self.fc = nn.ModuleList()
        for m_out in self.M:
            self.fc.append(_params(common.fc_init(
                m_in, m_out, generator=generator, device=device)))
            m_in = m_out

    def param_tree(self) -> dict:
        """The module's parameters in the JAX package's layout."""
        return {name: [dict(layer.items()) for layer in getattr(self, name)]
                for name in ("gconv", "fc")}

    def apply(self, params, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: ``[B, M0]`` or ``[B, M0, Fin]`` -> logits ``[B, C]``.
        ``train`` turns dropout on, drawing from ``generator``."""
        if x.dim() == 2:
            x = x[:, :, None]
        for i, layer in enumerate(params["gconv"]):
            x = self._filter(i, x, layer["w"])
            x = common.bias_act(layer, x, self.brelu)
            x = self.pool_fn(x, self.p[i])
        x = x.reshape(x.shape[0], -1)
        n_fc = len(params["fc"])
        for j, layer in enumerate(params["fc"]):
            last = j == n_fc - 1
            x = common.fc_apply(layer, x, relu=not last)
            if not last:
                x = common.dropout(x, self.dropout, train, generator)
        return x

    def _filter(self, i: int, x: torch.Tensor, w: torch.Tensor):
        if self.filter == "chebyshev":
            return cheby_conv(x, self.operators[i], w,
                              input_grad=(i > 0 or self.input_grad))
        if self.filter == "lanczos":
            return lanczos_conv(x, self.operators[i], w)
        U, Bmat = self._bases[i]
        if self.filter == "spline":
            # K control points -> per-frequency weights [M, Fout, Fin].
            with full_f32_matmul():
                w = torch.einsum("mk,kof->mof", Bmat, w)
        return fourier_conv(x, U, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.param_tree(), x)

    def loss(self, params, x: torch.Tensor, labels: torch.Tensor, *,
             train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Mean softmax cross-entropy plus ``regularization`` times the L2
        of the fc layers (filters are not regularized)."""
        logp = torch.log_softmax(
            self.apply(params, x, train=train, generator=generator), dim=1)
        ce = -logp.gather(1, labels[:, None].long())[:, 0].mean()
        if self.regularization:
            reg = sum(0.5 * (layer["w"] ** 2).sum()
                      + 0.5 * (layer["b"] ** 2).sum()
                      for layer in params["fc"])
            ce = ce + self.regularization * reg
        return ce

    def predict_classes(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x).argmax(dim=1)


def _params(layer: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in layer.items()})
