"""Plain reference of the NodeClassifier (Defferrard et al. 2016's
Chebyshev conv stack over one graph, per-node softmax) in float64 PyTorch.

It works out again everything the program's set-up derives from the
benchmark's scipy Laplacian: the rescaled operator ``L - I`` (``lmax`` 2),
its int8 twin (``max|L| / 127`` scale, values ``round(L / scale)``), and
each conv's activation scale ``max|x| * headroom / 127``.  It imports
nothing of the program.  The graph products are ``torch.sparse.mm`` on a
CSR matrix of the operator's values, exact on integers.

The precision that a cell states is emulated at the points where it
rounds:

* int8 serving (``serve_logits(qmax=127)``): the operator and every carry
  are integers (``|q| <= qmax``); a hop's emission is ``round(2 (acc *
  s_L) - x0)`` in float32, clipped; the taps sum the dequantized carries
  ``q * s_x``.  ``qmax=7`` is the int4 control.
* bf16-operator training (``train_steps(rnd=round_bf16)``) and float
  serving (``float_logits``): the operator's values, each carry, each
  injection ``g W_k^T`` and each adjoint hop round to bfloat16; taps, dW
  and the loss are exact.  ``rnd=int8_scaled`` is the int8 control.
* ``taps=round_tf32`` rounds the operands of every tap and dW product to
  TF32: the control of the taps, which the configuration states in
  float32 with TF32 off.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from harness.graphs import rescale_laplacian
from reference.rounding import int8_scaled, round_bf16, round_tf32

__all__ = ["operator", "serve_logits", "float_logits", "train_steps",
           "round_bf16", "round_tf32", "int8_scaled", "exact"]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def operator(L, device, values=None):
    """The rescaled Laplacian's ``(rows, cols, float32 values)`` and, given
    ``values``, the CSR float64 matrix of them on ``device``."""
    Lr = rescale_laplacian(L).tocoo()
    rows, cols = Lr.row.astype(np.int64), Lr.col.astype(np.int64)
    vals = torch.from_numpy(Lr.data.astype(np.float32))
    if values is None:
        return rows, cols, vals
    m = L.shape[0]
    idx = torch.from_numpy(np.stack([rows, cols]))
    A = torch.sparse_coo_tensor(idx, values.to(torch.float64), (m, m),
                                check_invariants=True)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return A.coalesce().to_sparse_csr().to(device)


def _emit(acc, x0, s_l32, qmax):
    y = acc.to(torch.float32) * s_l32
    if x0 is not None:
        y = 2.0 * y - x0.to(torch.float32)
    return torch.clamp(torch.round(y), -qmax, qmax).to(torch.float64)


@torch.no_grad()
def serve_logits(L, params: dict, x: torch.Tensor, qmax: int = 127,
                 headroom: float = 2.0, taps=exact) -> torch.Tensor:
    """Logits ``[m, classes]`` of the integer-carry NodeClassifier on
    ``x`` ``[m, Fin]`` (float32).  ``params``: leaf name -> tensor."""
    dev = x.device
    _, _, vals = operator(L, dev)
    s_l = float(vals.abs().max()) / qmax or 1.0
    s_l32 = torch.tensor(s_l, dtype=torch.float32, device=dev)
    vq = torch.clamp(torch.round(vals.to(dev) / s_l32), -qmax, qmax)
    A = operator(L, dev, vq.cpu())
    n = len([k for k in params if k.endswith(".w")])
    h = x.to(torch.float32)
    for i in range(n):
        w = params[f"convs.{i}.w"].to(torch.float64)
        b = params[f"convs.{i}.b"].to(torch.float64)
        s_x = torch.clamp_min(h.abs().amax(), 1e-30) * torch.tensor(
            headroom / qmax, dtype=torch.float32, device=dev)
        cur = torch.clamp(torch.round(h / s_x), -qmax, qmax).to(torch.float64)
        prev = None
        y = torch.zeros((h.shape[0], w.shape[2]), dtype=torch.float64,
                        device=dev)
        for k in range(w.shape[0]):
            if k == 1:
                prev, cur = cur, _emit(torch.sparse.mm(A, cur), None, s_l32,
                                       qmax)
            elif k >= 2:
                prev, cur = cur, _emit(torch.sparse.mm(A, cur), prev, s_l32,
                                       qmax)
            dq = (cur.to(torch.float32) * s_x).to(torch.float64)
            y += taps(dq) @ taps(w[k])
        y = y + b
        h = (torch.relu(y) if i < n - 1 else y).to(torch.float32)
    return y


def _basis(A, x, K, rnd):
    T = [rnd(x)]
    if K > 1:
        T.append(rnd(torch.sparse.mm(A, T[0])))
    for _ in range(2, K):
        T.append(rnd(2.0 * torch.sparse.mm(A, T[-1]) - T[-2]))
    return T


def _adjoint(A, g, w, rnd):
    """dx of one conv: the reverse recurrence on injections ``g W_k^T``,
    rounded where the operator's dtype rounds."""
    K = w.shape[0]
    gr, wr = rnd(g), rnd(w)
    C = [rnd(gr @ wr[k].t()) for k in range(K)]
    if K == 1:
        return C[0]
    if K == 2:
        return rnd(C[0] + rnd(torch.sparse.mm(A, C[1])))
    s1 = rnd(2.0 * torch.sparse.mm(A, C[K - 1]) + C[K - 2])
    s2 = C[K - 1]
    for k in range(K - 3, 0, -1):
        s1, s2 = rnd(2.0 * torch.sparse.mm(A, s1) - s2 + C[k]), s1
    return rnd(rnd(C[0] + rnd(torch.sparse.mm(A, s1))) - s2)


def _forward(A, p, feats, rnd, taps):
    """Each conv's basis and output, the last conv's output the logits."""
    n = len([k for k in p if k.endswith(".w")])
    h = feats.to(torch.float64)
    saved = []
    for i in range(n):
        w, b = p[f"convs.{i}.w"], p[f"convs.{i}.b"]
        T = _basis(A, h, w.shape[0], rnd)
        y = sum(taps(t) @ taps(w[k]) for k, t in enumerate(T)) + b
        saved.append((T, y))
        h = torch.relu(y).to(torch.float32).to(torch.float64)
    return saved


@torch.no_grad()
def float_logits(L, params: dict, x: torch.Tensor, rnd=round_bf16,
                 taps=exact) -> torch.Tensor:
    """Logits ``[m, classes]`` of the NodeClassifier on a float operator
    whose values and carries round with ``rnd`` (``exact`` for float32,
    whose rounding is under the comparison's limits)."""
    dev = x.device
    _, _, vals = operator(L, dev)
    A = operator(L, dev, rnd(vals.to(torch.float64)).cpu())
    p = {k: v.to(torch.float64) for k, v in params.items()}
    return _forward(A, p, x, rnd, taps)[-1][1]


@torch.no_grad()
def _loss_and_grads(A, p, feats, labels, mask, rnd, taps):
    n = len([k for k in p if k.endswith(".w")])
    saved = _forward(A, p, feats, rnd, taps)
    z = saved[-1][1]
    logp = torch.log_softmax(z, dim=1)
    m = mask.to(torch.float64)
    cnt = max(float(m.sum()), 1.0)
    picked = logp.gather(1, labels[:, None].long())[:, 0]
    loss = float(-(picked * m).sum() / cnt)
    g = torch.softmax(z, dim=1)
    g[torch.arange(len(labels), device=g.device), labels.long()] -= 1.0
    g = g * (m / cnt)[:, None]
    grads = {}
    for i in range(n - 1, -1, -1):
        T, y = saved[i]
        if i < n - 1:
            g = g * (y > 0).to(torch.float64)
        w = p[f"convs.{i}.w"]
        grads[f"convs.{i}.b"] = g.sum(0)
        grads[f"convs.{i}.w"] = torch.stack([taps(t).t() @ taps(g)
                                             for t in T])
        if i > 0:
            g = _adjoint(A, g.to(torch.float32).to(torch.float64), w, rnd)
            g = g.to(torch.float32).to(torch.float64)
    return loss, grads


def train_steps(L, params: dict, feats, labels, mask, *, learning_rate: float,
                steps: int, rnd=round_bf16, taps=exact) -> dict:
    """``steps`` full-batch adam steps (torch.optim.Adam's update, betas
    (0.9, 0.999), eps 1e-8) from ``params``.  Returns each step's loss,
    the first gradient's norm per leaf, and the norm of each leaf's change
    over the steps."""
    dev = feats.device
    _, _, vals = operator(L, dev)
    A = operator(L, dev, rnd(vals.to(torch.float64)).cpu())
    p = {k: v.detach().to(torch.float64).clone() for k, v in params.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    var = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad_norms = [], None
    for t in range(1, steps + 1):
        loss, grads = _loss_and_grads(A, p, feats, labels, mask, rnd, taps)
        losses.append(loss)
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        for k in p:
            mom[k] = b1 * mom[k] + (1 - b1) * grads[k]
            var[k] = b2 * var[k] + (1 - b2) * grads[k] ** 2
            denom = var[k].sqrt() / (1 - b2 ** t) ** 0.5 + eps
            p[k] = p[k] - (learning_rate / (1 - b1 ** t)) * mom[k] / denom
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": {k: float((p[k] - p0[k]).norm()) for k in p}}
