"""Plain reference of the fork's graph-convolutional LSTM forecaster,
``GconvModel.inference_glstm_period_expand_gconv3`` (xu-wang11/cnn_graph
lib/gconv_lstm.py:502-607), in float64 PyTorch with autograd.

* The cell is the GCRN cell of Seo et al. (arXiv:1612.07659, model 2
  without peepholes): ``pre = cheb_K(x; Wx) + cheb_K(h; Wh) + b`` over
  the gates (z, i, f, o), z = tanh, i = sigmoid, f = sigmoid(. + 1),
  o = sigmoid, ``c' = f c + i z``, ``h' = o tanh(c')``.
* Three timescale branches (closeness, period, trend), each a stack of
  cells over its window, output dropout after every layer; the
  branches' last outputs concatenated, an init conv and residual blocks
  of two convs (ReLU, the skip added before the second ReLU), a head
  conv; the mean squared error.
* ``cheb_K`` is the Chebyshev recurrence ``T_0 = x``, ``T_1 = L x``,
  ``T_k = 2 L T_{k-1} - T_{k-2}`` on the rescaled Laplacian ``2 L / lmax
  - I`` (``lmax`` 2), worked out here from the scipy Laplacian, and the
  taps ``sum_k T_k W_k``.

It imports nothing of the program nor of the rest of the benchmark, so
that a test can load it by its path.  ``precision="tf32"`` is the
control: the operands of every tap product (and of its gradients) are
rounded to TF32, as the tensor cores round float32 with TF32 on.
``gate_z="tan"`` is the fork's own gate z (``tf.tan``, a typo that the
program does not copy).  ``train_steps`` replays the program's Adam
steps (optax's update) with the program's dropout masks, drawn from a
``torch.Generator`` seeded as the Trainer's in the program's order, and
sums each step's gradients over batch chunks so that float64 fits on
the card.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse
import torch

__all__ = ["operator", "round_tf32", "forward", "loss", "dropout_masks",
           "epoch_batches", "named_leaves", "rebuild", "train_steps",
           "GATES"]

GATES = ("z", "i", "f", "o")
FORGET_BIAS = 1.0


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (10 mantissa bits; nearest, ties away from zero)."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32).to(t.dtype)


def operator(L, device):
    """``2 L / 2 - I`` of the scipy Laplacian ``L``: a float64 sparse CSR
    tensor on ``device``."""
    L = scipy.sparse.csr_matrix(L, dtype=np.float64)
    R = (L - scipy.sparse.identity(L.shape[0], format="csr")).tocoo()
    R.eliminate_zeros()
    idx = torch.from_numpy(np.stack([R.row, R.col]).astype(np.int64))
    A = torch.sparse_coo_tensor(idx, torch.from_numpy(R.data), R.shape,
                                check_invariants=True)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return A.coalesce().to_sparse_csr().to(device)


class _LMul(torch.autograd.Function):
    """``A @ x`` for the symmetric operator ``A``; its gradient ``A @ g``."""

    @staticmethod
    def forward(ctx, A, x):
        ctx.A = A
        return A @ x

    @staticmethod
    def backward(ctx, g):
        return None, ctx.A @ g


class _TF32MM(torch.autograd.Function):
    """``a @ b`` on TF32-rounded operands, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).t(), round_tf32(a).t() @ g


def _mm(a, b, precision):
    if precision == "tf32":
        return _TF32MM.apply(a, b)
    return a @ b


def cheb(A, x, w, precision="float64"):
    """``sum_k T_k(A) x W_k``: ``x`` ``[B, M, F]``, ``w`` ``[K, F, O]``."""
    B, M, F = x.shape
    K, _, O = w.shape

    def lmul(t):
        cols = t.permute(1, 0, 2).reshape(M, B * F)
        return _LMul.apply(A, cols).reshape(M, B, F).permute(1, 0, 2)

    T = [x]
    if K > 1:
        T.append(lmul(x))
    for _ in range(2, K):
        T.append(2.0 * lmul(T[-1]) - T[-2])
    return sum(_mm(t.reshape(B * M, F), w[k], precision)
               for k, t in enumerate(T)).reshape(B, M, O)


def _cell(A, p, carry, x, precision, gate_z):
    c, h = carry
    H = c.shape[-1]
    wx = torch.cat([p[f"W{g}x"] for g in GATES], -1)
    wh = torch.cat([p[f"W{g}h"] for g in GATES], -1)
    b = torch.cat([p[f"b{g}"] for g in GATES], -1)
    pre = cheb(A, x, wx, precision) + cheb(A, h, wh, precision) + b
    z = (torch.tan if gate_z == "tan" else torch.tanh)(pre[..., :H])
    i = torch.sigmoid(pre[..., H:2 * H])
    f = torch.sigmoid(pre[..., 2 * H:3 * H] + FORGET_BIAS)
    o = torch.sigmoid(pre[..., 3 * H:])
    c = f * c + i * z
    return c, o * torch.tanh(c)


def _branch(A, layers, xw, T, keep, masks, precision, gate_z):
    """``xw`` ``[B, M, 2 T]`` (in-series then out-series) -> the top
    layer's last output; ``masks``: one keep mask ``[T, B, M, H]`` a layer
    (None: no dropout)."""
    B, M, C = xw.shape
    seq = list(xw.reshape(B, M, C // T, T).permute(3, 0, 1, 2))
    for j, p in enumerate(layers):
        H = p["bz"].shape[0]
        c = h = xw.new_zeros((B, M, H))
        out = []
        for x in seq:
            c, h = _cell(A, p, (c, h), x, precision, gate_z)
            out.append(h)
        if masks is not None:
            out = [torch.where(m, o / keep, 0.0)
                   for m, o in zip(masks[j], out)]
        seq = out
    return seq[-1]


def forward(A, params, x, windows, *, keep=1.0, masks=None,
            precision="float64", gate_z="tanh"):
    """Predictions ``[B, M, 2]`` for ``x`` ``[B, M, C]`` (float64).
    ``params``: the program's tree (``lstms``: per branch a list of cell
    dicts; ``stack``: ``init`` and ``res`` blocks ``w1``/``w2``;
    ``head``); ``windows``: ``(T, start, end)`` channel ranges of the
    closeness, period and trend windows; ``masks``: per branch, per layer,
    the keep mask ``[T, B, M, H]`` (None: no dropout)."""
    hs = []
    for b, ((T, s, e), layers) in enumerate(zip(windows, params["lstms"])):
        hs.append(_branch(A, layers, x[:, :, s:e], T, keep,
                          None if masks is None else masks[b], precision,
                          gate_z))
    st = params["stack"]
    h = torch.relu(cheb(A, torch.cat(hs, dim=2), st["init"], precision))
    for blk in st["res"]:
        y = torch.relu(cheb(A, h, blk["w1"], precision))
        h = torch.relu(cheb(A, y, blk["w2"], precision) + h)
    return cheb(A, h, params["head"], precision)


def loss(A, params, x, y, windows, **kw):
    """The mean squared error of ``forward``."""
    return ((y - forward(A, params, x, windows, **kw)) ** 2).mean()


def dropout_masks(generator, batch, m, hidden, windows, layers, keep):
    """One step's keep masks, in the program's draw order: per branch,
    per layer, ``U[0, 1) < keep`` of one float32 draw ``[T, B, M, H]``
    from ``generator`` (on the device the program drew on)."""
    return [[torch.rand((T, batch, m, hidden), generator=generator,
                        device=generator.device, dtype=torch.float32) < keep
             for _ in range(layers)] for T, _, _ in windows]


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


def named_leaves(tree, prefix=""):
    """``(dotted name, leaf)`` of a tree of dicts and lists, in order."""
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


def rebuild(tree, flat, prefix=""):
    """``tree`` with each leaf replaced by ``flat[its dotted name]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in enumerate(tree)]
    return flat[prefix]


def train_steps(A, params, data, labels, batches, windows, *, keep,
                learning_rate, decay_rate, decay_steps, seed, layers,
                precision="float64", chunk=None, half=False) -> dict:
    """Adam steps (optax's update: bias-corrected moments, eps 1e-8
    outside the square root; the staircase rate ``lr decay^floor(count /
    decay_steps)``) on one batch each, the dropout masks drawn from a
    generator on ``data``'s device seeded with ``seed`` (the Trainer's).
    Each step's gradient is summed over chunks of ``chunk`` samples (the
    whole batch at once without it).  ``half``: the fault of a step that
    takes half of each batch.  Returns each step's loss, the first
    gradient's norm per leaf (dotted names) and each leaf's change over
    the steps.  TF32 is off throughout, restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(A, params, data, labels, batches, windows,
                            keep=keep, learning_rate=learning_rate,
                            decay_rate=decay_rate, decay_steps=decay_steps,
                            seed=seed, layers=layers, precision=precision,
                            chunk=chunk, half=half)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _train_steps(A, params, data, labels, batches, windows, *, keep,
                 learning_rate, decay_rate, decay_steps, seed, layers,
                 precision, chunk, half) -> dict:
    named = dict(named_leaves(params))
    p = {k: v.detach().to(torch.float64).clone() for k, v in named.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    gen = torch.Generator(device=data.device).manual_seed(seed)
    m = data.shape[1]
    hidden = named["lstms.0.0.bz"].shape[0]
    losses, grad_norms = [], None
    for count, rows in enumerate(batches):
        B = len(rows)
        masks = dropout_masks(gen, B, m, hidden, windows, layers, keep)
        if half:
            B //= 2
            rows = rows[:B]
            masks = [[mk[:, :B] for mk in br] for br in masks]
        step = chunk or B
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        tree = rebuild(params, leaves)
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total = 0.0
        for lo in range(0, B, step):
            idx = torch.as_tensor(rows[lo:lo + step], device=data.device)
            x = data[idx].to(torch.float64)
            y = labels[idx].to(torch.float64)
            part = [[mk[:, lo:lo + step] for mk in br] for br in masks]
            pred = forward(A, tree, x, windows, keep=keep, masks=part,
                           precision=precision)
            # This chunk's share of the batch mean.
            part_loss = ((y - pred) ** 2).sum() / (B * y[0].numel())
            g = torch.autograd.grad(part_loss, list(leaves.values()))
            for k, gk in zip(leaves, g):
                grads[k] += gk
            total += float(part_loss.detach())
            del pred, part_loss, g
        losses.append(total)
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
