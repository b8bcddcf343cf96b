"""Time the fused Chebyshev kernels K2 and K3 with a 2- and a 3-stage
cp.async ring, on one CUDA card.

    python3 tools/ring_depth.py [--reps N]

``csrc/cheby_fused.cu`` holds both depths of every ``cheby_conv_kernel``
instantiation; the wrappers launch ``ops.cheby.RING_STAGES``.  This
script calls the launchers with each depth (``_launch_conv`` for K2,
``_launch_dw`` for K3, the per-rank partials without the fold) at
``chip_smoke.py``'s phase-7 shapes (the bench's dense_fused conv and
ChebNet layer 1's forward and dx, on the MNIST grid's operators), in f32
and bf16.  It first holds each depth's result against the plain version
(f32 1e-4, bf16 1e-2 of the largest entry, as phase 7), then times the
two depths by device work (``chip_smoke.device_ms``) in turns, 3, 2, 2,
3, ``--reps`` times over, and prints each mean and the 2-stage time's
share of the 3-stage one, the card's name and power limit, and the rows
as one JSON line.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from cnn_graph_tpu_torch.data import (  # noqa: E402
    mnist_graph_data,
    synthetic_mnist,
)
from cnn_graph_tpu_torch.ops import (  # noqa: E402
    cheby_conv_fused_reference,
    cheby_dw_fused_reference,
    device_laplacian,
)
from cnn_graph_tpu_torch.ops.cheby import (  # noqa: E402
    _fold_dw_partials,
    _launch_conv,
    _launch_dw,
)

DEPTHS = (2, 3)
ORDER = (3, 2, 2, 3)  # one turn: each depth twice, the parent's first


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="turns of (3, 2, 2, 3) per kernel and shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("ring_depth needs a CUDA device; none is visible")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = smoke.card()
    print(f"card: {gpu}", flush=True)
    splits = synthetic_mnist(n_train=smoke.CHEB_B, n_val=0,
                             n_test=smoke.CHEB_B, seed=smoke.CHEB_SEED)
    Ls = mnist_graph_data(splits, seed=smoke.CHEB_SEED)[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    K = smoke.CHEB["K"][0]
    rows = []
    for lab, dt in smoke.DTYPES.items():
        tol = 1e-4 if lab == "f32" else 1e-2
        for shape, (B, lvl, F, O) in smoke.K2_SHAPES.items():
            op = device_laplacian(Ls[lvl], fmt="dense", dtype=dt, device=dev,
                                  use_pallas=True)
            x = torch.randn(B, op.m, F, generator=gen, device=dev)
            w = 0.05 * torch.randn(K, F, O, generator=gen, device=dev)
            g = torch.randn(B, op.m, O, generator=gen, device=dev)
            calls = {
                "K2": (lambda st: _launch_conv(op, x, w, st),
                       lambda: cheby_conv_fused_reference(x, op, w),
                       lambda y: y),
                "K3": (lambda st: _launch_dw(op, x, g, K, st),
                       lambda: cheby_dw_fused_reference(x, op, g, K),
                       lambda p: _fold_dw_partials(p, op.compute_dtype)),
            }
            for kernel, (launch, plain, finish) in calls.items():
                want = plain()
                scale = float(want.abs().max())
                for st in DEPTHS:
                    err = float((finish(launch(st)) - want).abs().max())
                    smoke.check(err <= tol * scale,
                                f"{kernel} {lab} {shape} {st} stages: "
                                f"{err:.3g} over {tol * scale:.3g}")
                times = {st: [] for st in DEPTHS}
                for _ in range(args.reps):
                    for st in ORDER:
                        times[st].append(smoke.device_ms(
                            lambda st=st: launch(st), 10))
                ms = {st: sum(t) / len(t) for st, t in times.items()}
                row = {"kernel": kernel, "dtype": lab, "shape": shape,
                       "x": [B, op.m, F], "O": O,
                       **{f"ms_{st}": ms[st] for st in DEPTHS},
                       **{f"runs_{st}": times[st] for st in DEPTHS},
                       "ratio_2_to_3": ms[2] / ms[3]}
                rows.append(row)
                print(f"{kernel} {lab} {shape} x {row['x']} O {O}: 2 stages "
                      f"{ms[2]:.4f} ms, 3 stages {ms[3]:.4f} ms, ratio "
                      f"{row['ratio_2_to_3']:.4f} [{gpu}]", flush=True)
    print(json.dumps({"ring_depth": rows}))
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
