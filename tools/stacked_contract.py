"""Time the ways to contract a bf16 Chebyshev basis with f32 output, at the
50k scattered graph's bf16 request, on one CUDA card.

    python3 tools/stacked_contract.py [--reps N]

``cheby_conv``'s stacked route (``ops/filters.py stacked_taps``) sums
``T_k(L) x W_k`` over k.  On a bf16 operator and f32 activations JAX
contracts with ``preferred_element_type=f32``: bf16 products summed and
returned in f32.  This script builds the basis of chip_smoke.py phase
11's request (the NodeClassifier on the 50k scattered graph: K=25,
B=1, M=50,000 of 50,048 padded rows, Fin=512, 16 classes) as
``cheby_basis`` lays it out, from seeded random values, and times, by
device work (``chip_smoke.device_ms``):

* ``bf16_einsum``: the einsum on bf16 operands, rounded to bf16 (the
  route before its repair; for scale only);
* ``upcast``: the basis and W upcast to f32, then the einsum;
* ``mm_out_f32``: one ``torch.mm(..., out_dtype=torch.float32)`` on
  ``[B*M, K*Fin]`` bf16, after the basis is laid out for it;
* ``mm_out_f32_per_k``: K such products of ``[B*M, Fin]`` slices,
  summed in f32, with no copy of the basis: the route kept,
  ``ops.filters.stacked_taps``, called as the route calls it.

Each is first held against ``upcast`` (1e-4 of its largest entry: sums
of 12,800 f32 products in another order; the bf16 einsum is reported,
not held), then timed in turns, ``--reps``
times over; the script prints each mean, its peak memory above the
basis, the card's name and power limit, and the rows as one JSON line.
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
from cnn_graph_tpu_torch.ops.cheby import _unrows  # noqa: E402
from cnn_graph_tpu_torch.ops.filters import stacked_taps  # noqa: E402

K, B, M, MP, FIN, OUT = 25, 1, 50000, 50048, 512, 16


def _ways(basis, w):
    wb = w.to(torch.bfloat16)

    def mm_out(b):
        a = b.permute(1, 2, 0, 3).reshape(B * M, K * FIN)
        return torch.mm(a, wb.reshape(K * FIN, OUT),
                        out_dtype=torch.float32).reshape(B, M, OUT)

    return {
        "bf16_einsum": lambda: torch.einsum(
            "kbmf,kfo->bmo", basis, wb).to(torch.float32),
        "upcast": lambda: torch.einsum(
            "kbmf,kfo->bmo", basis.float(), wb.float()),
        "mm_out_f32": lambda: mm_out(basis),
        "mm_out_f32_per_k": lambda: stacked_taps(basis, w, torch.float32),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("stacked_contract needs a CUDA device; none is "
                           "visible")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = smoke.card()
    gen = torch.Generator(device=dev).manual_seed(0)
    # cheby_basis's layout: the stacked [K, Mp, B*Fin] carries, sliced to
    # M rows and viewed as [K, B, M, Fin].
    stacked = torch.randn(K, MP, B * FIN, generator=gen, device=dev).to(
        torch.bfloat16)
    basis = _unrows(stacked, B, M, FIN)
    w = 0.05 * torch.randn(K, FIN, OUT, generator=gen, device=dev)
    ways = _ways(basis, w)
    want = ways["upcast"]()
    scale = float(want.abs().max())
    rows = {}
    for name, fn in ways.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = fn()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        extra = (torch.cuda.max_memory_allocated() - base) / 2**30
        if name != "bf16_einsum":
            smoke.check(got.dtype == torch.float32 and err <= 1e-4 * scale,
                        f"{name}: off the upcast by {err:.3g} of {scale:.3g}")
        rows[name] = {"max_abs_err": err, "extra_gib": extra, "ms": []}
        del got
    for _ in range(args.reps):
        for name, fn in ways.items():
            rows[name]["ms"].append(smoke.device_ms(fn, 5))
    for name, r in rows.items():
        r["ms"] = sum(r["ms"]) / len(r["ms"])
        print(f"{name}: {r['ms']:.4f} ms, max |y - upcast| "
              f"{r['max_abs_err']:.3g} (of max {scale:.3g}), peak "
              f"{r['extra_gib']:.2f} GiB above the basis [{gpu}]",
              flush=True)
    print(json.dumps({"basis": [K, B, M, FIN], "w": [K, FIN, OUT],
                      "card": gpu, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
