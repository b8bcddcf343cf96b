"""Device times of the int8 conversion kernels (``csrc/quant.cu``) against
the plain PyTorch expression they replace, at the 50k serving request's
carries (50,176 x 512 elements), with each kernel's least time.

    python3 tools/quant_times.py

Builds ``csrc/quant.cu`` (printing what ``ptxas`` says of each kernel),
checks each kernel bit-equal to the plain expression, and prints one JSON
line: for each case the kernel's and the plain expression's device ms
(``chip_smoke.device_ms``, 50 calls after a warm-up), the least time of
the bytes its elements need at 3.35 TB/s, and the kernel's share of it;
for the dequantisation also the one library call that computes the same
bits, ``torch.mul(q, s)`` (into a bf16 ``out`` for a bf16 result); with
the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS = 50_176, 512
PEAK_BYTES = 3.35e12


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from cnn_graph_tpu_torch import _build
    from cnn_graph_tpu_torch.ops import quant

    _, log = _build.build("quant")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(ROWS, COLS, generator=gen, device=dev)
    s = torch.clamp_min(x.abs().amax(), 1e-30) * torch.tensor(
        2.0 / 127.0, device=dev)
    q = quant.quantize_int8(x, s)
    n = x.numel()
    y_bf16 = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
    cases = {
        "dequant_f32": (lambda: quant.dequantize_int8(q, s),
                        lambda: q.to(torch.float32) * s,
                        lambda: torch.mul(q, s), 5),
        "dequant_bf16": (
            lambda: quant.dequantize_int8(q, s, torch.bfloat16),
            lambda: (q.to(torch.float32) * s).to(torch.bfloat16),
            lambda: torch.mul(q, s, out=y_bf16), 3),
        "dequant_f32_float": (lambda: quant.dequantize_int8(q, 0.01),
                              lambda: q.to(torch.float32) * 0.01,
                              lambda: torch.mul(q, 0.01), 5),
        "quant_f32": (
            lambda: quant.quantize_int8(x, s),
            lambda: torch.clamp(torch.round(x / s), -127,
                                127).to(torch.int8), None, 5),
        "quant_f32_float": (
            lambda: quant.quantize_int8(x, 0.01),
            lambda: torch.clamp(torch.round(x / 0.01), -127,
                                127).to(torch.int8), None, 5),
    }
    out = {}
    for name, (kernel, plain, library, bytes_per) in cases.items():
        want = plain()
        if not torch.equal(kernel(), want):
            raise SystemExit(f"{name}: kernel differs from the plain path")
        if library is not None and not torch.equal(library(), want):
            raise SystemExit(f"{name}: the library call differs from the "
                             "plain path")
        k_ms, p_ms = (cs.device_ms(kernel, 50), cs.device_ms(plain, 50))
        lib_ms = None if library is None else cs.device_ms(library, 50)
        least = bytes_per * n / PEAK_BYTES * 1e3
        out[name] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                     "library_ms": lib_ms, "least_ms": least,
                     "roofline_pct": 100.0 * least / k_ms}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out["card"] = card.strip()
    out["elements"] = n
    print("quant_times", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
