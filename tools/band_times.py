"""Device times of the banded kernels K1, K5 and K6 at 128x128 blocks on
the bench's 50k city graph, in one checkout, so that two commits'
``csrc/band.cu`` can be timed in turns in one call on one card.

    python3 tools/band_times.py CHECKOUT TAG

Loads CHECKOUT's package and ``chip_smoke.py`` (its ``device_ms``,
``_layout_inputs``, ``cast_op``, ``SIDE`` and ``KNN``), builds its
``csrc/band.cu``, and prints one line, ``TAG`` and a JSON object of the
device ms of L@x and the hop (C = 512, 50 calls each) for every layout
(dkw K1, uniform K5, ragged K6) in bf16, int8 and f32.  Run each
checkout in its own process, in turns (parent, change, change,
parent).  Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys


def main(root: str, tag: str):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cnn_graph_tpu_torch import _build, graphs
    from cnn_graph_tpu_torch.ops import device_laplacian, quantize_banded
    from cnn_graph_tpu_torch.ops.band import layout_call

    _build.build("band")
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    L, _ = graphs.city_graph(cs.SIDE, k=cs.KNN, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def build(**kw):
        return device_laplacian(L, fmt="banded", dtype=torch.bfloat16,
                                device=dev, **kw)

    def layouts(op, kernel_layout=False):
        by = {"bf16": op, "int8": quantize_banded(op, sample_x=3.0),
              "f32": cs.cast_op(op)}
        return {lab: dataclasses.replace(o, use_pallas=True)
                for lab, o in by.items()} if kernel_layout else by

    ops = {"dkw": layouts(build()), "uniform": layouts(build(ragged=False)),
           "ragged": layouts(build(use_pallas=False), kernel_layout=True)}
    out = {}
    for lay, by in ops.items():
        for lab, o in by.items():
            x, x0, _, scale = cs._layout_inputs(o, gen)
            out[f"{lay}_{lab}_spmm"] = cs.device_ms(
                lambda: layout_call(o, x, band_scale=scale), 50)
            out[f"{lay}_{lab}_hop"] = cs.device_ms(
                lambda: layout_call(o, x, x0, band_scale=scale), 50)
    print(tag, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
