"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--profile-dir DIR]

Phases, each fatal on failure (no CPU path, no fallback):

1. require a CUDA device; print the card's name and power limit;
2. build the banded kernel (csrc/band.cu: ``band_rows_kernel``, the
   walk over the band's nonzeros row by row, for K1 on the deep-K-window
   layout, K5 on the uniform band and K6 on the flat ragged band), the
   fused Chebyshev kernels (csrc/cheby_fused.cu: ``cheby_conv_kernel``,
   one template whose tap is K2's conv or K3's weight gradient, each in
   2- and 3-stage rings),
   the BSR operators' row-sparse gather kernel (csrc/bsr.cu,
   ``bsr_rows_kernel``, launched as K4 by ``bsr_colstream`` and as
   K7/K8/K9 by ``bsr_csr``; it shares csrc/rows.cuh with
   ``band_rows_kernel``) and the probes P1-P3 (csrc/probes.cu) from
   source, one nvcc each, started together; print each kernel's
   registers and shared memory, and the tensor-core instructions
   (``HMMA``/``HGMMA``) in K2's and K3's SASS (``cuobjdump -sass``),
   which their bf16 instantiations must hold;
3. hold the banded kernel K1 against both its plain PyTorch versions,
   the window product (``banded_dkw_reference``) and the row walk
   (``banded_rows_reference``), on the real 50,176-node serving operator
   at C = 512, for L@x, the hop 2L@x - x0 and the adjoint hop
   2L@x - x0 + c, in int8 (bit-identical; no adjoint hop), bf16 (one
   bf16 ulp: all round an f32 accumulation of exact bf16 products,
   summed in another order) and f32 (atol 1e-4, another summation
   order); time each form beside phase 16's library time, the sparse
   bound (``sparse_roofline``) and the block format's work
   (``spmm_roofline``);
4. serve the bench's NodeClassifier (K=25, Fin=512, 16 classes) on
   city_graph(224, k=8) through compile_serving: 4 requests in bf16 and
   4 in int8, each with its own features; check 24 kernel launches per
   request, finite [50176, 16] logits, and the served logits against the
   same requests run through the plain version on the card;
5. train the bench's deep NodeClassifier (K=25, Fin=512, hidden=[512],
   16 classes; bench.py:243-321) for 4 adam steps through
   train_node_classifier on label-correlated features: on the bf16
   operator as the bench does, and on the f32 operator with the keep
   probability 0.8 of experiments/node_classification.py; check 72
   kernel launches per step (3 L@x, 46 hops, 23 adjoint hops), a finite
   loss that falls, and one step's loss and gradients against the same
   step with every band product on the plain version (0 launches);
6. time per-request latency, ms per training step (kernel and plain
   version) and the kernel's ms per form beside the plain version's,
   with CUDA events after a warm-up;
7. hold the fused kernels K2 (the conv) and K3 (its weight gradient)
   against their plain versions at the bench's dense_fused shape (x and
   g [100, 976, 32], w [25, 32, 32] on the 976-node level-0 operator)
   and ChebNet layer 1's shape (x [100, 244, 32], w [25, 32, 64], g
   [100, 244, 64]) in f32 (1e-4 of the largest value) and bf16 (1e-2),
   and K2 also at layer 1's dx shape (g [100, 244, 64], W^T [25, 64,
   32]); time both by device work (``device_ms``) beside their bounds,
   and K3's fold of its per-rank partials alone; print each geometry,
   one CTA's shared memory and how many clusters the card holds at once
   (``conv_resources``), and fail unless the ring fits in 232,448 bytes
   and one cluster fits;
8. serve the paper's ChebNet (MNIST grid, F=[32, 64], K=[25, 25], p=[4,
   4], M=[512, 10]; nips2016/mnist.ipynb cells 14-17) on its coarsened
   operators through compile_serving: 4 requests of 100 synthetic digits,
   with f32 operators (the paper's) and with bf16 ones; check 1 K2 and
   0 K3 launches per request (layer 0, Fin = 1, takes the stacked path),
   finite [100, 10] logits, and the logits against the same requests
   through operators whose fused conv runs the plain versions; then
   serve the f32 model through compile_serving's defaults (int8=True):
   every dense operator quantized (QuantDenseLaplacian), 4 requests
   with 0 K2 and 0 K3 launches, finite logits equal to the same int8
   serving on the CPU within 1e-4 of their max (the CPU path is held
   to JAX's int8 ChebNet by tests/test_torch_chebnet.py), the int8 K=25
   ``cheby_finals`` chain on the level-0 twin bit-identical on the card
   and on the CPU, and the argmax agreement with the f32 logits within
   0.005 of JAX's int8 ChebNet's on the same weights and requests;
9. train that ChebNet (dropout 0.5, L2 5e-4) for 4 adam steps through
   train_classifier on one fixed batch of 100, with f32 and bf16
   operators; check 2 K2 and 1 K3 launches per step, a finite loss that
   falls, and one step's loss and gradients against the plain twin with
   the same dropout seed; time requests and steps beside the twin's;
10. on the bench's 50k scattered kNN graph (bench.py:763-787: 50,000
   Gaussian points in 8-D, seed 0, k=10, RCM, normalized Laplacian),
   built by ``device_laplacian(fmt="auto")``, which must give the
   column-streamed BSR operator: hold K4 (``bsr_colstream``, the row
   kernel of csrc/bsr.cu) against its plain version
   (``bsr_rows_reference``, the same row walk) and the block walk's plain
   version
   (``bsr_colstream_reference``) at C = 512 for L@x and the hop in f32
   (atol 1e-4 of the max), bf16 (one bf16 ulp) and int8 (bit-identical),
   and time all three, each time printed beside phase 16's library time,
   the sparse bound (``sparse_roofline``) and the block format's work
   (``spmm_roofline``); then the same checks, through K4 and K7, on a
   graph with a row of 300 nonzeros (``hub_graph``);
11. serve the bench's NodeClassifier on it (4 requests in bf16, 4 in
   int8, features labelled by node index as bench.py:699-704 makes
   them): 24 K4 launches per request, finite [50000, 16] logits, the
   logits against the plain twin's; train the deep one (hidden=[512]) on
   the bf16 operator for 4 adam steps: 72 K4 launches per step (26 L@x,
   46 hops), a falling loss, one step against the plain twin; time
   requests and steps beside the twin's;
12. hold ``bsr_csr`` (the same row kernel) against both plain versions,
   as phase 10 does, through each route it ports: K8 on the scattered
   graph's ``col_stream=False`` operator (f32 and bf16 L@x), K7 int8 on
   that operator's int8 twin (G = 1, L@x and hop), K9 on its
   ``chunked_rows=True`` operator (f32 and bf16 L@x) and K7 float with
   G > 1 on the 50k city graph's ``fmt="bsr", col_stream=False`` bf16
   operator (L@x and hop); then serve
   one request through each route's operator: 24 launches of that route
   each, logits against the plain twin's;
13. on the 50k city graph at C = 512, hold K5 (the ``ragged=False``
   operator) and K6 (the ragged operator built with ``use_pallas=False``
   and then given it, quantized before for int8) against both plain
   versions, as phase 3, for
   L@x, the hop and (float) the adjoint hop in f32, bf16 and int8,
   tolerances as phase 3, and time them as phase 3 does; check the
   in-place hop (``donate``) of K1, K5 and K6 bit-identical to the
   out-of-place one and written into x0's storage, and time the two;
14. run bench.py's K=25 chains (bench.py:423-612): ``cheby_finals`` in a
   loop of K-blocks with the bf16 renormalisation, and int8 carries on
   the quantized operator, timed by ``utils.profiling.slope_time``, on
   the 50k graph in each layout (dkw -> K1, ragged -> K6, uniform ->
   K5) and on ``city_graph(316, k=8)`` (~100k nodes) in the default
   layout; check K-1 launches per K-block, the int8 chain bit-identical
   to the plain chain's and bf16 within 2e-2 of its max; print us per
   SpMM, Gedges/s, the roofline and the plain chain's time; the 100k
   operator is freed after;
15. serve the bench's NodeClassifier on the uniform operator in bf16 and
   int8 (4 requests each, 24 K5 launches per request, logits against
   the plain twin's), train the deep one on it in bf16 (4 adam steps, 72
   K5 launches per step, one step against the plain twin), and serve one
   bf16 and one int8 request through the ragged operator (24 K6
   launches each);
16. time the library call for each sparse product: one
   ``torch.sparse.mm`` of the same matrix in CSR at C = 512 on the card
   (50k city graph and 50k scattered graph; f32 and bf16; torch has no
   int8 one), beside the kernels' bounds; the city graph's before phase
   3 and the scattered graph's first thing in phase 10, so that phases
   3, 10, 12 and 13 print it beside their kernels' times;
17. with ``--profile-dir DIR`` only: trace 3 requests per serving mode
   after 2 warm-ups (banded, scattered BSR, ChebNet, uniform, ragged),
   2 bf16 training steps after one (banded, scattered and uniform
   NodeClassifier), 2 f32 ChebNet training steps after one, and 3
   library calls after one, with ``torch.profiler`` (CPU and CUDA
   activities); print the device time per request or step, its share
   of the measured time, the largest device kernels and aten ops, and
   for training the device time by part (K1, K5 or K4 by form, taps,
   dW, injections, casts, adam; K2 forward, K2 dx, K3, K3's fold, the
   stacked basis of ChebNet's layer 0, fc, adam); write each
   ``key_averages()`` table
   to ``DIR/profile_<mode>.txt``;
18. the probes (utils/probes.py, csrc/probes.cu): hold P1 (``mxu_probe``)
   at every geometry of experiments/_probe.py main_mxu, P2
   (``pred_probe``) in every variant of main_pred and P3
   (``loopcost_probe``) at unroll 1, 2, 4 and 8 against their plain
   versions on seeded operands (bf16 P1/P2 ones scaled by
   ``probes.CHECK_SCALE``, so that a dropped carry shows), two
   replicas, after 1 and 3 iterations (P3: 64 dots a call, 1 and 3
   chained calls): int8 bit-identical, bf16 within one bf16 ulp after
   1 and 2e-2 of the max after 3 (``probes.compare``); then time
   cuBLAS's chained products (the ``peak`` rows) and each probe at one replica and at enough replicas
   for two CTAs per SM, with its launches counted, and print each rate
   with its share of the data sheet's peak and of the measured cuBLAS
   peak.

Each 50k scattered operator is freed after its phase.

The last three lines are the kernel record as one JSON object (each
kernel with its launches on the main path, its time and its plain
version's, its bound on the card and the library call's time), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cnn_graph_tpu_torch import _build, graphs  # noqa: E402
from cnn_graph_tpu_torch.data import (  # noqa: E402
    mnist_graph_data,
    synthetic_mnist,
)
from cnn_graph_tpu_torch.models import ChebNet, NodeClassifier  # noqa: E402
from cnn_graph_tpu_torch.models.common import (  # noqa: E402
    map_operators,
    tree_leaves,
    tree_map,
)
from cnn_graph_tpu_torch.ops import (  # noqa: E402
    BandedLaplacian,
    BlockSparseLaplacian,
    DenseLaplacian,
    QuantBandedLaplacian,
    QuantBlockSparseLaplacian,
    QuantDenseLaplacian,
    banded_dkw,
    banded_ragged,
    banded_rows_reference,
    banded_uniform,
    bsr_colstream,
    bsr_colstream_reference,
    bsr_csr,
    bsr_csr_reference,
    bsr_rows_reference,
    cheby_conv,
    cheby_conv_fused,
    cheby_conv_fused_reference,
    cheby_dw_fused,
    cheby_dw_fused_reference,
    cheby_finals,
    conv_geometry,
    conv_resources,
    device_laplacian,
    fused_filter,
    packing,
    quantize_banded,
    quantize_block_sparse,
)
from cnn_graph_tpu_torch.ops.band import layout_call  # noqa: E402
from cnn_graph_tpu_torch.ops.cheby import (  # noqa: E402
    _fold_dw_partials,
    _launch_dw,
)
from cnn_graph_tpu_torch.serve import compile_serving  # noqa: E402
from cnn_graph_tpu_torch.train import (  # noqa: E402
    train_classifier,
    train_node_classifier,
)
from cnn_graph_tpu_torch.utils import (  # noqa: E402
    probes,
    roofline,
    slope_time,
    sparse_roofline,
    spmm_roofline,
)

SIDE, KNN, FIN, CLASSES, K = 224, 8, 512, 16, 25
N_REQUESTS = 4  # per serving mode
TRAIN_STEPS, LEARNING_RATE = 4, 1e-3  # per training mode; bench.py:268
# Kernel launches per training step of the deep model: each layer's
# forward runs 1 L@x and K-2 hops; layer 1's backward (layer 0 has no
# input gradient) K-2 adjoint hops and 1 L@x.
STEP_FORMS = {"spmm": 3, "hop": 2 * (K - 2), "hop_c": K - 2}
SOURCE = "cnn_graph_tpu_torch/csrc/band.cu"
# The banded kernels by layout, and the TPU kernel each replaces.
LAYOUT_KERNELS = {"dkw": banded_dkw, "uniform": banded_uniform,
                  "ragged": banded_ragged}
REPLACES = {"dkw": "cnn_graph_tpu/ops/pallas_band.py:448",      # K1
            "uniform": "cnn_graph_tpu/ops/pallas_band.py:70",   # K5
            "ragged": "cnn_graph_tpu/ops/pallas_band.py:202"}   # K6
KERNEL_ID = {"dkw": "K1", "uniform": "K5", "ragged": "K6"}
# The kernel of csrc/band.cu each layout launches.
BAND_KERNEL = {lay: "band_rows_kernel" for lay in LAYOUT_KERNELS}
# bench.py's chains: the 100k city graph (bench.py:555) and the K-blocks
# slope_time differences (bench.py:401).
SIDE_100K, CHAIN_UNITS = 316, (2, 8)
PLAIN_CHAIN_UNITS = (1, 3)  # the plain chain's K-blocks take ~0.1-0.2 s
# The paper's MNIST ChebNet (nips2016/mnist.ipynb cells 14-17,
# experiments/mnist.py:66-75): 4 coarsening levels from seed 2017.
CHEB = dict(F=[32, 64], K=[25, 25], p=[4, 4], M=[512, 10], dropout=0.5,
            regularization=5e-4)
CHEB_B, CHEB_SEED = 100, 2017
# The share of phase 8's 400 requests on which the int8 ChebNet's argmax
# equals the f32 one's, as JAX's quantize_model_operators ChebNet gives
# it on the same seeded weights and requests (tests/test_torch_chebnet.py
# test_phase8_int8_agreement_matches_jax, on the CPU): 347 of 400.
CHEB_INT8_AGREEMENT = 0.8675
CHEB_SOURCE = "cnn_graph_tpu_torch/csrc/cheby_fused.cu"
CHEB_REPLACES = {"K2": "cnn_graph_tpu/ops/pallas_cheby.py:61",    # _kernel
                 "K3": "cnn_graph_tpu/ops/pallas_cheby.py:210"}  # _dw_kernel
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The bench's 50k scattered kNN graph (bench.py:763-787) and its kernels.
SCAT_N, SCAT_DIMS, SCAT_K = 50000, 8, 10
BSR_SOURCE = "cnn_graph_tpu_torch/csrc/bsr.cu"
BSR_KERNEL = "bsr_rows"  # csrc/bsr.cu bsr_rows_kernel, for K4 and K7-K9
BSR_REPLACES = {"K4": "cnn_graph_tpu/ops/pallas_spmm.py:129",  # colstream
                "K7": "cnn_graph_tpu/ops/pallas_spmm.py:35",   # grouped
                "K8": "cnn_graph_tpu/ops/pallas_spmm.py:450",  # _kernel
                "K9": "cnn_graph_tpu/ops/pallas_spmm.py:502"}  # chunked
# K4 launches per step of the deep model on BSR: each layer's forward
# 1 L@x and K-2 hops; layer 1's backward K-1 L@x (one per hop and one
# for its L@x); layer 0's features need no gradient.
BSR_STEP_FORMS = {"spmm": 2 + (K - 1), "hop": 2 * (K - 2)}
# The probes (phase 18) and the Pallas probe each replaces.
PROBE_SOURCE = "cnn_graph_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {"mxu": "experiments/_probe.py:154",       # _mxu_probe
                  "pred": "experiments/_probe.py:253",      # _pred_probe
                  "loopcost": "experiments/_probe.py:393"}  # main_loopcost
# Reduced counts: P1/P2 iterations of the longer timed chain (sq1024 an
# eighth, at least 32), cuBLAS chain links, P3 chained calls of 2048
# dots in the longer chain, and the plain versions' longer chains.
PROBE_ITERS, PEAK_ITERS, PROBE_CALLS = 200, 20, 6
PLAIN_PROBE_ITERS, PLAIN_PROBE_CALLS = 3, 2


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# Spin cycles per call enqueued behind device_ms's spin kernel: 2 ms at
# the H100's 1.98 GHz boost clock, more than a wrapper's host time.
SPIN_CYCLES_PER_CALL = 4_000_000


@contextlib.contextmanager
def call_seconds(module, name: str):
    """The seconds of each call of ``module.name`` made inside the block,
    in a list: a step of a builder, timed where the builder calls it."""
    fn, spent = getattr(module, name), []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield spent
    finally:
        setattr(module, name, fn)


def cuda_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls after one
    warm-up call, from CUDA events, with the host's enqueue hidden: a
    spin kernel holds the stream while the host enqueues the ``n`` calls,
    so the events time the device work alone.  ``cuda_ms`` times both,
    which for a kernel shorter than its wrapper's host time is the
    host's; requests and steps take ``cuda_ms``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * (n + 1))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def rows_plain(op, args, scale):
    """The row walk's plain version (``banded_rows_reference``) on ``op``'s
    layout."""
    lay = layout_of(op)
    if lay == "dkw":
        bands, sched, levels = op.bands_dkw, op.sched_dkw, op.levels
    elif lay == "ragged":
        bands, sched, levels = (op.band,), op.sched, op.levels
    else:
        bands, sched, levels = (op.band,), None, (op.band.shape[1],)
    return banded_rows_reference(bands, op.base, sched, op.nz_rowptr,
                                 op.nz_win, *args, layout=lay, levels=levels,
                                 G=op.rows_per_step, band_scale=scale)


def band_kernel_check(op, gen, what: str, lib: dict) -> dict:
    """``op``'s layout kernel (K1, K5 or K6) against its window plain
    version and the row walk's plain version, at C = FIN for every form it
    has; all timed, each time beside the
    sparse bound (``sparse_roofline``), the block format's work
    (``spmm_roofline``) and, for L@x, phase 16's library time ``lib``
    (the same matrix in CSR, by dtype).  Tolerances of ``_check_close``."""
    x, x0, c, scale = _layout_inputs(op, gen)
    plain = _plain_banded(op)
    dt = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(op.compute_dtype,
                                                           "f32")
    rec = {"max_abs_err": 0.0, "rows_max_abs_err": 0.0,
           "library_ms": lib.get(dt)}
    forms = {"spmm": (x, None, None), "hop": (x, x0, None)}
    if c is not None:  # the adjoint hop, float only
        forms["hop_c"] = (x, x0, c)
    for form, args in forms.items():
        def kern(a=args):
            return layout_call(op, *a, band_scale=scale)

        def ref(a=args):
            return layout_call(plain, *a, band_scale=scale)

        def rref(a=args):
            return rows_plain(op, a, scale)

        got = kern()
        pre = "" if form == "spmm" else form + "_"
        for key, want in ((pre + "max_abs_err", ref()),
                          (pre + "rows_max_abs_err", rref())):
            torch.cuda.synchronize()
            rec[key] = _check_close(got, want, f"{what} {form} ({key})")
            top = key[len(pre):]
            rec[top] = max(rec[top], rec[key])
        extra = sum(a is not None for a in args[1:])
        rec[pre + "ms"] = device_ms(kern, 20)
        rec[pre + "plain_ms"] = device_ms(ref, 3)
        rec[pre + "rows_plain_ms"] = device_ms(rref, 2)
        rec[pre + "roofline"] = sparse_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
        rec[pre + "block_roofline"] = spmm_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
    return rec


def print_band_kernel(what: str, rec: dict, gpu: str):
    """One line per banded kernel: each form's time beside its plain
    versions', its sparse bound and its block format's work; the library
    time beside L@x."""
    def one(pre):
        r, b = rec[pre + "roofline"], rec[pre + "block_roofline"]
        rows = (f", row walk plain {rec[pre + 'rows_plain_ms']:.4f}"
                if pre + "rows_plain_ms" in rec else "")
        return (f"{rec[pre + 'ms']:.4f} ms (plain {rec[pre + 'plain_ms']:.4f}"
                f"{rows} ms; sparse bound {r['bound_us'] / 1e3:.4f} ms "
                f"{r['bound_by']}, block format's work "
                f"{b['bound_us'] / 1e3:.4f} ms {b['bound_by']})")
    lib = ("none" if rec["library_ms"] is None
           else f"{rec['library_ms']:.4f} ms")
    c = f", +c {one('hop_c_')}" if "hop_c_ms" in rec else ""
    inplace = (f"; in place {rec['hop_inplace_ms']:.4f} ms vs out of place "
               f"{rec['hop_outofplace_ms']:.4f} ms" if "hop_inplace_ms" in rec
               else "")
    rows = (f" (row walk plain {rec['rows_max_abs_err']:.3g})"
            if "rows_max_abs_err" in rec else "")
    print(f"kernel {what} C={FIN}: max_abs_err {rec['max_abs_err']:.3g}"
          f"{rows}, L@x {one('')}; torch.sparse.mm {lib}; hop {one('hop_')}"
          f"{c}{inplace} [{gpu}]", flush=True)


# ------------------------------------- K5, K6, in place, bench's chains


def to_f32(op):
    """A float banded operator's f32 copy, every band array converted."""
    return dataclasses.replace(
        op, band=op.band.float(),
        bands_dkw=None if op.bands_dkw is None else tuple(
            b.float() for b in op.bands_dkw))


def band_launches() -> dict:
    return {lay: f.launches for lay, f in LAYOUT_KERNELS.items()}


def reset_band_launches():
    torch.cuda.synchronize()
    for f in LAYOUT_KERNELS.values():
        f.launches = 0
        f.form_launches.clear()


def layout_of(op) -> str:
    """The layout whose kernel an operator's products run."""
    if op.bands_dkw is not None:
        return "dkw"
    return "ragged" if op.levels else "uniform"


def _check_close(got, want, what: str) -> float:
    """Tolerances of phase 3: int8 bit-identical; bf16 one bf16 ulp (both
    round an f32 accumulation of exact bf16 products, summed in another
    order); f32 atol 1e-4 (another summation order).  Returns the
    largest absolute difference."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape")
    if got.dtype == torch.int8:
        check(torch.equal(got, want), f"{what} not bit-identical")
        return float((got.int() - want.int()).abs().max())
    torch.testing.assert_close(
        got.float(), want.float(), atol=1e-4,
        rtol=2**-7 if got.dtype == torch.bfloat16 else 0.0)
    return float((got.float() - want.float()).abs().max())


def _layout_inputs(op, gen):
    """x, x0, c at C = FIN in the operator's compute dtype (c None for
    int8) and the band scale."""
    x, x0, c = (torch.randn(op.m_padded, FIN, generator=gen,
                            device=op.base.device) for _ in range(3))
    if op.compute_dtype == torch.int8:
        return op.quantize(x), op.quantize(x0), None, op.band_scale
    return (*(t.to(op.compute_dtype) for t in (x, x0, c)), None)


def inplace_phase(op, gen, what: str) -> dict:
    """The in-place hop (``donate``): bit-identical to the out-of-place
    launch and written into x0's storage; both timed in turns."""
    x, x0, _, scale = _layout_inputs(op, gen)
    want = layout_call(op, x, x0, band_scale=scale)
    buf = x0.clone()
    ptr = buf.data_ptr()
    got = layout_call(op, x, buf, band_scale=scale, donate=True)
    torch.cuda.synchronize()
    check(got is buf and got.data_ptr() == ptr,
          f"{what}: the in-place hop did not return x0's storage")
    check(torch.equal(got, want), f"{what}: the in-place hop is not "
          "bit-identical to the out-of-place one")

    def outplace():
        return layout_call(op, x, x0, band_scale=scale)

    def inplace():
        return layout_call(op, x, buf, band_scale=scale, donate=True)

    t = [device_ms(f, 20) for f in (outplace, inplace, inplace, outplace)]
    return {"hop_outofplace_ms": (t[0] + t[3]) / 2,
            "hop_inplace_ms": (t[1] + t[2]) / 2}


def make_chain(op, u: int):
    """bench.py's chain (:461-474, :497-506): ``u`` K-blocks of
    ``cheby_finals(op, ., K)``; float carries renormalised to unit RMS
    after each block, int8 carries kept (one quantize in, one dequantize
    out).  Returns the final carry in float."""
    quant = op.compute_dtype == torch.int8

    def chain(x):
        with torch.no_grad():
            if quant:
                q = op.quantize(x.float())
                for _ in range(u):
                    q = cheby_finals(op, q, K)
                return op.dequantize(q)
            for _ in range(u):
                y = cheby_finals(op, x, K).float()
                x = (y * torch.rsqrt(y.pow(2).mean() + 1e-6)).to(x.dtype)
            return x

    return chain


def chain_phase(op, X, what: str, gpu: str) -> dict:
    """One bench chain on ``op``: K-1 launches of its layout's kernel per
    K-block and no other, the int8 chain bit-identical to the plain
    chain's and bf16 within 2e-2 of its max (one K-block), then us per
    SpMM by slope fit for both chains, Gedges/s and the roofline of the
    hop (23 of the 24 products).  ``launches`` is the one checked
    K-block's count, read before the timing runs."""
    kernel = LAYOUT_KERNELS[layout_of(op)]
    plain = _plain_banded(op)
    reset_band_launches()
    got = make_chain(op, 1)(X)
    torch.cuda.synchronize()
    launches = band_launches()
    n_launches = kernel.launches
    check(n_launches == K - 1 and sum(launches.values()) == K - 1,
          f"chain {what}: launches {launches}, want {K - 1} of "
          f"{layout_of(op)}")
    want = make_chain(plain, 1)(X)
    torch.cuda.synchronize()
    check(sum(band_launches().values()) == K - 1,
          f"chain {what}: the plain chain launched kernels")
    err = float((got - want).abs().max())
    if op.compute_dtype == torch.int8:
        check(torch.equal(got, want), f"chain {what}: int8 chain not "
              "bit-identical to the plain chain")
    else:
        check(err <= 2e-2 * float(want.abs().max()), f"chain {what}: off "
              f"the plain chain by {err:.3g} of max "
              f"{float(want.abs().max()):.3g}")
    per, fixed = slope_time(lambda u: make_chain(op, u), (X,),
                            units=CHAIN_UNITS)
    t = per / (K - 1)
    plain_per, _ = slope_time(lambda u: make_chain(plain, u), (X,),
                              units=PLAIN_CHAIN_UNITS, reps=1)
    plain_t = plain_per / (K - 1)
    roof = spmm_roofline(op, t, X.shape[1], extra_inputs=1)
    rec = {"layout": layout_of(op), "launches": n_launches,
           "us_per_spmm": t * 1e6, "gedges_per_s": op.nnz / t / 1e9,
           "fixed_ms": fixed * 1e3, "plain_us_per_spmm": plain_t * 1e6,
           "max_abs_err": err, "roofline": roof}
    print(f"chain {what} ({KERNEL_ID[rec['layout']]}) K={K} C={X.shape[1]}: "
          f"{rec['us_per_spmm']:.2f} us per SpMM, {rec['gedges_per_s']:.4f} "
          f"Gedges/s, {roof['achieved_frac_of_bound']:.3f} of the "
          f"{roof['bound_by']} bound {roof['bound_us']:.2f} us; plain "
          f"chain {rec['plain_us_per_spmm']:.2f} us per SpMM; max |kernel - "
          f"plain| {err:.3g} [{gpu}]", flush=True)
    return rec


def banded_serve_phase(served: dict, reqs: list, kernel, what: str,
                       gpu: str) -> dict:
    """Serve ``reqs`` through each handle of ``served``: K-1 launches of
    ``kernel`` per request and no other banded kernel, finite [m, 16]
    logits, and each request's logits against the same request through
    the plain version on the card (phase 4's checks)."""
    launches, logits = {}, {}
    for mode, serving in served.items():
        op = serving.model.op
        reset_band_launches()
        logits[mode] = [serving(x) for x in reqs[mode]]
        torch.cuda.synchronize()
        launches[mode] = kernel.launches
        n = len(reqs[mode])
        check(launches[mode] == n * (K - 1)
              and sum(band_launches().values()) == launches[mode],
              f"{what} {mode}: {band_launches()} launches for {n} requests")
        for y in logits[mode]:
            check(tuple(y.shape) == (op.m, CLASSES) and bool(
                torch.isfinite(y).all()), f"{what} {mode}: bad logits")
        # The same requests through the plain version on the card.
        twin = _plain_twin(op)
        p = serving.params["convs"][0]
        err = 0.0
        for x, y in zip(reqs[mode], logits[mode]):
            with torch.inference_mode():
                want = cheby_conv(x[None], twin, p["w"])[0] + p["b"]
            e = float((y - want).abs().max())
            err = max(err, e)
            # int8: identical carries, the same taps -> equal up to 1e-4.
            # bf16: carries rounded to bf16 after sums in another order
            # may differ by an ulp and travel along 24 hops.
            tol = 1e-4 if op.compute_dtype == torch.int8 else \
                2e-2 * float(want.abs().max())
            check(e <= tol, f"{what} {mode}: served logits off the plain "
                  f"version by {e:.3g} (limit {tol:.3g})")
        print(f"{what} {mode}: {n} requests, {launches[mode]} "
              f"{KERNEL_ID[layout_of(op)]} launches, logits "
              f"{tuple(logits[mode][0].shape)}, max |served - plain| "
              f"{err:.3g}", flush=True)
    return {"launches": launches, "logits": logits}


def csr_operand(L, m_padded: int, dev):
    """The rescaled Laplacian that ``device_laplacian`` packs, as one
    padded ``[m_padded, m_padded]`` CSR matrix on the card (f32 values),
    for the library call."""
    A = graphs.rescale_laplacian(L).tocsr()
    A.eliminate_zeros()
    m = A.shape[0]
    crow = np.concatenate([A.indptr, np.full(m_padded - m, A.indptr[-1])])
    return (torch.from_numpy(crow.astype(np.int64)).to(dev),
            torch.from_numpy(A.indices.astype(np.int64)).to(dev),
            torch.from_numpy(A.data.astype(np.float32)).to(dev), m_padded)


def library_phase(csr, gen, what: str, gpu: str) -> dict:
    """One ``torch.sparse.mm`` of the same matrix in CSR at C = FIN, by
    dtype, timed: the library yardstick for ``L @ x``, used nowhere in
    the port.  torch refuses int8 ("spmm not implemented for 'Char'"),
    so int8 has none.  ``calls`` holds each timed call, for the
    profile."""
    crow, col, val, mp = csr
    out = {"calls": {}, "int8": None}
    for lab, dt in DTYPES.items():
        x = torch.randn(mp, FIN, generator=gen, device=crow.device).to(dt)
        with warnings.catch_warnings():  # "sparse CSR support is beta"
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(crow, col, val.to(dt), size=(mp, mp))
        out["calls"][lab] = lambda _=None, A=A, x=x: torch.sparse.mm(A, x)
        out[lab] = device_ms(out["calls"][lab], 10)
        print(f"library {what} {lab}: torch.sparse.mm (CSR) C={FIN} "
              f"{out[lab]:.4f} ms [{gpu}]", flush=True)
    return out


def dense_cheby_bound(op, B: int, F: int, O: int, K_: int) -> dict:
    """The bound of one K2 call (or K3, whose operands have the same
    sizes) from its shapes: K-1 dense products ``[Mp, Mp] @ [Mp, B*F]``
    plus K taps ``[Mp*B, F] @ [F, O]``; L read once in its dtype, x and
    w (g for K3) read and y (dW) written once in f32."""
    mp = op.m_padded
    ops = (K_ - 1) * 2 * mp * mp * B * F + K_ * 2 * mp * B * F * O
    e = op.mat.element_size()
    nbytes = mp * mp * e + 4 * (B * mp * F + K_ * F * O + B * mp * O)
    return roofline(ops, nbytes, op.compute_dtype)


def bound_keys(r: dict) -> dict:
    """A roofline's bound as the kernel record's keys."""
    return {"bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"]}


def work_keys(r: dict) -> dict:
    """The block format's work (``spmm_roofline``) as the record's keys."""
    return {"block_work_ms": r["bound_us"] / 1e3,
            "block_work_by": r["bound_by"]}


def request_features(positions, n: int, seed: int = 1):
    """Patch labels [M] and ``n`` feature matrices [M, FIN] as
    bench.py:140-149 makes them: a per-class signature per spatial patch
    plus fresh noise per matrix."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(positions.shape[0]))
    patch = (positions[:, 0] // (side / 8)).astype(int) * 8 + (
        positions[:, 1] // (side / 8)).astype(int)
    labels = (patch % CLASSES).astype(np.int64)
    signatures = rng.normal(0, 1, (CLASSES, FIN)).astype(np.float32)
    return torch.from_numpy(labels), [torch.from_numpy(
        signatures[labels] + rng.normal(0, 1.0, (len(labels), FIN)).astype(
            np.float32)) for _ in range(n)]


def _plain_banded(op):
    """A banded operator (float or int8, any layout) whose products run
    its layout kernel's plain version."""
    return dataclasses.replace(op, use_pallas=False)


class _PlainBsrMixin:
    """Every BSR kernel call on the plain version (float and int8)."""

    def kernel_call(self, x, x0, route, block_scale=None):
        if route == "K4":
            return bsr_colstream_reference(
                self.blocks, self.cs_meta, self.cs_gcols, self.cs_gcolptr,
                self.cs_groupptr, x, x0, G=self.rows_per_step,
                block_shape=self.block_shape, block_scale=block_scale)
        return bsr_csr_reference(self.blocks, self.block_rowptr,
                                 self.block_cols, x, x0,
                                 block_shape=self.block_shape,
                                 block_scale=block_scale)


class _PlainBsr(_PlainBsrMixin, BlockSparseLaplacian):
    pass


class _PlainQuantBsr(_PlainBsrMixin, QuantBlockSparseLaplacian):
    pass


_PLAIN = {BlockSparseLaplacian: _PlainBsr,
          QuantBlockSparseLaplacian: _PlainQuantBsr}


def _plain_twin(op):
    """The operator with every kernel call on its plain version."""
    if isinstance(op, (BandedLaplacian, QuantBandedLaplacian)):
        return _plain_banded(op)
    return _PLAIN[type(op)](**{f.name: getattr(op, f.name)
                               for f in dataclasses.fields(op)})


def _device_kernels(avg):
    """Device kernel events of ``key_averages()``, without the device-side
    spans of ``record_function`` ranges, which would count twice."""
    return sorted((e for e in avg if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda e: -e.device_time_total)


def _busy_ms(avg, n: int) -> float:
    return sum(e.device_time_total for e in _device_kernels(avg)) / n / 1e3


def _trace(fn, n: int, out_dir: str, mode: str):
    """``key_averages()`` of ``n`` calls of ``fn`` under torch.profiler,
    its table written to ``out_dir/profile_<mode>.txt``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{mode}.txt"), "w") as f:
        f.write(avg.table(sort_by="cuda_time_total", row_limit=40))
    return avg, prof


def _pct(ms: float, total: float) -> float:
    return 100 * ms / total if total else float("nan")


def _print_top(avg, busy: float, n: int):
    kernels = _device_kernels(avg)
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    for kind, evs in (("kernel", kernels[:6]), ("op", ops[:6])):
        for e in evs:
            ms = e.device_time_total / n / 1e3
            print(f"  {kind} {e.key[:64]}: {ms:.3f} ms "
                  f"({_pct(ms, busy):.1f}%), {e.count / n:g} calls")


def profile_phase(served: dict, x: torch.Tensor, lat: dict, out_dir: str,
                  gpu: str, n: int = 3):
    """Device-time breakdown of ``n`` requests per serving mode."""
    os.makedirs(out_dir, exist_ok=True)
    for mode, serving in served.items():
        for _ in range(2):
            serving(x)
        avg, _ = _trace(lambda s=serving: s(x), n, out_dir, mode)
        busy = _busy_ms(avg, n)
        print(f"profile {mode}: device {busy:.3f} ms per request, "
              f"{100 * busy / lat[mode]:.1f}% of the {lat[mode]:.3f} ms "
              f"latency [{gpu}]")
        _print_top(avg, busy, n)


def train_parts(layout: str = "dkw") -> tuple:
    """Parts of a banded training step by the profiler range that holds
    them; casts are the aten conversions, which sit outside every other
    range.  The kernel's ranges are read from their device-side spans
    (one kernel each): a kernel launched through ctypes is not linked to
    the host-side event."""
    k = KERNEL_ID[layout]
    return (
        (f"{k} L@x", f"band_{layout}.spmm"),
        (f"{k} hop", f"band_{layout}.hop"),
        (f"{k} +c", f"band_{layout}.hop_c"),
        ("taps", "cheby_conv_banded.taps"), ("dW", "cheby_conv_banded.dW"),
        ("injections", "cheby_conv_banded.injections"),
        ("casts", "aten::_to_copy"), ("adam", "Optimizer.step#Adam.step"),
    )


# The same for the scattered graph's BSR training step.
BSR_TRAIN_PARTS = (
    ("K4 L@x", "bsr_colstream.spmm"), ("K4 hop", "bsr_colstream.hop"),
    ("taps (forward)", "cheby_conv.taps"),
    ("casts", "aten::_to_copy"), ("adam", "Optimizer.step#Adam.step"),
)


def train_profile_phase(run, step_ms: float, out_dir: str, gpu: str,
                        n: int = 2, mode: str = "train_bf16",
                        parts_of=train_parts()):
    """Device-time breakdown of ``n`` bf16 training steps by the parts
    ``parts_of`` names."""
    os.makedirs(out_dir, exist_ok=True)
    run(1)
    avg, _ = _trace(lambda: run(1), n, out_dir, mode)
    busy = _busy_ms(avg, n)
    print(f"profile {mode}: device {busy:.3f} ms per step, "
          f"{100 * busy / step_ms:.1f}% of the {step_ms:.3f} ms step [{gpu}]")
    events = {e.key: e for e in avg if e.device_type == DeviceType.CPU}
    events.update({e.key: e for e in avg if e.device_type == DeviceType.CUDA
                   and e.is_user_annotation
                   and e.key.startswith(("band_", "bsr_"))})
    parts = 0.0
    for label, key in parts_of:
        e = events.get(key)
        ms = 0.0 if e is None else e.device_time_total / n / 1e3
        parts += ms
        calls = 0 if e is None else e.count / n
        print(f"  part {label}: {ms:.3f} ms ({_pct(ms, busy):.1f}%), "
              f"{calls:g} calls")
    print(f"  part rest: {busy - parts:.3f} ms")
    _print_top(avg, busy, n)


def _spans_ms(prof, name: str) -> list:
    """Device-side spans of the ``record_function`` ranges called
    ``name``, in launch order, in ms: each holds one ctypes kernel."""
    spans = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.is_user_annotation and e.name == name),
                   key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in spans]


def chebnet_profile_phase(run, step_ms: float, out_dir: str, gpu: str,
                          n: int = 2):
    """Device-time breakdown of ``n`` f32 ChebNet training steps.  Each
    step launches K2 for the forward, then K2 for dx, then K3, so the
    K2 spans alternate forward and dx.  K3's fold and the fused conv's
    layout copies are their ranges' aten kernels, to which the ctypes
    kernels are not linked."""
    os.makedirs(out_dir, exist_ok=True)
    run(1)
    avg, prof = _trace(lambda: run(1), n, out_dir, "chebnet_train_f32")
    busy = _busy_ms(avg, n)
    print(f"profile chebnet train f32: device {busy:.3f} ms per step, "
          f"{100 * busy / step_ms:.1f}% of the {step_ms:.3f} ms step [{gpu}]")
    k2 = _spans_ms(prof, "cheby_fused.K2")
    events = {e.key: e for e in avg if e.device_type == DeviceType.CPU}

    def cpu_ms(*keys):
        return sum(events[k].device_time_total for k in keys
                   if k in events) / n / 1e3

    fold = cpu_ms("cheby_fused.K3.fold")
    parts = (
        ("K2 forward", sum(k2[0::2]) / n),
        ("K2 dx", sum(k2[1::2]) / n),
        ("K3 dW", sum(_spans_ms(prof, "cheby_fused.K3")) / n),
        ("K3 fold", fold),
        # The conv's ranges hold the fold's range: counted once, above.
        ("K2/K3 layout copies", cpu_ms("cheby_conv_fused.forward",
                                       "cheby_conv_fused.dx",
                                       "cheby_conv_fused.dW") - fold),
        ("layer 0 stacked basis", cpu_ms("cheby_conv.stacked")),
        ("fc forward", cpu_ms("fc")),
        ("adam", cpu_ms("Optimizer.step#Adam.step")),
    )
    for label, ms in parts:
        print(f"  part {label}: {ms:.3f} ms ({_pct(ms, busy):.1f}%)")
    print(f"  part rest (backward of layer 0 and fc, loss): "
          f"{busy - sum(ms for _, ms in parts):.3f} ms")
    _print_top(avg, busy, n)


def _on(params, dev):
    return tree_map(lambda t: t.detach().to(dev), params)


def loss_and_grads(model, params, data, seed: int):
    """One step's loss and parameter gradients, dropout drawn from a
    generator seeded with ``seed``."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    gen = torch.Generator(device=data[0].device).manual_seed(seed)
    loss = model.loss(p, *data, train=True, generator=gen)
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(p)]


def check_step(model, twin, params, data, tol: float, what: str, launches):
    """One step's loss and every gradient through ``model`` against the
    same step through ``twin``, the same dropout seed, and no kernel
    launch (``launches()``: the count) in the twin's step.  Returns the
    loss's relative error and the largest gradient error relative to its
    max."""
    loss, grads = loss_and_grads(model, params, data, seed=1)
    torch.cuda.synchronize()
    before = launches()
    loss_p, grads_p = loss_and_grads(twin, params, data, seed=1)
    torch.cuda.synchronize()
    check(launches() == before, f"{what}: the plain twin launched "
          f"{launches() - before} kernels")
    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    check(loss_err <= tol, f"{what}: loss {float(loss)} vs plain "
          f"{float(loss_p)}")
    grad_err = 0.0
    for g, gp in zip(grads, grads_p):
        check(bool(torch.isfinite(g).all()), f"{what}: gradient")
        err = float((g - gp).abs().max() / gp.abs().max())
        check(err <= tol, f"{what}: gradient {tuple(g.shape)} off the "
              f"plain version by {err:.3g} of its max (limit {tol})")
        grad_err = max(grad_err, err)
    return loss_err, grad_err


def train_phase(op, dropout: float, data, mode: str,
                kernel=banded_dkw) -> dict:
    """The deep model's training run on one operator: launches of
    ``kernel`` (its layout's banded kernel), loss, one step against the
    plain version, ms per step for both."""
    dev = op.base.device
    model = NodeClassifier(op, FIN, CLASSES, hidden=[FIN], K=K,
                           dropout=dropout,
                           generator=torch.Generator().manual_seed(0))
    params = _on(model.param_tree(), dev)

    def run(steps, m=model, seed=0):
        return train_node_classifier(
            m, params, *data, steps=steps, learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(seed))

    torch.cuda.reset_peak_memory_stats()
    reset_band_launches()
    _, losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(sum(band_launches().values()) == launches, f"train {mode}: "
          f"another banded kernel launched: {band_launches()}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    forms = dict(kernel.form_launches)
    want = {f: TRAIN_STEPS * n for f, n in STEP_FORMS.items()}
    check(launches == TRAIN_STEPS * 3 * (K - 1) and forms == want,
          f"train {mode}: {launches} launches {forms} for {TRAIN_STEPS} "
          f"steps, want {want}")
    losses = losses.tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train {mode}: losses {losses} not finite and falling")

    # One step through the kernel and through the plain version.
    twin = copy.copy(model)
    twin.op = _plain_twin(op)
    # f32: the same arithmetic summed in another order, through 48 hops;
    # bf16: carries rounded after sums in another order may land an ulp
    # apart and travel along the chains, as in serving.
    loss_err, grad_err = check_step(
        model, twin, params, data, 1e-3 if mode == "f32" else 2e-2,
        f"train {mode}", lambda: kernel.launches)

    step_ms = cuda_ms(lambda: run(TRAIN_STEPS), 1) / TRAIN_STEPS
    plain_step_ms = cuda_ms(lambda: run(1, m=twin), 1)
    return {"launches": launches, "forms": forms, "losses": losses,
            "peak_gb": peak_gb,
            "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "ms": step_ms, "plain_ms": plain_step_ms, "run": run}


# ------------------------------------------------------------- ChebNet, K2, K3


class _PlainDense(DenseLaplacian):
    """A dense operator whose fused conv runs the plain versions."""

    def fused_filter(self, x, w):
        return cheby_conv_fused_reference(x, self, w)

    def fused_dw(self, x, g, K):
        return cheby_dw_fused_reference(x, self, g, K)


def _plain_dense(op):
    return _PlainDense(**{f.name: getattr(op, f.name)
                          for f in dataclasses.fields(op)})


def cheby_launches() -> tuple:
    return cheby_conv_fused.launches, cheby_dw_fused.launches


def reset_cheby_launches():
    torch.cuda.synchronize()
    cheby_conv_fused.launches = cheby_dw_fused.launches = 0


def _kernel_vs_plain(kernel, plain, tol: float, what: str,
                     timer=None) -> dict:
    """One kernel call against its plain version on the same inputs,
    within ``tol`` of the plain result's largest entry, and both timed
    by ``timer`` (``cuda_ms``, looked up when called, by default)."""
    timer = timer or cuda_ms
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape/dtype")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= tol * scale,
          f"{what}: max |kernel - plain| {err:.3g} over limit "
          f"{tol * scale:.3g}")
    return {"max_abs_err": err, "scale": scale, "ms": timer(kernel, 10),
            "plain_ms": timer(plain, 3)}


# K2's shapes (B, level, F, O): the bench's dense_fused conv
# (bench.py:926-936) on the 976-node level 0, and ChebNet layer 1's
# forward and dx (W^T) on the 244-node level 2.
K2_SHAPES = {"bench": (CHEB_B, 0, 32, 32), "layer1": (CHEB_B, 2, 32, 64),
             "dx": (CHEB_B, 2, 64, 32)}


# The shapes at which K3 is held and timed: the bench's (x and g [100,
# 976, 32]) and ChebNet layer 1's (x [100, 244, 32], g [100, 244, 64]).
K3_SHAPES = ("bench", "layer1")


def _fitted_geometry(kernel: str, lab: str, shape: str, B: int, op, F: int,
                     O: int) -> dict:
    """``kernel``'s geometry at a shape, with one CTA's shared memory and
    the clusters the card holds at once; fails unless it fits."""
    dev = op.mat.device
    geo = conv_geometry(B, op.m_padded, F, O,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    geo.update(conv_resources(geo["rows"], op.mat.dtype, geo["cluster"],
                              kernel))
    check(0 < geo["smem"] <= 232_448 and geo["resident_clusters"] >= 1,
          f"{kernel} {lab} {shape}: {geo} does not fit the card")
    return geo


def cheby_kernel_phase(Ls, dev, gen: torch.Generator) -> dict:
    """K2 against its plain version at the bench's dense_fused shape,
    ChebNet layer 1's forward shape and its dx shape, and K3 at the bench
    and layer-1 shapes, in f32 and bf16, all timed by device work
    (``device_ms``), and K3's fold of its partials alone.  Tolerances, of
    the largest plain entry: f32 1e-4, the same products summed in
    another order through 24 hops; bf16 1e-2, a carry next to a bf16
    rounding boundary may round one ulp (2^-8) apart and later hops carry
    that along."""
    rec = {}
    for lab, dt in DTYPES.items():
        tol = 1e-4 if lab == "f32" else 1e-2
        for shape, (B, lvl, F, O) in K2_SHAPES.items():
            op = device_laplacian(Ls[lvl], fmt="dense", dtype=dt, device=dev,
                                  use_pallas=True)
            x = torch.randn(B, op.m, F, generator=gen, device=dev)
            w = 0.05 * torch.randn(CHEB["K"][0], F, O, generator=gen,
                                   device=dev)
            K_ = w.shape[0]
            # K3's operands (x, g; dW) have K2's sizes (x, w; y): one bound.
            bound = dense_cheby_bound(op, B, F, O, K_)
            rec[f"{lab}_{shape}"] = {
                **_kernel_vs_plain(
                    lambda: fused_filter(x, op, w),
                    lambda: cheby_conv_fused_reference(x, op, w), tol,
                    f"K2 {lab} {shape}", timer=device_ms),
                "bound": bound,
                "geometry": _fitted_geometry("K2", lab, shape, B, op, F, O)}
            if shape not in K3_SHAPES:
                continue
            g = torch.randn(B, op.m, O, generator=gen, device=dev)
            parts = _launch_dw(op, x, g, K_)
            rec[f"{lab}_{shape}_K3"] = {
                **_kernel_vs_plain(
                    lambda: cheby_dw_fused(x, op, g, K_),
                    lambda: cheby_dw_fused_reference(x, op, g, K_), tol,
                    f"K3 {lab} {shape}", timer=device_ms),
                "bound": bound,
                "fold_ms": device_ms(
                    lambda: _fold_dw_partials(parts, op.compute_dtype), 10),
                "parts_mb": parts.numel() * 4 / 1e6,
                "geometry": _fitted_geometry("K3", lab, shape, B, op, F, O)}
            del parts
    return rec


def chebnet_model(Ls, dt, dev):
    ops = [device_laplacian(L, fmt="dense", dtype=dt, device=dev,
                            use_pallas=True) for L in Ls]
    model = ChebNet(ops, **CHEB, generator=torch.Generator().manual_seed(0))
    return model, _on(model.param_tree(), dev)


def chebnet_serve_phase(model, params, reqs, mode: str) -> dict:
    """Serve ``reqs`` through compile_serving: 1 K2 and 0 K3 launches per
    request, finite logits, the same logits as the plain twin's."""
    serving = compile_serving(model, params, reqs[0], int8=False)
    twin = compile_serving(map_operators(model, _plain_dense), params,
                           reqs[0], int8=False)
    reset_cheby_launches()
    logits = [serving(x) for x in reqs]
    torch.cuda.synchronize()
    launches = cheby_launches()
    check(launches == (len(reqs), 0), f"chebnet serve {mode}: launches "
          f"{launches} for {len(reqs)} requests, want ({len(reqs)}, 0)")
    reset_cheby_launches()
    want = [twin(x) for x in reqs]
    torch.cuda.synchronize()
    check(cheby_launches() == (0, 0), f"chebnet serve {mode}: the plain "
          "twin launched kernels")
    # f32: only layer 1's sums run in another order; bf16: as the kernel
    # checks, an operand may round one ulp apart and travel along.
    tol = 1e-3 if mode == "f32" else 2e-2
    err = 0.0
    for y, yp in zip(logits, want):
        check(tuple(y.shape) == (CHEB_B, CHEB["M"][-1])
              and bool(torch.isfinite(y).all()),
              f"chebnet serve {mode}: bad logits")
        e = float((y - yp).abs().max())
        check(e <= tol * float(yp.abs().max()), f"chebnet serve {mode}: "
              f"logits off the plain twin's by {e:.3g}")
        err = max(err, e)
    return {"launches": launches, "max_abs_err": err, "serving": serving,
            "ms": cuda_ms(lambda: serving(reqs[0]), 5),
            "plain_ms": cuda_ms(lambda: twin(reqs[0]), 3)}


def chebnet_train_phase(model, params, batch, mode: str) -> dict:
    """4 adam steps on one fixed batch: 2 K2 and 1 K3 launches per step,
    a finite loss that falls, one step against the plain twin."""
    dev = batch[0].device

    def run(steps, m=model, seed=0):
        return train_classifier(
            m, params, *batch, batch_size=CHEB_B, steps=steps,
            learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(seed))

    reset_cheby_launches()
    _, losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = cheby_launches()
    check(launches == (2 * TRAIN_STEPS, TRAIN_STEPS),
          f"chebnet train {mode}: launches {launches} for {TRAIN_STEPS} "
          "steps")
    losses = losses.tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"chebnet train {mode}: losses {losses} not finite and falling")
    twin = map_operators(model, _plain_dense)
    loss_err, grad_err = check_step(
        model, twin, params, batch, 1e-3 if mode == "f32" else 2e-2,
        f"chebnet train {mode}", lambda: sum(cheby_launches()))
    return {"launches": launches, "losses": losses, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "run": run,
            "ms": cuda_ms(lambda: run(TRAIN_STEPS), 1) / TRAIN_STEPS,
            "plain_ms": cuda_ms(lambda: run(1, m=twin), 1)}


def chebnet_int8_phase(model, params, reqs, f32_serving) -> dict:
    """The default serving call, ``compile_serving(model, params, x)``:
    int8, every dense operator its ``QuantDenseLaplacian`` twin, the
    convs on the int8 streaming path with 0 K2 and 0 K3 launches, finite
    logits equal to the same serving on the CPU within 1e-4 of their max,
    and the int8 K=25 ``cheby_finals`` chain on the level-0 twin
    bit-identical on the card and on the CPU (exact float64 accumulation,
    one f32 emission).  The argmax agreement with the f32 serving over
    all requests is held to JAX's at this configuration,
    ``CHEB_INT8_AGREEMENT``, within 0.005 (2 of 400 rows: a near tie may
    fall either way).  JAX's int8 ChebNet itself agrees on 86.75%
    here, not the 95% its tests ask of a K=5 NodeClassifier
    (tests/test_quant_formats.py:312-313): the int8 recurrence over 24
    hops moves these random-weight logits by about 0.44 of their max.
    The largest int8 - f32 difference is returned too."""
    serving = compile_serving(model, params, reqs[0])
    check(all(isinstance(o, QuantDenseLaplacian)
              for o in serving.model.operators),
          "chebnet int8: the default serving call left an operator "
          "unquantized")
    reset_cheby_launches()
    logits = [serving(x) for x in reqs]
    torch.cuda.synchronize()
    launches = cheby_launches()
    check(launches == (0, 0), f"chebnet int8: K2/K3 launches {launches}")
    on_cpu = compile_serving(model, params, reqs[0].cpu())
    same, rel, err = 0, 0.0, 0.0
    for x, y in zip(reqs, logits):
        check(tuple(y.shape) == (CHEB_B, CHEB["M"][-1])
              and bool(torch.isfinite(y).all()), "chebnet int8: bad logits")
        want = on_cpu(x.cpu())
        e = float((y.cpu() - want).abs().max())
        check(e <= 1e-4 * float(want.abs().max()), f"chebnet int8: card "
              f"logits off the CPU's by {e:.3g}")
        err = max(err, e)
        f32 = f32_serving(x)
        same += int((y.argmax(1) == f32.argmax(1)).sum())
        rel = max(rel, float((y - f32).abs().max() / f32.abs().max()))
    agree = same / (len(reqs) * CHEB_B)
    check(abs(agree - CHEB_INT8_AGREEMENT) <= 0.005, f"chebnet int8: "
          f"argmax agreement with f32 {agree:.4f}, JAX's "
          f"{CHEB_INT8_AGREEMENT:.4f}")
    q = serving.model.operators[0]
    gen = torch.Generator(device=q.mat.device).manual_seed(5)
    xq = q.quantize(2.0 * torch.randn(q.m_padded, FIN, generator=gen,
                                      device=q.mat.device))
    with torch.inference_mode():
        chain = cheby_finals(q, xq, K)
        chain_cpu = cheby_finals(q.to("cpu"), xq.cpu(), K)
    check(chain.dtype == torch.int8 and torch.equal(chain.cpu(), chain_cpu),
          "chebnet int8: the K=25 chain differs between card and CPU")
    return {"launches": launches, "max_abs_err": err, "agreement": agree,
            "max_rel_diff": rel, "ms": cuda_ms(lambda: serving(reqs[0]), 5)}


# ------------------------------------------------ scattered BSR, K4, K7-K9


def scattered_graph():
    """The bench's 50k scattered kNN graph (bench.py:776-782)."""
    z = np.random.default_rng(0).normal(size=(SCAT_N, SCAT_DIMS)).astype(
        np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=SCAT_K, algorithm="auto"))
    perm = graphs.bandwidth_reducing_permutation(W)
    return graphs.laplacian(W[perm][:, perm].tocsr())


def scattered_features(m: int, n: int, seed: int = 2):
    """Labels [m] by node index in RCM order and ``n`` feature matrices
    [m, FIN], a class signature plus unit noise each, as bench.py:699-704
    makes them (the graph has no grid positions)."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(m) * CLASSES // m).astype(np.int64)
    signatures = rng.normal(0, 1, (CLASSES, FIN)).astype(np.float32)
    return torch.from_numpy(labels), [torch.from_numpy(
        signatures[labels] + rng.normal(0, 1.0, (m, FIN)).astype(np.float32))
        for _ in range(n)]


def bsr_launches() -> dict:
    """Launches by kernel: K4 and each bsr_csr route."""
    return {"K4": bsr_colstream.launches, **bsr_csr.route_launches}


def reset_bsr_launches():
    torch.cuda.synchronize()
    bsr_colstream.launches = bsr_csr.launches = 0
    for c in (bsr_colstream.form_launches, bsr_csr.form_launches,
              bsr_csr.route_launches):
        c.clear()


def hub_graph(n: int = 3000, degree: int = 300, seed: int = 4):
    """A kNN graph (n Gaussian points in 8-D, k=6) whose node 0 is joined
    to ``degree`` others: one row of ``degree`` + 7 nonzeros, which the
    row kernel walks in warp-wide chunks of 32."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 8)).astype(np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=6, algorithm="auto")).tolil()
    nb = rng.choice(np.arange(1, n), degree, replace=False)
    W[0, nb] = 0.5
    W[nb, 0] = 0.5
    return graphs.laplacian(W.tocsr())


def bsr_kernel_phase(op, route: str, forms, gen, what: str,
                     lib_ms=None, timed: bool = True) -> dict:
    """The row kernel as ``route`` on ``op`` against its plain version
    (``bsr_rows_reference``) and the block walk's (the plain twin's
    ``kernel_call``) at C = FIN, for each form in ``forms``; all three
    timed unless ``timed`` is false.  Tolerances: int8 bit-identical; f32
    1e-4 of the largest plain entry (another summation order); bf16 one
    bf16 ulp (all round one f32 accumulation).  ``lib_ms`` is phase 16's
    library time for the operator's dtype, printed beside."""
    dev = op.blocks.device
    x, x0 = (torch.randn(op.m_padded, FIN, generator=gen, device=dev)
             for _ in range(2))
    dt = op.compute_dtype
    if dt == torch.int8:
        x, x0, scale = op.quantize(x), op.quantize(x0), op.block_scale
    else:
        x, x0, scale = x.to(dt), x0.to(dt), None
    plain = _plain_twin(op)
    rows = (op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos)
    rec = {"max_abs_err": 0.0, "block_max_abs_err": 0.0,
           "library_ms": lib_ms}
    for form in forms:
        xx0 = None if form == "spmm" else x0

        def kern():
            return op.kernel_call(x, xx0, route, scale)

        def ref():
            return bsr_rows_reference(*rows, x, xx0, block_scale=scale)

        def block():
            return plain.kernel_call(x, xx0, route, scale)

        got = kern()
        for key, want in (("max_abs_err", ref()),
                          ("block_max_abs_err", block())):
            torch.cuda.synchronize()
            check(got.dtype == want.dtype == dt and got.shape == want.shape,
                  f"{what} {form}: dtype/shape")
            if dt == torch.int8:
                check(torch.equal(got, want), f"{what} {form} not "
                      f"bit-identical to the {key.split('_')[0]} plain "
                      "version")
                err = float((got.int() - want.int()).abs().max())
            else:
                err = float((got.float() - want.float()).abs().max())
                torch.testing.assert_close(
                    got.float(), want.float(),
                    rtol=2**-7 if dt == torch.bfloat16 else 0.0,
                    atol=1e-4 * float(want.float().abs().max()))
            rec[key] = max(rec[key], err)
        if not timed:
            continue
        pre = "" if form == "spmm" else form + "_"
        extra = int(xx0 is not None)
        rec[pre + "ms"] = device_ms(kern, 20)
        rec[pre + "plain_ms"] = device_ms(ref, 2)
        rec[pre + "block_plain_ms"] = device_ms(block, 2)
        rec[pre + "roofline"] = sparse_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
        rec[pre + "block_roofline"] = spmm_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
    return rec


def long_rows_phase(dev, gen) -> dict:
    """Phase 10's checks on ``hub_graph``, whose longest row holds more
    than 32 nonzeros: K4 and K7, L@x and the hop, f32, bf16 and int8, at
    C = FIN, untimed.  Returns the largest errors by dtype."""
    L = hub_graph()
    errs = {}
    for route, kw in (("K4", {}), ("K7", {"col_stream": False})):
        op = device_laplacian(L, fmt="bsr", device=dev, use_pallas=True,
                              **kw)
        longest = int(op.nz_rowptr.diff().max())
        check(longest > 32 and (route == "K7") != op.col_stream,
              f"long rows {route}: longest row {longest}, col_stream "
              f"{op.col_stream}")
        bf = dataclasses.replace(op, blocks=op.blocks.to(torch.bfloat16))
        for lab, o in (("f32", op), ("bf16", bf),
                       ("int8", quantize_block_sparse(op, sample_x=4.0))):
            rec = bsr_kernel_phase(o, route, ("spmm", "hop"), gen,
                                   f"long rows {route} {lab}", timed=False)
            errs[lab] = max(errs.get(lab, 0.0), rec["max_abs_err"],
                            rec["block_max_abs_err"])
    print(f"long rows (hub graph, {L.shape[0]} nodes, longest row "
          f"{longest}): K4 and K7 L@x and hop against both plain versions, "
          f"max_abs_err {errs}", flush=True)
    return errs


def print_bsr_kernel(what: str, rec: dict, gpu: str):
    def one(pre):
        r, b = rec[pre + "roofline"], rec[pre + "block_roofline"]
        return (f"{rec[pre + 'ms']:.4f} ms (plain {rec[pre + 'plain_ms']:.4f}"
                f", block plain {rec[pre + 'block_plain_ms']:.4f} ms; sparse "
                f"bound {r['bound_us'] / 1e3:.4f} ms {r['bound_by']}, block "
                f"format's work {b['bound_us'] / 1e3:.4f} ms "
                f"{b['bound_by']})")
    lib = ("none" if rec["library_ms"] is None
           else f"{rec['library_ms']:.4f} ms")
    hop = f", hop {one('hop_')}" if "hop_ms" in rec else ""
    print(f"kernel {what} C={FIN}: max_abs_err {rec['max_abs_err']:.3g} "
          f"(block plain {rec['block_max_abs_err']:.3g}), L@x {one('')}"
          f"{hop}; torch.sparse.mm {lib} [{gpu}]", flush=True)


def bsr_serve_phase(serving, reqs, kernel: str, what: str,
                    timed: bool) -> dict:
    """Serve ``reqs``: K-1 launches of ``kernel`` (K4 or a bsr_csr route)
    per request and no other BSR launch, finite [m, 16] logits, and the
    logits of the same requests through the plain twin (no launch).
    Tolerances as phase 4: 1e-4 int8, 2e-2 of the max bf16."""
    reset_bsr_launches()
    logits = [serving(x) for x in reqs]
    torch.cuda.synchronize()
    launches = {k: v for k, v in bsr_launches().items() if v}
    check(launches == {kernel: len(reqs) * (K - 1)},
          f"{what}: launches {launches} for {len(reqs)} requests")
    twin = compile_serving(map_operators(serving.model, _plain_twin),
                           serving.params, reqs[0], int8=False)
    reset_bsr_launches()
    want = [twin(x) for x in reqs]
    torch.cuda.synchronize()
    check(not any(bsr_launches().values()), f"{what}: the plain twin "
          "launched kernels")
    int8 = isinstance(serving.model.op, QuantBlockSparseLaplacian)
    err = 0.0
    for y, yp in zip(logits, want):
        check(tuple(y.shape) == (reqs[0].shape[0], CLASSES)
              and bool(torch.isfinite(y).all()), f"{what}: bad logits")
        e = float((y - yp).abs().max())
        tol = 1e-4 if int8 else 2e-2 * float(yp.abs().max())
        check(e <= tol, f"{what}: served logits off the plain twin's by "
              f"{e:.3g} (limit {tol:.3g})")
        err = max(err, e)
    rec = {"launches": launches[kernel], "max_abs_err": err,
           "serving": serving, "logits": logits}
    if timed:
        rec["ms"] = cuda_ms(lambda: serving(reqs[0]), 3)
        rec["plain_ms"] = cuda_ms(lambda: twin(reqs[0]), 1)
    return rec


def bsr_train_phase(op, data) -> dict:
    """The deep model on the bf16 colstream operator: 4 adam steps with
    72 K4 launches each, a falling loss, one step against the plain twin,
    ms per step for both."""
    dev = op.blocks.device
    model = NodeClassifier(op, FIN, CLASSES, hidden=[FIN], K=K,
                           generator=torch.Generator().manual_seed(0))
    params = _on(model.param_tree(), dev)

    def run(steps, m=model):
        return train_node_classifier(m, params, *data, steps=steps,
                                     learning_rate=LEARNING_RATE)

    torch.cuda.reset_peak_memory_stats()
    reset_bsr_launches()
    _, losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    counted = bsr_launches()
    forms = dict(bsr_colstream.form_launches)
    want = {f: TRAIN_STEPS * n for f, n in BSR_STEP_FORMS.items()}
    check(counted == {"K4": TRAIN_STEPS * 3 * (K - 1)}
          and forms == want, f"bsr train: launches {counted} "
          f"{forms} for {TRAIN_STEPS} steps, want {want}")
    losses = losses.tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"bsr train: losses {losses} not finite and falling")
    twin = copy.copy(model)
    twin.op = _plain_twin(op)
    loss_err, grad_err = check_step(model, twin, params, data, 2e-2,
                                    "bsr train bf16",
                                    lambda: bsr_colstream.launches)
    return {"launches": counted["K4"], "forms": forms,
            "losses": losses, "peak_gb": peak_gb, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "run": run,
            "ms": cuda_ms(lambda: run(TRAIN_STEPS), 1) / TRAIN_STEPS,
            "plain_ms": cuda_ms(lambda: run(1, m=twin), 1)}


# ------------------------------------------------------- the probes P1-P3


def probe_check_phase(dev) -> dict:
    """Each probe kernel against its plain version on the same seeded
    operands, two replicas, after 1 and 3 iterations (P3: 64 dots a
    call, 1 and 3 chained calls from a random seed), held to
    ``probes.compare``; bf16 P1 and P2 operands are scaled by
    ``probes.CHECK_SCALE``, so that the carry and P2's injection dot move
    the sums checked.  Returns ``{row name: (largest carry or output
    error, largest error of P1's extra)}``."""
    errs = {}
    for name, (_, _, _, taps, _) in probes.MXU_SHAPES.items():
        a, b = probes.mxu_operands(name, dev, check=True)
        e = [0.0, 0.0]
        for iters in (1, 3):
            got = probes.mxu_probe(a, b, iters, taps, replicas=2)
            want = probes.mxu_reference(a, b, iters, taps, replicas=2)
            torch.cuda.synchronize()
            for i in (0, 1):
                e[i] = max(e[i], probes.compare(got[i], want[i], iters))
        errs[f"probe_mxu_{name}"] = tuple(e)
    pa, pb = probes.pred_operands(dev, check=True)
    for name, (widths, cond) in probes.PRED_VARIANTS.items():
        w = torch.tensor(widths, dtype=torch.int32, device=dev)
        e = 0.0
        for iters in (1, 3):
            got = probes.pred_probe(w, pa, pb, iters, cond, replicas=2)
            want = probes.pred_reference(widths, pa, pb, iters, cond,
                                         replicas=2)
            torch.cuda.synchronize()
            e = max(e, probes.compare(got, want, iters))
        errs[f"probe_pred_{name}"] = (e, None)
    _, la, lb = probes.loopcost_operands(dev, replicas=2)
    gen = torch.Generator(device=dev).manual_seed(7)
    seed = torch.randn(2, probes.TILE, 512, generator=gen,
                       device=dev).to(torch.bfloat16)
    for unroll in probes.LOOPCOST_UNROLLS:
        got = want = seed
        e = 0.0
        for calls, tol_iters in ((1, 1), (2, 3)):
            for _ in range(calls):
                got = probes.loopcost_probe(got, la, lb, 64, unroll)
                want = probes.loopcost_reference(want, la, lb, 64, unroll)
            torch.cuda.synchronize()
            e = max(e, probes.compare(got, want, tol_iters))
        errs[f"probe_loopcost_u{unroll}"] = (e, None)
    return errs


def _probe_row(name, kind, err, recs, unit, **extra):
    """A probe's ``kernels`` row: ``ms``, ``plain_ms`` and the bound at
    the whole card's replicas, ``cta_ms`` at one replica; launches of
    both timing runs."""
    cta, card = recs.values()
    return {"name": name, "route": "cuda", "source": PROBE_SOURCE,
            "replaces": PROBE_REPLACES[kind],
            "launches": card["launches"] + cta["launches"],
            "max_abs_err": err[0], "ms": card["s"] * 1e3,
            "plain_ms": card["plain_s"] * 1e3,
            "bound_ms": card["bound_s"] * 1e3,
            "bound_by": card["bound_by"], "library_ms": None, "unit": unit,
            "replicas": card["replicas"], "ops_per_s": card["ops_per_s"],
            "cta_ms": cta["s"] * 1e3, "cta_ops_per_s": cta["ops_per_s"],
            **({"extra_max_abs_err": err[1]} if err[1] is not None else {}),
            **extra}


def probe_time_phase(errs: dict, gpu: str) -> list:
    """cuBLAS's chained products, then every probe timed at one replica
    and at the card's replicas (``probes.probe_rows``), each probe's
    launch count set to 0 just before and read just after.  Returns the
    ``kernels`` rows."""
    library = probes.peaks(PEAK_ITERS)
    for name, _, dt, _, variant in probes.PEAK_ROWS:
        r = library[name]
        print(f"peak {name} (cuBLAS{', ' + variant if variant else ''}): "
              f"{r['s_per_iter'] * 1e6:.1f} us per product, "
              f"{probes.shares(r['ops_per_s'], dt, variant=variant)} "
              f"[{gpu}]", flush=True)
    kernels = (probes.mxu_probe, probes.pred_probe, probes.loopcost_probe)
    for f in kernels:
        f.launches = 0
    timed = {kind: probes.probe_rows(kind, iters, library, plain)
             for kind, iters, plain in (
                 ("mxu", PROBE_ITERS, PLAIN_PROBE_ITERS),
                 ("pred", PROBE_ITERS, PLAIN_PROBE_ITERS),
                 ("loopcost", PROBE_CALLS, PLAIN_PROBE_CALLS))}
    torch.cuda.synchronize()
    counted = [f.launches for f in kernels]
    overhead = probes.loop_overhead(timed["loopcost"])
    for reps, ov in overhead.items():
        print(f"loopcost x{reps}: per-iteration overhead ~ {ov * 1e9:.1f} "
              f"ns [{gpu}]", flush=True)
    rows = []
    for name, recs in timed["mxu"].items():
        row = f"probe_mxu_{name}"
        rows.append(_probe_row(
            row, "mxu", errs[row], recs, "one iteration",
            library_peak_share=recs[max(recs)]["ops_per_s"] / probes.peak_of(
                library, probes.MXU_SHAPES[name][4])))
    for name, recs in timed["pred"].items():
        row = f"probe_pred_{name}"
        rows.append(_probe_row(row, "pred", errs[row], recs, "one iteration",
                               mean_w=recs[1]["mean_w"]))
    for unroll, recs in timed["loopcost"].items():
        cta, card = recs.values()
        row = f"probe_loopcost_u{unroll}"
        rows.append(_probe_row(
            row, "loopcost", errs[row], recs,
            f"one call of {probes.LOOPCOST_DOTS} dots",
            ns_per_dot=card["s_per_dot"] * 1e9,
            cta_ns_per_dot=cta["s_per_dot"] * 1e9,
            overhead_ns={str(k): v * 1e9 for k, v in overhead.items()}))
    for f, n, kind in zip(kernels, counted, ("mxu", "pred", "loopcost")):
        want = sum(r["launches"] for r in rows
                   if r["replaces"] == PROBE_REPLACES[kind])
        check(n == want and n > 0, f"probe {kind}: {n} launches counted, "
              f"rows hold {want}")
    return rows


# cheby_conv_kernel<T, BM, kStages, kTap>'s mangled template arguments.
_CHEBY_INSTANCE = re.compile(
    r"cheby_conv_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)EE")


def cheby_tensor_core_ops(lib) -> dict:
    """The tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS of
    each instantiation of ``cheby_conv_kernel`` (K2's tap and K3's, 64-
    and 128-row tiles, 2- and 3-stage rings) in the built library, by
    ``cuobjdump -sass``; fails unless all 16 are there and every bf16 one
    has some."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    found = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        m = _CHEBY_INSTANCE.search(name)
        if m:
            dt = "f32" if m[1] == "f" else "bf16"
            tap = ("K2", "K3")[int(m[4])]
            found[f"cheby_conv_kernel<{dt}, {m[2]}, {m[3]}, {tap}>"] = (
                body.count("HMMA") + body.count("HGMMA"))
    bf16 = [n for k, n in found.items() if "bf16" in k]
    check(len(found) == 16 and all(n > 0 for n in bf16),
          f"cheby_conv_kernel's bf16 SASS holds no tensor-core instruction, "
          f"or an instantiation is missing: {found}")
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-dir", help="also trace requests and training "
                    "steps with torch.profiler and write the tables here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(f"card: {gpu}", flush=True)

    # Phase 2: one nvcc per source, all started together.
    t0 = time.perf_counter()
    sources = ("band", "cheby_fused", "bsr", "probes")
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, log) in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")
    for kernel, n in cheby_tensor_core_ops(logs["cheby_fused"][0]).items():
        print(f"  sass cheby_fused: {kernel}: {n} HMMA/HGMMA")

    t0 = time.perf_counter()
    L, positions = graphs.city_graph(SIDE, k=KNN, seed=0)
    # The row index the banded kernels walk, timed where the operator
    # builds it.
    with call_seconds(packing, "band_row_index") as index_s:
        op = device_laplacian(L, fmt="auto", dtype=torch.bfloat16,
                              device=dev)
    check(len(index_s) == 1, f"{len(index_s)} row index builds")
    check(isinstance(op, BandedLaplacian), f"auto format gave {type(op)}")
    # One feature matrix per request, and the last one for training.
    labels, feats = request_features(positions, 2 * N_REQUESTS + 1)
    sample = float(max(f.abs().max() for f in feats[:2 * N_REQUESTS]))
    ops = {"bf16": op, "int8": quantize_banded(op, sample_x=sample),
           "f32": to_f32(op)}
    n_blocks = sum(b.shape[0] * b.shape[2] // 128 for b in op.bands_dkw)
    setup = time.perf_counter() - t0
    print(f"graph: {op.m} nodes, nnz {op.nnz}, levels {op.levels}, "
          f"G {op.rows_per_step}, {n_blocks} band blocks, set-up "
          f"{setup:.1f} s (the row index {index_s[0]:.3f} s)", flush=True)

    # Phase 16 first for the city graph: the library call, printed beside
    # the banded kernels of phases 3 and 13.
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = {"city": library_phase(csr_operand(L, op.m_padded, dev), gen,
                                 "50k city", gpu)}

    # Phase 3: K1 against both plain versions at the serving shape.
    checks = {lab: band_kernel_check(ops[lab], gen, f"K1 {lab}", lib["city"])
              for lab in ("int8", "bf16", "f32")}
    for lab, rec in checks.items():
        print_band_kernel(f"band_dkw (K1) {lab}", rec, gpu)

    # Phase 4: the main path, through the user's entry points.
    model = NodeClassifier(op, FIN, CLASSES, hidden=[], K=K,
                           generator=torch.Generator().manual_seed(0))
    params = model.param_tree()
    reqs = [f.to(dev) for f in feats[:2 * N_REQUESTS]]
    served = {
        "bf16": compile_serving(model, params, reqs[0], int8=False),
        "int8": compile_serving(model, params, reqs[0], int8=True),
    }
    served_k1 = banded_serve_phase(
        served, {"bf16": reqs[:N_REQUESTS], "int8": reqs[N_REQUESTS:]},
        banded_dkw, "serve", gpu)
    launches, logits = served_k1["launches"], served_k1["logits"]
    agree = float((logits["int8"][0].argmax(1) == served["bf16"](
        reqs[N_REQUESTS]).argmax(1)).float().mean())
    print(f"int8 vs bf16 predicted class agreement, one request: "
          f"{agree:.4f}")

    # Phase 5: training, the deep model on the same graph.
    nc_data = (feats[-1].to(dev), labels.to(dev),
               torch.ones(op.m, dtype=torch.bool, device=dev))
    trains = {"bf16": train_phase(ops["bf16"], 1.0, nc_data, "bf16"),
              "f32": train_phase(ops["f32"], 0.8, nc_data, "f32")}
    for mode, rec in trains.items():
        print(f"train {mode}: {TRAIN_STEPS} adam steps, {rec['launches']} "
              f"kernel launches {rec['forms']}, losses "
              f"{[round(v, 4) for v in rec['losses']]}; one step vs plain: "
              f"loss rel err {rec['loss_rel_err']:.3g}, gradient err "
              f"{rec['grad_rel_err']:.3g} of max; {rec['ms']:.3f} ms per "
              f"step (plain {rec['plain_ms']:.3f} ms), peak memory "
              f"{rec['peak_gb']:.2f} GiB [{gpu}]", flush=True)

    # Phase 6: latency.
    lat = {mode: cuda_ms(lambda s=s: s(reqs[0]), 5)
           for mode, s in served.items()}
    for mode, ms in lat.items():
        print(f"request latency {mode}: {ms:.3f} ms "
              f"({K - 1} SpMMs, {op.m} nodes, Fin {FIN}) [{gpu}]")

    # Phase 7: K2 and K3 against their plain versions, and timed.
    t0 = time.perf_counter()
    splits = synthetic_mnist(n_train=CHEB_B, n_val=0,
                             n_test=N_REQUESTS * CHEB_B, seed=CHEB_SEED)
    data, Ls, _ = mnist_graph_data(splits, seed=CHEB_SEED)
    print(f"mnist graph: levels {[L.shape[0] for L in Ls]} nodes, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kchecks = cheby_kernel_phase(Ls, dev, gen)

    def kernel_line(r):
        geo = r["geometry"]
        return (f"max_abs_err {r['max_abs_err']:.3g} (of max "
                f"{r['scale']:.3g}), {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f} ms; bound "
                f"{r['bound']['bound_us'] / 1e3:.4f} ms "
                f"{r['bound']['bound_by']}); {geo['groups']} clusters of "
                f"{geo['cluster']} CTAs, {geo['rows']}-row tiles, "
                f"{geo['smem']} B shared memory, "
                f"{geo['resident_clusters']} clusters at once")

    for lab in DTYPES:
        for shape, (B, lvl, F, O) in K2_SHAPES.items():
            m = Ls[lvl].shape[0]
            print(f"kernel K2 {lab} {shape} x [{B}, {m}, {F}] "
                  f"w [{CHEB['K'][0]}, {F}, {O}]: "
                  f"{kernel_line(kchecks[f'{lab}_{shape}'])} [{gpu}]",
                  flush=True)
            if shape in K3_SHAPES:
                r = kchecks[f"{lab}_{shape}_K3"]
                print(f"kernel K3 {lab} {shape} x [{B}, {m}, {F}] g [{B}, "
                      f"{m}, {O}] K={CHEB['K'][0]}: {kernel_line(r)}; fold "
                      f"of {r['parts_mb']:.1f} MB of partials "
                      f"{r['fold_ms']:.4f} ms ("
                      f"{100 * r['fold_ms'] / r['ms']:.1f}% of K3) [{gpu}]",
                      flush=True)

    # Phases 8 and 9: the paper's ChebNet served and trained, its
    # operators in f32 (the paper's) and in bf16.
    xs = torch.from_numpy(data["test_data"]).to(dev)
    creqs = list(xs.split(CHEB_B))
    batch = (torch.from_numpy(data["train_data"]).to(dev),
             torch.from_numpy(data["train_labels"]).to(dev))
    cheb = {}
    for lab, dt in DTYPES.items():
        model, cparams = chebnet_model(Ls, dt, dev)
        srv = chebnet_serve_phase(model, cparams, creqs, lab)
        trn = chebnet_train_phase(model, cparams, batch, lab)
        cheb[lab] = {"serve": srv, "train": trn}
        if lab == "f32":
            q8 = cheb["int8"] = chebnet_int8_phase(model, cparams, creqs,
                                                   srv["serving"])
            print(f"chebnet serve int8 (compile_serving defaults): "
                  f"{N_REQUESTS} requests of {CHEB_B}, launches (K2, K3) "
                  f"{q8['launches']}, max |card - CPU| "
                  f"{q8['max_abs_err']:.3g}, K=25 int8 chain bit-identical "
                  f"on card and CPU; argmax agreement with f32 "
                  f"{q8['agreement']:.4f} (JAX's {CHEB_INT8_AGREEMENT}; "
                  f"max |int8 - f32| "
                  f"{q8['max_rel_diff']:.3g} of the f32 max); "
                  f"{q8['ms']:.3f} ms per request [{gpu}]", flush=True)
        print(f"chebnet serve {lab}: {N_REQUESTS} requests of {CHEB_B}, "
              f"launches (K2, K3) {srv['launches']}, max |served - plain| "
              f"{srv['max_abs_err']:.3g}; {srv['ms']:.3f} ms per request "
              f"(plain {srv['plain_ms']:.3f} ms) [{gpu}]", flush=True)
        print(f"chebnet train {lab}: {TRAIN_STEPS} adam steps, launches "
              f"(K2, K3) {trn['launches']}, losses "
              f"{[round(v, 4) for v in trn['losses']]}; one step vs plain: "
              f"loss rel err {trn['loss_rel_err']:.3g}, gradient err "
              f"{trn['grad_rel_err']:.3g} of max; {trn['ms']:.3f} ms per "
              f"step (plain {trn['plain_ms']:.3f} ms) [{gpu}]", flush=True)

    # Phase 10: the bench's 50k scattered graph, K4 against its plain
    # version.  fmt="auto" must give the column-streamed BSR operator.
    t0 = time.perf_counter()
    L_s = scattered_graph()
    op32 = device_laplacian(L_s, fmt="auto", device=dev)
    check(isinstance(op32, BlockSparseLaplacian) and op32.col_stream
          and op32.block_shape == (128, 128), "auto format on the scattered "
          f"graph gave {type(op32).__name__} "
          f"(col_stream {getattr(op32, 'col_stream', None)})")
    print(f"scattered graph: {op32.m} nodes, nnz {op32.nnz}, "
          f"{int(op32.cs_groupptr[-1])} blocks of 128x128 with pads, G "
          f"{op32.rows_per_step}, {op32.cs_gcols.numel()} group "
          f"columns, set-up {time.perf_counter() - t0:.1f} s", flush=True)
    s_labels, s_feats = scattered_features(op32.m, 2 * N_REQUESTS + 1)
    s_reqs = [f.to(dev) for f in s_feats[:2 * N_REQUESTS]]
    s_max = float(max(f.abs().max() for f in s_feats[:2 * N_REQUESTS]))
    # Phase 16 for the scattered graph, printed beside its kernels.
    lib["scattered"] = library_phase(csr_operand(L_s, op32.m_padded, dev),
                                     gen, "50k scattered", gpu)
    k4 = {"f32": bsr_kernel_phase(op32, "K4", ("spmm", "hop"), gen,
                                  "K4 f32", lib["scattered"]["f32"])}
    s_bf16 = dataclasses.replace(op32, blocks=op32.blocks.to(torch.bfloat16))
    del op32  # f32 blocks: 3.55 GB
    torch.cuda.empty_cache()
    k4["bf16"] = bsr_kernel_phase(s_bf16, "K4", ("spmm", "hop"), gen,
                                  "K4 bf16", lib["scattered"]["bf16"])
    k4["int8"] = bsr_kernel_phase(
        quantize_block_sparse(s_bf16, sample_x=s_max), "K4", ("spmm", "hop"),
        gen, "K4 int8")
    for lab, rec in k4.items():
        print_bsr_kernel(f"{BSR_KERNEL} as K4 (bsr_colstream) {lab}", rec,
                         gpu)
    long_rows = long_rows_phase(dev, gen)

    # Phase 11: the scattered graph's NodeClassifier served and trained.
    s_model = NodeClassifier(s_bf16, FIN, CLASSES, hidden=[], K=K,
                             generator=torch.Generator().manual_seed(0))
    s_served = {}
    for i, mode in enumerate(("bf16", "int8")):
        serving = compile_serving(s_model, s_model.param_tree(), s_reqs[0],
                                  int8=mode == "int8")
        rec = s_served[mode] = bsr_serve_phase(
            serving, s_reqs[i * N_REQUESTS:(i + 1) * N_REQUESTS], "K4",
            f"scattered serve {mode}", timed=True)
        print(f"scattered serve {mode}: {N_REQUESTS} requests, "
              f"{rec['launches']} K4 launches, logits "
              f"{tuple(rec['logits'][0].shape)}, max |served - plain| "
              f"{rec['max_abs_err']:.3g}; {rec['ms']:.3f} ms per request "
              f"(plain {rec['plain_ms']:.3f} ms) [{gpu}]", flush=True)
    s_data = (s_feats[-1].to(dev), s_labels.to(dev),
              torch.ones(s_bf16.m, dtype=torch.bool, device=dev))
    s_train = bsr_train_phase(s_bf16, s_data)
    print(f"scattered train bf16: {TRAIN_STEPS} adam steps, "
          f"{s_train['launches']} K4 launches {s_train['forms']}, losses "
          f"{[round(v, 4) for v in s_train['losses']]}; one step vs plain: "
          f"loss rel err {s_train['loss_rel_err']:.3g}, gradient err "
          f"{s_train['grad_rel_err']:.3g} of max; {s_train['ms']:.3f} ms per "
          f"step (plain {s_train['plain_ms']:.3f} ms), peak memory "
          f"{s_train['peak_gb']:.2f} GiB [{gpu}]", flush=True)

    # Phase 12: bsr_csr through each route it ports, then one request
    # through each route's operator.
    t0 = time.perf_counter()
    op8 = device_laplacian(L_s, fmt="bsr", col_stream=False, device=dev)
    check(not op8.col_stream and op8.rows_per_step == 1
          and op8.group_max > 0 and op8.row_max == 0,
          f"col_stream=False layout: G {op8.rows_per_step}, group_max "
          f"{op8.group_max}, row_max {op8.row_max}")
    s_lib = lib["scattered"]
    csr = {"K8 f32": bsr_kernel_phase(op8, "K8", ("spmm",), gen, "K8 f32",
                                      s_lib["f32"])}
    bf8 = dataclasses.replace(op8, blocks=op8.blocks.to(torch.bfloat16))
    del op8
    torch.cuda.empty_cache()
    csr["K8 bf16"] = bsr_kernel_phase(bf8, "K8", ("spmm",), gen, "K8 bf16",
                                      s_lib["bf16"])
    q8 = quantize_block_sparse(bf8, sample_x=s_max)
    csr["K7 int8"] = bsr_kernel_phase(q8, "K7", ("spmm", "hop"), gen,
                                      "K7 int8")
    del q8
    op9 = device_laplacian(L_s, fmt="bsr", chunked_rows=True, device=dev)
    check(op9.row_max > 0 and op9.rows_per_step == 1 and op9.group_max == 0,
          f"chunked_rows layout: row_max {op9.row_max}")
    csr["K9 f32"] = bsr_kernel_phase(op9, "K9", ("spmm",), gen, "K9 f32",
                                     s_lib["f32"])
    bf9 = dataclasses.replace(op9, blocks=op9.blocks.to(torch.bfloat16))
    del op9
    torch.cuda.empty_cache()
    csr["K9 bf16"] = bsr_kernel_phase(bf9, "K9", ("spmm",), gen, "K9 bf16",
                                      s_lib["bf16"])
    op_city = device_laplacian(L, fmt="bsr", col_stream=False,
                               dtype=torch.bfloat16, device=dev)
    check(op_city.rows_per_step > 1, "the city graph's block-CSR layout has "
          f"G = {op_city.rows_per_step}, want more than 1")
    csr["K7 bf16"] = bsr_kernel_phase(op_city, "K7", ("spmm", "hop"), gen,
                                      "K7 bf16", lib["city"]["bf16"])
    print(f"block-CSR layouts: scattered G 1, group_max {bf8.group_max}; "
          f"chunked row_max {bf9.row_max}; city graph "
          f"{op_city.block_cols.numel()} blocks, G {op_city.rows_per_step}, "
          f"group_max {op_city.group_max}; set-up and checks "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for what, rec in csr.items():
        print_bsr_kernel(f"{BSR_KERNEL} as {what} (bsr_csr)", rec, gpu)
    routes = {}
    for key, kernel, rop, req, int8 in (
            ("K8 bf16", "K8", bf8, s_reqs[0], False),
            ("K7 int8", "K7", bf8, s_reqs[0], True),
            ("K9 bf16", "K9", bf9, s_reqs[0], False),
            ("K7 bf16", "K7", op_city, reqs[0], False)):
        model = NodeClassifier(rop, FIN, CLASSES, hidden=[], K=K,
                               generator=torch.Generator().manual_seed(0))
        rec = routes[key] = bsr_serve_phase(
            compile_serving(model, model.param_tree(), req, int8=int8),
            [req], kernel, f"serve through {key}", timed=False)
        print(f"serve through {key}: {rec['launches']} launches, max "
              f"|served - plain| {rec['max_abs_err']:.3g}", flush=True)
    route_launches = {key: {"launches": r["launches"]}
                      for key, r in routes.items()}
    del bf8, bf9, op_city, routes, model
    torch.cuda.empty_cache()

    # Phase 13: K5 and K6 against their plain versions on the 50k city
    # graph, and the in-place hop of K1, K5 and K6.
    t0 = time.perf_counter()
    uni = device_laplacian(L, fmt="banded", ragged=False,
                           dtype=torch.bfloat16, device=dev)
    rag = device_laplacian(L, fmt="banded", use_pallas=False,
                           dtype=torch.bfloat16, device=dev)
    check(uni.use_pallas and not rag.use_pallas and rag.bands_dkw is None,
          "the layouts' operators")
    # The ragged operator reaches K6 as in JAX: built without use_pallas
    # (so without the dkw twin), then given it; int8 quantized first.
    lay_ops = {
        "uniform": {"int8": quantize_banded(uni, sample_x=sample),
                    "bf16": uni, "f32": to_f32(uni)},
        "ragged": {lab: dataclasses.replace(o, use_pallas=True) for lab, o in
                   (("int8", quantize_banded(rag, sample_x=sample)),
                    ("bf16", rag), ("f32", to_f32(rag)))},
    }
    for lay, by in lay_ops.items():
        for lab, o in by.items():
            check(layout_of(o) == lay, f"{lay} {lab}: layout {layout_of(o)}")
    print(f"layouts: uniform W {uni.band_width}, {uni.band.shape[0]} x "
          f"{uni.band.shape[1]} = {uni.band.shape[0] * uni.band.shape[1]} "
          f"blocks; ragged levels {rag.levels}, {rag.band.shape[0]} blocks; "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    lay_checks = {lay: {lab: {
        **band_kernel_check(o, gen, f"{KERNEL_ID[lay]} {lab}", lib["city"]),
        **inplace_phase(o, gen, f"{KERNEL_ID[lay]} {lab}")}
        for lab, o in by.items()} for lay, by in lay_ops.items()}
    for lay, by in lay_checks.items():
        for lab, rec in by.items():
            print_band_kernel(f"band_{lay} ({KERNEL_ID[lay]}) {lab}", rec,
                              gpu)
    k1_inplace = {lab: inplace_phase(ops[lab], gen, f"K1 {lab}")
                  for lab in ("int8", "bf16", "f32")}
    for lab, rec in k1_inplace.items():
        print(f"kernel band_dkw (K1) {lab} C={FIN}: in place "
              f"{rec['hop_inplace_ms']:.4f} ms vs out of place "
              f"{rec['hop_outofplace_ms']:.4f} ms, bit-identical [{gpu}]",
              flush=True)

    # Phase 14: bench.py's K=25 chains, each layout at 50k, the default
    # layout at 100k.
    X = torch.randn(op.m_padded, FIN, generator=gen,
                    device=dev).to(torch.bfloat16)
    x_max = float(X.abs().max())
    chains = {}
    for lay, o in (("dkw", op), ("ragged", lay_ops["ragged"]["bf16"]),
                   ("uniform", uni)):
        q = quantize_banded(_plain_banded(o) if lay == "ragged" else o,
                            sample_x=x_max)
        chains[lay] = {
            "bf16": chain_phase(o, X, f"50k {lay} bf16", gpu),
            "int8": chain_phase(dataclasses.replace(q, use_pallas=True), X,
                                f"50k {lay} int8", gpu)}
    del X, q
    t0 = time.perf_counter()
    L100, _ = graphs.city_graph(SIDE_100K, k=KNN, seed=0)
    op100 = device_laplacian(L100, fmt="auto", dtype=torch.bfloat16,
                             device=dev)
    check(isinstance(op100, BandedLaplacian) and layout_of(op100) == "dkw",
          f"100k auto format gave {type(op100).__name__}")
    print(f"graph 100k: {op100.m} nodes, nnz {op100.nnz}, levels "
          f"{op100.levels}, {op100.band.shape[0]} band blocks, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    X = torch.randn(op100.m_padded, FIN, generator=gen,
                    device=dev).to(torch.bfloat16)
    chains["100k"] = {
        "bf16": chain_phase(op100, X, "100k dkw bf16", gpu),
        "int8": chain_phase(quantize_banded(
            op100, sample_x=float(X.abs().max())), X, "100k dkw int8", gpu)}
    del op100, X, L100
    torch.cuda.empty_cache()

    # Phase 15: the NodeClassifier on the uniform operator (K5), served
    # and trained, and requests through the ragged one (K6).
    u_model = NodeClassifier(uni, FIN, CLASSES, hidden=[], K=K,
                             generator=torch.Generator().manual_seed(0))
    u_served = {mode: compile_serving(u_model, u_model.param_tree(), reqs[0],
                                      int8=mode == "int8")
                for mode in ("bf16", "int8")}
    u_serve = banded_serve_phase(
        u_served, {"bf16": reqs[:N_REQUESTS], "int8": reqs[N_REQUESTS:]},
        banded_uniform, "uniform serve", gpu)
    u_lat = {}
    for mode, srv in u_served.items():
        twin = compile_serving(map_operators(srv.model, _plain_twin),
                               srv.params, reqs[0], int8=False)
        u_lat[mode] = {"ms": cuda_ms(lambda s=srv: s(reqs[0]), 5),
                       "plain_ms": cuda_ms(lambda t=twin: t(reqs[0]), 2)}
        print(f"uniform request latency {mode}: {u_lat[mode]['ms']:.3f} ms "
              f"(plain twin {u_lat[mode]['plain_ms']:.3f} ms) [{gpu}]",
              flush=True)
    u_train = train_phase(uni, 1.0, nc_data, "uniform bf16",
                          kernel=banded_uniform)
    print(f"train uniform bf16: {TRAIN_STEPS} adam steps, "
          f"{u_train['launches']} K5 launches {u_train['forms']}, losses "
          f"{[round(v, 4) for v in u_train['losses']]}; one step vs plain: "
          f"loss rel err {u_train['loss_rel_err']:.3g}, gradient err "
          f"{u_train['grad_rel_err']:.3g} of max; {u_train['ms']:.3f} ms per "
          f"step (plain {u_train['plain_ms']:.3f} ms), peak memory "
          f"{u_train['peak_gb']:.2f} GiB [{gpu}]", flush=True)
    r_model = NodeClassifier(lay_ops["ragged"]["bf16"], FIN, CLASSES,
                             hidden=[], K=K,
                             generator=torch.Generator().manual_seed(0))
    r_served = {mode: compile_serving(
        map_operators(r_model, lambda _, o=lay_ops["ragged"][mode]: o),
        r_model.param_tree(), reqs[0], int8=False)
        for mode in ("bf16", "int8")}
    r_serve = banded_serve_phase(
        r_served, {"bf16": reqs[:1], "int8": reqs[N_REQUESTS:N_REQUESTS + 1]},
        banded_ragged, "ragged serve", gpu)
    r_lat = {mode: cuda_ms(lambda s=srv: s(reqs[0]), 5)
             for mode, srv in r_served.items()}
    for mode, ms in r_lat.items():
        print(f"ragged request latency {mode}: {ms:.3f} ms [{gpu}]")

    if args.profile_dir:
        profile_phase(served, reqs[0], lat, args.profile_dir, gpu)
        train_profile_phase(trains["bf16"]["run"], trains["bf16"]["ms"],
                            args.profile_dir, gpu)
        profile_phase({"chebnet_f32": cheb["f32"]["serve"]["serving"]},
                      creqs[0], {"chebnet_f32": cheb["f32"]["serve"]["ms"]},
                      args.profile_dir, gpu)
        chebnet_profile_phase(cheb["f32"]["train"]["run"],
                              cheb["f32"]["train"]["ms"], args.profile_dir,
                              gpu)
        profile_phase({f"scattered_{m}": r["serving"]
                       for m, r in s_served.items()}, s_reqs[0],
                      {f"scattered_{m}": r["ms"] for m, r in s_served.items()},
                      args.profile_dir, gpu)
        train_profile_phase(s_train["run"], s_train["ms"], args.profile_dir,
                            gpu, mode="scattered_train_bf16",
                            parts_of=BSR_TRAIN_PARTS)
        profile_phase({f"uniform_{m}": srv for m, srv in u_served.items()},
                      reqs[0], {f"uniform_{m}": r["ms"]
                                for m, r in u_lat.items()},
                      args.profile_dir, gpu)
        profile_phase({f"ragged_{m}": srv for m, srv in r_served.items()},
                      reqs[0], {f"ragged_{m}": ms for m, ms in r_lat.items()},
                      args.profile_dir, gpu)
        train_profile_phase(u_train["run"], u_train["ms"], args.profile_dir,
                            gpu, mode="uniform_train_bf16",
                            parts_of=train_parts("uniform"))
        for graph, rec in lib.items():
            for lab, call in rec["calls"].items():
                profile_phase({f"library_{graph}_{lab}": call}, None,
                              {f"library_{graph}_{lab}": rec[lab]},
                              args.profile_dir, gpu)

    # Phase 18: the probes against their plain versions, then timed.
    t0 = time.perf_counter()
    probe_errs = probe_check_phase(dev)
    for name, (e, ex) in probe_errs.items():
        print(f"probe check {name}: max_abs_err {e:.3g}"
              + ("" if ex is None else f", extra {ex:.3g}"), flush=True)
    probe_rows = probe_time_phase(probe_errs, gpu)
    print(f"probes: checks and timing {time.perf_counter() - t0:.1f} s",
          flush=True)

    def band_row(name, lay, lab, rec, launches, **extra):
        """A banded kernel's row: the sparse bound as ``bound_ms``, the
        block format's work and the row walk's plain version beside."""
        rows = {k: rec[k] for k in ("rows_max_abs_err", "rows_plain_ms",
                                    "hop_rows_plain_ms") if k in rec}
        return {"name": name, "route": "cuda", "source": SOURCE,
                "kernel": BAND_KERNEL[lay], "replaces": REPLACES[lay],
                "launches": launches, "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                **bound_keys(rec["roofline"]),
                **work_keys(rec["block_roofline"]),
                "library_ms": rec["library_ms"], "hop_ms": rec["hop_ms"],
                "hop_plain_ms": rec["hop_plain_ms"],
                "hop_bound_ms": rec["hop_roofline"]["bound_us"] / 1e3,
                **rows, **extra}

    def chain_keys(lay, lab):
        c = chains[lay][lab]
        return {"chain_launches_per_block": c["launches"],
                "chain_us_per_spmm": c["us_per_spmm"],
                "chain_plain_us_per_spmm": c["plain_us_per_spmm"],
                "chain_gedges_per_s": c["gedges_per_s"]}

    def f32_keys(rec):
        return {"f32_ms": rec["ms"], "f32_plain_ms": rec["plain_ms"],
                "f32_max_abs_err": rec["max_abs_err"],
                "f32_bound_ms": rec["roofline"]["bound_us"] / 1e3,
                "f32_block_work_ms": rec["block_roofline"]["bound_us"] / 1e3,
                "f32_library_ms": rec["library_ms"]}

    def bsr_keys(rec, library_ms):
        """A row kernel's numbers: the sparse bound as ``bound_ms``, the
        block format's work and the block walk's plain time beside."""
        out = {}
        for pre in ("", "hop_"):
            if pre + "ms" not in rec:
                continue
            r, b = rec[pre + "roofline"], rec[pre + "block_roofline"]
            out.update({
                pre + "ms": rec[pre + "ms"],
                pre + "plain_ms": rec[pre + "plain_ms"],
                pre + "block_plain_ms": rec[pre + "block_plain_ms"],
                pre + "bound_ms": r["bound_us"] / 1e3,
                pre + "bound_by": r["bound_by"],
                pre + "block_work_ms": b["bound_us"] / 1e3,
                pre + "block_work_by": b["bound_by"]})
        return {"max_abs_err": rec["max_abs_err"],
                "block_max_abs_err": rec["block_max_abs_err"], **out,
                "library_ms": library_ms}

    record = {"kernels": [
        band_row(f"band_dkw_{lab}", "dkw", lab, checks[lab], launches[lab],
                 request_ms=lat[lab], **chain_keys("dkw", lab),
                 chain_100k_launches_per_block=chains["100k"][lab][
                     "launches"],
                 chain_100k_us_per_spmm=chains["100k"][lab]["us_per_spmm"],
                 **k1_inplace[lab],
                 **({"train_launches_per_step":
                     trains["bf16"]["launches"] // TRAIN_STEPS,
                     **f32_keys(checks["f32"])} if lab == "bf16" else {}))
        for lab in ("int8", "bf16")
    ] + [
        {"name": f"band_dkw_hop_c_{lab}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["dkw"],
         "launches": trains[lab]["forms"]["hop_c"],
         "kernel": BAND_KERNEL["dkw"],
         "max_abs_err": checks[lab]["hop_c_max_abs_err"],
         "rows_max_abs_err": checks[lab]["hop_c_rows_max_abs_err"],
         "ms": checks[lab]["hop_c_ms"],
         "plain_ms": checks[lab]["hop_c_plain_ms"],
         "rows_plain_ms": checks[lab]["hop_c_rows_plain_ms"],
         **bound_keys(checks[lab]["hop_c_roofline"]),
         **work_keys(checks[lab]["hop_c_block_roofline"]),
         "library_ms": None,
         "train_ms_per_step": trains[lab]["ms"],
         "train_plain_ms_per_step": trains[lab]["plain_ms"]}
        for lab in ("bf16", "f32")
    ] + [
        band_row(f"band_uniform_{lab}", "uniform", lab,
                 lay_checks["uniform"][lab],
                 u_serve["launches"][lab],
                 request_ms=u_lat[lab]["ms"],
                 request_plain_ms=u_lat[lab]["plain_ms"],
                 hop_inplace_ms=lay_checks["uniform"][lab]["hop_inplace_ms"],
                 **chain_keys("uniform", lab),
                 **({"hop_c_ms": lay_checks["uniform"][lab]["hop_c_ms"],
                     "train_launches_per_step":
                         u_train["launches"] // TRAIN_STEPS,
                     "train_ms_per_step": u_train["ms"],
                     "train_plain_ms_per_step": u_train["plain_ms"],
                     **f32_keys(lay_checks["uniform"]["f32"])}
                    if lab == "bf16" else {}))
        for lab in ("int8", "bf16")
    ] + [
        band_row(f"band_ragged_{lab}", "ragged", lab,
                 lay_checks["ragged"][lab],
                 r_serve["launches"][lab],
                 request_ms=r_lat[lab],
                 hop_inplace_ms=lay_checks["ragged"][lab]["hop_inplace_ms"],
                 **chain_keys("ragged", lab),
                 **({"hop_c_ms": lay_checks["ragged"][lab]["hop_c_ms"],
                     **f32_keys(lay_checks["ragged"]["f32"])}
                    if lab == "bf16" else {}))
        for lab in ("int8", "bf16")
    ] + [
        {"name": f"cheby_conv_fused_{lab}", "route": "cuda",
         "source": CHEB_SOURCE, "kernel": "cheby_conv_kernel<kConvTap>",
         "replaces": CHEB_REPLACES["K2"],
         "launches": (cheb[lab]["serve"]["launches"][0]
                      + cheb[lab]["train"]["launches"][0]),
         "max_abs_err": kchecks[f"{lab}_bench"]["max_abs_err"],
         "ms": kchecks[f"{lab}_bench"]["ms"],
         "plain_ms": kchecks[f"{lab}_bench"]["plain_ms"],
         **bound_keys(kchecks[f"{lab}_bench"]["bound"]), "library_ms": None,
         **{f"{shape}_{k}": kchecks[f"{lab}_{shape}"][k]
            for shape in ("layer1", "dx")
            for k in ("ms", "plain_ms", "max_abs_err")},
         **{f"{shape}_bound_ms": kchecks[f"{lab}_{shape}"]["bound"][
             "bound_us"] / 1e3 for shape in ("layer1", "dx")},
         "request_ms": cheb[lab]["serve"]["ms"],
         "request_plain_ms": cheb[lab]["serve"]["plain_ms"],
         "train_ms_per_step": cheb[lab]["train"]["ms"],
         "train_plain_ms_per_step": cheb[lab]["train"]["plain_ms"]}
        for lab in DTYPES
    ] + [
        {"name": f"cheby_dw_fused_{lab}", "route": "cuda",
         "source": CHEB_SOURCE, "kernel": "cheby_conv_kernel<kDwTap>",
         "replaces": CHEB_REPLACES["K3"],
         "launches": cheb[lab]["train"]["launches"][1],
         "max_abs_err": kchecks[f"{lab}_bench_K3"]["max_abs_err"],
         "ms": kchecks[f"{lab}_bench_K3"]["ms"],
         "plain_ms": kchecks[f"{lab}_bench_K3"]["plain_ms"],
         **bound_keys(kchecks[f"{lab}_bench_K3"]["bound"]),
         "library_ms": None,
         "fold_ms": kchecks[f"{lab}_bench_K3"]["fold_ms"],
         **{f"layer1_{k}": kchecks[f"{lab}_layer1_K3"][k]
            for k in ("ms", "plain_ms", "max_abs_err", "fold_ms")},
         "layer1_bound_ms": kchecks[f"{lab}_layer1_K3"]["bound"][
             "bound_us"] / 1e3}
        for lab in DTYPES
    ] + [
        {"name": f"{BSR_KERNEL}_K4_{lab}", "route": "cuda",
         "source": BSR_SOURCE, "replaces": BSR_REPLACES["K4"],
         "wrapper": "bsr_colstream",
         "launches": (s_served[lab]["launches"]
                      + (s_train["launches"] if lab == "bf16" else 0)),
         **bsr_keys(k4[lab], lib["scattered"][lab]),
         "long_rows_max_abs_err": long_rows[lab],
         "request_ms": s_served[lab]["ms"],
         "request_plain_ms": s_served[lab]["plain_ms"],
         **({"train_ms_per_step": s_train["ms"],
             "train_plain_ms_per_step": s_train["plain_ms"],
             **{"f32_" + k: v for k, v in bsr_keys(
                 k4["f32"], lib["scattered"]["f32"]).items()},
             "f32_long_rows_max_abs_err": long_rows["f32"]}
            if lab == "bf16" else {})}
        for lab in ("bf16", "int8")
    ] + [
        {"name": f"{BSR_KERNEL}_{key.replace(' ', '_')}", "route": "cuda",
         "source": BSR_SOURCE, "replaces": BSR_REPLACES[key[:2]],
         "wrapper": "bsr_csr", "launches": rec["launches"],
         **bsr_keys(csr[key], lib["city" if key == "K7 bf16"
                                  else "scattered"][key.split()[1]]),
         **({"f32_" + k: v for k, v in bsr_keys(
             csr[f"{key[:2]} f32"], lib["scattered"]["f32"]).items()}
            if f"{key[:2]} f32" in csr else {})}
        for key, rec in route_launches.items()
    ] + probe_rows}
    for row in record["kernels"]:
        check(row["launches"] > 0, f"{row['name']}: no launch on its path")
    print(json.dumps(record))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
