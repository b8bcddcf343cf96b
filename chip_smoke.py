"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--profile-dir DIR]

Phases, each fatal on failure (no CPU path, no fallback):

1. require a CUDA device; print the card's name and power limit;
2. build the banded kernel (csrc/band_dkw.cu), the fused Chebyshev
   kernels (csrc/cheby_fused.cu) and the BSR kernels (csrc/bsr.cu) from
   source, one nvcc each, started together; print each kernel's
   registers and shared memory;
3. hold the banded kernel against its plain PyTorch version on the real
   50,176-node serving operator at C = 512, for L@x and the hop 2L@x - x0,
   in int8 (bit-identical), bf16 (one bf16 ulp: both round an f32
   accumulation of exact bf16 products, summed in another order) and f32
   (atol 1e-4, another summation order), and for the adjoint hop
   2L@x - x0 + c in bf16 and f32 (same bounds);
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
   g [100, 976, 32], w [25, 32, 32] on the 976-node level-0 operator) in
   f32 and bf16, and K2 at ChebNet layer 1's dx shape (g [100, 244, 64],
   W^T [25, 64, 32]) in f32, and time both;
8. serve the paper's ChebNet (MNIST grid, F=[32, 64], K=[25, 25], p=[4,
   4], M=[512, 10]; nips2016/mnist.ipynb cells 14-17) on its coarsened
   operators through compile_serving: 4 requests of 100 synthetic digits,
   with f32 operators (the paper's) and with bf16 ones; check 1 K2 and
   0 K3 launches per request (layer 0, Fin = 1, takes the stacked path),
   finite [100, 10] logits, and the logits against the same requests
   through operators whose fused conv runs the plain versions;
9. train that ChebNet (dropout 0.5, L2 5e-4) for 4 adam steps through
   train_classifier on one fixed batch of 100, with f32 and bf16
   operators; check 2 K2 and 1 K3 launches per step, a finite loss that
   falls, and one step's loss and gradients against the plain twin with
   the same dropout seed; time requests and steps beside the twin's;
10. on the bench's 50k scattered kNN graph (bench.py:763-787: 50,000
   Gaussian points in 8-D, seed 0, k=10, RCM, normalized Laplacian),
   built by ``device_laplacian(fmt="auto")``, which must give the
   column-streamed BSR operator: hold K4 (``bsr_colstream``, csrc/bsr.cu)
   against its plain version at C = 512 for L@x and the hop in f32
   (atol 1e-4 of the max), bf16 (one bf16 ulp) and int8 (bit-identical),
   and time both;
11. serve the bench's NodeClassifier on it (4 requests in bf16, 4 in
   int8, features labelled by node index as bench.py:699-704 makes
   them): 24 K4 launches per request, finite [50000, 16] logits, the
   logits against the plain twin's; train the deep one (hidden=[512]) on
   the bf16 operator for 4 adam steps: 72 K4 launches per step (26 L@x,
   46 hops), a falling loss, one step against the plain twin; time
   requests and steps beside the twin's;
12. hold ``bsr_csr`` (csrc/bsr.cu) against its plain version through each
   route it ports: K8 on the scattered graph's ``col_stream=False``
   operator (f32 and bf16 L@x), K7 int8 on that operator's int8 twin
   (G = 1, L@x and hop), K9 on its ``chunked_rows=True`` operator (f32
   and bf16 L@x) and K7 float with G > 1 on the 50k city graph's
   ``fmt="bsr", col_stream=False`` bf16 operator (L@x and hop); then serve
   one request through each route's operator: 24 launches of that route
   each, logits against the plain twin's;
13. with ``--profile-dir DIR`` only: trace 3 requests per serving mode
   after 2 warm-ups (banded, scattered BSR, ChebNet), 2 bf16 training
   steps after one (banded and scattered NodeClassifier), and 2 f32
   ChebNet training steps after one, with ``torch.profiler`` (CPU and
   CUDA activities); print the device time per request or step, its
   share of the measured time, the largest device kernels and aten ops,
   and for training the device time by part (K1 or K4 by form, taps, dW,
   injections, casts, adam; K2 forward, K2 dx, K3, the stacked basis of
   ChebNet's layer 0, fc, adam); write each ``key_averages()`` table to
   ``DIR/profile_<mode>.txt``.

Each 50k scattered operator is freed after its phase.

The line before the last is the kernel record as one JSON object; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
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
    banded_dkw,
    banded_dkw_reference,
    bsr_colstream,
    bsr_colstream_reference,
    bsr_csr,
    bsr_csr_reference,
    cheby_conv,
    cheby_conv_fused,
    cheby_conv_fused_reference,
    cheby_dw_fused,
    cheby_dw_fused_reference,
    device_laplacian,
    fused_filter,
    quantize_banded,
    quantize_block_sparse,
)
from cnn_graph_tpu_torch.serve import compile_serving  # noqa: E402
from cnn_graph_tpu_torch.train import (  # noqa: E402
    train_classifier,
    train_node_classifier,
)

SIDE, KNN, FIN, CLASSES, K = 224, 8, 512, 16, 25
N_REQUESTS = 4  # per serving mode
TRAIN_STEPS, LEARNING_RATE = 4, 1e-3  # per training mode; bench.py:268
# Kernel launches per training step of the deep model: each layer's
# forward runs 1 L@x and K-2 hops; layer 1's backward (layer 0 has no
# input gradient) K-2 adjoint hops and 1 L@x.
STEP_FORMS = {"spmm": 3, "hop": 2 * (K - 2), "hop_c": K - 2}
SOURCE = "cnn_graph_tpu_torch/csrc/band_dkw.cu"
REPLACES = "cnn_graph_tpu/ops/pallas_band.py:448"  # _kernel_dkw
# The paper's MNIST ChebNet (nips2016/mnist.ipynb cells 14-17,
# experiments/mnist.py:66-75): 4 coarsening levels from seed 2017.
CHEB = dict(F=[32, 64], K=[25, 25], p=[4, 4], M=[512, 10], dropout=0.5,
            regularization=5e-4)
CHEB_B, CHEB_SEED = 100, 2017
CHEB_SOURCE = "cnn_graph_tpu_torch/csrc/cheby_fused.cu"
CHEB_REPLACES = {"K2": "cnn_graph_tpu/ops/pallas_cheby.py:61",    # _kernel
                 "K3": "cnn_graph_tpu/ops/pallas_cheby.py:210"}  # _dw_kernel
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The bench's 50k scattered kNN graph (bench.py:763-787) and its kernels.
SCAT_N, SCAT_DIMS, SCAT_K = 50000, 8, 10
BSR_SOURCE = "cnn_graph_tpu_torch/csrc/bsr.cu"
BSR_REPLACES = {"K4": "cnn_graph_tpu/ops/pallas_spmm.py:129",  # colstream
                "K7": "cnn_graph_tpu/ops/pallas_spmm.py:35",   # grouped
                "K8": "cnn_graph_tpu/ops/pallas_spmm.py:450",  # _kernel
                "K9": "cnn_graph_tpu/ops/pallas_spmm.py:502"}  # chunked
# K4 launches per step of the deep model on BSR: each layer's forward
# 1 L@x and K-2 hops; layer 1's backward K-1 L@x (one per hop and one
# for its L@x); layer 0's features need no gradient.
BSR_STEP_FORMS = {"spmm": 2 + (K - 1), "hop": 2 * (K - 2)}


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


def kernel_phase(ops, C: int, gen: torch.Generator, label: str) -> dict:
    """Kernel vs plain version on one operator, every form it has."""
    op = ops[label]
    dev = op.base.device
    x, x0, c = (torch.randn(op.m_padded, C, generator=gen, device=dev)
                for _ in range(3))
    if label == "int8":
        x, x0, scale = op.quantize(x), op.quantize(x0), op.band_scale
        forms = (("spmm", None, None), ("hop", x0, None))
    else:
        x, x0, c = (t.to(op.compute_dtype) for t in (x, x0, c))
        scale = None
        forms = (("spmm", None, None), ("hop", x0, None), ("hop_c", x0, c))
    kw = dict(levels=op.levels, G=op.rows_per_step, band_scale=scale)
    rec = {"max_abs_err": 0.0}
    for form, xx0, cc in forms:
        args = (op.bands_dkw, op.base, op.sched_dkw, x, xx0, cc)
        got = banded_dkw(*args, **kw)
        want = banded_dkw_reference(*args, **kw)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{label} {form}: dtype/shape")
        if label == "int8":
            check(torch.equal(got, want), f"int8 {form} not bit-identical")
            err = float((got.int() - want.int()).abs().max())
        else:
            rtol = 2**-7 if label == "bf16" else 0.0
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=rtol, atol=1e-4)
        if form == "hop_c":
            rec["hop_c_max_abs_err"] = err
        else:
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        pre = "" if form == "spmm" else form + "_"
        rec[pre + "ms"] = cuda_ms(lambda: banded_dkw(*args, **kw), 20)
        rec[pre + "plain_ms"] = cuda_ms(
            lambda: banded_dkw_reference(*args, **kw), 3)
    return rec


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


class _PlainBanded(BandedLaplacian):
    """The bf16 operator with every band product on the plain version."""

    def matmul(self, x):
        return self.cheby_hop(x, None)

    def cheby_hop(self, x1, x0):
        return self.cheby_hop_c(x1, x0, None)

    def cheby_hop_c(self, x1, x0, c):
        cdt = self.compute_dtype
        return banded_dkw_reference(
            self.bands_dkw, self.base, self.sched_dkw, x1.to(cdt),
            *(None if t is None else t.to(cdt) for t in (x0, c)),
            levels=self.levels, G=self.rows_per_step).to(x1.dtype)


class _PlainQuantBanded(QuantBandedLaplacian):
    """The int8 operator with every band product on the plain version."""

    def _call(self, x_q, x0_q):
        return banded_dkw_reference(
            self.bands_dkw, self.base, self.sched_dkw, x_q, x0_q,
            levels=self.levels, G=self.rows_per_step,
            band_scale=self.band_scale)


class _PlainBsrMixin:
    """Every BSR kernel call on the plain version (float and int8)."""

    def kernel_call(self, x, x0, route, block_scale=None):
        if route == "K4":
            return bsr_colstream_reference(
                self.blocks, self.cs_meta, self.cs_gcols, self.cs_gcolptr,
                self.cs_groupptr, x, x0, G=self.rows_per_step,
                block_scale=block_scale)
        return bsr_csr_reference(self.blocks, self.block_rowptr,
                                 self.block_cols, x, x0,
                                 block_scale=block_scale)


class _PlainBsr(_PlainBsrMixin, BlockSparseLaplacian):
    pass


class _PlainQuantBsr(_PlainBsrMixin, QuantBlockSparseLaplacian):
    pass


_PLAIN = {BandedLaplacian: _PlainBanded,
          QuantBandedLaplacian: _PlainQuantBanded,
          BlockSparseLaplacian: _PlainBsr,
          QuantBlockSparseLaplacian: _PlainQuantBsr}


def _plain_twin(op):
    """The operator with every kernel call on its plain version."""
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


# Parts of a training step by the profiler range that holds them; casts
# are the aten conversions, which sit outside every other range.  K1's
# ranges are read from their device-side spans (one kernel each): a
# kernel launched through ctypes is not linked to the host-side event.
TRAIN_PARTS = (
    ("K1 L@x", "band_dkw.spmm"), ("K1 hop", "band_dkw.hop"),
    ("K1 +c", "band_dkw.hop_c"), ("taps", "cheby_conv_banded.taps"),
    ("dW", "cheby_conv_banded.dW"),
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
                        parts_of=TRAIN_PARTS):
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
                   and e.key.startswith(("band_dkw", "bsr_"))})
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
    K2 spans alternate forward and dx.  The fused conv's layout copies
    are its ranges' aten kernels, to which the ctypes kernels are not
    linked."""
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

    parts = (
        ("K2 forward", sum(k2[0::2]) / n),
        ("K2 dx", sum(k2[1::2]) / n),
        ("K3 dW", sum(_spans_ms(prof, "cheby_fused.K3")) / n),
        ("K2/K3 layout copies", cpu_ms("cheby_conv_fused.forward",
                                       "cheby_conv_fused.dx",
                                       "cheby_conv_fused.dW")),
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


def train_phase(op, dropout: float, data, mode: str) -> dict:
    """The deep model's training run on one operator: launches, loss,
    one step against the plain version, ms per step for both."""
    dev = op.base.device
    model = NodeClassifier(op, FIN, CLASSES, hidden=[FIN], K=K,
                           dropout=dropout,
                           generator=torch.Generator().manual_seed(0))
    params = _on(model.param_tree(), dev)

    def run(steps, m=model, seed=0):
        return train_node_classifier(
            m, params, *data, steps=steps, learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(seed))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    banded_dkw.launches = 0
    banded_dkw.form_launches.clear()
    _, losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = banded_dkw.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    forms = dict(banded_dkw.form_launches)
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
        f"train {mode}", lambda: banded_dkw.launches)

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


def _kernel_vs_plain(kernel, plain, tol: float, what: str) -> dict:
    """One kernel call against its plain version on the same inputs,
    within ``tol`` of the plain result's largest entry, and both timed."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape/dtype")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= tol * scale,
          f"{what}: max |kernel - plain| {err:.3g} over limit "
          f"{tol * scale:.3g}")
    return {"max_abs_err": err, "scale": scale, "ms": cuda_ms(kernel, 10),
            "plain_ms": cuda_ms(plain, 3)}


def cheby_kernel_phase(Ls, dev, gen: torch.Generator) -> dict:
    """K2 and K3 against their plain versions at the bench's dense_fused
    shape (bench.py:926-936) in f32 and bf16, and K2 at ChebNet layer 1's
    dx shape in f32.  Tolerances, of the largest plain entry: f32 1e-4,
    the same f32 products summed in another order through 24 hops; bf16
    1e-2, a carry next to a bf16 rounding boundary may round one ulp
    (2^-8) apart and later hops carry that along."""
    rec = {}
    for lab, dt in DTYPES.items():
        op = device_laplacian(Ls[0], fmt="dense", dtype=dt, device=dev,
                              use_pallas=True)
        x, g = (torch.randn(CHEB_B, op.m, 32, generator=gen, device=dev)
                for _ in range(2))
        w = 0.05 * torch.randn(CHEB["K"][0], 32, 32, generator=gen,
                               device=dev)
        tol = 1e-4 if lab == "f32" else 1e-2
        rec[lab] = {
            "K2": _kernel_vs_plain(
                lambda: fused_filter(x, op, w),
                lambda: cheby_conv_fused_reference(x, op, w), tol,
                f"K2 {lab}"),
            "K3": _kernel_vs_plain(
                lambda: cheby_dw_fused(x, op, g, w.shape[0]),
                lambda: cheby_dw_fused_reference(x, op, g, w.shape[0]), tol,
                f"K3 {lab}"),
        }
    op = device_laplacian(Ls[2], fmt="dense", device=dev, use_pallas=True)
    g = torch.randn(CHEB_B, op.m, 64, generator=gen, device=dev)
    wt = 0.05 * torch.randn(CHEB["K"][1], 64, 32, generator=gen, device=dev)
    rec["dx"] = _kernel_vs_plain(
        lambda: fused_filter(g, op, wt),
        lambda: cheby_conv_fused_reference(g, op, wt), 1e-4, "K2 dx f32")
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


def bsr_kernel_phase(op, route: str, forms, gen, what: str) -> dict:
    """``route``'s kernel on ``op`` against its plain version at C = FIN,
    for each form in ``forms``, and both timed.  Tolerances: int8
    bit-identical; f32 1e-4 of the largest plain entry (another summation
    order); bf16 one bf16 ulp (both round one f32 accumulation)."""
    dev = op.blocks.device
    x, x0 = (torch.randn(op.m_padded, FIN, generator=gen, device=dev)
             for _ in range(2))
    dt = op.compute_dtype
    if dt == torch.int8:
        x, x0, scale = op.quantize(x), op.quantize(x0), op.block_scale
    else:
        x, x0, scale = x.to(dt), x0.to(dt), None
    plain = _plain_twin(op)
    rec = {"max_abs_err": 0.0}
    for form in forms:
        xx0 = None if form == "spmm" else x0

        def kern():
            return op.kernel_call(x, xx0, route, scale)

        def ref():
            return plain.kernel_call(x, xx0, route, scale)

        got, want = kern(), ref()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == dt and got.shape == want.shape,
              f"{what} {form}: dtype/shape")
        if dt == torch.int8:
            check(torch.equal(got, want), f"{what} {form} not bit-identical")
            err = float((got.int() - want.int()).abs().max())
        else:
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(
                got.float(), want.float(),
                rtol=2**-7 if dt == torch.bfloat16 else 0.0,
                atol=1e-4 * float(want.float().abs().max()))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        pre = "" if form == "spmm" else form + "_"
        rec[pre + "ms"] = cuda_ms(kern, 5)
        rec[pre + "plain_ms"] = cuda_ms(ref, 2)
    return rec


def print_bsr_kernel(what: str, rec: dict, gpu: str):
    hop = (f", hop {rec['hop_ms']:.4f} ms (plain {rec['hop_plain_ms']:.4f}"
           " ms)" if "hop_ms" in rec else "")
    print(f"kernel {what} C={FIN}: max_abs_err {rec['max_abs_err']:.3g}, "
          f"L@x {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms){hop} "
          f"[{gpu}]", flush=True)


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
    sources = ("band_dkw", "cheby_fused", "bsr")
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, log) in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    L, positions = graphs.city_graph(SIDE, k=KNN, seed=0)
    op = device_laplacian(L, fmt="auto", dtype=torch.bfloat16, device=dev)
    check(isinstance(op, BandedLaplacian), f"auto format gave {type(op)}")
    # One feature matrix per request, and the last one for training.
    labels, feats = request_features(positions, 2 * N_REQUESTS + 1)
    sample = float(max(f.abs().max() for f in feats[:2 * N_REQUESTS]))
    ops = {"bf16": op, "int8": quantize_banded(op, sample_x=sample),
           "f32": dataclasses.replace(
               op, bands_dkw=tuple(b.float() for b in op.bands_dkw))}
    n_blocks = sum(b.shape[0] * b.shape[2] // 128 for b in op.bands_dkw)
    print(f"graph: {op.m} nodes, nnz {op.nnz}, levels {op.levels}, "
          f"G {op.rows_per_step}, {n_blocks} band blocks, "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)

    # Phase 3: kernel against plain version at the serving shape.
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {lab: kernel_phase(ops, FIN, gen, lab)
              for lab in ("int8", "bf16", "f32")}
    for lab, rec in checks.items():
        hop_c = ("" if lab == "int8" else
                 f", +c {rec['hop_c_ms']:.4f} ms (plain "
                 f"{rec['hop_c_plain_ms']:.4f} ms, max_abs_err "
                 f"{rec['hop_c_max_abs_err']:.3g})")
        print(f"kernel {lab} C={FIN}: max_abs_err {rec['max_abs_err']:.3g}, "
              f"L@x {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms), "
              f"hop {rec['hop_ms']:.4f} ms (plain {rec['hop_plain_ms']:.4f} "
              f"ms){hop_c} [{gpu}]", flush=True)

    # Phase 4: the main path, through the user's entry points.
    model = NodeClassifier(op, FIN, CLASSES, hidden=[], K=K,
                           generator=torch.Generator().manual_seed(0))
    params = model.param_tree()
    reqs = [f.to(dev) for f in feats[:2 * N_REQUESTS]]
    served = {
        "bf16": compile_serving(model, params, reqs[0], int8=False),
        "int8": compile_serving(model, params, reqs[0], int8=True),
    }
    launches, logits = {}, {}
    for i, (mode, serving) in enumerate(served.items()):
        batch = reqs[i * N_REQUESTS:(i + 1) * N_REQUESTS]
        torch.cuda.synchronize()
        banded_dkw.launches = 0
        logits[mode] = [serving(x) for x in batch]
        torch.cuda.synchronize()
        launches[mode] = banded_dkw.launches
        check(launches[mode] == N_REQUESTS * (K - 1),
              f"{mode}: {launches[mode]} launches for {N_REQUESTS} requests")
        for y in logits[mode]:
            check(tuple(y.shape) == (op.m, CLASSES) and bool(
                torch.isfinite(y).all()), f"{mode}: bad logits")
        # The same requests through the plain version on the card.
        twin = _plain_twin(serving.model.op)
        p = serving.params["convs"][0]
        err = 0.0
        for x, y in zip(batch, logits[mode]):
            with torch.inference_mode():
                want = cheby_conv(x[None], twin, p["w"])[0] + p["b"]
            err = max(err, float((y - want).abs().max()))
            scale = float(want.abs().max())
            # int8: identical carries, the same taps -> equal up to 1e-4.
            # bf16: carries rounded to bf16 after sums in another order
            # may differ by an ulp and travel along 24 hops.
            tol = 1e-4 if mode == "int8" else 2e-2 * scale
            check(float((y - want).abs().max()) <= tol,
                  f"{mode}: served logits off the plain version by "
                  f"{float((y - want).abs().max()):.3g} (limit {tol:.3g})")
        print(f"serve {mode}: {N_REQUESTS} requests, {launches[mode]} kernel "
              f"launches, logits {tuple(logits[mode][0].shape)}, max |served"
              f" - plain| {err:.3g}", flush=True)
    agree = float((logits["int8"][0].argmax(1) == served["bf16"](
        reqs[N_REQUESTS]).argmax(1)).float().mean())
    print(f"int8 vs bf16 predicted class agreement, one request: "
          f"{agree:.4f}")

    # Phase 5: training, the deep model on the same graph.
    data = (feats[-1].to(dev), labels.to(dev),
            torch.ones(op.m, dtype=torch.bool, device=dev))
    trains = {"bf16": train_phase(ops["bf16"], 1.0, data, "bf16"),
              "f32": train_phase(ops["f32"], 0.8, data, "f32")}
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
    for lab in DTYPES:
        for kern in ("K2", "K3"):
            r = kchecks[lab][kern]
            print(f"kernel {kern} {lab} [100, 976, 32] K=25: max_abs_err "
                  f"{r['max_abs_err']:.3g} (of max {r['scale']:.3g}), "
                  f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms) [{gpu}]",
                  flush=True)
    r = kchecks["dx"]
    print(f"kernel K2 dx f32 [100, 244, 64] W^T [25, 64, 32]: max_abs_err "
          f"{r['max_abs_err']:.3g} (of max {r['scale']:.3g}), {r['ms']:.4f} "
          f"ms (plain {r['plain_ms']:.4f} ms) [{gpu}]", flush=True)

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
    k4 = {"f32": bsr_kernel_phase(op32, "K4", ("spmm", "hop"), gen,
                                  "K4 f32")}
    s_bf16 = dataclasses.replace(op32, blocks=op32.blocks.to(torch.bfloat16))
    del op32  # f32 blocks: 3.55 GB
    torch.cuda.empty_cache()
    k4["bf16"] = bsr_kernel_phase(s_bf16, "K4", ("spmm", "hop"), gen,
                                  "K4 bf16")
    k4["int8"] = bsr_kernel_phase(
        quantize_block_sparse(s_bf16, sample_x=s_max), "K4", ("spmm", "hop"),
        gen, "K4 int8")
    for lab, rec in k4.items():
        print_bsr_kernel(f"bsr_colstream (K4) {lab}", rec, gpu)

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
    csr = {"K8 f32": bsr_kernel_phase(op8, "K8", ("spmm",), gen, "K8 f32")}
    bf8 = dataclasses.replace(op8, blocks=op8.blocks.to(torch.bfloat16))
    del op8
    torch.cuda.empty_cache()
    csr["K8 bf16"] = bsr_kernel_phase(bf8, "K8", ("spmm",), gen, "K8 bf16")
    q8 = quantize_block_sparse(bf8, sample_x=s_max)
    csr["K7 int8"] = bsr_kernel_phase(q8, "K7", ("spmm", "hop"), gen,
                                      "K7 int8")
    del q8
    op9 = device_laplacian(L_s, fmt="bsr", chunked_rows=True, device=dev)
    check(op9.row_max > 0 and op9.rows_per_step == 1 and op9.group_max == 0,
          f"chunked_rows layout: row_max {op9.row_max}")
    csr["K9 f32"] = bsr_kernel_phase(op9, "K9", ("spmm",), gen, "K9 f32")
    bf9 = dataclasses.replace(op9, blocks=op9.blocks.to(torch.bfloat16))
    del op9
    torch.cuda.empty_cache()
    csr["K9 bf16"] = bsr_kernel_phase(bf9, "K9", ("spmm",), gen, "K9 bf16")
    op_city = device_laplacian(L, fmt="bsr", col_stream=False,
                               dtype=torch.bfloat16, device=dev)
    check(op_city.rows_per_step > 1, "the city graph's block-CSR layout has "
          f"G = {op_city.rows_per_step}, want more than 1")
    csr["K7 bf16"] = bsr_kernel_phase(op_city, "K7", ("spmm", "hop"), gen,
                                      "K7 bf16")
    print(f"block-CSR layouts: scattered G 1, group_max {bf8.group_max}; "
          f"chunked row_max {bf9.row_max}; city graph "
          f"{op_city.block_cols.numel()} blocks, G {op_city.rows_per_step}, "
          f"group_max {op_city.group_max}; set-up and checks "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for what, rec in csr.items():
        print_bsr_kernel(f"bsr_csr ({what})", rec, gpu)
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

    record = {"kernels": [
        {"name": f"band_dkw_{lab}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches[lab],
         "max_abs_err": checks[lab]["max_abs_err"], "ms": checks[lab]["ms"],
         "plain_ms": checks[lab]["plain_ms"],
         "hop_ms": checks[lab]["hop_ms"],
         "hop_plain_ms": checks[lab]["hop_plain_ms"],
         "request_ms": lat[lab]}
        for lab in ("int8", "bf16")
    ] + [
        {"name": f"band_dkw_hop_c_{lab}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": trains[lab]["forms"]["hop_c"],
         "max_abs_err": checks[lab]["hop_c_max_abs_err"],
         "ms": checks[lab]["hop_c_ms"],
         "plain_ms": checks[lab]["hop_c_plain_ms"],
         "train_ms_per_step": trains[lab]["ms"],
         "train_plain_ms_per_step": trains[lab]["plain_ms"]}
        for lab in ("bf16", "f32")
    ] + [
        {"name": f"cheby_conv_fused_{lab}", "route": "cuda",
         "source": CHEB_SOURCE, "replaces": CHEB_REPLACES["K2"],
         "launches": (cheb[lab]["serve"]["launches"][0]
                      + cheb[lab]["train"]["launches"][0]),
         "max_abs_err": kchecks[lab]["K2"]["max_abs_err"],
         "ms": kchecks[lab]["K2"]["ms"],
         "plain_ms": kchecks[lab]["K2"]["plain_ms"],
         "request_ms": cheb[lab]["serve"]["ms"],
         "request_plain_ms": cheb[lab]["serve"]["plain_ms"],
         "train_ms_per_step": cheb[lab]["train"]["ms"],
         "train_plain_ms_per_step": cheb[lab]["train"]["plain_ms"],
         **({"dx_ms": kchecks["dx"]["ms"],
             "dx_plain_ms": kchecks["dx"]["plain_ms"],
             "dx_max_abs_err": kchecks["dx"]["max_abs_err"]}
            if lab == "f32" else {})}
        for lab in DTYPES
    ] + [
        {"name": f"cheby_dw_fused_{lab}", "route": "cuda",
         "source": CHEB_SOURCE, "replaces": CHEB_REPLACES["K3"],
         "launches": cheb[lab]["train"]["launches"][1],
         "max_abs_err": kchecks[lab]["K3"]["max_abs_err"],
         "ms": kchecks[lab]["K3"]["ms"],
         "plain_ms": kchecks[lab]["K3"]["plain_ms"]}
        for lab in DTYPES
    ] + [
        {"name": f"bsr_colstream_{lab}", "route": "cuda",
         "source": BSR_SOURCE, "replaces": BSR_REPLACES["K4"],
         "launches": (s_served[lab]["launches"]
                      + (s_train["launches"] if lab == "bf16" else 0)),
         "max_abs_err": k4[lab]["max_abs_err"], "ms": k4[lab]["ms"],
         "plain_ms": k4[lab]["plain_ms"], "hop_ms": k4[lab]["hop_ms"],
         "hop_plain_ms": k4[lab]["hop_plain_ms"],
         "request_ms": s_served[lab]["ms"],
         "request_plain_ms": s_served[lab]["plain_ms"],
         **({"train_ms_per_step": s_train["ms"],
             "train_plain_ms_per_step": s_train["plain_ms"],
             "f32_ms": k4["f32"]["ms"], "f32_plain_ms": k4["f32"]["plain_ms"],
             "f32_hop_ms": k4["f32"]["hop_ms"],
             "f32_hop_plain_ms": k4["f32"]["hop_plain_ms"],
             "f32_max_abs_err": k4["f32"]["max_abs_err"]}
            if lab == "bf16" else {})}
        for lab in ("bf16", "int8")
    ] + [
        {"name": f"bsr_csr_{key.replace(' ', '_')}", "route": "cuda",
         "source": BSR_SOURCE, "replaces": BSR_REPLACES[key[:2]],
         "launches": rec["launches"],
         "max_abs_err": csr[key]["max_abs_err"], "ms": csr[key]["ms"],
         "plain_ms": csr[key]["plain_ms"],
         **({"hop_ms": csr[key]["hop_ms"],
             "hop_plain_ms": csr[key]["hop_plain_ms"]}
            if "hop_ms" in csr[key] else {}),
         **({"f32_ms": csr[f"{key[:2]} f32"]["ms"],
             "f32_plain_ms": csr[f"{key[:2]} f32"]["plain_ms"],
             "f32_max_abs_err": csr[f"{key[:2]} f32"]["max_abs_err"]}
            if f"{key[:2]} f32" in csr else {})}
        for key, rec in route_launches.items()
    ]}
    print(json.dumps(record))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
