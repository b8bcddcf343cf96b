"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--profile-dir DIR]

Phases, each fatal on failure (no CPU path, no fallback):

1. require a CUDA device; print the card's name and power limit;
2. build the banded kernel (csrc/band_dkw.cu) from source with nvcc;
3. hold the kernel against its plain PyTorch version on the real
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
7. with ``--profile-dir DIR`` only: trace 3 requests per serving mode
   after 2 warm-ups, and 2 bf16 training steps after one, with
   ``torch.profiler`` (CPU and CUDA activities); print the device time
   per request or step, its share of the measured time, the largest
   device kernels and aten ops, and for training the device time by
   part (K1 by form, taps, dW, injections, casts, adam); write each
   ``key_averages()`` table to ``DIR/profile_<mode>.txt``.

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

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cnn_graph_tpu_torch import _build, graphs  # noqa: E402
from cnn_graph_tpu_torch.models import NodeClassifier  # noqa: E402
from cnn_graph_tpu_torch.ops import (  # noqa: E402
    BandedLaplacian,
    QuantBandedLaplacian,
    banded_dkw,
    banded_dkw_reference,
    cheby_conv,
    device_laplacian,
    quantize_banded,
)
from cnn_graph_tpu_torch.serve import compile_serving  # noqa: E402
from cnn_graph_tpu_torch.train import train_node_classifier  # noqa: E402

SIDE, KNN, FIN, CLASSES, K = 224, 8, 512, 16, 25
N_REQUESTS = 4  # per serving mode
TRAIN_STEPS, LEARNING_RATE = 4, 1e-3  # per training mode; bench.py:268
# Kernel launches per training step of the deep model: each layer's
# forward runs 1 L@x and K-2 hops; layer 1's backward (layer 0 has no
# input gradient) K-2 adjoint hops and 1 L@x.
STEP_FORMS = {"spmm": 3, "hop": 2 * (K - 2), "hop_c": K - 2}
SOURCE = "cnn_graph_tpu_torch/csrc/band_dkw.cu"
REPLACES = "cnn_graph_tpu/ops/pallas_band.py:448"  # _kernel_dkw


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


def _plain_twin(op):
    cls = _PlainQuantBanded if isinstance(op, QuantBandedLaplacian) \
        else _PlainBanded
    return cls(**{f.name: getattr(op, f.name) for f in dataclasses.fields(op)})


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
    return avg


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
        avg = _trace(lambda s=serving: s(x), n, out_dir, mode)
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


def train_profile_phase(run, step_ms: float, out_dir: str, gpu: str,
                        n: int = 2):
    """Device-time breakdown of ``n`` bf16 training steps."""
    os.makedirs(out_dir, exist_ok=True)
    run(1)
    avg = _trace(lambda: run(1), n, out_dir, "train_bf16")
    busy = _busy_ms(avg, n)
    print(f"profile train bf16: device {busy:.3f} ms per step, "
          f"{100 * busy / step_ms:.1f}% of the {step_ms:.3f} ms step [{gpu}]")
    events = {e.key: e for e in avg if e.device_type == DeviceType.CPU}
    events.update({e.key: e for e in avg if e.device_type == DeviceType.CUDA
                   and e.is_user_annotation and e.key.startswith("band_dkw")})
    parts = 0.0
    for label, key in TRAIN_PARTS:
        e = events.get(key)
        ms = 0.0 if e is None else e.device_time_total / n / 1e3
        parts += ms
        calls = 0 if e is None else e.count / n
        print(f"  part {label}: {ms:.3f} ms ({_pct(ms, busy):.1f}%), "
              f"{calls:g} calls")
    print(f"  part rest: {busy - parts:.3f} ms")
    _print_top(avg, busy, n)


def _on(params, dev):
    return {"convs": [{k: v.detach().to(dev) for k, v in layer.items()}
                      for layer in params["convs"]]}


def loss_and_grads(model, params, data, seed: int):
    """One step's loss and parameter gradients, dropout drawn from a
    generator seeded with ``seed``."""
    p = {"convs": [{k: v.detach().clone().requires_grad_()
                    for k, v in layer.items()} for layer in params["convs"]]}
    gen = torch.Generator(device=data[0].device).manual_seed(seed)
    loss = model.loss(p, *data, train=True, generator=gen)
    loss.backward()
    return loss.detach(), [t.grad for layer in p["convs"]
                           for t in layer.values()]


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
    loss, grads = loss_and_grads(model, params, data, seed=1)
    torch.cuda.synchronize()
    banded_dkw.launches = 0
    loss_p, grads_p = loss_and_grads(twin, params, data, seed=1)
    torch.cuda.synchronize()
    check(banded_dkw.launches == 0, f"train {mode}: the plain twin launched "
          f"{banded_dkw.launches} kernels")
    # f32: the same arithmetic summed in another order, through 48 hops;
    # bf16: carries rounded after sums in another order may land an ulp
    # apart and travel along the chains, as in serving.
    tol = 1e-3 if mode == "f32" else 2e-2
    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    check(loss_err <= tol, f"train {mode}: loss {float(loss)} vs plain "
          f"{float(loss_p)}")
    grad_err = 0.0
    for g, gp in zip(grads, grads_p):
        check(bool(torch.isfinite(g).all()), f"train {mode}: gradient")
        err = float((g - gp).abs().max() / gp.abs().max())
        check(err <= tol, f"train {mode}: gradient {tuple(g.shape)} off the "
              f"plain version by {err:.3g} of its max (limit {tol})")
        grad_err = max(grad_err, err)

    step_ms = cuda_ms(lambda: run(TRAIN_STEPS), 1) / TRAIN_STEPS
    plain_step_ms = cuda_ms(lambda: run(1, m=twin), 1)
    return {"launches": launches, "forms": forms, "losses": losses,
            "peak_gb": peak_gb,
            "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "ms": step_ms, "plain_ms": plain_step_ms, "run": run}


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

    t0 = time.perf_counter()
    _, log = _build.build("band_dkw")
    build_s = time.perf_counter() - t0
    print(f"build: band_dkw.cu in {build_s:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

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
    if args.profile_dir:
        profile_phase(served, reqs[0], lat, args.profile_dir, gpu)
        train_profile_phase(trains["bf16"]["run"], trains["bf16"]["ms"],
                            args.profile_dir, gpu)

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
    ]}
    print(json.dumps(record))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
