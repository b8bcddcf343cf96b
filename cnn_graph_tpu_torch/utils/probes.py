"""Tensor-core probes on an NVIDIA H100: the counterpart of
``experiments/_probe.py``'s ``peak``, ``mxu``, ``pred`` and ``loopcost``
modes.

    python -m cnn_graph_tpu_torch.utils.probes {peak,mxu,pred,loopcost} [iters]

prints the same rows as ``_probe.py``, timed on the card by
``utils.profiling.slope_time`` (two chain lengths, differenced); as
there, ``iters`` is the longer chain's links or iterations, and P3's dots
per call.

* ``mxu_probe`` (P1, ``_probe.py:136 _mxu_probe``): the in-kernel rate of
  one dot geometry, a loop-carried chain so that no dot can be hoisted;
* ``pred_probe`` (P2, ``_probe.py:235 _pred_probe``): the 9-tap loop with
  each tap run only when ``d < w_i``, ``w_i`` cycling through a width
  table on the device;
* ``loopcost_probe`` (P3, ``_probe.py:372 main_loopcost``): ``n_dots``
  dots from 16 operand pairs, ``unroll`` per iteration of a dynamic loop;
* ``peak_probe`` (``_probe.py:54 _peak_probe``): the library's own matrix
  product chained, ``torch.matmul`` and ``torch._int_mm`` (cuBLAS), the
  yardstick the probes are read against.

The three probe kernels live in ``csrc/probes.cu`` and run only on a CUDA
device: a CPU tensor raises, nothing falls back.  Each has its plain
PyTorch version (``*_reference``), which computes the same function on any
device and is what the kernels are held against.  ``launches`` on each
probe counts its kernel launches (a view of the recorder's counter,
``utils/profiling.py Counted``).  The Pallas probes compute their
functions with every operand resident in VMEM; ``csrc/probes.cu`` says
how the CUDA ones keep theirs in L2 and walk them through the wmma CTA
tile of the banded tile kernels that the row walks replaced.
"""

from __future__ import annotations

import ctypes
import functools
import math
import sys

import torch

from cnn_graph_tpu_torch import _build
from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.utils.profiling import (
    H100_OPS_PER_S,
    counted,
    roofline,
    slope_time,
)

__all__ = ["TILE", "LOOP_PAIRS", "MXU_SHAPES", "PRED_VARIANTS",
           "LOOPCOST_UNROLLS", "CHECK_SCALE", "mxu_flops", "pred_flops",
           "loopcost_flops", "mxu_probe", "mxu_reference", "pred_probe",
           "pred_reference", "loopcost_probe", "loopcost_reference",
           "peak_probe", "card_replicas", "card_sms", "mxu_operands",
           "pred_operands", "loopcost_operands", "time_probe",
           "probe_rows", "loop_overhead", "PEAK_ROWS", "peaks", "peak_of",
           "compare", "shares"]

TILE = 128  # a CTA's output rows and columns, and the carry's rows
LOOP_PAIRS = 16  # main_loopcost's T
# main_mxu's geometries (_probe.py:217-230): m, k, n, taps, dtype.
MXU_SHAPES = {
    "tap9_bf16": (128, 1152, 512, 9, torch.bfloat16),
    "deepk_bf16": (128, 1152, 512, 1, torch.bfloat16),
    "deepk_m256": (256, 1152, 512, 1, torch.bfloat16),
    "tap9_int8": (128, 1152, 512, 9, torch.int8),
    "deepk_int8": (128, 1152, 512, 1, torch.int8),
    "sq1024": (1024, 1024, 1024, 1, torch.bfloat16),
    "i8_sq1024": (1024, 1024, 1024, 1, torch.int8),
}
# main_pred's variants (_probe.py:305-310): width table, cond.
PRED_VARIANTS = {
    "base9": ([9], False),
    "cond_w9": ([9], True),
    "cond_w7": ([5, 6, 7, 8, 9, 9, 7, 5, 6, 8], True),
    "cond_w5": ([5], True),
}
PRED_SHAPE = (9, 128, 128, 512)  # taps, m, k0, n (_probe.py:235)
LOOPCOST_UNROLLS = (1, 2, 4, 8)
LOOPCOST_DOTS = 2048  # main_loopcost's N
# bf16 operands of the checks are N(0, 1) times this (a power of two, so
# exact in bf16): the carry acc * 1e-6 then moves the next iteration's
# sums by 10-50% (P1 tap9's b + carry, P1 deep-K's and P2's injection
# dot), where N(0, 1) operands leave it under one bf16 ulp of b.
CHECK_SCALE = 2.0 ** 14
_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1}


def mxu_flops(m: int, k: int, n: int, taps: int) -> int:
    """Operations of one P1 iteration (_probe.py:208): the deep-K form
    counts its 128-deep injection tap."""
    return 2 * m * (k + (TILE if taps == 1 else 0)) * n


def pred_flops(widths, m: int = 128, k0: int = 128, n: int = 512) -> float:
    """Useful operations of one P2 iteration (_probe.py:299-300): the mean
    width's taps plus the injection tap."""
    return 2 * m * k0 * n * (sum(widths) / len(widths) + 1)


def loopcost_flops(m: int = 128, k: int = 128, n: int = 512) -> int:
    """Operations of one P3 dot (_probe.py:435)."""
    return 2 * m * k * n


def card_replicas(n: int, sms: int) -> int:
    """Replicas of a probe whose ``n / 128`` column tiles then give at
    least two CTAs on each of ``sms`` SMs."""
    return math.ceil(2 * sms / (n // TILE))


def card_sms() -> int:
    """The current CUDA device's streaming multiprocessors."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


# ------------------------------------------------------- plain versions


def _wrap(x: torch.Tensor, dtype) -> torch.Tensor:
    """An integer tensor wrapped into ``dtype``'s range, as a two's
    complement narrowing (JAX's ``astype``) does."""
    bits = torch.iinfo(dtype).bits
    half = 1 << (bits - 1)
    return (torch.remainder(x.to(torch.int64) + half, 2 * half) - half).to(
        dtype)


def mxu_reference(a: torch.Tensor, b: torch.Tensor, iters: int, taps: int,
                  replicas: int = 1):
    """Plain PyTorch version of ``mxu_probe``: the body of ``_mxu_probe``
    (_probe.py:155-181) run ``iters`` times from a zero carry.  The carry
    has ``R = min(m, 128)`` rows (the probe's 128; smaller m for small
    tests); taps > 1 needs ``k / taps == R``.  bf16 operands accumulate in
    f32, int8 in float64, which is exact here and equals JAX's int32.
    Returns ``(carry [replicas, R, n], extra [replicas, R, n])``: ``extra``
    sums ``acc[R c : R c + R]`` over the iterations for c = m/R - 1 down
    to 1 (f32, or int32 wrapped), as the kernel folds the rows that feed
    no carry; zero when m = R."""
    int8 = a.dtype == torch.int8
    _, m, kd = a.shape
    n = b.shape[2]
    R = min(m, TILE)
    acc_dt = torch.float64 if int8 else torch.float32
    A, B = a.to(acc_dt), b.to(acc_dt)
    carry = torch.zeros(replicas, R, n, dtype=a.dtype, device=a.device)
    extra = torch.zeros(replicas, R, n, dtype=acc_dt, device=a.device)
    with full_f32_matmul():
        for _ in range(iters):
            if taps > 1:
                acc = torch.zeros(replicas, m, n, dtype=acc_dt,
                                  device=a.device)
                for d in range(taps):
                    if int8:
                        bb = _wrap(b[d].to(torch.int32) + carry.to(
                            torch.int32), torch.int8)
                    else:
                        bb = b[d] + carry  # bf16, rounded once
                    acc = acc + A[d] @ bb.to(acc_dt)
            else:
                acc = A[0] @ B[0] + A[0][:, :R] @ carry.to(acc_dt)
            for c in reversed(range(1, m // R)):
                extra = extra + acc[:, R * c:R * (c + 1)]
            head = acc[:, :R]
            if int8:
                carry = _wrap(head.to(torch.int64) >> 12, torch.int8)
            else:
                carry = (head * 1e-6).to(a.dtype)
    if int8:
        extra = _wrap(extra.to(torch.int64), torch.int32)
    return carry, extra


def pred_reference(widths, a: torch.Tensor, b: torch.Tensor, iters: int,
                   cond: bool = True, replicas: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``pred_probe`` (_probe.py:254-271): per
    iteration ``acc = a[0] @ carry``, then ``a[d] @ b[d]`` for each tap d
    with ``not cond or d < widths[i % len(widths)]``, then ``carry =
    bf16(acc * 1e-6)``; f32 accumulation.  ``m == k0``.  Returns the
    carry ``[replicas, k0, n]``."""
    w = [int(v) for v in (widths.tolist() if torch.is_tensor(widths)
                          else widths)]
    taps, _, k0 = a.shape
    A, B = a.float(), b.float()
    carry = torch.zeros(replicas, k0, b.shape[2], dtype=a.dtype,
                        device=a.device)
    with full_f32_matmul():
        for i in range(iters):
            acc = A[0] @ carry.float()
            for d in range(taps):
                if not cond or d < w[i % len(w)]:
                    acc = acc + A[d] @ B[d]
            carry = (acc * 1e-6).to(a.dtype)
    return carry


def loopcost_reference(seed: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       n_dots: int, unroll: int) -> torch.Tensor:
    """Plain PyTorch version of ``loopcost_probe`` (_probe.py:393-409):
    ``acc = f32(seed)``; ``n_dots / unroll`` iterations of ``unroll`` dots
    ``acc += a[idx] @ b[idx]``, ``idx = (i * unroll + d) % T``; returns
    ``bf16(acc * 1e-3)`` in seed's shape."""
    T = a.shape[0]
    A, B = a.float(), b.float()
    acc = seed.float()
    with full_f32_matmul():
        for i in range(n_dots // unroll):
            base = (i * unroll) % T
            for d in range(unroll):
                idx = (base + d) % T
                acc = acc + A[idx] @ B[idx]
    return (acc * 1e-3).to(seed.dtype)


def compare(got: torch.Tensor, want: torch.Tensor, iters: int) -> float:
    """Hold a probe kernel's output to its plain version's.  Integers
    (int8 carries, int32 ``extra``) bit-identical.  bf16 after one
    iteration within one bf16 ulp of each entry, plus 2^-15 of the max
    for f32 sums taken in another order near cancellation; after more,
    within 2e-2 of the max (carries an ulp apart travel).  f32 ``extra``
    within 1e-4 of the max.  Returns the largest absolute difference;
    raises ``AssertionError`` past the bound."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            raise AssertionError("integer output not bit-identical")
        return float((got.long() - want.long()).abs().max())
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * top)
    elif iters == 1:
        torch.testing.assert_close(g, w, rtol=2**-7, atol=2**-15 * top)
    else:
        torch.testing.assert_close(g, w, rtol=0, atol=2e-2 * top)
    return float((g - w).abs().max())


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_mxu_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.probe_pred_launch.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.probe_loopcost_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    for fn in (lib.probe_mxu_launch, lib.probe_pred_launch,
               lib.probe_loopcost_launch):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, tensors, dtypes):
    """Every tensor contiguous on one CUDA device in an accepted dtype;
    a CPU tensor raises: the probes have no plain fallback."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: the probe kernels run on a CUDA device "
                           f"only, not {dev}; the plain version is "
                           f"{name.replace('_probe', '_reference')}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on "
                             f"{dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must start on a 16-byte "
                             "boundary")
    if tensors[0].dtype not in dtypes or any(
            t.dtype != tensors[0].dtype for t in tensors[1:]):
        raise TypeError(f"{name}: operands must share one dtype of "
                        f"{dtypes}")


def _run(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


@counted("mxu_probe")
def mxu_probe(a: torch.Tensor, b: torch.Tensor, iters: int, taps: int,
              replicas: int = 1):
    """P1 on the card: ``replicas`` copies of ``mxu_reference``'s chain,
    one CTA per 128-column tile each, in one launch.  ``a`` ``[taps, m,
    k/taps]``, ``b`` ``[taps, k/taps, n]``, bfloat16 or int8; m and n
    multiples of 128; taps > 1 needs ``k/taps == 128``.  Returns ``(carry,
    extra)``, each ``[replicas, 128, n]``."""
    _check("mxu_probe", (a, b), tuple(_DTYPE_CODE))
    t, m, kd = a.shape
    if (t != taps or b.shape[:2] != (taps, kd) or m % TILE
            or b.shape[2] % TILE or (taps > 1 and kd != TILE)
            or (taps == 1 and (kd % 32 or kd < TILE)) or replicas < 1):
        raise ValueError(f"mxu_probe: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, taps {taps}")
    n = b.shape[2]
    out = torch.empty(replicas, TILE, n, dtype=a.dtype, device=a.device)
    extra = torch.zeros(replicas, TILE, n, device=a.device,
                        dtype=torch.int32 if a.dtype == torch.int8
                        else torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _run("mxu_probe", _lib().probe_mxu_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), extra.data_ptr(), m,
            taps * kd, n, taps, iters, replicas, _DTYPE_CODE[a.dtype],
            stream))
    mxu_probe.launched()
    return out, extra


@counted("pred_probe")
def pred_probe(widths: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               iters: int, cond: bool = True,
               replicas: int = 1) -> torch.Tensor:
    """P2 on the card: ``pred_reference``'s chain, the width table int32
    on the device, the branch uniform over each CTA.  ``a`` ``[taps, 128,
    128]``, ``b`` ``[taps, 128, n]`` bfloat16.  Returns the carry
    ``[replicas, 128, n]``."""
    _check("pred_probe", (a, b), (torch.bfloat16,))
    if (widths.dtype != torch.int32 or widths.device != a.device
            or widths.dim() != 1 or widths.numel() < 1):
        raise ValueError("pred_probe: widths must be a non-empty int32 "
                         "vector on the operands' device")
    taps = a.shape[0]
    if (a.shape[1:] != (TILE, TILE) or b.shape[:2] != (taps, TILE)
            or b.shape[2] % TILE or replicas < 1):
        raise ValueError(f"pred_probe: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    n = b.shape[2]
    out = torch.empty(replicas, TILE, n, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _run("pred_probe", _lib().probe_pred_launch(
            widths.data_ptr(), widths.numel(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), taps, n, iters, int(cond), replicas, stream))
    pred_probe.launched()
    return out


@counted("loopcost_probe")
def loopcost_probe(seed: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   n_dots: int, unroll: int) -> torch.Tensor:
    """P3 on the card: ``loopcost_reference`` in one launch, the unroll a
    compile-time constant (1, 2, 4 or 8).  ``seed`` ``[replicas, 128, n]``,
    ``a`` ``[T, 128, 128]``, ``b`` ``[T, 128, n]``, bfloat16.  Returns
    ``[replicas, 128, n]``: the next call's seed."""
    _check("loopcost_probe", (seed, a, b), (torch.bfloat16,))
    T = a.shape[0]
    if (seed.dim() != 3 or seed.shape[1] != TILE or seed.shape[2] % TILE
            or a.shape[1:] != (TILE, TILE)
            or b.shape != (T, TILE, seed.shape[2])
            or unroll not in LOOPCOST_UNROLLS or n_dots % unroll):
        raise ValueError(f"loopcost_probe: seed {tuple(seed.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, unroll "
                         f"{unroll}, n_dots {n_dots}")
    out = torch.empty_like(seed)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _run("loopcost_probe", _lib().probe_loopcost_launch(
            seed.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), T,
            seed.shape[2], n_dots, unroll, seed.shape[0], stream))
    loopcost_probe.launched()
    return out


# -------------------------------------------------------------- operands


def mxu_operands(name: str, device, seed: int = 0, check: bool = False):
    """Seeded operands of one ``MXU_SHAPES`` geometry: bf16 ``N(0, 1)``,
    times ``CHECK_SCALE`` with ``check`` (the carry then counts); int8
    uniform on [-127, 127] (the carry wraps, as in JAX)."""
    m, k, n, taps, dt = MXU_SHAPES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ((taps, m, k // taps), (taps, k // taps, n))
    if dt == torch.int8:
        return tuple(torch.randint(-127, 128, s, generator=g, device=device,
                                   dtype=torch.int8) for s in shapes)
    scale = CHECK_SCALE if check else 1.0
    return tuple((scale * torch.randn(s, generator=g, device=device)).to(dt)
                 for s in shapes)


def pred_operands(device, seed: int = 0, check: bool = False):
    """P2's ``(a, b)``, bf16 ``N(0, 1)``, times ``CHECK_SCALE`` with
    ``check``."""
    taps, m, k0, n = PRED_SHAPE
    g = torch.Generator(device=device).manual_seed(seed)
    scale = CHECK_SCALE if check else 1.0
    return tuple((scale * torch.randn(s, generator=g, device=device)).to(
        torch.bfloat16) for s in ((taps, m, k0), (taps, k0, n)))


def loopcost_operands(device, replicas: int = 1, seed: int = 0):
    """``(seed, a, b)`` as main_loopcost makes them (_probe.py:431-434):
    operands ``N(0, 0.01^2)``, a zero seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = (0.01 * torch.randn(LOOP_PAIRS, TILE, TILE, generator=g,
                            device=device)).to(torch.bfloat16)
    b = (0.01 * torch.randn(LOOP_PAIRS, TILE, 512, generator=g,
                            device=device)).to(torch.bfloat16)
    return torch.zeros(replicas, TILE, 512, dtype=torch.bfloat16,
                       device=device), a, b


# ---------------------------------------------------------------- timing


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _chain(seed, step):
    """``make(u)`` for ``slope_time``: ``u`` calls of ``step``, each
    seeded by the last one's output."""
    def make(u):
        def run():
            s = seed
            for _ in range(u):
                s = step(s)
            return s
        return run
    return make


def _case(kind: str, name, iters: int, replicas: int, n_dots: int) -> dict:
    """What ``time_probe`` needs of one probe at ``replicas``: ``run`` and
    ``plain`` (``u`` -> a callable of a ``u``-unit chain), the units of
    the longer timed chain, and the operations, bytes and operand dtype of
    one unit.  A unit is an iteration of P1 or P2, whose operands and
    outputs move once a call, or a call of P3 (``n_dots`` dots)."""
    if kind == "mxu":
        m, k, n, taps, dt = MXU_SHAPES[name]
        a, b = mxu_operands(name, "cuda")
        iters = max(iters // 8, 32) if m == 1024 else iters
        outs = replicas * TILE * n * (dt.itemsize + 4)  # carry and extra
        return {"run": lambda u: lambda: mxu_probe(a, b, u, taps,
                                                   replicas)[0],
                "plain": lambda u: lambda: mxu_reference(a, b, u, taps,
                                                         replicas)[0],
                "iters": iters, "ops": mxu_flops(m, k, n, taps) * replicas,
                "nbytes": (_nbytes(a, b) + outs) / iters, "dtype": dt}
    if kind == "pred":
        widths, cond = PRED_VARIANTS[name]
        a, b = pred_operands("cuda")
        w = torch.tensor(widths, dtype=torch.int32, device="cuda")
        outs = replicas * TILE * b.shape[2] * 2
        return {"run": lambda u: lambda: pred_probe(w, a, b, u, cond,
                                                    replicas),
                "plain": lambda u: lambda: pred_reference(widths, a, b, u,
                                                          cond, replicas),
                "iters": iters, "ops": pred_flops(widths) * replicas,
                "nbytes": (_nbytes(a, b, w) + outs) / iters,
                "dtype": torch.bfloat16,
                "mean_w": sum(widths) / len(widths)}
    seed, a, b = loopcost_operands("cuda", replicas)
    return {"run": _chain(seed, lambda s: loopcost_probe(s, a, b, n_dots,
                                                         name)),
            "plain": _chain(seed, lambda s: loopcost_reference(
                s, a, b, n_dots, name)),
            "iters": iters, "ops": loopcost_flops() * n_dots * replicas,
            "nbytes": 2 * _nbytes(seed) + _nbytes(a, b),
            "dtype": torch.bfloat16, "n_dots": n_dots}


_KERNEL = {"mxu": mxu_probe, "pred": pred_probe, "loopcost": loopcost_probe}
_CASES = {"mxu": tuple(MXU_SHAPES), "pred": tuple(PRED_VARIANTS),
          "loopcost": LOOPCOST_UNROLLS}
_UNIT = {"mxu": "iteration", "pred": "iteration", "loopcost": "call"}


def time_probe(kind: str, name, iters: int, replicas: int = 1,
               plain_iters: int = 0, n_dots: int = LOOPCOST_DOTS) -> dict:
    """One probe on the card: ``kind`` is ``"mxu"`` (``name`` a
    geometry), ``"pred"`` (a variant) or ``"loopcost"`` (an unroll).
    Seconds per unit ``s`` by slope fit over ``(max(iters // 4, 2),
    iters)`` units (sq1024: an eighth of ``iters``, at least 32), the
    launches this made, the rate over every replica, and the bound of one
    unit (``roofline``).  P2's rate counts useful operations
    (``pred_flops``); P3 adds seconds per dot of one replica's tile.
    With ``plain_iters``, the plain version's seconds per unit
    ``plain_s``, fitted over (1, plain_iters)."""
    c = _case(kind, name, iters, replicas, n_dots)
    kernel = _KERNEL[kind]
    before = kernel.launches
    per, fixed = slope_time(c["run"], units=(max(c["iters"] // 4, 2),
                                             c["iters"]))
    bound = roofline(c["ops"], c["nbytes"], c["dtype"])
    rec = {"name": name, "replicas": replicas, "s": per, "fixed_s": fixed,
           "launches": kernel.launches - before, "ops_per_unit": c["ops"],
           "ops_per_s": c["ops"] / per, "bound_s": bound["bound_us"] / 1e6,
           "bound_by": bound["bound_by"]}
    if kind == "pred":
        rec["mean_w"] = c["mean_w"]
    if kind == "loopcost":
        rec["n_dots"] = n_dots
        rec["s_per_dot"] = per / (n_dots * replicas)
    if plain_iters:
        rec["plain_s"] = slope_time(c["plain"], units=(1, plain_iters),
                                    reps=1)[0]
    return rec


# The rows of main_peak that the port keeps (_probe.py:113-131): name,
# size, dtype, iteration divisor (iters // d, at least 4) or multiplier
# (negative), and the variant: "tf32" lets f32 take TF32; "col_b" gives
# int8 its second operand column-major, the layout of cuBLASLt's int8
# tensor-core kernels (A row-major, B column-major).
PEAK_ROWS = (
    ("bf16_2048", 2048, torch.bfloat16, -8, None),
    ("bf16_4096", 4096, torch.bfloat16, 1, None),
    ("bf16_8192", 8192, torch.bfloat16, 8, None),
    ("f32_4096", 4096, torch.float32, 4, None),
    ("f32_tf32_4096", 4096, torch.float32, 4, "tf32"),
    ("int8_4096", 4096, torch.int8, 1, None),
    ("int8_4096_col_b", 4096, torch.int8, 1, "col_b"),
)


def peak_probe(size: int, dtype, iters: int, variant=None) -> dict:
    """The library's matrix-product rate (_probe.py:54-110): a chain of
    ``[size, size]`` products, slope-fitted over (max(iters // 4, 2),
    iters) links.  bf16 and f32: ``z = z @ (1.0003 I)`` from ``0.03``,
    f32 in exact f32 unless ``variant="tf32"`` (TF32, the analogue of the
    TPU's default f32 precision); int8: ``z = (z @ w) >> 12`` from ones
    through ``torch._int_mm`` (int32 accumulation), ``w`` column-major
    with ``variant="col_b"``.  A measurement of cuBLAS, which no path of
    the port calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("peak_probe times the card; no CUDA device")
    dev = torch.device("cuda")
    if dtype == torch.int8:
        z0 = torch.ones(size, size, dtype=torch.int8, device=dev)
        w = torch.ones(size, size, dtype=torch.int8, device=dev)
        if variant == "col_b":
            w = w.t().contiguous().t()

        def link(z):
            return (torch._int_mm(z, w) >> 12).to(torch.int8)
    else:
        z0 = torch.full((size, size), 0.03, dtype=dtype, device=dev)
        w = (torch.eye(size, device=dev) * 1.0003).to(dtype)

        def link(z):
            return torch.matmul(z, w)

    def make(u):
        def run():
            z = z0
            for _ in range(u):
                z = link(z)
            return z
        return run

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = variant == "tf32"
    try:
        per, fixed = slope_time(make, units=(max(iters // 4, 2), iters))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    flops = 2 * size ** 3
    return {"s_per_iter": per, "fixed_s": fixed, "ops_per_s": flops / per}


def peaks(iters: int) -> dict:
    """Every ``PEAK_ROWS`` row at ``iters``: name -> ``peak_probe``."""
    out = {}
    for name, size, dt, div, variant in PEAK_ROWS:
        it = iters * -div if div < 0 else max(iters // div, 4)
        out[name] = peak_probe(size, dt, it, variant)
    return out


def peak_of(measured: dict, dtype) -> float:
    """The highest measured library rate for ``dtype`` (ops per second)."""
    return max(measured[name]["ops_per_s"]
               for name, _, dt, _, _ in PEAK_ROWS if dt == dtype)


# -------------------------------------------------------------------- CLI


def shares(ops_per_s: float, dtype, library: float | None = None,
           variant=None) -> str:
    """A rate as TFLOP/s (TOP/s for int8) and its share of the data-sheet
    peak (``variant="tf32"``: the TF32 rate) and, where measured, of the
    library's peak."""
    unit = "TOP/s" if dtype == torch.int8 else "TFLOP/s"
    peak = H100_OPS_PER_S["tf32" if variant == "tf32" else dtype]
    out = (f"{ops_per_s / 1e12:7.1f} {unit} ({100 * ops_per_s / peak:4.1f}% "
           "of data sheet")
    if library:
        out += f", {100 * ops_per_s / library:4.1f}% of cuBLAS"
    return out + ")"


def probe_rows(kind: str, iters: int, library: dict | None = None,
               plain_iters: int = 0, n_dots: int = LOOPCOST_DOTS) -> dict:
    """``time_probe`` for every case of ``kind`` at one replica and at
    ``card_replicas``, a row printed for each; ``library`` (``peaks``'
    result) adds the cuBLAS share, ``plain_iters`` the plain version's
    time at the card's replicas.  Returns ``{name: {replicas:
    record}}``."""
    out = {}
    sms = card_sms()
    for name in _CASES[kind]:
        n, dt = ((MXU_SHAPES[name][2], MXU_SHAPES[name][4]) if kind == "mxu"
                 else (PRED_SHAPE[3], torch.bfloat16))
        peak = library and peak_of(library, dt)
        out[name] = {}
        for reps in (1, card_replicas(n, sms)):
            r = out[name][reps] = time_probe(
                kind, name, iters, reps, plain_iters if reps > 1 else 0,
                n_dots)
            dot = (f" {r['s_per_dot'] * 1e9:.1f} ns/dot"
                   if kind == "loopcost" else "")
            print(f"{kind} {name!s:10s} x{reps:<3d} {r['s'] * 1e6:9.2f} us "
                  f"per {_UNIT[kind]}{dot} {shares(r['ops_per_s'], dt, peak)}",
                  flush=True)
    return out


def loop_overhead(rows: dict) -> dict:
    """P3's cost of one loop iteration at each replica count, from
    ``probe_rows("loopcost", ...)``: ``(t1 - t8) 8 / 7`` per dot of a
    tile (_probe.py:444-447), seconds."""
    return {reps: (rows[1][reps]["s"] - rows[8][reps]["s"])
            / rows[1][reps]["n_dots"] * 8 / 7 for reps in rows[1]}


def main(argv) -> int:
    if len(argv) < 1 or argv[0] not in ("peak", "mxu", "pred", "loopcost"):
        print(__doc__.split("\n\n")[1].strip())
        return 2
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device; none is visible")
    mode, arg = argv[0], (int(argv[1]) if len(argv) > 1 else None)
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    if mode == "peak":
        measured = peaks(arg or 50)
        for name, _, dt, _, variant in PEAK_ROWS:
            r = measured[name]
            print(f"{name:16s} {r['s_per_iter'] * 1e6:8.1f} us/iter  "
                  f"{shares(r['ops_per_s'], dt, variant=variant)}  "
                  f"fixed={r['fixed_s'] * 1e3:.1f} ms", flush=True)
    elif mode == "loopcost":
        rows = probe_rows("loopcost", 16, n_dots=arg or LOOPCOST_DOTS)
        for reps, ov in loop_overhead(rows).items():
            print(f"loopcost x{reps}: per-iteration overhead ~ "
                  f"{ov * 1e9:.1f} ns", flush=True)
    else:
        probe_rows(mode, arg or 2000)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
