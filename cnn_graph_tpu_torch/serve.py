"""Serving: one call from a trained model to an inference handle, or to a
deployable artifact that loads without model code.

Counterpart of ``cnn_graph_tpu/serve.py``:

* ``compile_serving`` (:114): the in-process handle.  It quantizes the
  model's graph operators (``int8=True``), places the operators (in
  ``op`` or an ``operators`` list, as ``_model_operators`` :54-62 finds
  them) and the whole parameter tree on the example input's device; a
  call checks its input against ``input_spec`` and runs the forward pass
  under ``torch.inference_mode()``.  The JAX package's AOT compile has
  no counterpart: PyTorch runs eagerly.
* ``export_serving`` (:131) and ``load_serving`` (:211): the same
  inference function, traced by ``torch.export`` into ``model.pt2``, its
  leaves in ``leaves.npz`` and ``meta.json`` beside it.  The directory
  is the deployable unit: ``load_serving`` builds no model, and needs
  only this package's op library (``ops/library.py``), which registers
  the hand-written kernels as the custom ops the program calls.

The graph operators and the parameters are ARGUMENTS of the exported
program, flattened into leaves (``models.common.graph_arrays``), never
constants baked into it, as in JAX (:20-27): its calling convention is
``(list_of_tensors, x)``.  Ints and floats of the operators (levels,
G, scales) are static, as in JAX's trace.  ``meta.json`` keeps JAX's
keys; ``platforms`` is the one device type the program was traced for
(``cpu`` or ``cuda``), and ``int8`` says whether an operator was
actually converted.  Both handles run under ``full_f32_matmul()``: the
program does not record the global TF32 switch, and f32 taps must not
silently run in TF32 in a process that turned it on.

Run an artifact from the command line (one JSON line: load seconds,
ms per call, kernel launches per request):

    python -m cnn_graph_tpu_torch.serve DIR X.npy [X.npy ...] [--out OUT]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from cnn_graph_tpu_torch.models import common
# Registers the kernels' custom ops, which torch.export.load needs.
from cnn_graph_tpu_torch.ops import library
from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.ops.laplacian import BCOOLaplacian
from cnn_graph_tpu_torch.utils.profiling import span

__all__ = ["InputSpec", "CompiledServing", "LoadedServing",
           "compile_serving", "export_serving", "load_serving"]

_TIMED_CALLS = 5  # the command line's latency: calls of the first input
_ARTIFACT = "model.pt2"
_LEAVES = "leaves.npz"
_META = "meta.json"


@dataclasses.dataclass(frozen=True)
class InputSpec:
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _check_input(spec: InputSpec, x: torch.Tensor):
    if (tuple(x.shape) != spec.shape or x.dtype != spec.dtype
            or x.device != spec.device):
        raise ValueError(
            f"input {tuple(x.shape)} {x.dtype} on {x.device} does not "
            f"match the serving spec {spec}"
        )


class CompiledServing:
    """Inference handle for ONE input shape, dtype and device."""

    def __init__(self, model, params, input_spec: InputSpec):
        self.model = model  # its operator quantized and on the device
        self.params = params  # on the device
        self.input_spec = input_spec

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with span("serve.request", unit=True):
            _check_input(self.input_spec, x)
            with torch.inference_mode(), full_f32_matmul():
                return self.model.apply(self.params, x)


def _model_operators(model) -> list:
    """The model's graph operators (``op``, ``operators``), in order."""
    ops = []
    for f in ("op", "operators"):
        v = getattr(model, f, None)
        if v is not None:
            ops.extend(v if isinstance(v, list) else [v])
    return ops


def _prepare(model, params, example_x, int8, sample_x, headroom):
    """The served model and parameters on ``example_x``'s device, its
    operators quantized with ``int8``, and the number of operators that
    were converted to an int8 twin."""
    device = example_x.device
    if sample_x is None:
        sample_x = float(example_x.abs().max()) or 1.0
    qmodel = (common.quantize_model_operators(model, sample_x=sample_x,
                                              headroom=headroom)
              if int8 else model)
    n_quant = sum(after is not before for before, after in zip(
        _model_operators(model), _model_operators(qmodel)))
    served = common.map_operators(qmodel, lambda op: op.to(device))
    params = common.tree_map(lambda t: t.detach().to(device), params)
    return served, params, n_quant


def compile_serving(model, params, example_x: torch.Tensor, int8: bool = True,
                    sample_x: float | None = None,
                    headroom: float = 2.0) -> CompiledServing:
    """Serving handle for ``model.apply(params, x)`` at ``example_x``'s
    shape, dtype and device.  ``int8=True`` swaps the graph operator for
    its quantized twin; ``sample_x`` defaults to ``max|example_x|`` and
    seeds the operator's static activation scale (the recurrence itself
    rescales at run time inside ``cheby_conv``)."""
    served, params, _ = _prepare(model, params, example_x, int8, sample_x,
                                 headroom)
    spec = InputSpec(tuple(example_x.shape), example_x.dtype,
                     example_x.device)
    return CompiledServing(served, params, spec)


class _FlatApply(torch.nn.Module):
    """``model.apply`` on flat leaves, the program ``torch.export``
    traces: ``forward(leaves, x)`` rebuilds the graph data and the
    parameters from ``spec`` inside the trace.  The model is held
    outside the module's attributes, so that none of its own parameters
    or tensors enters the program."""

    def __init__(self, model, spec):
        super().__init__()
        self._served = (model, spec)

    def forward(self, leaves: list, x: torch.Tensor) -> torch.Tensor:
        model, spec = self._served
        graph, params = pytree.tree_unflatten(leaves, spec)
        return common.with_graph_arrays(model, graph).apply(params, x)


def export_serving(model, params, example_x: torch.Tensor, path: str,
                   int8: bool = True, sample_x: float | None = None,
                   headroom: float = 2.0, platforms=None) -> str:
    """Trace the (quantized) inference function at ``example_x``'s
    shape, dtype and device with ``torch.export`` and write it and its
    leaves to the directory ``path``, which ``load_serving`` loads
    without model code.  ``int8``, ``sample_x`` and ``headroom`` as for
    ``compile_serving``.  ``platforms`` (default: ``example_x``'s device
    type) may only name that device type: the program is traced on that
    device's kernels and runs there alone.  A model on node-sharded
    operators is refused, as JAX's (serve.py:145-155), and so is one on
    a BCOO operator, whose sparse matrix ``torch.export`` cannot take as
    a leaf.  Returns ``path``."""
    sharded = [type(o).__name__ for o in _model_operators(model)
               if getattr(o, "mesh", None) is not None]
    if sharded:
        raise ValueError(
            f"model carries sharded (halo) operators {sharded}: the "
            "export artifact is the single-chip serving unit — a "
            "shard_map program would bake the exporting mesh's device "
            "count into the artifact.  Shard at the serving layer by "
            "graph partition instead, or rebuild the model with "
            "single-chip operators before exporting."
        )
    if any(isinstance(o, BCOOLaplacian) for o in _model_operators(model)):
        raise ValueError(
            "model carries a BCOO operator: its torch sparse matrix cannot "
            "be a leaf of the artifact (torch.export takes dense tensors); "
            "build the operator with fmt='dense', 'banded' or 'bsr' to "
            "export it")
    kind = example_x.device.type
    if platforms is not None and list(platforms) != [kind]:
        raise ValueError(
            f"platforms {list(platforms)}: the program is traced for the "
            f"device of example_x ({kind!r}) and runs there only; put "
            "example_x on the target device instead")
    served, params, n_quant = _prepare(model, params, example_x, int8,
                                       sample_x, headroom)
    leaves, spec = pytree.tree_flatten(
        (common.graph_arrays(served), params))
    with torch.no_grad():
        program = torch.export.export(_FlatApply(served, spec),
                                      (leaves, example_x), strict=False)
    # The leaves go to leaves.npz; kept, torch.export.save would write
    # them and x into model.pt2 again as the example inputs.
    program.example_inputs = None
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _ARTIFACT))
    host = [t.detach().contiguous().cpu() for t in leaves]
    # Raw bytes with dtype and shape beside (JAX :163-176): bf16 then
    # round-trips without pickled tensors.
    np.savez(os.path.join(path, _LEAVES), **{
        f"a{i}": t.reshape(-1).view(torch.uint8).numpy()
        for i, t in enumerate(host)})
    meta = {
        "n_leaves": len(host),
        "leaf_dtypes": [_dtype_name(t.dtype) for t in host],
        "leaf_shapes": [list(t.shape) for t in host],
        "input_shape": list(example_x.shape),
        "input_dtype": _dtype_name(example_x.dtype),
        # What the artifact computes in: False when the request converted
        # no operator, so the metadata never overstates the quantization.
        "int8": bool(int8) and n_quant > 0,
        "int8_requested": bool(int8),
        "quantized_operators": n_quant,
        "platforms": [kind],
        "model": type(model).__name__,
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class LoadedServing:
    """Inference handle over a loaded artifact (no model code)."""

    def __init__(self, program, leaves, meta, device):
        self._fn = program.module()
        self._leaves = leaves
        self.meta = meta
        self.input_spec = InputSpec(tuple(meta["input_shape"]),
                                    getattr(torch, meta["input_dtype"]),
                                    device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with span("serve.request", unit=True):
            _check_input(self.input_spec, x)
            with torch.inference_mode(), full_f32_matmul():
                return self._fn(self._leaves, x)


def load_serving(path: str) -> LoadedServing:
    """Load an ``export_serving`` directory onto the device type it was
    traced for (the current CUDA device for ``cuda``)."""
    program = torch.export.load(os.path.join(path, _ARTIFACT))
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    device = torch.device(meta["platforms"][0])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    raw = np.load(os.path.join(path, _LEAVES))
    leaves = [
        torch.from_numpy(raw[f"a{i}"]).view(getattr(torch, dt)).reshape(
            shape).to(device)
        for i, (dt, shape) in enumerate(zip(meta["leaf_dtypes"],
                                            meta["leaf_shapes"]))]
    return LoadedServing(program, leaves, meta, device)


def main(argv=None) -> dict:
    """Load an artifact, serve each input once, then time
    ``_TIMED_CALLS`` calls of the first; print and return one JSON
    record: the load seconds, the kernel launches of the checked calls
    (per wrapper), ms per timed call (CUDA events on the card, the host
    clock on the CPU) and the device."""
    ap = argparse.ArgumentParser(description="Serve an export_serving "
                                 "artifact on .npy inputs.")
    ap.add_argument("artifact")
    ap.add_argument("inputs", nargs="+", help=".npy requests")
    ap.add_argument("--out", help="write each request's output here as "
                    "out_<i>.npy")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    serving = load_serving(args.artifact)
    dev = serving.input_spec.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    xs = [torch.from_numpy(np.load(p)).to(dev) for p in args.inputs]
    library.reset_launch_counts()
    ys = [serving(x) for x in xs]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: v for k, v in library.launch_counts().items() if v}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for i, y in enumerate(ys):
            np.save(os.path.join(args.out, f"out_{i}.npy"), y.cpu().numpy())
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(_TIMED_CALLS):
            serving(xs[0])
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / _TIMED_CALLS
    else:
        t = time.perf_counter()
        for _ in range(_TIMED_CALLS):
            serving(xs[0])
        ms = (time.perf_counter() - t) * 1e3 / _TIMED_CALLS
    rec = {"load_s": load_s, "requests": len(xs), "launches": launches,
           "ms": ms, "device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu")}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
