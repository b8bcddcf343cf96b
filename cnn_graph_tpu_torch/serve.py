"""Serving: one call from a model to an inference handle on a device.

Counterpart of ``cnn_graph_tpu/serve.py:114 compile_serving``.  Building
the handle quantizes the model's graph operators (``int8=True``) and
places the operators (in ``op`` or an ``operators`` list, as
``_model_operators`` :54-62 finds them) and the whole parameter tree on
the example input's device; a
call checks its input against ``input_spec`` and runs the forward pass
under ``torch.inference_mode()``.  The JAX package's AOT compile has no
counterpart: PyTorch runs eagerly.  ``export_serving``/``load_serving``
come later, with ``torch.export`` and the kernels as custom ops.
"""

from __future__ import annotations

import dataclasses

import torch

from cnn_graph_tpu_torch.models import common

__all__ = ["InputSpec", "CompiledServing", "compile_serving"]


@dataclasses.dataclass(frozen=True)
class InputSpec:
    shape: tuple
    dtype: torch.dtype
    device: torch.device


class CompiledServing:
    """Inference handle for ONE input shape, dtype and device."""

    def __init__(self, model, params, input_spec: InputSpec):
        self.model = model  # its operator quantized and on the device
        self.params = params  # on the device
        self.input_spec = input_spec

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.input_spec
        if (tuple(x.shape) != spec.shape or x.dtype != spec.dtype
                or x.device != spec.device):
            raise ValueError(
                f"input {tuple(x.shape)} {x.dtype} on {x.device} does not "
                f"match the serving spec {spec}"
            )
        with torch.inference_mode():
            return self.model.apply(self.params, x)


def compile_serving(model, params, example_x: torch.Tensor, int8: bool = True,
                    sample_x: float | None = None,
                    headroom: float = 2.0) -> CompiledServing:
    """Serving handle for ``model.apply(params, x)`` at ``example_x``'s
    shape, dtype and device.  ``int8=True`` swaps the graph operator for
    its quantized twin; ``sample_x`` defaults to ``max|example_x|`` and
    seeds the operator's static activation scale (the recurrence itself
    rescales at run time inside ``cheby_conv``)."""
    device = example_x.device
    if sample_x is None:
        sample_x = float(example_x.abs().max()) or 1.0
    if int8:
        model = common.quantize_model_operators(model, sample_x=sample_x,
                                                headroom=headroom)
    served = common.map_operators(model, lambda op: op.to(device))
    params = common.tree_map(lambda t: t.detach().to(device), params)
    spec = InputSpec(tuple(example_x.shape), example_x.dtype, device)
    return CompiledServing(served, params, spec)
