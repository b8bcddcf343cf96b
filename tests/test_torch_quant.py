"""The int8 twins' activation conversions (``ops/quant.py``) on the CPU:
the wrappers take the plain expression for a CPU tensor and count no
launch, the custom ops under ``torch.library.opcheck`` and their fake
implementations' shapes and dtypes, ``rows_view``'s layouts and
refusals, the checks a CUDA input meets (on meta tensors), the scale the
launch takes, and an int8 serving artifact that holds both conversions
as nodes and gives the compiled handle's logits.  The kernels themselves
are held to the plain expression on the card in
``test_torch_quant_gpu.py``."""

import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.ops import device_laplacian, quant
from cnn_graph_tpu_torch.serve import (compile_serving, export_serving,
                                       load_serving)

OPS = torch.ops.cnn_graph_torch


def _int8(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


def _x(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g) * 3


# Inputs as the callers pass them: a contiguous carry, the streaming
# conv's node slice ``q[:M]``, the int8 basis' ``stacked[:, :M]``, a
# column slice, and the transposed carry of a ChebNet's first conv.
LAYOUTS = {
    "contiguous": lambda t: t.reshape(-1, 37)[:, :37],
    "rows": lambda t: t.reshape(40, 37)[:33],
    "stacked": lambda t: t.reshape(4, 10, 37)[:, :7],
    "columns": lambda t: t.reshape(40, 37)[:, :20],
    "transposed": lambda t: t.reshape(37, 40).t(),
}
SCALES = {"float": lambda: 0.037, "tensor": lambda: torch.tensor(0.037)}


class TestPlainPathOnTheCpu:
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    @pytest.mark.parametrize("scale", list(SCALES))
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dequantize(self, layout, scale, dtype):
        q, s = LAYOUTS[layout](_int8(40 * 37)), SCALES[scale]()
        before = quant.dequantize_int8.launches
        got = quant.dequantize_int8(q, s, dtype)
        want = (q.to(torch.float32) * s).to(dtype)
        assert torch.equal(got, want) and got.dtype == dtype
        assert got.stride() == want.stride()
        assert quant.dequantize_int8.launches == before

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    @pytest.mark.parametrize("scale", list(SCALES))
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_quantize(self, layout, scale, dtype):
        x = LAYOUTS[layout](_x(40 * 37).to(dtype))
        s = SCALES[scale]()
        before = quant.quantize_int8.launches
        got = quant.quantize_int8(x, s)
        want = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        assert torch.equal(got, want) and got.stride() == want.stride()
        assert quant.quantize_int8.launches == before


class TestCustomOps:
    @pytest.mark.parametrize("scale", list(SCALES))
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_opcheck(self, scale, dtype):
        s = SCALES[scale]()
        t, v = (s, 0.0) if scale == "tensor" else (None, s)
        torch.library.opcheck(OPS.quantize_int8, (_x(9, 37).to(dtype), t, v))
        torch.library.opcheck(OPS.dequantize_int8, (_int8(9, 37), t, v,
                                                    dtype))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
    def test_fake_shapes_and_dtypes(self, dtype):
        with FakeTensorMode():
            x = torch.empty(3, 50, 24, dtype=dtype)[:, :41]
            q = torch.empty(3, 50, 24, dtype=torch.int8)[:, :41]
            s = torch.empty(())
            y = OPS.quantize_int8(x, s, 0.0)
            z = OPS.dequantize_int8(q, None, 0.5, dtype)
        assert (tuple(y.shape), y.dtype) == ((3, 41, 24), torch.int8)
        assert (tuple(z.shape), z.dtype) == ((3, 41, 24), dtype)
        assert y.is_contiguous() and z.is_contiguous()

    def test_fake_keeps_a_dense_layout(self):
        """A dense input's strides, as the kernel and the plain
        expression keep them; contiguous otherwise."""
        with FakeTensorMode():
            x = torch.empty(12, 40).t()
            q = torch.empty(12, 40, dtype=torch.int8).t()
            y = OPS.quantize_int8(x, None, 0.5)
            z = OPS.dequantize_int8(q, None, 0.5, torch.bfloat16)
        assert y.stride() == z.stride() == (1, 40)


class TestLayouts:
    @pytest.mark.parametrize("make,want", [
        (lambda: torch.empty(2, 3, 5, 7), (1, 1, 210, 210, 210)),
        (lambda: torch.empty(0, 16), (1, 1, 0, 0, 0)),
        (lambda: torch.empty(40, 37)[:, :20], (1, 40, 20, 0, 37)),
        (lambda: torch.empty(4, 10, 37)[:, :7], (4, 1, 259, 370, 259)),
        (lambda: torch.empty(4, 10, 37)[:, :7, :32], (4, 7, 32, 370, 37)),
        (lambda: torch.empty(6, 10, 5)[::2], (3, 1, 50, 100, 50)),
        (lambda: torch.empty(6, 4).t(), (1, 1, 24, 24, 24)),
        (lambda: torch.empty(2, 3, 5).permute(2, 0, 1), (1, 1, 30, 30, 30)),
    ], ids=["contiguous", "empty", "columns", "stacked", "stacked_columns",
            "batch_step", "transposed", "permuted"])
    def test_rows_view(self, make, want):
        assert quant.rows_view(make()) == want

    @pytest.mark.parametrize("make", [
        lambda: torch.empty(6, 4).t()[:3],
        lambda: torch.empty(20)[::2],
        lambda: torch.empty(2, 3, 4, 8)[:, :, :2],
        lambda: torch.empty(3, 4, 8)[:, :, ::2],
    ], ids=["transposed_slice", "strided_1d", "sliced_4d", "column_step"])
    def test_rows_view_refuses(self, make):
        with pytest.raises(ValueError, match="unit column stride"):
            quant.rows_view(make())

    def test_checks_of_a_device_input(self):
        """What a CUDA input meets before the op is called, on meta
        tensors (a device other than the CPU): the float dtypes, a
        layout ``rows_view`` takes (a transpose too), a 0-d float32 scale on the input's
        device, or a 0-d CPU one."""
        x = torch.empty(8, 32, device="meta")
        s = torch.empty((), device="meta")
        quant._check(x, s, torch.float32, "q")
        quant._check(x, torch.tensor(0.5), torch.bfloat16, "q")
        quant._check(x[:, :16], None, torch.float16, "q")
        quant._check(x.t(), s, torch.float32, "q")
        with pytest.raises(TypeError, match="no kernel"):
            quant._check(x.double(), None, torch.float64, "q")
        with pytest.raises(ValueError, match="unit column stride"):
            quant._check(x.t()[:16], s, torch.float32, "q")
        for bad in (s.reshape(1), s.double(), s.bfloat16()):
            with pytest.raises(ValueError, match="0-d float32"):
                quant._check(x, bad, torch.float32, "q")
        with pytest.raises(ValueError, match="0-d tensor"):
            quant._check(x, torch.tensor([0.5]), torch.float32, "q")

    def test_the_scale_the_launch_takes(self):
        """A host number in f32, its f32 reciprocal where ATen multiplies
        by it (quantisation), a 0-d CPU tensor as a host number, and a
        device scale rounded to the input's dtype as ATen casts it."""
        s = 0.1
        assert quant._kernel_scale(None, s, torch.float32, False) == (
            None, float(np.float32(s)))
        inv = float(np.float32(1.0) / np.float32(s))
        assert quant._kernel_scale(None, s, torch.float32, True) == (None,
                                                                     inv)
        assert quant._kernel_scale(torch.tensor(s, dtype=torch.float64),
                                   0.0, torch.float32, True) == (None, inv)
        dev = torch.tensor(s, device="meta")
        t, v = quant._kernel_scale(dev, 0.0, torch.bfloat16, True)
        assert t.dtype == torch.float32 and t.device.type == "meta"
        assert v == 0.0


def test_int8_artifact_holds_both_conversions(tmp_path):
    """An int8 ``compile_serving`` NodeClassifier exported with
    ``torch.export``: the program calls ``quantize_int8`` once a conv and
    ``dequantize_int8`` K times a conv as nodes, and its loaded copy gives
    the compiled handle's logits bit for bit."""
    L, _ = graphs.city_graph(12, k=8, seed=0)
    op = device_laplacian(L, fmt="banded", use_pallas=True, device="cpu")
    K, hidden = 3, [8]
    model = NodeClassifier(op, 4, 3, hidden=hidden, K=K,
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(op.m, 4)).astype(np.float32))
    export_serving(model, model.param_tree(), x, str(tmp_path), int8=True)
    program = torch.export.load(os.path.join(str(tmp_path), "model.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    convs = len(hidden) + 1
    assert targets.count("cnn_graph_torch.quantize_int8.default") == convs
    assert targets.count("cnn_graph_torch.dequantize_int8.default") == (
        K * convs)
    loaded = load_serving(str(tmp_path))
    assert torch.equal(loaded(x), compile_serving(model, model.param_tree(),
                                                  x)(x))


def _chebnet_grid10(dev="cpu"):
    """A small ChebNet whose level-0 operator needs no padding, so its
    first conv (Fin = 1) hands the conversions a transposed carry."""
    from cnn_graph_tpu_torch.models import ChebNet

    W = graphs.knn_graph(graphs.grid(10), k=8)
    Ws, perm = graphs.coarsen(W, levels=2, seed=2017)
    ops = [device_laplacian(graphs.laplacian(A, normalized=True),
                            fmt="dense", use_pallas=True, device=dev)
           for A in Ws]
    model = ChebNet(ops, F=[4, 8], K=[5, 5], p=[2, 2], M=[16, 10],
                    generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(graphs.perm_data(np.random.default_rng(11).normal(
        size=(6, 100)), perm).astype(np.float32))
    return model, x


@pytest.mark.parametrize("net", ["node_classifier", "chebnet"])
def test_int8_convs_pass_layouts_the_kernels_take(net, monkeypatch):
    """Every input that an int8 request hands a conversion is one that
    the card's kernels take (``rows_view``), so that no int8 serving
    raises there: the NodeClassifier's carries and the ChebNet's, whose
    first conv quantizes a transposed carry."""
    seen = []
    for name in ("quantize_int8", "dequantize_int8"):
        fn = getattr(quant, name)

        def spy(t, *args, fn=fn, name=name):
            seen.append((name, quant.rows_view(t)))
            return fn(t, *args)

        monkeypatch.setattr(quant, name, spy)
    if net == "chebnet":
        model, x = _chebnet_grid10()
        assert model.operators[0].m == model.operators[0].m_padded
    else:
        L, _ = graphs.city_graph(12, k=8, seed=0)
        op = device_laplacian(L, fmt="banded", use_pallas=True, device="cpu")
        model = NodeClassifier(op, 4, 3, hidden=[8], K=3,
                               generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(op.m, 4)).astype(np.float32))
    compile_serving(model, model.param_tree(), x)(x)
    K = 5 if net == "chebnet" else 3
    assert [n for n, _ in seen].count("quantize_int8") == 2
    assert [n for n, _ in seen].count("dequantize_int8") == 2 * K
