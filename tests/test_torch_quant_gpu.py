"""The int8 conversion kernels (``csrc/quant.cu``, ``ops/quant.py``)
against the plain PyTorch expression on the card, bit for bit
(``torch.equal``): dequantisation to float32, bfloat16 and float16,
quantisation from them, the scale as a 0-d CUDA tensor (ATen divides)
and as a Python float (ATen multiplies by the f32 reciprocal), element
counts that are not a multiple of 16, the int8 basis' sliced 3-D input,
transposed and permuted dense inputs (each output in the plain
expression's layout), values half an ulp either side of a rounding
boundary and past +-127; the refusal of a layout the kernels do not
take; the launches an int8 request and its loaded artifact make; and an
int8 ChebNet request, whose first conv quantizes a transposed carry.

Imports only torch and the port, so it runs on a GPU machine without
JAX: ``python -m pytest --noconftest tests/test_torch_quant_gpu.py``.
Every test skips where no CUDA device is present."""

import numpy as np
import pytest
import torch

from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.ops import device_laplacian, quant
from cnn_graph_tpu_torch.serve import compile_serving

pytestmark = pytest.mark.gpu

FLOATS = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _scale(kind, value, device):
    """The scale as ``ops/filters.py _Int8Carries.encode`` computes it on
    the card (a 0-d CUDA tensor), or as the operators' ``act_scale`` (a
    float)."""
    if kind == "float":
        return value
    return torch.clamp_min(torch.tensor(value, device=device), 1e-30)


# (shape, slice): contiguous with 16 | n, with n % 16 != 0, a handful of
# elements; the streaming conv's q[:M]; the int8 basis' stacked[:, :M]
# with C a multiple of 16 and not; a column slice; the transposed carry
# of a ChebNet's first conv (Fin = 1) and a permuted 3-D tensor.
SHAPES = {
    "n4096": ((64, 64), None),
    "n1221": ((33, 37), None),
    "n3": ((3,), None),
    "rows": ((300, 48), lambda t: t[:257]),
    "stacked": ((5, 300, 48), lambda t: t[:, :250]),
    "stacked_c37": ((5, 300, 37), lambda t: t[:, :250]),
    "columns": ((300, 64), lambda t: t[:, :48]),
    "columns_c40": ((300, 64), lambda t: t[:, :40]),
    "transposed": ((37, 300), lambda t: t.t()),
    "permuted": ((5, 30, 37), lambda t: t.permute(1, 2, 0)),
}


def _view(t, name):
    cut = SHAPES[name][1]
    return t if cut is None else cut(t)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["tensor", "float"])
@pytest.mark.parametrize("dtype", FLOATS)
def test_dequantize_matches_plain(cuda_device, shape, kind, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = _view(torch.randint(-128, 128, SHAPES[shape][0], generator=g,
                            device=cuda_device, dtype=torch.int8), shape)
    s = _scale(kind, 0.0123457, cuda_device)
    before = quant.dequantize_int8.launches
    got = quant.dequantize_int8(q, s, dtype)
    want = (q.to(torch.float32) * s).to(dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want) and got.stride() == want.stride()
    assert quant.dequantize_int8.launches == before + 1


def _boundary_values(s: float, dtype, device):
    """x at every half-integer multiple of s from -140.5 to 140.5, one f32
    ulp either side (x / s then rounds to either side of the tie), and
    values past +-127 up to the infinities."""
    ties = (torch.arange(-141, 141, dtype=torch.float64) + 0.5) * s
    ties = ties.to(torch.float32)
    up = torch.nextafter(ties, torch.tensor(float("inf")))
    down = torch.nextafter(ties, torch.tensor(float("-inf")))
    far = torch.tensor([200.0, -200.0, 1e30, -1e30, float("inf"),
                        float("-inf"), 0.0, -0.0]) * s
    x = torch.cat([ties, up, down, far])
    return x.to(dtype).to(device)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["tensor", "float"])
@pytest.mark.parametrize("dtype", FLOATS)
def test_quantize_matches_plain(cuda_device, shape, kind, dtype):
    sv = 0.0123457
    n = int(np.prod(SHAPES[shape][0]))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(n, generator=g, device=cuda_device) * 0.8
    edge = _boundary_values(sv, torch.float32, cuda_device)
    k = min(n, edge.numel())
    x[:k] = edge[:k]
    x = _view(x.to(dtype).reshape(SHAPES[shape][0]), shape)
    s = _scale(kind, sv, cuda_device)
    before = quant.quantize_int8.launches
    got = quant.quantize_int8(x, s)
    want = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.equal(got, want)
    assert got.stride() == want.stride()
    assert quant.quantize_int8.launches == before + 1


@pytest.mark.parametrize("kind", ["tensor", "float"])
@pytest.mark.parametrize("dtype", FLOATS)
def test_quantize_at_the_rounding_boundaries(cuda_device, kind, dtype):
    """Every tie and its neighbours, alone in one tensor: where dividing
    and multiplying by the reciprocal differ, the kernel follows ATen."""
    sv = 0.0123457
    x = _boundary_values(sv, dtype, cuda_device)
    s = _scale(kind, sv, cuda_device)
    got = quant.quantize_int8(x, s)
    want = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    assert torch.equal(got, want)
    assert int(got.max()) == 127 and int(got.min()) == -127


def test_full_width_carries_match_plain(cuda_device):
    """The 50k serving request's carries, 50,176 x 512, both ways."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(50_176, 512, generator=g, device=cuda_device)
    s = torch.clamp_min(x.abs().amax(), 1e-30) * torch.tensor(
        2.0 / 127.0, device=cuda_device)
    q = quant.quantize_int8(x, s)
    assert torch.equal(q, torch.clamp(torch.round(x / s), -127,
                                      127).to(torch.int8))
    assert torch.equal(quant.dequantize_int8(q, s),
                       q.to(torch.float32) * s)


def test_refuses_what_it_does_not_take(cuda_device):
    x = torch.randn(64, 48, device=cuda_device)
    q = quant.quantize_int8(x, 0.1)
    before = (quant.quantize_int8.launches, quant.dequantize_int8.launches)
    with pytest.raises(ValueError, match="unit column stride"):
        quant.quantize_int8(x.t()[:40], 0.1)
    with pytest.raises(ValueError, match="unit column stride"):
        quant.dequantize_int8(q.t()[:40], 0.1)
    with pytest.raises(ValueError, match="unit column stride"):
        quant.dequantize_int8(q.reshape(-1)[::2], 0.1)
    with pytest.raises(ValueError, match="0-d float32"):
        quant.quantize_int8(x, torch.tensor([0.1], device=cuda_device))
    with pytest.raises(TypeError, match="no kernel"):
        quant.dequantize_int8(q, 0.1, torch.float64)
    with pytest.raises(TypeError, match="not int8"):
        quant.dequantize_int8(x, 0.1)
    assert (quant.quantize_int8.launches,
            quant.dequantize_int8.launches) == before


def test_int8_request_and_artifact_launch_the_conversions(cuda_device,
                                                          tmp_path):
    """An int8 NodeClassifier request on the card: one quantisation a
    conv and K dequantisations a conv, each one launch, as compiled and
    as a loaded artifact, with bit-identical logits."""
    from cnn_graph_tpu_torch.serve import export_serving, load_serving

    L, _ = graphs.city_graph(24, k=8, seed=0)
    op = device_laplacian(L, fmt="banded", device=cuda_device)
    K, hidden = 5, [8]
    model = NodeClassifier(op, 16, 4, hidden=hidden, K=K,
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(op.m, 16)).astype(np.float32)).to(cuda_device)
    compiled = compile_serving(model, model.param_tree(), x)
    export_serving(model, model.param_tree(), x, str(tmp_path))
    loaded = load_serving(str(tmp_path))
    convs = len(hidden) + 1
    ys = []
    for handle in (compiled, loaded):
        before = (quant.quantize_int8.launches,
                  quant.dequantize_int8.launches)
        ys.append(handle(x))
        torch.cuda.synchronize()
        assert (quant.quantize_int8.launches - before[0],
                quant.dequantize_int8.launches - before[1]) == (convs,
                                                                K * convs)
    assert torch.equal(ys[0], ys[1])


def test_int8_chebnet_request_takes_the_transposed_carry(cuda_device):
    """compile_serving's default int8 ChebNet on the card: the first
    conv (Fin = 1, the level-0 operator unpadded) quantizes a transposed
    carry.  One quantisation and K dequantisations a conv, each one
    launch, and the logits of the same serving on the CPU within 1e-4 of
    their max."""
    from cnn_graph_tpu_torch.models import ChebNet

    W = graphs.knn_graph(graphs.grid(10), k=8)
    Ws, perm = graphs.coarsen(W, levels=2, seed=2017)
    Ls = [graphs.laplacian(A, normalized=True) for A in Ws]
    arch = dict(F=[4, 8], K=[5, 5], p=[2, 2], M=[16, 10])
    x = torch.from_numpy(graphs.perm_data(np.random.default_rng(11).normal(
        size=(6, 100)), perm).astype(np.float32))
    logits = {}
    for dev in ("cpu", cuda_device):
        ops = [device_laplacian(L, fmt="dense", use_pallas=True, device=dev)
               for L in Ls]
        assert ops[0].m == ops[0].m_padded
        model = ChebNet(ops, **arch, generator=torch.Generator().manual_seed(3))
        serving = compile_serving(model, model.param_tree(), x.to(dev))
        before = (quant.quantize_int8.launches,
                  quant.dequantize_int8.launches)
        logits[str(dev)] = serving(x.to(dev)).cpu()
        torch.cuda.synchronize()
        launched = (quant.quantize_int8.launches - before[0],
                    quant.dequantize_int8.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (2, 10))
    got, want = logits[str(cuda_device)], logits["cpu"]
    assert torch.allclose(got, want, rtol=0,
                          atol=1e-4 * float(want.abs().max()))
