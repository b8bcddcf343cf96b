"""The port's span and counter recorder (``utils/profiling.py``): off and
free of ``record_function`` without a profiler on every conv route, on
under a ``torch.profiler`` session and inside ``recording()`` with
parents, units and exception-closed spans, on the profiler's clock (a
span brackets its range in a CPU trace), the ``dequant_bytes`` counter
of an int8 request, the launch counts as views of its counters, and no
``record_function`` left elsewhere in the package."""

import pathlib

import numpy as np
import pytest
import torch

from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.ops import (band, bsr, cheby, device_laplacian,
                                     library, quantize_banded)
from cnn_graph_tpu_torch.ops.filters import cheby_conv
from cnn_graph_tpu_torch.serve import compile_serving
from cnn_graph_tpu_torch.utils import probes, profiling

PORT = pathlib.Path(__file__).resolve().parents[1] / "cnn_graph_tpu_torch"
K = 3
MS = 1_000_000  # ns


@pytest.fixture(scope="module")
def city():
    L, _ = graphs.city_graph(12, k=8, seed=0)
    return L


def _routes(L):
    """A tiny operator on each route of ``cheby_conv`` with its x and w:
    banded, the int8 stream, the fused dense kernels' plain versions, the
    stacked basis."""
    g = torch.Generator().manual_seed(0)
    banded = device_laplacian(L, fmt="banded", device="cpu")
    dense = dict(fmt="dense", device="cpu")
    return {
        "banded": (banded, 4, 6),
        "quant_stream": (quantize_banded(banded, sample_x=3.0), 4, 6),
        "fused": (device_laplacian(L, use_pallas=True, **dense), 32, 64),
        "stacked": (device_laplacian(L, **dense), 4, 6),
    }, g


def _conv(op, fin, fout, g, grad):
    x = torch.randn(2, op.m, fin, generator=g)
    w = torch.randn(K, fin, fout, generator=g).requires_grad_(grad)
    if grad:
        x.requires_grad_(True)
        cheby_conv(x, op, w).sum().backward()
        return w.grad
    with torch.inference_mode():
        return cheby_conv(x, op, w)


def _raise(*args, **kwargs):
    raise AssertionError("record_function opened with no profiler")


def test_off_without_a_profiler(city, monkeypatch):
    """No profiler, no ``recording()``: every route runs (forward, and the
    backward where it has one) with ``record_function`` made to raise, and
    nothing is recorded; ``count`` only adds to its total."""
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with profiling.recording() as rec:
        pass
    routes, g = _routes(city)
    for name, (op, fin, fout) in routes.items():
        assert _conv(op, fin, fout, g, grad=False) is not None
        if name != "quant_stream":  # inference-only
            assert _conv(op, fin, fout, g, grad=True) is not None
    assert rec.spans == [] and not rec.per_unit and not rec.live
    assert profiling.span("conv.taps", device=True) is profiling.span("x")
    before = profiling.COUNTS["dequant_bytes"]
    profiling.count("dequant_bytes", 7)
    assert profiling.COUNTS["dequant_bytes"] == before + 7
    assert not rec.per_unit
    # The same convs, recorded: each took the route it is named for.
    monkeypatch.undo()
    for name, (op, fin, fout) in routes.items():
        with profiling.recording() as rec:
            _conv(op, fin, fout, g, grad=name != "quant_stream")
        assert rec.spans[0].name == f"conv.{name}"


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_records_spans_units_and_exceptions(city, how):
    """Under a CPU ``torch.profiler`` session or ``recording()``: a span
    for each route and layer, parents by nesting, each unit's spans and
    counts under its index, and the span an exception closed marked."""
    routes, g = _routes(city)
    op, fin, fout = routes["quant_stream"]
    ctx = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
        if how == "profiler" else profiling.recording())
    with ctx:
        for _ in range(2):
            with profiling.span("serve.request", unit=True):
                _conv(op, fin, fout, g, grad=False)
        with pytest.raises(KeyError):
            with profiling.span("train.step", unit=True):
                with profiling.span("train.optimizer", device=True):
                    raise KeyError("closed by an exception")
        rec = profiling.RECORDER
    names = [s.name for s in rec.spans]
    assert [s.name for s in rec.unit_spans] == ["serve.request"] * 2 + [
        "train.step"]
    for u, unit in enumerate(rec.unit_spans):
        inside = [s for s in rec.spans if s.unit == u]
        assert inside[0] is unit and unit.parent == -1
        assert all(s.start_ns >= unit.start_ns and s.end_ns <= unit.end_ns
                   for s in inside)
    conv = rec.spans[names.index("conv.quant_stream")]
    assert rec.spans[conv.parent].name == "serve.request"
    per_request = [s.name for s in rec.spans if s.unit == 0]
    assert per_request.count("dequantize") == K
    assert per_request.count("conv.taps") == K
    assert per_request.count("quantize") == 1
    for s in rec.spans:
        if s.name in ("dequantize", "conv.taps", "quantize"):
            assert rec.spans[s.parent].name == "conv.quant_stream"
    assert [s.failed for s in rec.spans if s.unit == 2] == [True, True]
    assert not any(s.failed for s in rec.spans if s.unit != 2)
    assert set(rec.per_unit["dequant_bytes"]) == {0, 1}
    # No card: no event is recorded, no span is timed on the device.
    assert rec.stamps == [] and all(s.events is None for s in rec.spans)


def test_a_new_session_starts_empty():
    with profiling.recording() as rec:
        with profiling.span("a"):
            pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("b"):
            pass
    assert [s.name for s in profiling.RECORDER.spans] == ["b"]
    profiling.span("c")  # off: the next session starts anew
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("d"):
            pass
    assert [s.name for s in profiling.RECORDER.spans] == ["d"]


def test_the_buffer_is_capped(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    with profiling.recording() as rec:
        for _ in range(5):
            with profiling.span("hop"):
                pass
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_span_brackets_its_range_on_the_profilers_clock(tmp_path):
    """In a CPU trace (``profiling.trace``) each span opens a
    ``record_function`` of its name, and the span's host stamps bracket
    the range's ``_KinetoEvent`` times to within 1 ms: both are
    ``time.time_ns()`` nanoseconds."""
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(4):
            with profiling.span("serve.request", unit=True):
                with profiling.span("conv.stacked"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    spans = profiling.RECORDER.spans
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in ("serve.request", "conv.stacked")),
                    key=lambda e: e.start_ns())
    assert [e.name() for e in ranges] == [s.name for s in spans]
    for s, e in list(zip(spans, ranges))[2:]:  # past the first calls
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s.start_ns - MS <= a <= b <= s.end_ns + MS
        assert a - s.start_ns < MS and s.end_ns - b < MS
    assert (tmp_path / "trace.json").is_file()


def test_dequant_bytes_per_int8_request(city):
    """A tiny int8 ``compile_serving`` NodeClassifier: each request counts
    5 bytes (1 read, 4 written) for every element it dequantises, K hops
    of ``[M, Fin]`` per conv, and 5 for each it quantises (the padded
    input once per conv)."""
    op = device_laplacian(city, fmt="banded", device="cpu")
    hidden, classes = [8], 3
    model = NodeClassifier(op, 4, classes, hidden=hidden, K=K,
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(op.m, 4)).astype(np.float32))
    handle = compile_serving(model, model.param_tree(), x)
    with profiling.recording() as rec:
        for _ in range(2):
            handle(x)
    fins = [4] + hidden
    want = 5 * sum(K * op.m * f for f in fins)
    assert dict(rec.per_unit["dequant_bytes"]) == {0: want, 1: want}
    assert dict(rec.per_unit["quant_bytes"]) == {
        u: 5 * sum(op.m_padded * f for f in fins) for u in (0, 1)}
    assert [s.name for s in rec.unit_spans] == ["serve.request"] * 2


def test_launch_counts_are_views_of_the_counters():
    """``launches``, ``form_launches``, ``route_launches`` and
    ``library.launch_counts`` read and reset as the attributes did, over
    the recorder's ``launches.*`` counters."""
    library.reset_launch_counts()
    assert not any(library.launch_counts().values())
    band.banded_dkw.launched("hop")
    band.banded_dkw.launched("hop")
    bsr.bsr_csr.launched("spmm", "K8")
    cheby.cheby_conv_fused.launched()
    assert band.banded_dkw.launches == 2
    assert dict(band.banded_dkw.form_launches) == {"hop": 2}
    assert band.banded_dkw.form_launches["spmm"] == 0
    assert "spmm" not in band.banded_dkw.form_launches
    assert {**bsr.bsr_csr.route_launches} == {"K8": 1}
    assert profiling.COUNTS["launches.band_dkw.form.hop"] == 2
    assert library.launch_counts() == {
        "band_dkw": 2, "band_uniform": 0, "band_ragged": 0,
        "bsr_colstream": 0, "bsr_csr": 1, "cheby_conv_fused": 1,
        "cheby_dw_fused": 0}
    band.banded_dkw.launches = 0
    band.banded_dkw.form_launches.clear()
    assert band.banded_dkw.launches == 0
    assert not any(band.banded_dkw.form_launches.values())
    probes.mxu_probe.launches += 1
    assert probes.mxu_probe.launches >= 1
    library.reset_launch_counts()
    assert not any(library.launch_counts().values())
    assert not any(bsr.bsr_csr.route_launches.values())
    assert band.banded_dkw.__name__ == "banded_dkw"
    assert band.banded_dkw.__wrapped__.__doc__ == band.banded_dkw.__doc__


def test_one_span_system_in_the_package():
    """The recorder is the package's only opener of ``record_function``
    ranges."""
    for path in PORT.rglob("*.py"):
        if path.name == "profiling.py" and path.parent.name == "utils":
            continue
        text = path.read_text()
        assert "record_function" not in text, path
        assert "profiled(" not in text, path
