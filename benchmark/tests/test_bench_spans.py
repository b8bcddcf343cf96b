"""The readers of the program's own spans (``harness/spans.py``), on a
window and a recording made by hand: the recorder's event stamps pair
with the window's ``cudaEventRecord`` calls past the harness's marker
records, the units traced before the first marker and the one an
exception closed are left out, and a recording whose stamps do not pair
reads None with a note."""

import types

import pytest

from cnn_graph_tpu_torch.utils import profiling
from harness import found, spans, trace
from harness.work import PEAK_BYTES

MS = 1_000_000  # ns
US = 1_000
# The recorder's clock against the trace's, and the lag from a stamp to
# the event record it precedes.
SHIFT = 987_654_321
LAG = 3 * US
MARKER = "at::cuda::(anonymous namespace)::spin_kernel(long)"


class _Event:
    def __init__(self, t_ns):
        self.t_ns = t_ns

    def elapsed_time(self, end):
        return (end.t_ns - self.t_ns) / MS


class _Ctx:
    def __init__(self, window, n):
        self.window, self.units, self.primary = window, {"request": n}, \
            "request"
        self.notes = []

    n_primary = property(lambda self: self.units["request"])
    note = lambda self, text: self.notes.append(text)  # noqa: E731


def _recording(units, jitter=()):
    """A recorder session and the trace's event records: ``units`` is a
    list of ``(start_ms, end_ms, failed, taps)``, each unit a
    ``serve.request`` span anchored at its start with one ``conv.taps``
    span of ``taps = (start_ms, end_ms)`` timed on the device and one
    ``dequantize`` span beside it; ``jitter`` moves stamp ``i``'s host
    interval by ``ns``."""
    rec = profiling.Recorder()
    records = []

    def stamp(t_ms):
        t = round(t_ms * MS)
        records.append(("cudaEventRecord", t, t + 2 * US))
        rec.stamps.append((t + SHIFT - LAG, t + SHIFT + LAG))
        return _Event(t)

    for u, (a, b, failed, (ta, tb)) in enumerate(units):
        s = profiling.Span("serve.request", -1, u,
                           round(a * MS) + SHIFT - LAG)
        s.end_ns, s.failed = round(b * MS) + SHIFT, failed
        rec.spans.append(s)
        rec.unit_spans.append(s)
        stamp(a)
        for name, (x, y) in (("conv.taps", (ta, tb)),
                             ("dequantize", (tb, tb + 0.5))):
            c = profiling.Span(name, len(rec.spans) - 1, u,
                               round(x * MS) + SHIFT - 2 * LAG)
            c.end_ns = round(y * MS) + SHIFT + LAG
            c.events = (stamp(x), stamp(y))
            rec.spans.append(c)
        rec.per_unit["dequant_bytes"][u] += 1_000_000
    for i, d in jitter:
        a, b = rec.stamps[i]
        rec.stamps[i] = (a + d, b + d)
    return rec, records


# Two warm-up requests before the first marker (10 ms), three inside the
# window, the last of them closed by an exception; the window ends at the
# second marker (20 ms).
UNITS = [(1.0, 3.0, False, (1.5, 2.0)), (4.0, 6.0, False, (4.5, 5.0)),
         (10.5, 12.5, False, (11.0, 12.0)), (13.0, 16.0, False, (13.5, 14.0)),
         (16.5, 19.0, True, (17.0, 17.5))]


def _window(records, marker_records=((10.005, 10.007), (20.003, 20.005))):
    device = [(MARKER, "kernel", 10 * MS, 10 * MS + 1000),
              ("gemm", "kernel", 11 * MS + 200 * US, 12 * MS),
              ("gemm", "kernel", 13 * MS + 200 * US, 14 * MS),
              ("gemm", "kernel", 14 * MS, 19 * MS),
              (MARKER, "kernel", 20 * MS, 20 * MS + 1000)]
    host = list(records) + [("cudaEventRecord", round(a * MS), round(b * MS))
                            for a, b in marker_records]
    return trace.window_from_markers(device, host)


@pytest.fixture
def recorded(monkeypatch):
    def make(units=UNITS, jitter=(), **kw):
        rec, records = _recording(units, jitter)
        monkeypatch.setattr(profiling, "RECORDER", rec)
        return _Ctx(_window(records, **kw), 3)

    return make


def test_stamps_pair_past_the_markers(recorded):
    ctx = recorded()
    p = spans.program(ctx)
    assert p is not None and not ctx.notes
    assert p.units == [2, 3]  # not the warm-up, not the failed one
    assert p.pairs == 3 * 5  # the window's stamps, no marker record
    assert p.residual_s < 1e-9
    assert p.t(round(10 * MS) + SHIFT - LAG) == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("markers", [((10.005, 10.007),), (),
                                     ((10.005, 10.007), (19.999, 19.9995))])
def test_either_marker_record_may_lie_outside(recorded, markers):
    ctx = recorded(marker_records=markers)
    assert spans.program(ctx).units == [2, 3]


def test_readers_on_the_kept_units(recorded):
    ctx = recorded()
    assert spans.host_ms(ctx) == pytest.approx((2.0 + 3.0) / 2 + LAG / MS)
    assert spans.device_ms(ctx, {"conv.taps"}) == pytest.approx(
        (1.0 + 0.5) / 2)
    assert spans.counter(ctx, "dequant_bytes") == 1_000_000
    # The idle 10.0-11.2 ms has its middle (10.6) inside unit 2 (10.5-12.5
    # ms), 12.0-13.2 its middle (12.6) between units, 19-20 its middle in
    # the unit an exception closed.
    assert spans.idle_in_program_ms(ctx) == pytest.approx(1.2 / 2)
    dq = found.reader("dequant_roofline.serve").read(ctx)
    assert dq == pytest.approx(100 * 1e6 / PEAK_BYTES / 0.5e-3)
    assert found.reader("taps_ms.serve").read(ctx) == pytest.approx(0.75)
    assert found.reader("host_ms.serve").read(ctx) == spans.host_ms(ctx)


def test_stamps_that_do_not_pair_read_none_with_a_note(recorded):
    ctx = recorded(jitter=[(12, 200 * US)])  # a call 200 us after its record
    assert spans.host_ms(ctx) is None
    assert "do not pair" in ctx.notes[0]


def test_a_record_late_in_its_call_pairs(recorded, monkeypatch):
    """A record that starts late in its call (the event created inside
    it) still lies inside the call's host interval."""
    rec, records = _recording(UNITS)
    a, b = rec.stamps[12]
    rec.stamps[12] = (a - 900 * US, b)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    assert spans.program(_Ctx(_window(records), 3)).units == [2, 3]


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", None)
    rec, records = _recording(UNITS)
    ctx = _Ctx(_window(records), 3)
    for quantity in ("host_ms", "idle_in_program_ms", "dequant_roofline",
                     "taps_ms"):
        ctx.notes = []
        assert found.reader(f"{quantity}.serve").read(ctx) is None
        assert "records no spans" in ctx.notes[0]


def test_no_window_reads_none():
    ctx = types.SimpleNamespace(window=None, primary="request", notes=[])
    ctx.note = ctx.notes.append
    assert spans.host_ms(ctx) is None
    assert ctx.notes == ["no traced window"]
