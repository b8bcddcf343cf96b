"""The program's own spans and counters, set on the traced window's clock.

The port records spans and counters (``cnn_graph_tpu_torch/utils/
profiling.py``, ``RECORDER``) while a ``torch.profiler`` session is
active, so a traced run leaves the window's in the process: a unit span
(``serve.request``, ``train.step``) for each request or step, the spans
inside it, and each counter's increments by unit.  Spans carry host
stamps; the window (``trace.Window``) is in seconds from its first
marker.  The two meet through CUDA event records: the recorder keeps the
host interval of every event record it makes (a unit span's anchor, a
timed span's pair), and the trace's host list holds the matching
``cudaEventRecord`` calls together with the harness's own marker records
(``trace.Capture.mark``), each of which may lie just inside the window
or just outside it.  The stamps pair in order with the window's records
less those markers, as one run of consecutive stamps (the window is one
stretch of time); the offset is the median difference, and a pairing in
which a record lies more than ``TOLERANCE_S`` outside the host interval
of its call is refused.  (On the card, torch 2.11, about 1% of records
start tens of us to ms late in their call, most by the event's creation
inside ``Event.record``: a tolerance on the difference from the median
alone refuses every window.)  The units kept are those whose span lies
inside the window and no exception closed: not the calls traced before
the first marker, nor the step that the harness's ``WindowClosed``
ended.

A reader here returns None and says why (``ctx.note``) where the program
records no spans, as a program older than the recorder does.
"""

from __future__ import annotations

import statistics

__all__ = ["Program", "program", "pair", "TOLERANCE_S", "UNIT_SPAN",
           "host_ms", "device_ms", "counter", "idle_in_program_ms"]

TOLERANCE_S = 50e-6
# The unit span of each loop's unit.
UNIT_SPAN = {"request": "serve.request", "step": "train.step"}
_EVENT_RECORD = "cudaEventRecord"


def pair(records_s: list, stamps: list):
    """``(offset_ns, residual_s, pairs)`` that put host stamps on the
    window's clock (``t_s = (t_ns - offset_ns) / 1e9``), from the
    window's event records ``records_s`` (their starts) and the
    recorder's ``stamps`` (each record's host interval ``(before,
    after)``), or a string that says why they do not pair.  The run of
    consecutive stamps is the one whose differences ``before - record``
    agree best (least interquartile range over a sample of pairs); the
    offset is their median.  ``residual_s`` is the farthest a record falls
    outside its call's host interval: a record may start late in its
    call (the event is created inside it, the thread may be preempted)
    but never before it nor after it returned."""
    n, m = len(records_s), len(stamps)
    before = [a for a, _ in stamps]
    best = None
    for lo in (0, 1):  # a marker record at either end, or none
        for hi in (0, 1):
            core = [round(t * 1e9) for t in records_s[lo:n - hi]]
            L = len(core)
            if L == 0 or L > m:
                continue
            probe = sorted({0, L - 1, *(L * j // 64 for j in range(64))})

            def spread(k):
                d = sorted(before[k + i] - core[i] for i in probe)
                return d[3 * len(d) // 4] - d[len(d) // 4], d[-1] - d[0]

            for k in sorted(range(m - L + 1), key=spread)[:3]:
                offset = statistics.median_low(
                    before[k + i] - core[i] for i in range(L))
                # How far each record (on the host clock) lies before or
                # after its call's host interval.
                resid = max(0, max(max(stamps[k + i][0] - core[i] - offset,
                                       core[i] + offset - stamps[k + i][1])
                                   for i in range(L))) * 1e-9
                key = (resid > TOLERANCE_S, -L, resid)
                if best is None or key < best[0]:
                    best = (key, offset, resid, L)
    if best is None:
        return (f"{n} event records in the window, {m} recorded by the "
                "program: nothing to pair")
    _, offset, resid, L = best
    if resid > TOLERANCE_S:
        return (f"the program's {m} event stamps do not pair with the "
                f"window's {n} event records: in the best run of {L} "
                f"pairs a record lies {resid * 1e6:.1f} us outside its "
                f"call, over {TOLERANCE_S * 1e6:.0f} us")
    return offset, resid, L


class Program:
    """The recorder's session on the window's clock: ``units`` the kept
    unit numbers; ``offset_ns``, ``residual_s`` and ``pairs`` the
    pairing's."""

    def __init__(self, rec, offset_ns: int, residual_s: float, pairs: int,
                 window_s: float, unit_name: str):
        self.rec, self.offset_ns, self.residual_s = rec, offset_ns, residual_s
        self.pairs = pairs
        self.units = [u for u, s in enumerate(rec.unit_spans)
                      if s.name == unit_name and not s.failed
                      and s.end_ns is not None
                      and self.t(s.start_ns) >= 0.0
                      and self.t(s.end_ns) <= window_s]
        self._kept = set(self.units)

    def t(self, ns: int) -> float:
        """A host stamp in seconds from the window's start."""
        return (ns - self.offset_ns) * 1e-9

    def unit_spans(self) -> list:
        return [self.rec.unit_spans[u] for u in self.units]

    def inside(self, names) -> list:
        """The spans called one of ``names`` that belong to a kept unit
        and closed without an exception."""
        return [s for s in self.rec.spans if s.name in names
                and s.unit in self._kept and not s.failed]


def _build(ctx):
    if ctx.window is None or ctx.window.window_s <= 0:
        return None, "no traced window"
    from cnn_graph_tpu_torch.utils import profiling

    rec = getattr(profiling, "RECORDER", None)
    if rec is None or not hasattr(rec, "unit_spans"):
        return None, "the program records no spans (no utils.profiling " \
                     "RECORDER)"
    name = UNIT_SPAN.get(ctx.primary)
    if not any(s.name == name for s in rec.unit_spans):
        return None, f"no {name} span recorded"
    records = [a for n, a, _ in ctx.window.host
               if n.startswith(_EVENT_RECORD)]
    got = pair(records, rec.stamps)
    if isinstance(got, str):
        return None, got
    prog = Program(rec, *got, ctx.window.window_s, name)
    if not prog.units:
        return None, f"no whole {name} span inside the window"
    return prog, None


def program(ctx):
    """The window's ``Program``, or None with a note; built once a
    window."""
    cached = getattr(ctx, "_program", None)
    if cached is None or cached[0] is not ctx.window:
        cached = (ctx.window, *_build(ctx))
        ctx._program = cached
    if cached[1] is None:
        ctx.note(cached[2])
    return cached[1]


def host_ms(ctx):
    """The median host ms of the kept unit spans: the program's own time
    from a call's entry to its return."""
    p = program(ctx)
    if p is None:
        return None
    return statistics.median(s.host_ms() for s in p.unit_spans())


def device_ms(ctx, names):
    """Device ms per kept unit in the spans called one of ``names``,
    from each span's CUDA events (idle inside it included)."""
    p = program(ctx)
    if p is None:
        return None
    spans = p.inside(names)
    if not spans:
        ctx.note(f"no {'/'.join(sorted(names))} span in the window's units")
        return None
    ms = [s.device_ms() for s in spans]
    if None in ms:
        ctx.note(f"a {'/'.join(sorted(names))} span has no device timing")
        return None
    return sum(ms) / len(p.units)


def counter(ctx, name: str):
    """The counter ``name``'s increments per kept unit."""
    p = program(ctx)
    if p is None:
        return None
    by_unit = p.rec.per_unit.get(name, {})
    return sum(by_unit.get(u, 0) for u in p.units) / len(p.units)


def idle_in_program_ms(ctx):
    """Device idle ms per kept unit in the stretches whose middle falls
    inside a kept unit span, where the program held the host."""
    p = program(ctx)
    if p is None:
        return None
    spans = sorted((p.t(s.start_ns), p.t(s.end_ns)) for s in p.unit_spans())
    idle, i = 0.0, 0
    for a, b in ctx.window.idle_gaps():
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][1] < mid:
            i += 1
        if i < len(spans) and spans[i][0] <= mid:
            idle += b - a
    return 1e3 * idle / len(p.units)
