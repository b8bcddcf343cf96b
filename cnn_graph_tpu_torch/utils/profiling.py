"""Step timers, trace capture, device timing by slope fit, the SpMM
rooflines, and the program's own span and counter recorder, on an
NVIDIA H100.

Counterpart of ``cnn_graph_tpu/utils/profiling.py`` (``slope_time`` :18,
``StepTimer`` :55, ``trace`` :81, ``spmm_roofline`` :117), its own copy:
that module imports JAX.
``sparse_roofline`` is the port's own: the bound of a sparse product by
what its nonzeros need, where ``spmm_roofline`` counts a block format's
work.  Times
come from CUDA events, and a run that finds no card raises rather than
time the CPU.  The roofline uses the H100 SXM data-sheet peaks at its
700 W limit (dense rates, no sparsity) in place of the TPU v5e's
measured ones.

**The recorder** (``span``, ``count``, ``recording``, ``RECORDER``) is
the port's one record of its layers.  ``span(name)`` marks a layer
boundary and ``count(name, n)`` a quantity of work; both record while a
``torch.profiler`` session is active or inside ``recording()``, and
otherwise cost one check (``span`` then returns a shared no-op context
and ``count`` only adds to its total in ``COUNTS``).  A recorded span
keeps its name, its parent, the unit it belongs to (the request or
step, a ``unit=True`` span, counted from 0 in its session), its start
and end in ``time.time_ns()`` nanoseconds (the clock in which the
profiler stamps its events) and whether an exception closed it; with
``device=True`` also a pair of CUDA timing events around it, whose
elapsed time (``Span.device_ms``, read after the caller synchronises)
includes any device idle inside the span. A unit span records a CUDA
event at its start, the anchor, whose host stamps a reader pairs with
the trace's ``cudaEventRecord`` calls to put spans on the trace's clock:
``RECORDER.stamps`` holds the host interval ``(before, after)`` of every
event record the recorder makes, in order. While recording, each
counter's increments are also kept against the current unit
(``RECORDER.per_unit``). Inside ``recording(ranges=True)`` (``trace``
enters it) each span also opens a ``record_function`` of its name, so
that a profiler that records CPU activity nests the program's spans over
its ops and kernels; torch cannot tell which activities a running
profiler records, so a caller that wants the ranges asks for them.
A session starts with an empty buffer when recording turns on, as the
first span or counter after it sees; it keeps at most ``SPAN_CAP``
spans and counts the rest in ``RECORDER.dropped``.  Spans nest by the
order they open in: opened from the autograd engine's device thread
while the caller waits in ``backward``, they nest under the caller's.

The kernel wrappers' launch counts (``launches``, ``form_launches``,
``route_launches`` of a ``Counted`` wrapper) are views of ``COUNTS``.
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import functools
import math
import os
import time

import torch

__all__ = ["H100_BYTES_PER_S", "H100_OPS_PER_S", "StepTimer", "trace",
           "slope_time", "spmm_roofline", "sparse_roofline", "roofline",
           "span", "count", "recording", "counted", "Counted", "Span",
           "Recorder", "RECORDER", "COUNTS", "SPAN_CAP"]

# ---------------------------------------------------------- the recorder

# Spans one recording session keeps: a 4 s traced window of the 50k
# serving cell records about 20,000.
SPAN_CAP = 1 << 18
# Every counter's total since the process started (or since a view reset
# it), recorded or not.
COUNTS = collections.Counter()
_profiler_on = torch._C._autograd._profiler_enabled
# True inside ``recording()``.
_recording = False


class Span:
    """One recorded span: ``parent`` is the index of the span it opened
    inside (-1 for none), ``unit`` the unit it belongs to (None outside
    any), ``start_ns``/``end_ns`` ``time.time_ns()`` stamps, ``failed``
    whether an exception closed it, ``events`` its CUDA timing events
    (``device=True`` on a card) until their time is read into ``ms``."""

    __slots__ = ("name", "parent", "unit", "start_ns", "end_ns", "failed",
                 "events", "ms")

    def __init__(self, name, parent, unit, start_ns):
        self.name, self.parent, self.unit = name, parent, unit
        self.start_ns, self.end_ns = start_ns, None
        self.failed, self.events, self.ms = False, None, None

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self):
        """The device time between the span's two events, idle included,
        or None for a span not timed; the events must have completed."""
        if self.ms is None and self.events is not None:
            self.ms = self.events[0].elapsed_time(self.events[1])
        return self.ms


class _Null:
    """The shared context of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """The context of a span being recorded."""

    __slots__ = ("rec", "name", "device", "unit", "span", "index",
                 "outer_unit", "range")

    def __init__(self, rec, name, device, unit):
        self.rec, self.name, self.device, self.unit = rec, name, device, unit
        self.span = self.range = None

    def __enter__(self):
        rec = self.rec
        if len(rec.spans) >= SPAN_CAP:
            rec.dropped += 1
            return None
        self.outer_unit = rec.unit
        if self.unit:
            rec.unit = len(rec.unit_spans)
        s = Span(self.name, rec.stack[-1] if rec.stack else -1, rec.unit,
                 time.time_ns())
        self.span, self.index = s, len(rec.spans)
        rec.spans.append(s)
        if self.unit:
            rec.unit_spans.append(s)
        rec.stack.append(self.index)
        if rec.ranges:
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        if rec.cuda and (self.unit or self.device):
            if self.device:
                s.events = (rec.event(), rec.event())
                rec.pending.append(s)
            ev = s.events[0] if self.device else rec.anchor
            t = time.time_ns()
            ev.record()
            rec.stamps.append((t, time.time_ns()))
        return s

    def __exit__(self, exc_type, exc, tb):
        s = self.span
        if s is None:
            return False
        rec = self.rec
        if s.events is not None:
            t = time.time_ns()
            s.events[1].record()
            rec.stamps.append((t, time.time_ns()))
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        s.end_ns = time.time_ns()
        s.failed = exc_type is not None
        if rec.stack and rec.stack[-1] == self.index:
            rec.stack.pop()
        rec.unit = self.outer_unit
        return False


class Recorder:
    """The spans and per-unit counts of the current (or last) recording
    session: ``spans`` in the order they opened, ``unit_spans`` the unit
    spans (unit ``u`` is ``unit_spans[u]``), ``stamps`` the host
    ``time.time_ns()`` stamps just before and just after each CUDA event
    record the session made, in order, ``per_unit`` counter name -> unit ->
    increments, ``dropped`` the spans past ``SPAN_CAP``.  ``live``:
    recording was on at the last span or counter."""

    def __init__(self):
        self.start()
        self.live = False

    def start(self, ranges: bool = False):
        """A new session: an empty buffer."""
        self.spans, self.unit_spans, self.stamps, self.stack = [], [], [], []
        self.per_unit = collections.defaultdict(collections.Counter)
        self.unit, self.dropped = None, 0
        self.ranges = ranges
        # Events only where the process already uses the card.
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        # Timed spans whose events are not yet read, oldest first, and
        # events free to record again: an event costs about as much to
        # create as to record (~10 us on the card).
        self.pending, self.free = collections.deque(), []
        # Anchors are recorded and never read: one event serves them all.
        self.anchor = torch.cuda.Event() if self.cuda else None
        self.live = True

    def event(self):
        """A timing event to record: one a completed timed span has given
        back, else a new one."""
        if not self.free:
            while self.pending:
                s = self.pending[0]
                if s.end_ns is None or not s.events[1].query():
                    break
                self.pending.popleft()
                s.device_ms()
                self.free.extend(s.events)
                s.events = None
        return self.free.pop() if self.free else torch.cuda.Event(
            enable_timing=True)

    def open(self, name, device, unit):
        if not self.live:
            self.start()
        return _Open(self, name, device, unit)

    def add(self, name, n):
        if not self.live:
            self.start()
        self.per_unit[name][self.unit] += n


RECORDER = Recorder()


def span(name: str, device: bool = False, unit: bool = False):
    """A context that records the span ``name`` while recording (a
    ``torch.profiler`` session or ``recording()``), else the shared
    no-op context.  ``device``: also time it on the card with a pair of
    CUDA events; ``unit``: the span is a unit of work (a request, a
    step) that the spans and counts inside it belong to, anchored by a
    CUDA event at its start."""
    if _recording or _profiler_on():
        return RECORDER.open(name, device, unit)
    RECORDER.live = False
    return _NULL


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``; while recording, also against
    the current unit."""
    COUNTS[name] += n
    if _recording or _profiler_on():
        RECORDER.add(name, n)


@contextlib.contextmanager
def recording(ranges: bool = False):
    """Record spans and counters for the block, profiler or not, in a
    new session; ``ranges``: each span also opens a ``record_function``
    (for a profiler that records CPU activity).  Yields ``RECORDER``."""
    global _recording
    outer = _recording
    _recording = True
    RECORDER.start(ranges)
    try:
        yield RECORDER
    finally:
        _recording = outer
        RECORDER.ranges = False
        RECORDER.live = False


class _CountView(collections.abc.MutableMapping):
    """The counters ``<prefix><key>`` of ``COUNTS`` as a mapping; a key
    never counted reads 0."""

    def __init__(self, prefix: str):
        self._prefix = prefix

    def _keys(self):
        n = len(self._prefix)
        return [k[n:] for k in COUNTS if k.startswith(self._prefix)]

    def __getitem__(self, key):
        return COUNTS[self._prefix + key]

    def __setitem__(self, key, n):
        COUNTS[self._prefix + key] = n

    def __delitem__(self, key):
        del COUNTS[self._prefix + key]

    def __contains__(self, key):
        return self._prefix + key in COUNTS

    def __iter__(self):
        return iter(self._keys())

    def __len__(self):
        return len(self._keys())


class Counted:
    """A kernel wrapper whose launches are counted in ``COUNTS``:
    ``launches`` is ``launches.<name>``, ``form_launches[f]``
    ``launches.<name>.form.<f>`` and ``route_launches[r]``
    ``launches.<name>.route.<r>``, each readable and settable.  Calling
    it calls the wrapped function."""

    def __init__(self, fn, name: str):
        functools.update_wrapper(self, fn)
        self.counter = f"launches.{name}"
        self.form_launches = _CountView(f"{self.counter}.form.")
        self.route_launches = _CountView(f"{self.counter}.route.")

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return COUNTS[self.counter]

    @launches.setter
    def launches(self, n: int):
        COUNTS[self.counter] = n

    def launched(self, form: str | None = None, route: str | None = None):
        """Count one launch, by form and route where given."""
        count(self.counter)
        if form is not None:
            count(f"{self.counter}.form.{form}")
        if route is not None:
            count(f"{self.counter}.route.{route}")

    def reset(self):
        """Every count of this wrapper to 0."""
        for k in [k for k in COUNTS if k == self.counter
                  or k.startswith(self.counter + ".")]:
            del COUNTS[k]


def counted(name: str):
    """Decorator: the function as a ``Counted`` wrapper whose counters
    are ``launches.<name>...``."""
    return functools.partial(Counted, name=name)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    """Wall-clock step timer (JAX :55): ``stop(result)`` waits for the
    card when a tensor of ``result`` lives there, so that queued work is
    charged to the step that launched it; CPU tensors are computed by
    the time they are returned."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        devices = {t.device for t in _tensors(result) if t.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)

    @property
    def min_ms(self) -> float:
        return 1000.0 * min(self.times) if self.times else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write a Chrome trace, ``log_dir/trace.json``,
    which Perfetto and ``chrome://tracing`` open (JAX :81 writes a
    ``jax.profiler`` trace); the program's spans are recorded
    (``recording(ranges=True)``) and nest over the ops and kernels they
    hold.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, recording(
            ranges=True):
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

H100_BYTES_PER_S = 3.35e12
# Operations per second by the operands' type: tensor cores for bf16 and
# int8; float32 is computed in exact f32 by FMA outside the tensor cores;
# "tf32" is the tensor cores' rate for f32 products taken in TF32, which
# only the probes' library rows (utils/probes.py peak_probe) ask for.
H100_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12,
                  torch.float32: 67e12, "tf32": 495e12}


def slope_time(make_fn, args=(), units=(2, 16), reps: int = 3):
    """Per-unit device time with every per-call constant cancelled: time
    the same chain at two lengths and difference them,

        per_unit = (t(u1) - t(u0)) / (u1 - u0).

    ``make_fn(u)`` returns a callable whose device work grows linearly in
    ``u`` and whose result holds only finite values.  Each length runs
    once as a warm-up, then ``reps`` times between CUDA events on the
    current stream; the least time counts.  Returns ``(per_unit_seconds,
    fixed_seconds)``."""
    if not torch.cuda.is_available():
        raise RuntimeError("slope_time times the card; no CUDA device is "
                           "visible")
    times = []
    for u in units:
        fn = make_fn(u)
        out = fn(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"slope_time: the {u}-unit chain gave "
                               "non-finite values")
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        times.append(best)
    per_unit = (times[-1] - times[0]) / (units[-1] - units[0])
    return per_unit, times[0] - units[0] * per_unit


def _operator_blocks(op):
    """``(blocks, block rows, block cols)`` an operator's product reads:
    the dkw layout's arrays where present, else the flat ragged or the
    uniform band, the BSR blocks without their zero tails, or the whole
    dense matrix as one block."""
    if getattr(op, "bands_dkw", None) is not None:
        # Square blocks where the operator names no shape (the halo ones).
        br, bc = getattr(op, "block_shape", (op.bands_dkw[0].shape[1],) * 2)
        return (sum(b.shape[0] * (b.shape[2] // bc) for b in op.bands_dkw),
                br, bc)
    if getattr(op, "band", None) is not None:
        if op.band.dim() == 3:  # flat ragged
            return op.band.shape[0], op.band.shape[1], op.band.shape[2]
        nbr, w, br, bc = op.band.shape
        return nbr * w, br, bc
    if getattr(op, "blocks", None) is not None:
        _, br, bc = op.blocks.shape
        return op.block_cols.numel(), br, bc
    if getattr(op, "mat", None) is not None:
        return 1, op.mat.shape[0], op.mat.shape[1]
    raise ValueError(f"no roofline model for {type(op).__name__}")


def roofline(ops: float, nbytes: float, dtype, seconds: float | None = None,
             bytes_per_s: float = H100_BYTES_PER_S,
             ops_per_s: dict = H100_OPS_PER_S) -> dict:
    """The least time the card could take for ``ops`` operations on
    ``dtype`` operands and ``nbytes`` moved once: the larger of the two
    times, named by what bounds it; with ``seconds``, the achieved share
    of that bound."""
    t_bytes = nbytes / bytes_per_s
    t_ops = ops / ops_per_s[dtype]
    out = {"bytes": int(nbytes), "flops": int(ops),
           "t_bytes_us": t_bytes * 1e6, "t_ops_us": t_ops * 1e6,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_us": max(t_bytes, t_ops) * 1e6}
    if seconds is not None:
        out["achieved_frac_of_bound"] = max(t_bytes, t_ops) / seconds
    return out


def spmm_roofline(op, seconds_per_spmm: float | None, feature_width: int,
                  extra_inputs: int = 0, **peaks) -> dict:
    """Roofline of one ``L @ x`` through ``op`` at ``feature_width``
    columns (JAX :117-181): the operator's storage read once plus one
    activation read and one written, against the products of every
    stored block, zero blocks included.  ``extra_inputs`` adds that many
    more activation reads (1 for the hop's x0, 2 with the adjoint hop's
    c).  ``useful_edge_flops_frac`` is the share of those products that
    the graph's nonzeros need."""
    e = torch.empty(0, dtype=op.compute_dtype).element_size()
    C = feature_width
    nb, br, bc = _operator_blocks(op)
    flops = 2 * nb * br * bc * C
    nbytes = nb * br * bc * e + (2 + extra_inputs) * op.m_padded * C * e
    out = roofline(flops, nbytes, op.compute_dtype, seconds_per_spmm,
                   **peaks)
    out["useful_edge_flops_frac"] = 2 * op.nnz * C / flops
    return out


def sparse_roofline(op, seconds_per_spmm: float | None, feature_width: int,
                    extra_inputs: int = 0, **peaks) -> dict:
    """Roofline of one ``L @ x`` by what the inputs need: each nonzero's
    value (in the operator's dtype) and column index, the int32 row
    pointer over the ``m_padded`` rows, one activation read and one
    written (``extra_inputs`` more reads: 1 for the hop's x0), and
    ``2 nnz C`` operations.  The index is int32 (a CSR column, the BSR
    row kernel's ``nz_cols``) or, on a banded operator, the int16 window
    offset that the banded row walk reads (``ops.packing.band_row_index``;
    the band fixes every nonzero's window, in every layout).
    ``spmm_roofline`` counts the block format's work instead."""
    e = torch.empty(0, dtype=op.compute_dtype).element_size()
    index_bytes = 2 if getattr(op, "band", None) is not None else 4
    C = feature_width
    nnz = op.nnz
    nbytes = (nnz * (e + index_bytes) + (op.m_padded + 1) * 4
              + (2 + extra_inputs) * op.m_padded * C * e)
    return roofline(2 * nnz * C, nbytes, op.compute_dtype, seconds_per_spmm,
                    **peaks)
