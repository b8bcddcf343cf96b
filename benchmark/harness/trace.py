"""The traced window: ``torch.profiler`` over the measured loop, reduced to
device intervals, host intervals and the window's bounds.

The profiler records the device's activity alone (``ProfilerActivity.
CUDA``: kernels, copies, sets, and the CUDA runtime calls that launch
them).  Recording every ATen call on the host as well slows the host by
tens of microseconds a call, and where the host sets the pace that reads
as device idle time that untraced runs do not have.  The window's bounds
are two marker kernels (``torch.cuda._sleep``'s ``spin_kernel``) that the
harness launches after a synchronise at the window's start and at its
end, each with a CUDA event recorded beside it; the markers themselves
are left out.  Where the trace does not hold both marker kernels, the
two ``cudaEventRecord`` calls bound the window instead.  An idle stretch is named by
the runtime call the host was in, else by the device operation that
ended it (the host was dispatching it).  Only the raw event list is
read; no Chrome trace is written.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

__all__ = ["Capture", "Window", "reduce_events", "window_between",
           "window_from_markers", "MARKER"]

# Host events that only say that the host was launching.
_LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGetLastError",
                    "cudaPeekAtLastError", "cudaDeviceGetAttribute",
                    "cudaStreamIsCapturing", "cudaFuncSetAttribute",
                    "Activity Buffer Request", "Buffer Flush")
# The kernel of ``torch.cuda._sleep``: the window's bounds on the device,
# and the runtime call of the event recorded beside each.
MARKER = "spin_kernel"
_EVENT_RECORD = "cudaEventRecord"


@dataclasses.dataclass
class Window:
    """The device's and the host's activity inside the traced window, in
    seconds from its start."""

    window_s: float
    device: list  # (name, kind, start_s, end_s), sorted by start
    host: list  # (name, start_s, end_s), sorted by start

    def kernels(self):
        return [d for d in self.device if d[1] == "kernel"]

    def busy_intervals(self) -> list:
        """The union of the device's operation intervals."""
        merged = []
        for _, _, a, b in self.device:
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1][1] = b
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list:
        """``(start_s, end_s)`` of each stretch with no device operation."""
        gaps, t = [], 0.0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def host_at(self, t: float, starts: list):
        """The innermost host span that covers time ``t``, or None."""
        best, best_len = None, float("inf")
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 400, -1), -1):
            name, a, b = self.host[j]
            if a <= t <= b and b - a < best_len:
                best, best_len = name, b - a
        return best

    def gap_name(self, a: float, b: float, starts: list,
                 dev_starts: list) -> str:
        """What the host did in the idle stretch ``(a, b)``: the runtime
        call it was in, else the dispatch of the operation that ended it."""
        name = self.host_at(0.5 * (a + b), starts)
        if name is not None:
            return name
        i = bisect.bisect_left(dev_starts, b)
        if i < len(self.device):
            return f"dispatch before {self.device[i][0]}"
        return "after the last operation"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        time by what the host was doing, ``[name, seconds]`` each."""
        by_op = collections.Counter()
        for name, _, a, b in self.device:
            by_op[name[:160]] += b - a
        starts = [h[1] for h in self.host]
        dev_starts = [d[2] for d in self.device]
        by_host = collections.Counter()
        for a, b in self.idle_gaps():
            by_host[self.gap_name(a, b, starts, dev_starts)[:160]] += b - a
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in by_host.most_common(top)]}


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce_events(events) -> tuple:
    """``(device, host)`` lists from ``_KinetoEvent``s: device activities
    ``(name, kind, start_ns, end_ns)`` (kernels, copies, sets; not the
    device-side copies of ``record_function`` ranges) and host spans
    ``(name, start_ns, end_ns)``."""
    device, host = [], []
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if "CUDA" in str(e.device_type()):
            if not e.is_user_annotation():
                device.append((name, _device_kind(name), a, b))
        elif not name.startswith(_LAUNCH_PREFIXES):
            host.append((name, a, b))
    return device, host


def window_between(device, host, w0: int, w1: int) -> Window:
    """Clip everything to ``[w0, w1]`` (ns) and shift its start to 0."""

    def clip(a, b):
        return max(a, w0), min(b, w1)

    dev = []
    for name, kind, a, b in device:
        a, b = clip(a, b)
        if b > a:
            dev.append((name, kind, (a - w0) * 1e-9, (b - w0) * 1e-9))
    hst = []
    for name, a, b in host:
        a, b = clip(a, b)
        if b >= a:
            hst.append((name, (a - w0) * 1e-9, (b - w0) * 1e-9))
    dev.sort(key=lambda d: d[2])
    hst.sort(key=lambda h: h[1])
    return Window((w1 - w0) * 1e-9, dev, hst)


def window_from_markers(device, host) -> Window:
    """The window between the two marker kernels, which are left out, or
    else between the two event records launched beside them."""
    marks = sorted(a for name, _, a, _ in device if MARKER in name)
    records = sorted(a for name, a, _ in host
                     if name.startswith(_EVENT_RECORD))
    device = [d for d in device if MARKER not in d[0]]
    if len(marks) == 2:
        return window_between(device, host, marks[0], marks[1])
    if len(records) == 2:
        return window_between(device, host, records[0], records[1])
    raise RuntimeError(f"the trace holds {len(marks)} {MARKER} markers and "
                       f"{len(records)} {_EVENT_RECORD} calls, not the "
                       f"window's two ({len(device)} device operations)")


class Capture:
    """``torch.profiler`` over the device while the ``with`` lasts;
    ``mark()`` launches a bound of the window (after a synchronise), and
    ``window()`` then reduces the events between the two.  Off
    (``enabled=False``) it costs nothing and ``window()`` is None."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def mark(self):
        if self.enabled:
            import torch

            torch.cuda._sleep(1)
            torch.cuda.Event().record()

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def window(self):
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        device, host = reduce_events(events)
        self._prof = None
        return window_from_markers(device, host)
