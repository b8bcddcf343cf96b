"""The reduction of a traced window, on events made by hand: the window
lies between the two marker kernels, which are left out; idle stretches
are named by the runtime call the host was in, else by the operation
whose dispatch ended them; the readers count what lies inside."""

import pytest

from harness import readers, trace
from harness.work import Work

MS = 1_000_000  # ns


def _window():
    device = [
        ("at::cuda::(anonymous namespace)::spin_kernel(long)", "kernel",
         10 * MS, 10 * MS + 1000),
        ("warm_kernel", "kernel", 5 * MS, 8 * MS),  # before the window
        ("band_rows_kernel", "kernel", 11 * MS, 13 * MS),
        ("gemm", "kernel", 13 * MS, 14 * MS),
        ("Memcpy HtoD", "gpu_memcpy", 16 * MS, 17 * MS),
        ("band_rows_kernel", "kernel", 17 * MS, 19 * MS),
        ("at::cuda::(anonymous namespace)::spin_kernel(long)", "kernel",
         20 * MS, 20 * MS + 1000),
    ]
    host = [("cudaDeviceSynchronize", 19 * MS, 20 * MS - 1000)]
    return trace.window_from_markers(device, host)


def test_window_lies_between_the_markers():
    w = _window()
    assert w.window_s == pytest.approx(0.010)
    assert [d[0] for d in w.device] == ["band_rows_kernel", "gemm",
                                        "Memcpy HtoD", "band_rows_kernel"]
    assert w.busy_s() == pytest.approx(0.006)
    assert [tuple(round(x, 6) for x in g) for g in w.idle_gaps()] == [
        (0.0, 0.001), (0.004, 0.006), (0.009, 0.010)]


def test_idle_stretches_are_named():
    b = _window().breakdown()
    gaps = dict(b["idle_gaps"])
    assert gaps["dispatch before band_rows_kernel"] == pytest.approx(0.001)
    assert gaps["dispatch before Memcpy HtoD"] == pytest.approx(0.002)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(0.001)
    assert dict(b["device_ops"])["band_rows_kernel"] == pytest.approx(0.004)


def test_event_records_bound_a_window_without_both_markers():
    device = [("gemm", "kernel", 2 * MS, 3 * MS),
              ("at::cuda::spin_kernel(long)", "kernel", 1 * MS, 1 * MS + 9)]
    host = [("cudaEventRecord", 1 * MS, 1 * MS + 5),
            ("cudaEventRecord", 5 * MS, 5 * MS + 5)]
    w = trace.window_from_markers(device, host)
    assert w.window_s == pytest.approx(0.004)
    assert [d[0] for d in w.device] == ["gemm"]


def test_a_trace_without_both_markers_is_refused():
    with pytest.raises(RuntimeError, match="markers"):
        trace.window_from_markers([("gemm", "kernel", 0, 10)],
                                  [("cudaEventRecord", 0, 1)])


class _Ctx:
    def __init__(self, window, n, work):
        self.window, self.units, self.primary = window, {"step": n}, "step"
        self.work = {"step": work}
        self.notes = []

    n_primary = property(lambda self: self.units["step"])
    note = lambda self, text: self.notes.append(text)  # noqa: E731

    def kernel_work(self, kernel):
        return self.work["step"]["kernels"].get(kernel, []) * self.n_primary

    def total_work(self):
        return self.work["step"]["total"] * self.n_primary


def test_readers_on_the_window():
    hop = Work(flops=2e9, bytes=1e6)
    ctx = _Ctx(_window(), 2, {"total": hop * 2,
                              "kernels": {"band_rows_kernel": [hop]}})
    assert readers.idle_pct(ctx) == pytest.approx(40.0)
    assert readers.launches(ctx) == 1.5  # copies are not kernels
    assert readers.other_kernels_ms(ctx, ("band_rows_kernel",)) == (
        pytest.approx(0.5))
    assert readers.roofline_pct(ctx, "band_rows_kernel") == pytest.approx(
        100 * 2 * hop.least_s() / 0.004)
    assert readers.mfu_pct(ctx) == pytest.approx(
        100 * 4 * hop.compute_s() / 0.010)
    ctx.units["step"] = 3  # 3 launches expected, 2 traced: left out
    assert readers.roofline_pct(ctx, "band_rows_kernel") is None
    assert ctx.notes
