"""What the per-layer metrics' readers share: reductions of the traced
window (``trace.Window``) by kernel name, over the units run in it.

A reader that finds nothing to read returns None and says why
(``ctx.note``); the harness then leaves the metric out of the line.
"""

from __future__ import annotations

__all__ = ["idle_pct", "mfu_pct", "other_kernels_ms", "launches",
           "roofline_pct"]


def _window(ctx):
    if ctx.window is None or ctx.window.window_s <= 0:
        ctx.note("no traced window")
        return None
    if not ctx.n_primary:
        ctx.note(f"no {ctx.primary} in the traced window")
        return None
    return ctx.window


def idle_pct(ctx):
    """The share of the window in which no device operation ran."""
    w = _window(ctx)
    if w is None:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)


def mfu_pct(ctx):
    """The compute side of the window's work (operations over the peak
    rate of their type) over the window's length."""
    w = _window(ctx)
    if w is None:
        return None
    return 100.0 * ctx.total_work().compute_s() / w.window_s


def _matches(name: str, kernels) -> bool:
    return any(k in name for k in kernels)


def other_kernels_ms(ctx, handwritten):
    """Device ms per unit in kernels whose names hold none of
    ``handwritten``."""
    w = _window(ctx)
    if w is None:
        return None
    s = sum(b - a for n, _, a, b in w.kernels()
            if not _matches(n, handwritten))
    return 1e3 * s / ctx.n_primary


def launches(ctx):
    """Device kernels per unit, all kernels counted."""
    w = _window(ctx)
    if w is None:
        return None
    return len(w.kernels()) / ctx.n_primary


def roofline_pct(ctx, kernel: str):
    """The least time of the work that ``kernel``'s launches carry over
    their device time.  None where the trace holds another number of its
    launches than the window's units need: then the work is not known."""
    w = _window(ctx)
    if w is None:
        return None
    spans = [b - a for n, _, a, b in w.kernels() if kernel in n]
    want = ctx.kernel_work(kernel)
    if not spans:
        ctx.note(f"no {kernel} launch in the trace")
        return None
    if len(spans) != len(want):
        ctx.note(f"{len(spans)} {kernel} launches traced, {len(want)} "
                 "expected from the units run")
        return None
    return 100.0 * sum(x.least_s() for x in want) / sum(spans)
