"""Run a checkout's ``chip_smoke.py`` with every CUDA-event timer
replaced by one that times the device's work alone, so that two commits'
kernel times stand on one yardstick.

    python3 tools/smoke_device_times.py CHECKOUT [chip_smoke.py arguments]

``chip_smoke.py`` times with ``cuda_ms`` (CUDA events around ``n``
calls) and, from the banded row walk on, its kernels with ``device_ms``
(the same, with a spin kernel holding the stream while the host enqueues
the calls).  Under ``cuda_ms`` a kernel shorter than its wrapper's host
time reads the host's time, so an older checkout's kernel rows cannot be
set beside a newer one's.  This script loads CHECKOUT's ``chip_smoke.py``
as a module, puts ``device_ms`` below in place of both timers and runs
its ``main``.  Every time that run prints is then device work with the
host's enqueue hidden, as long as the host enqueues each call within
``SPIN_MS``: request and step times included, which are then device
times, not latencies.  Slope-fitted chains keep their own timer.  The
checks, the output and the exit code are the checkout's own.  Needs one
CUDA card.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch

# The spin per timed call, and the cycles it takes at the H100's 1.98 GHz
# boost clock (a lower clock spins longer, which only hides more host).
SPIN_MS = 10.0
CYCLES_PER_MS = 1_980_000


def device_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls after one
    warm-up call: a spin kernel holds the stream while the host enqueues
    the calls, then CUDA events time the device work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(CYCLES_PER_MS * SPIN_MS * (n + 1)))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__.strip().split("\n\n")[1], file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    path = os.path.join(tree, "chip_smoke.py")
    sys.path.insert(0, tree)
    os.chdir(tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    smoke.cuda_ms = smoke.device_ms = device_ms
    sys.argv = [path, *sys.argv[2:]]
    return smoke.main()


if __name__ == "__main__":
    sys.exit(main())
