"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced, and the result line.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``
(``harness/found.py``):

* the configuration's file (``configs[].file``): the model's sizes and
  its graph, whose ``kind`` names the maker
  ``benchmark/graph_kinds/<kind>.py``;
* the traffic mix ``benchmark/traffic/<traffic>.json``, whose ``entry``
  names ``benchmark/entries/<entry>.py``: the program's path that the
  window drives, with its hand-over to the plain reference in
  ``benchmark/reference/``, and which of the two loops below drives it
  (``serve``: a closed loop with one client; ``train``: one step object
  driven from set-up through the window);
* the limits of the correctness check, ``benchmark/checks/<cell>.json``;
* each per-layer metric's reader, ``benchmark/metrics/<quantity>.py``.
"""

from __future__ import annotations

import contextlib
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import torch

from harness import compare, found, trace

__all__ = ["Manifest", "run_cell", "TRACE_SECONDS"]

# A traced run records this much of the window (or the whole, if shorter):
# enough for a few hundred requests or steps, and a few evaluations.
TRACE_SECONDS = 4.0


class Manifest:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, path: Path):
        self.root = path.resolve().parent
        self.data = json.loads(path.read_text())

    def cell(self, name) -> dict:
        """The workload called ``name``; a dict (a cell that tests describe
        and ``BENCHMARK.json`` does not hold) is taken as it is."""
        if isinstance(name, dict):
            return name
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        return json.loads((self.root / self.config_entry(
            cell["config"])["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((found.BENCH_DIR / "traffic"
                           / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((found.BENCH_DIR / "checks"
                           / f"{cell['name']}.json").read_text())

    def entry(self, traffic: dict):
        return found.entry(traffic["entry"])

    def metrics_for(self, cell: dict, section: str) -> list:
        return [m for m in self.data[section]
                if cell["name"] in m.get("workloads", [cell["name"]])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WindowClosed(Exception):
    """Raised from inside a training step's feed once the window is over."""


def serve_loop(sess, seconds: float, traffic: dict, seed: int, traced: bool,
               device, log) -> dict:
    """A closed loop with one client and one request in flight: request i
    takes the ring's input ``i mod len(ring)`` and ends in a synchronise.
    A uniform sample of ``check_sample`` answers of the window, drawn from
    the seed (reservoir sampling), is kept for the check: a fixed number,
    so that the memory they hold does not vary with the request count."""
    ring = sess.inputs
    size = int(traffic["check_sample"])
    rng = random.Random(seed)
    for i in range(int(traffic["warmup"])):
        a = time.perf_counter()
        sess.call(ring[i % len(ring)])
        _sync(device)
        log(f"set-up: warm-up request {i}: {time.perf_counter() - a:.3f} s")
    slots, lat = [], []
    capture = trace.Capture(traced)
    with capture:
        if traced:
            for i in range(2):  # the profiler's own first calls
                sess.call(ring[i % len(ring)])
            _sync(device)
            capture.mark()
        t0 = time.perf_counter()
        i = 0
        while True:
            a = time.perf_counter()
            out = sess.call(ring[i % len(ring)])
            _sync(device)
            b = time.perf_counter()
            lat.append(b - a)
            if i < size:
                slots.append((i, out))
            else:
                j = rng.randrange(i + 1)
                if j < size:
                    slots[j] = (i, out)
            i += 1
            if b - t0 >= seconds:
                break
        capture.mark()
        _sync(device)
    elapsed = b - t0
    lat_sorted = sorted(lat)
    p95 = (statistics.quantiles(lat_sorted, n=100, method="inclusive")[94]
           if len(lat) > 1 else lat[0])
    return {"t0": t0, "units": {"request": i}, "attempted": i, "failed": 0,
            "values": {"requests_per_s": i / elapsed,
                       "request_p95_ms": p95 * 1e3},
            "kept": dict(slots), "window": capture.window()}


def train_loop(sess, seconds: float, traffic: dict, traced: bool,
               device, log) -> dict:
    """The step object's own loop, from set-up through the window: steps
    ``0 .. checked - 1`` are checked against the reference; the window
    starts at step ``checked``, after one evaluation as warm-up where the
    loop evaluates, and closes at the first step that starts after
    ``seconds``; every step enqueued before is counted and waited for."""
    checked = int(traffic["checked_steps"])
    state = {"t0": None, "steps": 0, "evals": 0}
    capture = trace.Capture(traced)

    def on_step(step: int):
        if step <= checked:
            _sync(device)
            log(f"set-up: step {step} at {time.perf_counter():.3f}")
            sess.observe(step)
        if step == checked:
            sess.warm()
            _sync(device)
            log(f"set-up: warm evaluation done at {time.perf_counter():.3f}")
            if traced:
                capture.__enter__()
                for _ in range(2):  # the profiler's own first calls
                    sess.warm()
                _sync(device)
                capture.mark()
            state["t0"] = time.perf_counter()
        if step >= checked:
            if time.perf_counter() - state["t0"] >= seconds:
                raise WindowClosed(step)
            state["steps"] = step - checked + 1

    @contextlib.contextmanager
    def on_eval():
        yield
        if state["t0"] is not None:
            state["evals"] += 1

    try:
        sess.drive(on_step, on_eval)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the step loop ended before the window closed")
    _sync(device)
    t1 = time.perf_counter()
    window = None
    if traced:
        capture.mark()
        _sync(device)
        capture.__exit__(None, None, None)
        window = capture.window()
    n = state["steps"]
    return {"t0": state["t0"], "units": {"step": n, "eval": state["evals"]},
            "attempted": n, "failed": 0,
            "values": {"train_step_ms": (t1 - state["t0"]) / n * 1e3},
            "window": window}


class ReadContext:
    """What a per-layer metric's reader gets: the traced window, the units
    run in it, the work each unit needs, and a way to say why a metric
    is left out."""

    def __init__(self, window, units: dict, work: dict, primary: str):
        self.window = window
        self.units = units
        self.work = work
        self.primary = primary
        self.notes = []

    @property
    def n_primary(self) -> int:
        return self.units[self.primary]

    def total_work(self):
        from harness.work import Work

        total = Work()
        for unit, n in self.units.items():
            if n:
                total = total + self.work[unit]["total"] * n
        return total

    def kernel_work(self, kernel: str) -> list:
        """Each launch of ``kernel`` the window's units need, as Work."""
        out = []
        for unit, n in self.units.items():
            out += self.work[unit].get("kernels", {}).get(kernel, []) * n
        return out

    def note(self, text: str):
        self.notes.append(text)


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, overrides=None,
             log=None) -> dict:
    """Run cell ``name`` once and return the result line's object.
    ``overrides`` (tests only) updates the configuration and traffic
    dicts; ``log`` takes the lines that go to standard error."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    overrides = overrides or {}
    cell = manifest.cell(name)
    config = manifest.config(cell)
    traffic = manifest.traffic(cell)
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits = overrides.get("limits") or manifest.limits(cell)
    entry = manifest.entry(traffic)
    if traced and device.type != "cuda":
        raise ValueError("a traced run reads the card's trace: it needs CUDA")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    length = min(seconds, TRACE_SECONDS) if traced else seconds

    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the session")
    sess = entry.session(config, traffic, seed, device)
    built_s = time.perf_counter() - t_start
    if entry.LOOP == "serve":
        out = serve_loop(sess, length, traffic, seed, traced, device, log)
    elif entry.LOOP == "train":
        out = train_loop(sess, length, traffic, traced, device, log)
    else:
        raise ValueError(f"unknown loop {entry.LOOP!r}")
    setup_s = out["t0"] - t_start
    log(f"set-up: session built at {built_s:.3f} s, window at "
        f"{setup_s:.3f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    work = sess.work()
    primary = "request" if entry.LOOP == "serve" else "step"

    readings = sess.check(out.get("kept"))
    for line in getattr(sess, "detail", []):
        log(line)
    correct, checks = compare.verdict(readings, limits)
    for k, c in checks.items():
        c["value"] = _finite(c["value"])

    values = dict(out["values"], setup_s=setup_s,
                  peak_mem_mib=peak / 2**20)
    metrics = {}
    result_extra = {}
    if not traced:
        for m in manifest.metrics_for(cell, "end_to_end"):
            # A metric split by cells (``requests_per_s.chebnet``) reads
            # the quantity its name starts with.
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        ctx = ReadContext(out["window"], out["units"], work, primary)
        for m in manifest.metrics_for(cell, "per_layer"):
            ctx.notes = []
            v = found.reader(m["name"]).read(ctx)
            if v is None:
                log(f"metric {m['name']}: not read ({'; '.join(ctx.notes)})")
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        w = out["window"]
        if w is not None:
            result_extra["busy_s"] = w.busy_s()
            result_extra["window_s"] = w.window_s
            result_extra["breakdown"] = w.breakdown()
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": peak}
    if traced:
        device_info["busy_s"] = result_extra.get("busy_s", 0.0)
        device_info["window_s"] = result_extra.get("window_s", 0.0)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if traced and "breakdown" in result_extra:
        result["breakdown"] = result_extra["breakdown"]
    result["checks"] = checks
    log(f"units in the window: {json.dumps(out['units'])}")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return result
