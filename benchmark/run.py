"""Run one cell of the benchmark of ``cnn_graph_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  It loads
and warms up the cell, measures for ``--seconds`` (a traced run: the
first few seconds of the window under ``torch.profiler``), checks what
the window produced against the plain reference, and prints one JSON
object as its last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared with its limit.  The card's
power limit and the checks go to standard error.  Without a CUDA device,
with JAX loaded, or outside a checkout of the repository, it prints no
result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Forbidden in the measured process, compared by whole top-level names
# (the port's own package name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cnn_graph_tpu")
# Kernel and build caches at fixed paths inside the checkout.
CACHES = {"TRITON_CACHE_DIR": BENCH / ".cache" / "triton",
          "TORCH_EXTENSIONS_DIR": BENCH / ".cache" / "torch_extensions"}


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def fail(code: int, msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        fail(2, "--seed must be >= 0 and --seconds > 0")
    if not (ROOT / "cnn_graph_tpu_torch" / "__init__.py").is_file():
        fail(2, f"no cnn_graph_tpu_torch package beside {BENCH.name}/: "
                "run from a checkout of the repository")
    for var, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    sys.path[:0] = [str(BENCH), str(ROOT)]

    import torch

    from harness.runner import Manifest, run_cell

    manifest = Manifest(ROOT / "BENCHMARK.json")
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        fail(3, "no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        fail(3, f"{cell['chips']} devices needed, "
                f"{torch.cuda.device_count()} present")
    print(f"card: {power_limit()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START)
    found = forbidden_loaded()
    if found:
        fail(4, f"modules loaded that the benchmark forbids: {found}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
