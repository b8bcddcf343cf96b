"""Readings of a cell's correctness controls, and of the faults a training
cell can have, at the cell's own size: the plain reference computed in a
precision below the one the cell states (int4 for int8, int8 carries
for bf16, TF32 for float32 with TF32 off) and for training the reference
on half of each batch, each held by the cell's numbers against the
reference at the stated precision.  The traffic mix's ``controls`` name
them.  The limits in ``benchmark/checks/<cell>.json`` lie between these
readings and the program's.  The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed.  It needs the card, as ``run.py`` does.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(manifest, name, seed: int, device, overrides=None,
             which: str = "controls") -> dict:
    """``{control name: {number: reading}}`` for one seed: the traffic
    mix's ``controls``, which the limits separate from the program's
    readings, or its ``observed``, read for the record."""
    overrides = overrides or {}
    cell = manifest.cell(name)
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    entry = manifest.entry(traffic)
    return entry.session(config, traffic, seed, device).control(which)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    from harness.runner import Manifest

    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device")
    torch.cuda.set_device(0)
    manifest = Manifest(ROOT / "BENCHMARK.json")
    limits = manifest.limits(manifest.cell(args.workload))
    for seed in args.seeds:
        for which in ("controls", "observed"):
            r = readings(manifest, args.workload, seed,
                         torch.device("cuda", 0), which=which)
            if r:
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  which: r, "limits": limits}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
