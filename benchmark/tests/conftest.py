"""The benchmark's own tests: ``python -m pytest benchmark/tests`` (CPU) and
``python -m pytest benchmark/tests -m gpu`` on the card.  Nothing here
imports JAX; ``tests/conftest.py`` (which does) does not apply."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny configurations for CPU runs of the whole harness: every layer of
# each cell's path at a size a test run holds.  The banded operator is
# asked for by name: at 256 nodes "auto" would pick the dense one.
_CITY = {"graph": {"kind": "city", "side": 16, "k": 8, "seed": 0,
                   "jitter": 0.3},
         "K": 5, "input_features": 32, "hidden": [32], "num_classes": 4,
         "operator_format": "banded"}
_MNIST = {"K": [5, 5], "M": [64, 10]}
# The 50k serving limit (0.035) sits under the TF32-taps control's 0.07 at
# full size; at 32 features the control reads 0.016, so the tiny int8
# mixes hold a tiny limit, still 50 times a sound tiny run's reading.
_TINY_INT8 = {"logit_gap": 0.005}
TINY = {
    "nodecls-city50k-serve-int8": {"config": _CITY, "limits": _TINY_INT8},
    "nodecls-city50k-train-deep-bf16": {"config": _CITY},
    "chebnet-mnist-serve-f32": {"config": _MNIST, "traffic": {"ring": 8}},
    "chebnet-mnist-train-f32": {"config": _MNIST,
                                "traffic": {"n_train": 1000, "n_val": 200,
                                            "eval_frequency": 20}},
    # Mixes that the entries take as data and no cell runs yet.
    "nodecls-serve-bf16": {"config": _CITY, "traffic": {
        "int8": False, "operator_dtype": "bfloat16",
        "reference_rounding": "bfloat16",
        "controls": {"int8_carries": {"reference_rounding": "int8"}}},
        "limits": {"logit_gap": 0.01},
        # bf16 carries round apart where the kernel's float32 sum and the
        # reference's float64 one straddle a rounding boundary.
        "sound": 1e-3},
    "nodecls-serve-loaded-hostfeat": {"config": _CITY, "traffic": {
        "handle": "loaded", "features": "host"}, "limits": _TINY_INT8},
}
# Cells that the tests run and BENCHMARK.json does not hold: the ChebNet
# training cell, left out of the benchmark for its host noise (PERF.md),
# and the mixes above, each on a traffic file that a cell uses.
EXTRA = {
    "chebnet-mnist-train-f32": {"config": "chebnet-mnist-paper",
                                "traffic": "train-trainer-f32"},
    "nodecls-serve-bf16": {"config": "nodecls-city50k-deep",
                           "traffic": "serve-int8-ring4"},
    "nodecls-serve-loaded-hostfeat": {"config": "nodecls-city50k-deep",
                                      "traffic": "serve-int8-ring4"},
}


def cell_of(manifest, name: str) -> dict:
    if name in EXTRA:
        return dict(EXTRA[name], name=name, chips=1)
    return manifest.cell(name)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with CUDA; skips without one")


@pytest.fixture
def manifest():
    from harness.runner import Manifest

    return Manifest(ROOT / "BENCHMARK.json")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    return torch.device("cuda", 0)
