"""Each cell's control (the plain reference in the nearest precision
below the cell's, put in the program's place) and, for training, the
half-batch fault read above the cell's limits: on the CPU at a tiny
size, and on the card at the cell's own size (``-m gpu``)."""

import json

import pytest
import torch

import control
from conftest import ROOT, TINY, cell_of

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _failed(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_at_a_tiny_size(manifest, name):
    cell = cell_of(manifest, name)
    limits = TINY[name].get("limits") or manifest.limits(cell)
    r = control.readings(manifest, cell, 41, torch.device("cpu"), TINY[name])
    assert r
    for kind, readings in r.items():
        assert _failed(readings, limits), (kind, readings, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_full_size(manifest, name, cuda):
    limits = manifest.limits(manifest.cell(name))
    for seed in (3_100_000_001, 3_100_000_002, 3_100_000_003):
        r = control.readings(manifest, name, seed, cuda)
        for kind, readings in r.items():
            assert _failed(readings, limits), (seed, kind, readings)
