"""The pieces of the benchmark that it finds by name, each a file of its
own, so that a later configuration, traffic mix or metric adds files and
entries and edits none:

* a graph kind, ``benchmark/graph_kinds/<graph.kind>.py``: ``make(spec)``
  builds the configuration's graph from its ``graph`` group;
* a dataset, ``benchmark/datasets/<data>.py``: ``make(spec, sizes,
  seed)`` makes a configuration's samples;
* an entry, ``benchmark/entries/<entry>.py``, named by a traffic mix:
  ``LOOP`` (``serve`` or ``train``) and ``session(config, traffic, seed,
  device)``, the program's path that the window drives with its
  hand-over to the plain reference;
* a per-layer metric's reader, ``benchmark/metrics/<quantity>.py``, the
  part of the metric's name before its first dot (``mfu`` reads
  ``mfu.serve`` and ``mfu.train``): ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

__all__ = ["BENCH_DIR", "load_module", "graph", "dataset", "entry",
           "reader"]

BENCH_DIR = Path(__file__).resolve().parents[1]
_LOADED = {}


def load_module(path: Path, name: str):
    if name in _LOADED:
        return _LOADED[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[name] = mod
    return mod


def _piece(folder: str, name: str):
    return load_module(BENCH_DIR / folder / f"{name}.py",
                       f"bench_{folder}_{name}".replace("-", "_"))


def graph(spec: dict) -> dict:
    """The graph of a configuration's ``graph`` group, as its kind makes
    it: ``{"laplacians": [scipy matrices], ...}`` and what else the kind
    gives (node positions, a coarsening's permutation)."""
    return _piece("graph_kinds", spec["kind"]).make(spec)


def dataset(name: str, spec: dict, sizes: tuple, seed: int) -> dict:
    return _piece("datasets", name).make(spec, sizes, seed)


def entry(name: str):
    return _piece("entries", name)


def reader(metric: str):
    return _piece("metrics", metric.split(".")[0])
