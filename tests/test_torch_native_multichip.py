"""The port's native Graclus matcher (``cnn_graph_tpu_torch.native``) and
its multichip experiment's ``comm`` mode (``cnn_graph_tpu_torch.experiments.
multichip``) against the JAX package.

The matcher is built from the port's own C++ copy into the port's
``_build/`` (never the JAX package's committed library); its clusters
must equal the Python loop's (``graclus_pairing``) and JAX's matcher's
exactly, on the MNIST grid, a kNN graph and a graph of tied gains, and
``coarsen`` must give JAX's graphs and permutation.  ``comm`` must print
JAX's ``main_comm`` table (``experiments/multichip.py:256``) for n = 2,
4 and 8 on ``city_graph(64)``, with JAX's mesh on conftest's 8 CPU
devices."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import scipy.sparse

from cnn_graph_tpu.graphs import coarsening as jax_coarsening
from cnn_graph_tpu.parallel import banded_halo_laplacian, make_mesh
from cnn_graph_tpu_torch import _build, graphs, native
from cnn_graph_tpu_torch.experiments import multichip
from cnn_graph_tpu_torch.graphs import coarsening

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid_graph():
    z = graphs.grid(28)
    return graphs.adjacency(*graphs.knn(z, k=8)).tocsr()


def _knn_graph():
    z = np.random.default_rng(11).normal(size=(900, 5))
    return graphs.knn_graph(z, k=10).tocsr()


def _tied_graph():
    """A ring with every edge weight and degree equal, so every gain
    ties: the first neighbour in CSR order must win, as in the loop."""
    n = 64
    i = np.arange(n)
    rows = np.concatenate([i, i])
    cols = np.concatenate([(i + 1) % n, (i - 1) % n])
    return scipy.sparse.csr_matrix((np.ones(2 * n), (rows, cols)),
                                   shape=(n, n))


GRAPHS = {"grid": _grid_graph, "knn": _knn_graph, "tied": _tied_graph}


class TestNativeGraclus:
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_clusters_match_python_loop_and_jax(self, name):
        W = GRAPHS[name]()
        rid = np.random.default_rng(3).permutation(W.shape[0])
        d = np.asarray(W.sum(axis=0)).ravel() - W.diagonal()
        args = (W.indptr, W.indices, W.data, rid, d)
        got = native.graclus_one_level(*args)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, coarsening.graclus_pairing(*args))
        np.testing.assert_array_equal(
            got, jax_coarsening.graclus_pairing(*args))
        assert np.bincount(got).max() <= 2  # pairs and singletons

    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_coarsen_matches_jax(self, name):
        W = GRAPHS[name]()
        graphs_p, perm_p = graphs.coarsen(W, levels=3, seed=5)
        graphs_j, perm_j = jax_coarsening.coarsen(W, levels=3, seed=5)
        assert list(perm_p) == list(perm_j)
        for a, b in zip(graphs_p, graphs_j):
            assert a.shape == b.shape and abs(a - b).max() == 0

    def test_builds_into_the_ports_build_dir(self):
        lib, _ = _build.build_host("graph_kernels")
        assert lib.parent == _build.BUILD_DIR
        assert lib.parent.name == "_build"
        assert lib.parent.parent.name == "cnn_graph_tpu_torch"

    def test_failed_build_raises_with_the_compiler_output(self, tmp_path,
                                                          monkeypatch):
        (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
        monkeypatch.setattr(_build, "HOST_SOURCE_DIR", tmp_path)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed to build "
                           "broken.cpp") as e:
            _build.build_host("broken")
        assert "error" in str(e.value)

    def test_missing_compiler_raises(self, monkeypatch):
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            _build._gxx()

    def test_graclus_runs_the_native_matcher(self, monkeypatch):
        calls = []
        real = native.graclus_one_level

        def spy(*a):
            calls.append(1)
            return real(*a)

        monkeypatch.setattr(native, "graclus_one_level", spy)
        graphs.coarsen(_grid_graph(), levels=2, seed=1)
        assert len(calls) == 2


def _jax_multichip(monkeypatch):
    """JAX's experiments/multichip.py as a module, without its
    ``_common`` import (which sets a compile cache outside the repo)."""
    monkeypatch.setitem(sys.modules, "_common", types.ModuleType("_common"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "jax_multichip", os.path.join(ROOT, "experiments", "multichip.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestMultichipComm:
    SIDE = 64

    def test_comm_prints_jax_table(self, monkeypatch, capsys):
        """The header and each n's row as JAX prints them, at JAX's G for
        each n (the two packages' banded halo operators take another
        default G at n = 2: JAX's VMEM model gives 6, the port 8)."""
        jax_mc = _jax_multichip(monkeypatch)
        jax_mc.main_comm([str(self.SIDE)])
        want = capsys.readouterr().out.splitlines()
        L, _ = graphs.city_graph(self.SIDE, k=8, seed=0)
        got = []
        for n in (2, 4, 8):
            G = banded_halo_laplacian(L, make_mesh(data=8 // n, nodes=n)
                                      ).rows_per_step
            multichip.main_comm(self.SIDE, (n,), rows_per_step=G)
            lines = capsys.readouterr().out.splitlines()
            got = lines[:2] if not got else got
            got.append(lines[2])
        assert got == want

    def test_comm_cli_runs_on_the_cpu(self, capsys):
        rows = multichip.main(["comm", str(self.SIDE), "4", "8"])
        out = capsys.readouterr().out.splitlines()
        assert [r["n"] for r in rows] == [4, 8] and len(out) == 4
        for r in rows:
            assert r["mb_int8"] == r["mb_hop"] / 2
            assert 0 < r["boundary_nodes"] <= r["cut_edges"]
