"""The port's mesh, all-gather operator and dp x nodes training
(``cnn_graph_tpu_torch.parallel``) against the JAX package on its
virtual 8-device mesh: tests/test_parallel.py case for case (float 1e-4,
the step's loss 1e-5), the Trainer's ``TrainConfig.mesh`` against one
process, the torch dry run, the export refusal, and the drivers'
``--mesh-nodes`` and ``--mesh-data`` launched with
``torch.distributed.run``.

The port runs in four gloo worker processes on the CPU
(``tests/_torch_dist.py``); JAX runs here.
"""

import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import flat_tree, gathered, run_world
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import cheby_conv, device_laplacian
from cnn_graph_tpu.parallel import make_mesh, node_sharded_laplacian

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    z = rng.uniform(size=(48, 2)).astype(np.float32)
    W = gc.knn_graph(z, k=4)
    return gc.laplacian(W, normalized=True)


def _csr(prefix, L):
    return {f"{prefix}L_data": L.data, f"{prefix}L_indices": L.indices,
            f"{prefix}L_indptr": L.indptr, f"{prefix}L_shape":
            np.array(L.shape)}


@pytest.fixture(scope="module")
def step_data():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(8, 48, 4)).astype(np.float32),
            rng.normal(size=(8, 48, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_step(graph, step_data):
    """JAX's single-device sgd step of tests/test_parallel.py."""
    import optax

    from cnn_graph_tpu.models import ResGNN

    model = ResGNN(device_laplacian(graph, fmt="dense"), input_features=4,
                   K=3, nfilter=8, nres_layer_count=1)
    params = model.init(jax.random.PRNGKey(0))
    opt = optax.sgd(0.1)
    x, y = (jnp.asarray(a) for a in step_data)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, x, y)
    updates, _ = opt.update(grads, opt.init(params), params)
    return params, optax.apply_updates(params, updates), float(loss)


@pytest.fixture(scope="module")
def world(graph, step_data, jax_step, tmp_path_factory):
    rng = np.random.default_rng(1)
    inp = {**_csr("", graph), **_csr("R", graph)}
    inp["x_ns"] = rng.normal(size=(48, 16)).astype(np.float32)
    inp["x_conv"] = rng.normal(size=(4, 48, 3)).astype(np.float32)
    inp["w_conv"] = (rng.normal(size=(5, 3, 2)) * 0.1).astype(np.float32)
    inp["x_step"], inp["y_step"] = step_data
    inp.update(flat_tree(jax.tree.map(np.asarray, jax_step[0]), "resgnn."))
    inp["x_fit"] = rng.normal(size=(32, 48, 3)).astype(np.float32)
    inp["y_fit"] = rng.normal(size=(32, 48, 2)).astype(np.float32)
    inp.update(_csr("C", graph))
    inp["x_cls"] = rng.normal(size=(64, 48)).astype(np.float32)
    inp["y_cls"] = rng.integers(0, 3, size=64).astype(np.int64)
    res = run_world("parallel", WORLD, tmp_path_factory.mktemp("parallel"),
                    **inp)
    return types.SimpleNamespace(inp=inp, res=res)


class TestMesh:
    def test_make_mesh_shapes(self, world):
        for r in world.res:
            assert list(r["default_shape"]) == [WORLD, 1]
            assert list(r["shape22"]) == [2, 2]

    def test_bad_factorization(self, world):
        assert all(bool(r["bad_factorization"]) for r in world.res)

    def test_data_sharding_and_replicated(self, world):
        for r in world.res:
            assert bool(r["indivisible_batch"])
            np.testing.assert_array_equal(r["replicated"], 0.0)


class TestNodeShardedLaplacian:
    @pytest.mark.parametrize("nodes", [1, 2, 4])
    def test_matmul_matches_single_chip(self, graph, world, nodes):
        single = device_laplacian(graph, fmt="dense")
        got = gathered(world.res, f"ns_matmul_n{nodes}", mesh=f"n{nodes}")
        Xs = np.zeros((single.m_padded, 16), np.float32)
        Xs[:48] = world.inp["x_ns"]
        want = np.asarray(single.matmul(jnp.asarray(Xs)))
        np.testing.assert_allclose(got[:48], want[:48], atol=1e-4)
        mesh = make_mesh(data=8 // nodes, nodes=nodes)
        sharded = node_sharded_laplacian(graph, mesh)
        assert got.shape[0] == sharded.m_padded

    def test_cheby_conv_over_sharded_operator(self, graph, world):
        single = device_laplacian(graph, fmt="dense")
        got = gathered(world.res, "ns_conv", axis=1, mesh="n2")
        want = np.asarray(cheby_conv(jnp.asarray(world.inp["x_conv"]),
                                     single,
                                     jnp.asarray(world.inp["w_conv"])))
        np.testing.assert_allclose(got[:, :48], want, atol=1e-4)


class TestDataParallelTraining:
    @pytest.mark.parametrize("operator", ["ns", "halo"])
    def test_dp_tp_train_step_matches_single_device(self, world, jax_step,
                                                    operator):
        """One sgd step on a (2 data x 2 nodes) mesh, the all-gather and
        the dense halo operators, equals JAX's single-device step: the
        loss's node sum and the gradients' node sum and data mean."""
        _, want, want_loss = jax_step
        flat = flat_tree(jax.tree.map(np.asarray, want))
        for r in world.res:
            np.testing.assert_allclose(r[f"step_loss_{operator}"], want_loss,
                                       atol=1e-5)
            for path, w in flat.items():
                np.testing.assert_allclose(r[f"step_{operator}.{path}"], w,
                                           atol=1e-4)

    def test_trainer_mesh_matches_one_process(self, world):
        """``Trainer.fit`` with ``TrainConfig(mesh=make_mesh(2, 2))`` on
        ResGNN over the dense halo operator: the parameters and losses
        of the one-process fit."""
        for r in world.res:
            n = sum(1 for k in r if k.startswith("fit_one_")
                    and k != "fit_one_losses")
            assert n > 0
            for i in range(n):
                np.testing.assert_allclose(r[f"fit_mesh_{i}"],
                                           r[f"fit_one_{i}"], atol=1e-4)
            np.testing.assert_allclose(r["fit_mesh_losses"],
                                       r["fit_one_losses"], rtol=1e-4,
                                       atol=1e-5)

    def test_trainer_data_parallel_matches_one_process(self, world):
        """Batch data parallelism over the whole world with dropout: each
        rank keeps its slice of the whole batch's masks, so the fit is the
        one-process fit (JAX's TestMeshDataParallel, tolerances as
        there)."""
        for r in world.res:
            n = sum(1 for k in r if k.startswith("dp_one_")
                    and k != "dp_one_losses")
            for i in range(n):
                np.testing.assert_allclose(r[f"dp_mesh_{i}"], r[f"dp_one_{i}"],
                                           atol=5e-4, rtol=1e-3)
            np.testing.assert_allclose(r["dp_mesh_losses"],
                                       r["dp_one_losses"], rtol=1e-3,
                                       atol=1e-4)


class TestDryRunAndExport:
    def test_dryrun_multichip(self, world):
        for r in world.res:
            assert np.all(np.isfinite(r["dryrun"]))

    def test_dryrun_runs_the_sparse_halo_hops(self, world):
        """The dry run's third part (JAX __graft_entry__.py:138-155): one
        fused hop of each sparse halo format, the same sum on every
        rank."""
        for r in world.res:
            keys = [str(k) for k in r["dryrun_keys"]]
            assert keys[-2:] == ["sparse_bsr", "sparse_banded"]
            assert np.all(r["dryrun"][-2:] > 0)
        first = world.res[0]["dryrun"][-2:]
        for r in world.res[1:]:
            np.testing.assert_allclose(r["dryrun"][-2:], first, rtol=1e-6)

    def test_export_serving_refuses_sharded_operators(self, world):
        assert all(bool(r["export_refused"]) for r in world.res)


def _launch(nproc, module, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_node_classification_driver_mesh_nodes():
    """The driver at ``--mesh-nodes 2 --halo banded --int8`` on two
    ranks against the one-process run: the same graph, weights, masks
    and row padding, so the same test accuracy within 0.01."""
    args = ["--device", "cpu", "--nodes", "4096", "--steps", "20", "--int8"]
    proc = _launch(2, "cnn_graph_tpu_torch.experiments.node_classification",
                   "--mesh-nodes", "2", *args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = subprocess.run(
        [sys.executable, "-m",
         "cnn_graph_tpu_torch.experiments.node_classification", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    out = proc.stdout
    assert "backend gloo (CPU tensors)" in out, out
    assert re.search(r"banded-halo operator: .* mesh \{'data': 1, "
                     r"'nodes': 2\}", out), out
    assert "K1 launches per training step by rank: [0.0, 0.0]" in out, out

    def accs(text):
        acc = re.search(r"train acc ([\d.]+) \| test acc ([\d.]+)", text)
        q = re.search(r"int8 test acc ([\d.]+) \(delta vs f32 ([-+][\d.]+)",
                      text)
        assert acc and q, text
        return float(acc.group(2)), float(q.group(1)), float(q.group(2))

    test_acc, int8_acc, delta = accs(out)
    one_acc, _, _ = accs(one.stdout)
    assert test_acc > 4.0 / 16
    assert abs(test_acc - one_acc) <= 0.01, (test_acc, one_acc)
    assert abs(delta) < 0.05
    assert out.count("test acc") == 2  # rank 0 alone reports


def test_mnist_driver_mesh_data():
    proc = _launch(2, "cnn_graph_tpu_torch.experiments.mnist",
                   "--mesh-data", "2", "--device", "cpu", "--epochs", "1",
                   "--n-train", "200", "--n-val", "100", "--n-test", "100",
                   "--K", "3")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [s for s in proc.stdout.splitlines() if s.startswith("test  ")]
    assert len(lines) == 1 and "accuracy: " in lines[0], proc.stdout
    assert "data-parallel training over mesh {'data': 2, 'nodes': 1}" in (
        proc.stdout)
