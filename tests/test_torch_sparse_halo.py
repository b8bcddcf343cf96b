"""The port's sparse halo operators (``cnn_graph_tpu_torch.parallel.
sparse_halo``) against the JAX package's on its virtual 8-device mesh,
on tests/test_node_classification.py's community graph (256 nodes, C =
16): the per-shard host arrays byte-equal, products and gradients in
f32 within 1e-5 of the max, bf16 on the gather route at JAX's per-block
rounding, the int8 chains bit-identical to JAX's quantized sparse halo
and to the single-chip ``quantize_banded`` chain, the NodeClassifier,
the int8 twins and the export refusal, and the driver's ``--halo
sparse`` and ``sparse-banded`` on two ranks.

The port runs in gloo worker processes on the CPU (``tests/
_torch_dist.py``, one world of 2 and one of 4 ranks); JAX runs here.
BSR and the banded format are each held at 8x8 blocks (JAX's test
shape, tests/test_node_classification.py:214-260) and at 128x128.
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
import scipy.sparse

from _torch_dist import gathered, run_world
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import NodeClassifier
from cnn_graph_tpu.ops import device_laplacian, quantize_banded
from cnn_graph_tpu.parallel import (
    make_mesh,
    quantize_sparse_halo,
    sparse_halo_laplacian,
)
from cnn_graph_tpu.parallel import sparse_halo as jax_sh
from cnn_graph_tpu_torch.parallel import sparse_halo as port_sh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 512  # the most padded rows of any operator here
K_CHAIN = 7


def _community_graph():
    """tests/test_node_classification.py's planted partition: 4
    communities of 64, labels = community, RCM order."""
    rng = np.random.default_rng(0)
    n_per, k = 64, 4
    centers = rng.normal(0, 5, (k, 8))
    z = np.concatenate([centers[c] + rng.normal(0, 1, (n_per, 8))
                        for c in range(k)]).astype(np.float32)
    labels = np.repeat(np.arange(k), n_per)
    order = rng.permutation(len(labels))
    z, labels = z[order], labels[order]
    W = gc.knn_graph(z, k=6)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return gc.laplacian(W, normalized=True), z[perm], labels[perm]


def _rows(rng, m, *shape, dtype=np.float32):
    a = np.zeros((ROWS,) + shape, dtype)
    if dtype == np.int8:
        a[:m] = rng.integers(-100, 100, (m,) + shape)
    else:
        a[:m] = rng.normal(size=(m,) + shape)
    return a


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, tmp_path_factory):
    n = request.param
    L, z, labels = _community_graph()
    m = L.shape[0]
    rng = np.random.default_rng(n)
    inp = {"L_data": L.data, "L_indices": L.indices, "L_indptr": L.indptr,
           "L_shape": np.array(L.shape), "x": _rows(rng, m, 16),
           "x0": _rows(rng, m, 16), "t": _rows(rng, m, 16),
           "xq": _rows(rng, m, 16, dtype=np.int8)}
    dense = device_laplacian(L, fmt="dense")
    nc = NodeClassifier(dense, input_features=8, num_classes=4, hidden=[16],
                        K=3)
    params = nc.init(jax.random.PRNGKey(0))
    for i, layer in enumerate(params["convs"]):
        inp[f"nc_w{i}"] = np.asarray(layer["w"])
        inp[f"nc_b{i}"] = np.asarray(layer["b"])
    mask = np.arange(m) < 100
    inp.update(feats=z.astype(np.float32), labels=labels.astype(np.int64),
               mask=mask)
    res = run_world("sparse", n, tmp_path_factory.mktemp(f"sparse{n}"), **inp)
    mesh = make_mesh(data=8 // n, nodes=n)
    jops = {"bsr8": sparse_halo_laplacian(L, mesh, block_shape=(8, 8)),
            "bsr128": sparse_halo_laplacian(L, mesh),
            "band": sparse_halo_laplacian(L, mesh, fmt="banded"),
            "band8": sparse_halo_laplacian(L, mesh, fmt="banded",
                                           block_shape=(8, 8))}
    jops["bsr8p"] = jops["bsr8"]
    return types.SimpleNamespace(
        n=n, L=L, mesh=mesh, jops=jops, inp=inp, res=res, params=params,
        mask=mask, labels=labels, z=z,
        g=lambda key, axis=0: gathered(res, key, axis))


def _jit(mesh, fn, *args):
    with mesh:
        return np.asarray(jax.jit(fn)(*args))


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


FORMATS = ["bsr8", "bsr8p", "bsr128", "band", "band8"]


class TestHostPlan:
    """The per-shard host arrays, byte-equal to JAX's."""

    def test_shard_arrays_match_jax(self, world):
        for r in world.res:
            s = int(r["coord"][1])
            for name in FORMATS:
                jop = world.jops[name]
                np.testing.assert_array_equal(r[f"{name}_meta"], [
                    jop.m_padded, jop.rows_per_shard, jop.halo,
                    jop.ext_cols_padded])
                np.testing.assert_array_equal(
                    r[f"{name}_send_idx"], np.asarray(jop.send_idx)[s])
                if name.startswith("band"):
                    for f in ("band", "base", "colperm"):
                        np.testing.assert_array_equal(
                            r[f"{name}_{f}"], np.asarray(getattr(jop, f))[s])
                    continue
                nb = r[f"{name}_blocks"].shape[0]
                blocks = np.asarray(jop.blocks)[s]
                np.testing.assert_array_equal(r[f"{name}_blocks"],
                                              blocks[:nb])
                assert not blocks[nb:].any(), "JAX's padding blocks are zero"
                for f in ("block_rows", "block_cols"):
                    np.testing.assert_array_equal(
                        r[f"{name}_{f}"], np.asarray(getattr(jop, f))[s, :nb])

    def test_extended_columns_match_jax_dict_map(self):
        """The vectorised column map against JAX's dict over every
        nonzero (sparse_halo.py:576-586), on a scattered graph whose
        shards need columns of every peer."""
        rng = np.random.default_rng(5)
        W = gc.knn_graph(rng.normal(size=(600, 6)).astype(np.float32), k=6)
        L = gc.rescale_laplacian(gc.laplacian(W, normalized=True)).tocsr()
        n = 4
        mp, ms, H, ext_p, _, locals_ = port_sh._extended_plan(
            L, n, (8, 8), range(n))
        _, _, _, need, _, H_j = port_sh.build_halo_plan(L, n, tile=8)
        assert H == H_j
        Lp = scipy.sparse.csr_matrix((L.data, L.indices, L.indptr),
                                     shape=(L.shape[0], mp))
        Lp.resize(mp, mp)
        for s in range(n):
            block = Lp[s * ms:(s + 1) * ms].tocoo()
            col_map = {int(c): ms + t * H + slot for t in range(n)
                       for slot, c in enumerate(need[s][t])}
            want = np.array([col_map.get(int(c), int(c) - s * ms)
                             for c in block.col], np.int64)
            np.testing.assert_array_equal(locals_[s].col, want)
            np.testing.assert_array_equal(locals_[s].row, block.row)
            assert locals_[s].shape == (ms, ext_p)

    @pytest.mark.parametrize("block_shape", [(128, 128), (8, 8)])
    def test_pack_local_banded_matches_jax(self, world, block_shape):
        L = gc.rescale_laplacian(world.L).tocsr()
        _, ms, _, ext_p, _, locals_ = port_sh._extended_plan(
            L, world.n, block_shape, range(world.n))
        for loc in locals_.values():
            got = port_sh._pack_local_banded(loc, ms, ext_p, block_shape)
            want = jax_sh._pack_local_banded(loc, ms, ext_p, block_shape)
            assert got[4] == want[4]
            for a, b in zip(got[:4] + got[5:], want[:4] + want[5:]):
                np.testing.assert_array_equal(a, b)


class TestProducts:
    @pytest.mark.parametrize("name", FORMATS)
    def test_matmul_and_hop_match_jax(self, world, name):
        jop = world.jops[name]
        mp = jop.m_padded
        x, x0 = (jnp.asarray(world.inp[k][:mp]) for k in ("x", "x0"))
        want = _jit(world.mesh, jop.matmul, x)
        want_hop = _jit(world.mesh, jop.cheby_hop, x, x0)
        _close(world.g(f"{name}_matmul"), want, 1e-5)
        _close(world.g(f"{name}_hop"), want_hop, 1e-5)
        dense = device_laplacian(world.L, fmt="dense")
        xd = jnp.asarray(world.inp["x"][:dense.m_padded])
        m = world.L.shape[0]
        _close(world.g(f"{name}_matmul")[:m],
               np.asarray(dense.matmul(xd))[:m], 1e-5)

    def test_bf16_gather_route_rounds_per_block_as_jax(self, world):
        jop = sparse_halo_laplacian(world.L, world.mesh, block_shape=(8, 8),
                                    dtype=jnp.bfloat16)
        mp = jop.m_padded
        x, x0 = (jnp.asarray(world.inp[k][:mp], jnp.bfloat16)
                 for k in ("x", "x0"))
        for key, fn, args in (("bf16_matmul", jop.matmul, (x,)),
                              ("bf16_hop", jop.cheby_hop, (x, x0))):
            want = _jit(world.mesh, fn, *args).astype(np.float32)
            _close(world.g(key), want, 1e-6)

    @pytest.mark.parametrize("name", FORMATS)
    def test_gradients_match_jax(self, world, name):
        jop = world.jops[name]
        mp = jop.m_padded
        x, x0, t = (jnp.asarray(world.inp[k][:mp]) for k in ("x", "x0", "t"))
        with world.mesh:
            g_mm = jax.jit(jax.grad(lambda v: jnp.sum(jop.matmul(v) * t)))(x)
            g1, g0 = jax.jit(jax.grad(lambda a, b: jnp.sum(
                jop.cheby_hop(a, b) * t), argnums=(0, 1)))(x, x0)
        _close(world.g(f"{name}_grad_mm"), np.asarray(g_mm), 1e-5)
        _close(world.g(f"{name}_grad_hop1"), np.asarray(g1), 1e-5)
        _close(world.g(f"{name}_grad_hop0"), np.asarray(g0), 1e-5)


class TestQuant:
    @pytest.mark.parametrize("name", ["bsr8", "bsr8p", "band", "band8"])
    def test_chain_bitexact_vs_jax_and_single_chip(self, world, name):
        jop = world.jops[name]
        q = quantize_sparse_halo(jop, sample_x=3.0)
        mp = jop.m_padded
        xq = jnp.asarray(world.inp["xq"][:mp])

        def chain(op, x):
            b = [x, op.spmm_q(x)]
            for _ in range(2, K_CHAIN):
                b.append(op.cheby_hop_q(b[-1], b[-2]))
            return jnp.stack(b)

        want = _jit(world.mesh, chain, q, xq)
        got = world.g(f"{name}_qchain", axis=1)
        np.testing.assert_array_equal(got, want)
        sq = quantize_banded(device_laplacian(world.L, fmt="banded",
                                              use_pallas=False), sample_x=3.0)
        single = np.asarray(jax.jit(chain)(
            sq, jnp.asarray(world.inp["xq"][:sq.m_padded])))
        m = world.L.shape[0]
        np.testing.assert_array_equal(got[:, :m], single[:, :m])
        for r in world.res:
            assert float(r[f"{name}_band_scale"]) == q.band_scale
            assert float(r[f"{name}_band_scale"]) == sq.band_scale
            # One int8 exchange: H rows to each of n peers at C = 16.
            assert int(r[f"{name}_traffic_int8"]) == (
                world.n * jop.halo * 16)


class TestConstruction:
    def test_kinds_auto_fallback_and_refusals(self, world):
        for r in world.res:
            assert r["kinds"].all()
            assert r["auto"].all(), ("auto: bsr past the width, else "
                                     "banded, at 8x8 blocks too")
            (wide,) = (str(v) for v in r["refused"])
            assert "band width" in wide and "exceeds 0" in wide


class TestNodeClassifier:
    @pytest.mark.parametrize("name", ["bsr8", "band"])
    def test_logits_loss_and_gradients_match_jax(self, world, name):
        jop = world.jops[name]
        model = NodeClassifier(jop, input_features=8, num_classes=4,
                               hidden=[16], K=3)
        mp, m = jop.m_padded, world.L.shape[0]
        fp = jnp.zeros((mp, 8)).at[:m].set(world.z)
        lab = jnp.zeros((mp,), jnp.int32).at[:m].set(world.labels)
        msk = jnp.zeros((mp,), bool).at[:m].set(world.mask)
        with world.mesh:
            logits = np.asarray(jax.jit(model.apply)(world.params, fp))
            loss, grads = jax.jit(jax.value_and_grad(model.loss))(
                world.params, fp, lab, msk)
        _close(world.g(f"{name}_nc_logits")[:m], logits[:m], 1e-5)
        for r in world.res:
            np.testing.assert_allclose(float(r[f"{name}_nc_loss"]),
                                       float(loss), rtol=1e-5)
            want = [grads["convs"][i][k] for i in range(2)
                    for k in ("w", "b")]
            for i, w in enumerate(want):
                _close(r[f"{name}_nc_grad{i}"], np.asarray(w), 1e-4)

    def test_int8_twins_and_export_refusal(self, world):
        for r in world.res:
            assert r["quant"].all(), r["quant"]
        m = world.L.shape[0]
        for name in ("bsr8", "band"):
            y_f = world.g(f"{name}_nc_logits")[:m]
            y_q = world.g(f"{name}_nc_qlogits")[:m]
            rel = np.linalg.norm(y_q - y_f) / np.linalg.norm(y_f)
            assert rel < 0.15, (name, rel)


def _launch(nproc, module, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.mark.parametrize("halo,kernel,line", [
    ("sparse", "K8", r"sparse-halo operator: \d+ blocks on rank 0, halo \d+"),
    ("sparse-banded", "K5", r"sparse-banded operator: band \(\d+, 128, "
                            r"128\) x \d+ block-rows/shard"),
])
def test_node_classification_driver_sparse_halo(halo, kernel, line):
    """The driver at ``--mesh-nodes 2 --halo {sparse,sparse-banded}
    --int8`` on two ranks: the operator line, the kernel's launches per
    step (0 on the CPU), the accuracies."""
    proc = _launch(2, "cnn_graph_tpu_torch.experiments.node_classification",
                   "--mesh-nodes", "2", "--halo", halo, "--device", "cpu",
                   "--nodes", "2048", "--steps", "10", "--int8")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert re.search(line, out), out
    assert f"{kernel} launches per training step by rank: [0.0, 0.0]" in out
    acc = re.search(r"train acc ([\d.]+) \| test acc ([\d.]+)", out)
    q = re.search(r"int8 test acc ([\d.]+) \(delta vs f32 ([-+][\d.]+)", out)
    assert acc and q, out
    assert float(acc.group(2)) > 2.0 / 16
    assert abs(float(q.group(2))) < 0.05
