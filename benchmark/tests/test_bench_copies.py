"""The benchmark's frozen copies give the same arrays as the program's at
small sizes, and the work rule gives hand-worked counts."""

import numpy as np
import pytest
import torch

from harness import data, graphs
from harness import work as W


def _same_sparse(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("side", [12, 30])
def test_city_graph(side):
    from cnn_graph_tpu_torch.graphs import construction

    L, pos = graphs.city_graph(side, 8, 0, 0.3)
    Lp, posp = construction.city_graph(side, k=8, seed=0)
    _same_sparse(L, Lp)
    np.testing.assert_array_equal(pos, posp)
    R = construction.rescale_laplacian(Lp).tocsr()
    R.eliminate_zeros()
    _same_sparse(graphs.rescale_laplacian(L), R)


def test_grid_graph_coarsening_and_perm():
    from cnn_graph_tpu_torch.data import mnist
    from cnn_graph_tpu_torch.graphs import coarsening, construction

    Wg = graphs.grid_knn_graph(28, 8)
    _same_sparse(Wg, construction.knn_graph(construction.grid(28), k=8))
    ours, perm = graphs.coarsen(Wg, 4, 2017)
    theirs, perm_p = coarsening.coarsen(Wg, levels=4, seed=2017)
    assert list(perm) == list(perm_p)
    for a, b in zip(ours, theirs):
        _same_sparse(a, b)
        _same_sparse(graphs.laplacian(a),
                     construction.laplacian(b, normalized=True))
    x = np.random.default_rng(0).random((5, 784)).astype(np.float32)
    np.testing.assert_array_equal(graphs.perm_data(x, perm),
                                  coarsening.perm_data(x, perm_p))
    splits = data.synthetic_mnist(40, 10, 10, seed=3)
    _, Ls, perm_m = mnist.mnist_graph_data(splits, seed=2017)
    assert list(perm_m) == list(perm)
    for a, b in zip(ours, Ls):
        _same_sparse(graphs.laplacian(a), b)


@pytest.mark.parametrize("seed", [0, 2017, 3_000_000_017])
def test_synthetic_mnist(seed):
    from cnn_graph_tpu_torch.data import mnist

    ours = data.synthetic_mnist(60, 20, 30, seed)
    theirs = mnist.synthetic_mnist(60, 20, 30, seed)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_planted_partition_labels_and_features():
    import chip_smoke

    _, pos = graphs.city_graph(16, 8, 0, 0.3)
    labels = data.patch_labels(pos, chip_smoke.CLASSES)
    labels_p, _ = chip_smoke.request_features(pos, 1)
    np.testing.assert_array_equal(labels, labels_p.numpy())
    gen = torch.Generator().manual_seed(5)
    a, b = data.planted_features(torch.from_numpy(labels), 16, 8, 2, gen)
    again = data.planted_features(torch.from_numpy(labels), 16, 8, 2,
                                  torch.Generator().manual_seed(5))
    assert torch.equal(a, again[0]) and torch.equal(b, again[1])
    # One signature per class, shared by both matrices: their difference
    # is noise alone, of variance 2.
    assert abs(float((a - b).var()) - 2.0) < 0.3
    sig = (a + b) / 2
    for c in range(16):
        rows = sig[torch.from_numpy(labels) == c]
        if len(rows) > 20:
            assert float((rows - rows.mean(0)).var()) < 0.8


def test_weights_from_seed():
    gen = torch.Generator().manual_seed(1)
    w = data.weights_from_seed({"a": (3, 40, 50), "b": (7,)}, gen)
    assert w["a"].shape == (3, 40, 50) and w["b"].shape == (7,)
    assert float(w["a"].abs().max()) <= 0.2
    assert abs(float(w["a"].std()) - 0.088) < 0.01  # N(0, .1) folded at 2s


def test_work_rule_by_hand():
    h = W.hop(nnz=10, m=4, cols=3, op_dtype="bfloat16", x_dtype="bfloat16",
              operands=3)
    assert (h.flops, h.int_ops, h.bytes) == (60, 0, 10 * 2 + 3 * 4 * 3 * 2)
    q = W.hop(10, 4, 3, "int8", "int8", 2)
    assert (q.flops, q.int_ops, q.bytes) == (0, 60, 10 + 2 * 12)
    assert q.compute_s() == 60 / W.PEAK_INT8
    d = W.dense(2, 3, 4)
    assert (d.flops, d.bytes) == (48, (6 + 12 + 8) * 4)
    f = W.fused_conv(nnz=10, m=4, batch=2, fin=3, fout=5, K=3,
                     dtype="float32")
    assert f.flops == 2 * 10 * 6 * 2 + 2 * 3 * 4 * 2 * 3 * 5
    assert f.bytes == 2 * 10 * 4 + 4 * 6 * 4 + 3 * 3 * 5 * 4 + 4 * 2 * 5 * 4
    assert f.least_s() == max(f.flops / W.PEAK_FLOAT, f.bytes / W.PEAK_BYTES)
    assert (d * 2 + h).flops == 2 * 48 + 60


def test_family_work_counts(manifest):
    """The 50k cells' K1 launches as chip_smoke.py counts them (24 a
    request's conv, 72 a deep step) and their operations by hand."""
    from conftest import TINY

    cell = manifest.cell("nodecls-city50k-train-deep-bf16")
    cfg, traffic = manifest.config(cell), manifest.traffic(cell)
    cfg.update(TINY[cell["name"]]["config"], K=25)
    sess = manifest.entry(traffic).session(cfg, traffic, 1,
                                           torch.device("cpu"))
    w = sess.work()["step"]
    m, nnz = 256, sess.p.nnz
    k1 = w["kernels"]["band_rows_kernel"]
    assert len(k1) == 72
    assert sum(x.flops for x in k1) == 72 * 2 * nnz * 32
    taps = 2 * m * 32 * 32 * 25 + 2 * m * 32 * 4 * 25
    assert w["total"].flops == (sum(x.flops for x in k1) + 2 * taps
                                + 2 * m * 4 * 32 * 25)


def test_chebnet_work_follows_the_configured_route(manifest):
    """The route comes from the configuration: a fused conv 1 adds K2's
    forward, K3's dW and K2's dx launches, and its dW recomputes the
    hops; the stacked route counts dx (injections and the adjoint hops)
    as well: the two steps differ by the dW hops on ``fout`` columns."""
    from conftest import EXTRA

    cell = dict(EXTRA["chebnet-mnist-train-f32"],
                name="chebnet-mnist-train-f32")
    steps, kernels = {}, {}
    for route in ([False, True], [False, False]):
        cfg, traffic = manifest.config(cell), manifest.traffic(cell)
        cfg.update(fused_convs=route, M=[64, 10])
        traffic.update(n_train=200, n_val=100)
        sess = manifest.entry(traffic).session(cfg, traffic, 1,
                                               torch.device("cpu"))
        w = sess.work()["step"]
        steps[route[1]] = w["total"].flops
        kernels[route[1]] = len(w["kernels"]["cheby_conv_kernel"])
    m, nnz, K = sess.p.conv(1)
    B, fin, fout = 100, 32, 64
    assert (m, K) == (244, 25)
    assert kernels == {True: 3, False: 0}
    assert steps[True] - steps[False] == (K - 1) * 2 * nnz * B * fout
    assert fin < fout
