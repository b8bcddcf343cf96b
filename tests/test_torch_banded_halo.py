"""The port's banded halo operator (``cnn_graph_tpu_torch.parallel.
banded_halo``) against the JAX package's on its virtual 8-device mesh:
tests/test_banded_halo.py case for case, at its tolerances (float 1e-4
and 1e-5, int8 bit-exact).

The port runs in four gloo worker processes on the CPU
(``tests/_torch_dist.py``, one world for the whole module); JAX runs
here, and the two meet as NumPy arrays.  Each rank returns its rows;
``gathered`` puts the global array back together.  Both sides take
``rows_per_step`` explicitly: JAX sizes G by its TPU VMEM model, which
the port does not have, and G changes the padding, not the result.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import gathered, run_world
from cnn_graph_tpu.data.synthetic import city_graph
from cnn_graph_tpu.ops import device_laplacian
from cnn_graph_tpu.parallel import banded_halo_laplacian, make_mesh
from cnn_graph_tpu_torch.parallel import banded_halo as port_bh

G = 2
WORLD = 4


def _pad(rng, mp, m, *shape):
    a = np.zeros((mp,) + shape, np.float32)
    a[:m] = rng.normal(size=(m,) + shape)
    return a


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    L, _ = city_graph(40, k=8, seed=0)  # 1600 nodes, bandable
    mesh = make_mesh(data=2, nodes=WORLD)
    op = banded_halo_laplacian(L, mesh, rows_per_step=G)
    split = banded_halo_laplacian(L, mesh, rows_per_step=1)
    ref = device_laplacian(L, fmt="dense")
    m, mp = op.m, op.m_padded
    rng = np.random.default_rng(0)
    inp = {"L_data": L.data, "L_indices": L.indices, "L_indptr": L.indptr,
           "L_shape": np.array(L.shape), "G": np.int64(G)}
    inp.update(x64=_pad(rng, mp, m, 64), x32=_pad(rng, mp, m, 32),
               x1=_pad(rng, mp, m, 32), x0=_pad(rng, mp, m, 32),
               x16=_pad(rng, mp, m, 16))
    inp["s1"] = rng.normal(size=(split.m_padded, 32)).astype(np.float32)
    inp["s0"] = rng.normal(size=(split.m_padded, 32)).astype(np.float32)
    inp["xc"] = rng.normal(size=(mp, 32)).astype(np.float32)
    for K in (1, 2, 3, 6):
        inp[f"xg{K}"] = rng.normal(size=(mp, 8)).astype(np.float32)
        inp[f"t{K}"] = rng.normal(size=(K, mp, 8)).astype(np.float32)
    xb = np.zeros((1, mp, 3), np.float32)
    xb[0, :m] = rng.normal(size=(m, 3))
    inp["xb"] = xb
    xq = rng.integers(-100, 100, (mp, 16)).astype(np.int8)
    inp["xq16"] = xq
    xq32 = rng.integers(-100, 100, (mp, 32)).astype(np.int8)
    xq32[m:] = 0
    inp["xq32"] = xq32
    inp["q1"] = rng.integers(-100, 100, (split.m_padded, 16)).astype(np.int8)
    inp["q0"] = rng.integers(-100, 100, (split.m_padded, 16)).astype(np.int8)
    xconv = np.zeros((1, mp, 16), np.float32)
    xconv[:, :m] = rng.normal(size=(1, m, 16))
    inp["x_conv"] = xconv
    inp["w_conv"] = (rng.normal(size=(6, 16, 8)) * 0.2).astype(np.float32)

    from cnn_graph_tpu.models import NodeClassifier

    srv = NodeClassifier(op, input_features=16, num_classes=4, hidden=[8],
                         K=4)
    srv_params = srv.init(jax.random.PRNGKey(0))
    nc = NodeClassifier(op, input_features=8, num_classes=2, hidden=[8],
                        K=3, dropout=1.0)
    nc_params = nc.init(jax.random.PRNGKey(0))
    for pre, params in (("srv_", srv_params), ("nc_", nc_params)):
        for i, layer in enumerate(params["convs"]):
            inp[f"{pre}w{i}"] = np.asarray(layer["w"])
            inp[f"{pre}b{i}"] = np.asarray(layer["b"])
    labels = (rng.random(mp) < 0.5).astype(np.int64)
    feats = np.zeros((mp, 8), np.float32)
    feats[:m] = labels[:m, None] + 0.3 * rng.normal(size=(m, 8))
    mask = np.zeros(mp, bool)
    mask[:m] = True
    inp.update(feats=feats, labels=labels, mask=mask)

    res = run_world("banded", WORLD, tmp_path_factory.mktemp("banded"),
                    **inp)
    return types.SimpleNamespace(
        L=L, mesh=mesh, op=op, split=split, ref=ref, inp=inp, res=res,
        srv=srv, srv_params=srv_params, nc=nc, nc_params=nc_params,
        g=lambda key, axis=0: gathered(res, key, axis))


def _jit(mesh, fn, *args):
    with mesh:
        return np.asarray(jax.jit(fn)(*args))


class TestPlan:
    """The host plan, byte-equal to the JAX builder's arrays."""

    @pytest.mark.parametrize("rows_per_step,ragged,force", [
        (2, True, 0), (1, True, 0), (2, False, 0), (2, True, 3)])
    def test_plan_matches_jax(self, setup, rows_per_step, ragged, force):
        jop = banded_halo_laplacian(
            setup.L, setup.mesh, rows_per_step=rows_per_step,
            use_pallas=ragged, ragged=ragged, force_boundary=force)
        from cnn_graph_tpu.graphs.construction import rescale_laplacian

        Lr = rescale_laplacian(setup.L, lmax=2.0).tocsr()
        Lr.eliminate_zeros()
        p = port_bh._plan(Lr, WORLD, rows_per_step, 48, ragged, force,
                          dkw=ragged)
        assert (p["halo_left"], p["halo_right"], p["boundary_pre"],
                p["boundary_suf"], p["overlap"], p["mp"]) == (
            jop.halo_left, jop.halo_right, jop.boundary_pre,
            jop.boundary_suf, jop.overlap, jop.m_padded)
        assert p["levels"] == tuple(jop.levels)
        np.testing.assert_array_equal(p["base"], np.asarray(jop.base))
        np.testing.assert_array_equal(p["band"], np.asarray(jop.band))
        names = ("sched", "sched_int", "sched_suf", "sched_dkw",
                 "sched_dkw_int", "sched_dkw_suf") if ragged else ()
        for name in names:
            np.testing.assert_array_equal(p[name],
                                          np.asarray(getattr(jop, name)))
        if ragged:
            assert len(p["bands_dkw"]) == len(jop.bands_dkw)
            for a, b in zip(p["bands_dkw"], jop.bands_dkw):
                np.testing.assert_array_equal(a, np.asarray(b))


class TestBandedHalo:
    def test_ragged_default_matches_uniform_exactly(self, setup):
        assert setup.res[0]["levels"].size, "ragged is the default"
        got_r, got_u = setup.g("chain5_op", 1), setup.g("chain5_uni", 1)
        np.testing.assert_allclose(got_r, got_u, atol=1e-5)
        want = _jit(setup.mesh, lambda o, v: o.cheby_chain(v, 5), setup.op,
                    jnp.asarray(setup.inp["x32"]))
        np.testing.assert_allclose(got_r, want, atol=1e-5)

    def test_matmul_matches_dense(self, setup):
        m = setup.op.m
        got = setup.g("matmul_op")
        xr = np.zeros((setup.ref.m_padded, 64), np.float32)
        xr[:m] = setup.inp["x64"][:m]
        want = np.asarray(setup.ref.matmul(jnp.asarray(xr)))
        np.testing.assert_allclose(got[:m], want[:m], atol=1e-4)
        np.testing.assert_allclose(got[m:], 0.0, atol=1e-5)
        sharded = _jit(setup.mesh, lambda o, v: o.matmul(v), setup.op,
                       jnp.asarray(setup.inp["x64"]))
        np.testing.assert_allclose(got, sharded, atol=1e-5)

    def test_cheby_hop_matches_dense(self, setup):
        m = setup.op.m
        got = setup.g("hop")
        x1 = np.zeros((setup.ref.m_padded, 32), np.float32)
        x0 = np.zeros_like(x1)
        x1[:m], x0[:m] = setup.inp["x1"][:m], setup.inp["x0"][:m]
        want = np.asarray(setup.ref.cheby_hop(jnp.asarray(x1),
                                              jnp.asarray(x0)))
        np.testing.assert_allclose(got[:m], want[:m], atol=1e-4)

    def test_gradients_match_dense(self, setup):
        m = setup.op.m
        got = setup.g("hop_grad")

        def f(o, v):
            return jnp.sum(o.cheby_hop(v, 0.5 * v) ** 2)

        xr = np.zeros((setup.ref.m_padded, 16), np.float32)
        xr[:m] = setup.inp["x16"][:m]
        gr = np.asarray(jax.grad(lambda v: f(setup.ref, v))(jnp.asarray(xr)))
        np.testing.assert_allclose(got[:m], gr[:m], rtol=1e-3, atol=1e-4)
        gs = _jit(setup.mesh, jax.grad(f, argnums=1), setup.op,
                  jnp.asarray(setup.inp["x16"]))
        np.testing.assert_allclose(got, gs, rtol=1e-3, atol=1e-4)

    def test_halo_extents_are_tight(self, setup):
        op = setup.op
        for r in setup.res:
            mp, h_l, h_r, _, _, _, ms = r["op_meta"]
            assert (mp, h_l, h_r, ms) == (op.m_padded, op.halo_left,
                                         op.halo_right, op.rows_per_shard)
        nbr_s = op.rows_per_shard // 128
        assert 0 < op.halo_left <= nbr_s
        assert 0 <= op.halo_right <= nbr_s
        assert op.halo_left + op.halo_right < 2 * nbr_s

    def test_overlap_split_matches_unsplit(self, setup):
        meta = setup.res[0]["split_meta"]
        assert meta[5] and (meta[3] or meta[4]), meta
        np.testing.assert_array_equal(setup.g("split_y_split"),
                                      setup.g("split_y_flat"))
        np.testing.assert_array_equal(setup.g("split_g_split"),
                                      setup.g("split_g_flat"))
        want = np.asarray(setup.ref.cheby_hop(
            jnp.asarray(setup.inp["s1"][:setup.ref.m_padded]),
            jnp.asarray(setup.inp["s0"][:setup.ref.m_padded])))
        m = setup.op.m
        np.testing.assert_allclose(setup.g("split_y_split")[:m], want[:m],
                                   atol=1e-4)

    def test_too_many_shards_raises(self):
        L, _ = city_graph(16, k=8, seed=0)  # 256 nodes -> 2 block rows
        mesh8 = types.SimpleNamespace(shape={"data": 1, "nodes": 8})
        with pytest.raises(ValueError):
            port_bh.banded_halo_laplacian(L, mesh8)
        with pytest.raises(ValueError):
            banded_halo_laplacian(L, make_mesh(data=1, nodes=8))

    def test_node_classifier_matches_jax(self, setup):
        nc, params = setup.nc, setup.nc_params
        x, y, msk = (jnp.asarray(setup.inp[k])
                     for k in ("feats", "labels", "mask"))
        with setup.mesh:
            logits = np.asarray(jax.jit(nc.apply)(params, x))
            loss, grads = jax.jit(jax.value_and_grad(nc.loss))(
                params, x, y, msk)
        np.testing.assert_allclose(setup.g("nc_logits"), logits, atol=1e-4)
        r0 = setup.res[0]
        np.testing.assert_allclose(r0["nc_loss"], float(loss), atol=1e-5)
        flat = [grads["convs"][i][k] for i in range(2) for k in ("w", "b")]
        for i, g in enumerate(flat):
            for r in setup.res:  # every rank holds the global gradient
                np.testing.assert_allclose(r[f"nc_grad{i}"], np.asarray(g),
                                           atol=1e-4)

    def test_node_classifier_trains_through(self, setup):
        losses = setup.res[0]["nc_losses"]
        assert np.all(np.isfinite(losses))
        assert losses[-1] < losses[0] * 0.5, losses
        for r in setup.res[1:]:
            np.testing.assert_array_equal(r["nc_losses"], losses)


class TestChebyChain:
    def test_chain_bitexact_vs_per_hop(self, setup):
        got, per_hop = setup.g("chain7", 1), setup.g("chain7_hops", 1)
        np.testing.assert_array_equal(got, per_hop)
        want = _jit(setup.mesh, lambda o, v: o.cheby_chain(v, 7), setup.op,
                    jnp.asarray(setup.inp["xc"]))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_chain_grad_matches_per_hop_autodiff(self, setup):
        g_chain, g_hops = setup.g("g6_chain"), setup.g("g6_hops")
        np.testing.assert_allclose(g_chain, g_hops, atol=2e-4, rtol=1e-5)
        t = jnp.asarray(setup.inp["t6"])
        want = _jit(setup.mesh, jax.grad(
            lambda v: jnp.sum(setup.op.cheby_chain(v, 6) * t)),
            jnp.asarray(setup.inp["xg6"]))
        np.testing.assert_allclose(g_chain, want, atol=1e-4)

    def test_chain_and_adjoint_through_the_split(self, setup):
        """The chain and its adjoint on the overlap operator (prefix,
        interior and suffix passes per hop) against JAX's operator with
        the same split."""
        meta = setup.res[0]["split_meta"]
        assert meta[5] and (meta[3] or meta[4]), meta
        split = setup.split
        t = jnp.asarray(setup.inp["t6"][:, :split.m_padded])
        x = jnp.asarray(setup.inp["xg6"][:split.m_padded])
        y = _jit(setup.mesh, lambda o, v: o.cheby_chain(v, 6), split, x)
        g = _jit(setup.mesh, jax.grad(
            lambda v: jnp.sum(split.cheby_chain(v, 6) * t)), x)
        np.testing.assert_allclose(setup.g("y6_split", 1), y, atol=1e-4)
        np.testing.assert_allclose(setup.g("g6_split"), g, atol=1e-4)

    @pytest.mark.parametrize("K", [1, 2, 3])
    def test_chain_small_K_edge_cases(self, setup, K):
        np.testing.assert_array_equal(setup.g(f"y{K}_chain", 1),
                                      setup.g(f"y{K}_hops", 1))
        np.testing.assert_allclose(setup.g(f"g{K}_chain"),
                                   setup.g(f"g{K}_hops"), atol=2e-4,
                                   rtol=1e-5)

    def test_cheby_basis_dispatches_chain(self, setup):
        from cnn_graph_tpu.ops import cheby_basis

        m = setup.op.m
        got = setup.g("basis", 2)[:, :, :m]
        x = jnp.asarray(setup.inp["xb"][:, :m])
        want = np.asarray(jax.jit(lambda o, v: cheby_basis(v, o, 5))(
            setup.ref, x))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_dkw_layout_matches_ragged(self, setup):
        """The deep-K-window layout (K1's, ``use_pallas=True``) through
        the kernel's plain version on the CPU: the ragged operator's
        products, in another summation order."""
        np.testing.assert_allclose(setup.g("matmul_dkw"),
                                   setup.g("matmul_op"), atol=1e-5)
        np.testing.assert_allclose(setup.g("chain5_dkw", 1),
                                   setup.g("chain5_op", 1), atol=1e-5)


class TestQuantBandedHalo:
    def test_chain_bitexact_vs_single_chip(self, setup):
        from cnn_graph_tpu.ops import quantize_banded

        sop = device_laplacian(setup.L, fmt="banded", use_pallas=False,
                               dtype=jnp.float32)
        sq = quantize_banded(sop, sample_x=3.0)
        assert np.isclose(float(setup.res[0]["band_scale"]), sq.band_scale,
                          rtol=1e-6)
        m = setup.op.m
        xq = np.zeros((sq.m_padded, 32), np.int8)
        xq[:m] = setup.inp["xq32"][:m]

        def chain(q, x, K=9):
            b = [x, q.spmm_q(x)]
            for _ in range(2, K):
                b.append(q.cheby_hop_q(b[-1], b[-2]))
            return jnp.stack(b)

        want = np.asarray(jax.jit(chain)(sq, jnp.asarray(xq)))
        for key in ("qchain9", "qchain9_dkw"):
            np.testing.assert_array_equal(setup.g(key, 1)[:, :m],
                                          want[:, :m])

    def test_quant_chain_bitexact_vs_per_hop(self, setup):
        from cnn_graph_tpu.parallel import quantize_banded_halo

        got = setup.g("qchain", 1)
        np.testing.assert_array_equal(got, setup.g("qchain_hops", 1))
        qop = quantize_banded_halo(setup.op, sample_x=3.0)
        want = _jit(setup.mesh, lambda o, v: o.cheby_chain_q(v, 6), qop,
                    jnp.asarray(setup.inp["xq16"]))
        np.testing.assert_array_equal(got, want)

    def test_overlap_split_matches_unsplit_int8(self, setup):
        np.testing.assert_array_equal(setup.g("qsplit_split"),
                                      setup.g("qsplit_flat"))

    def test_cheby_conv_and_model_serving(self, setup):
        from cnn_graph_tpu.ops import cheby_conv

        assert bool(setup.res[0]["quant_is_halo"])
        m = setup.op.m
        got = setup.g("qconv", 1)[:, :m]
        xr = np.zeros((1, setup.ref.m_padded, 16), np.float32)
        xr[:, :m] = setup.inp["x_conv"][:, :m]
        want = np.asarray(jax.jit(cheby_conv)(
            jnp.asarray(xr), setup.ref, jnp.asarray(setup.inp["w_conv"])))
        rel = np.linalg.norm(got - want[:, :m]) / np.linalg.norm(want[:, :m])
        assert rel < 0.12, rel
        y_f, y_q = setup.g("y_f"), setup.g("y_q")
        rel_m = np.linalg.norm(y_q - y_f) / np.linalg.norm(y_f)
        assert rel_m < 0.15, rel_m
        with setup.mesh:
            want_f = np.asarray(jax.jit(setup.srv.apply)(
                setup.srv_params, jnp.asarray(setup.inp["x_conv"][0])))
        np.testing.assert_allclose(y_f, want_f, atol=1e-4)

    def test_halo_payload_is_int8(self, setup):
        """The exchanged halo is int8: every byte a rank sent in one int8
        product, and a middle rank's are both halos' rows."""
        op = setup.op
        for r in setup.res:
            assert r["traffic_int8"] > 0
            assert r["traffic_int8"] == r["traffic_all"]
        mid = [r for r in setup.res if 0 < int(r["coord"][1]) < WORLD - 1]
        for r in mid:
            assert r["traffic_int8"] == (
                (op.halo_left + op.halo_right) * 128 * 16)
