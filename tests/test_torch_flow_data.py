"""The port's flow-forecasting data path on the CPU against the JAX
package's: ``stl.decompose``, ``synthetic_flow``,
``community_classification``, every ``HumanTraffic`` loader and
normalizer on ``.mat`` files the test writes, and the RData reader on the
byte streams that ``tests/test_utils_misc.py`` builds for the JAX reader
(the same helpers, copied).

Everything here is float64 NumPy (or the reader's own arrays) computed
the same way in both packages: arrays are held equal byte for byte, no
tolerance."""

import bz2
import gzip
import os
import struct

import numpy as np
import pytest
import scipy.io

from cnn_graph_tpu.data import humantraffic as jax_ht
from cnn_graph_tpu.data import rdata as jax_rdata
from cnn_graph_tpu.data import stl as jax_stl
from cnn_graph_tpu.data import synthetic as jax_synthetic
from cnn_graph_tpu_torch.data import humantraffic, rdata, stl, synthetic


def _equal(a, b):
    """Equal trees of arrays, sparse matrices, dicts, lists and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif hasattr(a, "tocsr"):
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.toarray(), b.toarray())
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == object:  # R strings: compare the values
            assert a.tolist() == b.tolist()
        else:
            assert a.tobytes() == b.tobytes()
    else:
        assert a == b or (a is None and b is None)


@pytest.fixture(scope="module")
def flow_dir(tmp_path_factory):
    """A dataset directory in the reference's ``.mat`` layout: the files
    of JAX's ``tests/test_data.py`` fixture, an ``ln_data.mat`` with
    split traffic, and a directory whose edge matrix isolates node 0."""
    d = tmp_path_factory.mktemp("flow")
    in_m, out_m, edges = jax_synthetic.synthetic_flow(n_nodes=20,
                                                      n_steps=1400, seed=0)
    rng = np.random.default_rng(1)
    frac = rng.uniform(0.3, 0.7, in_m.shape)
    split_in = np.stack([in_m * frac, in_m * (1 - frac)], axis=2)
    frac = rng.uniform(0.3, 0.7, out_m.shape)
    split_out = np.stack([out_m * frac, out_m * (1 - frac)], axis=2)
    split = {"inmatrix": in_m, "outmatrix": out_m,
             "split_in_traffic": split_in, "split_out_traffic": split_out}
    scipy.io.savemat(d / "ln_data.mat", split)
    scipy.io.savemat(d / "split_lndata_street.mat", split)
    scipy.io.savemat(d / "bj_data.mat", {"inmatrix": in_m,
                                         "outmatrix": out_m})
    scipy.io.savemat(d / "lndata_street.mat", {"inmatrix": in_m,
                                               "outmatrix": out_m})
    scipy.io.savemat(d / "edge_matrix.mat", {"edge_matrix": edges})
    in_bad = in_m.copy()
    in_bad[:, 700:705] = -1
    scipy.io.savemat(d / "bj_clus.mat", {"inmatrix": in_bad,
                                         "outmatrix": out_m})
    iso = d / "iso"
    iso.mkdir()
    cut = edges.copy()
    cut[0, :] = cut[:, 0] = 0
    scipy.io.savemat(iso / "edge_matrix.mat", {"edge_matrix": cut})
    scipy.io.savemat(iso / "ln_data.mat", {"inmatrix": in_m,
                                           "outmatrix": out_m})
    return str(d), in_m, out_m


@pytest.mark.parametrize("period,n", [(48, 500), (7, 60), (2, 5)])
def test_stl_decompose_matches_jax(period, n):
    x = np.random.default_rng(period).normal(size=n).cumsum()
    _equal(vars(stl.decompose(x, period)), vars(jax_stl.decompose(x, period)))


def test_stl_decompose_refuses_a_short_series():
    with pytest.raises(ValueError, match="two periods"):
        stl.decompose(np.zeros(10), 6)


@pytest.mark.parametrize("kw", [dict(), dict(n_nodes=7, n_steps=100,
                                             period=10, seed=5)])
def test_synthetic_flow_matches_jax(kw):
    _equal(synthetic.synthetic_flow(**kw), jax_synthetic.synthetic_flow(**kw))


def test_community_classification_matches_jax():
    kw = dict(n=300, d=20, n_communities=4, knn=4, coarsening_levels=2,
              seed=3)
    splits, graphs_, perm = synthetic.community_classification(**kw)
    splits_j, graphs_j, perm_j = jax_synthetic.community_classification(**kw)
    _equal(splits, splits_j)
    _equal(graphs_, graphs_j)
    assert perm == perm_j


def test_city_graph_is_one_copy():
    from cnn_graph_tpu_torch.graphs import construction

    assert synthetic.city_graph is construction.city_graph


# (loader, arguments, subdirectory): every entry point of HumanTraffic.
LOADERS = [
    ("load_ln_data_period", (4, 3, 1), ""),
    ("load_ln_data_period", (2, 1, 5), ""),
    ("load_split_ln_data_period", (3, 3, 2), ""),
    ("load_split_ln_data", (3,), ""),
    ("load_bj_data", (4,), ""),
    ("load_bj_clus_data", (4,), ""),
    ("load_bj_data_period_trend", (4, 3, 1), ""),
    ("load_bj_clus_period_trend", (4,), ""),
    ("load_unisolate_data", (3,), "iso"),
    ("load_data", (3,), ""),
    ("load_lstm_data", (5, 0, "ln_data.mat"), ""),
    ("load_lndata_street", (4,), ""),
]


@pytest.mark.parametrize("name,args,sub", LOADERS)
def test_loaders_match_jax(flow_dir, name, args, sub):
    """Each loader's splits, labels, edge matrix and normalization state
    equal JAX's byte for byte."""
    path = os.path.join(flow_dir[0], sub)
    ht, ht_j = humantraffic.HumanTraffic(path), jax_ht.HumanTraffic(path)
    got, want = getattr(ht, name)(*args), getattr(ht_j, name)(*args)
    _equal(list(got), list(want))
    assert (ht.max_val, ht.min_val) == (ht_j.max_val, ht_j.min_val)
    if name != "load_lstm_data":
        assert got[2].shape[0] == humantraffic.TEST_STEPS


def test_splits_unpack_in_the_reference_order(flow_dir):
    ht = humantraffic.HumanTraffic(flow_dir[0])
    s = ht.dataset_split(np.arange(400)[:, None], np.arange(400)[:, None])
    assert isinstance(s, humantraffic.FlowSplits)
    tr, va, te, trl, val, tel = s
    assert (len(tr), len(va), len(te)) == (185, 47, 168)
    assert tr is s["train_data"] and tel is s["test_labels"]


@pytest.mark.parametrize("name", ["normalize", "normalize_split",
                                  "normalize_seasonal_decompose",
                                  "split_normalize_seasonal_decompose"])
def test_normalizers_match_jax(flow_dir, name):
    """Each normalizer's arrays, its scale and ``reverse_normalize``."""
    mat = scipy.io.loadmat(os.path.join(flow_dir[0], "ln_data.mat"))
    args = [mat["inmatrix"][:6, :400], mat["outmatrix"][:6, :400]]
    if "split" in name:
        args += [mat["split_in_traffic"][:6, :400],
                 mat["split_out_traffic"][:6, :400]]
    ht, ht_j = humantraffic.HumanTraffic("."), jax_ht.HumanTraffic(".")
    got, want = getattr(ht, name)(*args), getattr(ht_j, name)(*args)
    _equal(list(got), list(want))
    assert (ht.max_val, ht.min_val) == (ht_j.max_val, ht_j.min_val)
    _equal(ht.reverse_normalize(got[0]), ht_j.reverse_normalize(want[0]))
    if name == "normalize_seasonal_decompose":
        _equal(ht.seasonal_in_matrix, ht_j.seasonal_in_matrix)
        _equal(ht.seasonal_out_matrix, ht_j.seasonal_out_matrix)


@pytest.mark.parametrize("kw", [dict(seq_period=3, seq_trend=2),
                                dict(start=5)])
def test_make_windows_with_missing_mask_matches_jax(flow_dir, kw):
    _, in_m, out_m = flow_dir
    mask = np.zeros(in_m.shape, bool)
    mask[3, 400:410] = True
    got = humantraffic.HumanTraffic.make_windows(in_m, out_m, 4,
                                                 missing_mask=mask, **kw)
    want = jax_ht.HumanTraffic.make_windows(in_m, out_m, 4,
                                            missing_mask=mask, **kw)
    _equal(list(got), list(want))


# R's XDR serialization, built as tests/test_utils_misc.py builds it.


def _xdr_int(v):
    return struct.pack(">i", v)


def _xdr_sym(name):
    return _xdr_int(1) + _xdr_int(9) + _xdr_int(len(name)) + name.encode()


def _xdr_real_matrix(values, dim):
    out = _xdr_int(14 | 0x200) + _xdr_int(len(values))
    out += struct.pack(f">{len(values)}d", *values)
    out += _xdr_int(2 | 0x400) + _xdr_sym("dim")
    out += _xdr_int(13) + _xdr_int(len(dim))
    for d in dim:
        out += _xdr_int(d)
    return out + _xdr_int(254)


def _xdr_workspace(bindings, version=2):
    body = b"X\n" + _xdr_int(version) + _xdr_int(0x030303) + _xdr_int(
        0x020300)
    if version == 3:
        body += _xdr_int(5) + b"UTF-8"
    for name, payload in bindings:
        body += _xdr_int(2 | 0x400) + _xdr_sym(name) + payload
    body += _xdr_int(254)
    return b"RDX%d\n" % version + body


def _streams():
    """Workspaces of every type the reader takes, in each wrapper."""
    named = (_xdr_int(19 | 0x200) + _xdr_int(1) + _xdr_int(14) + _xdr_int(2)
             + struct.pack(">2d", 5.0, 6.0) + _xdr_int(2 | 0x400)
             + _xdr_sym("names") + _xdr_int(16) + _xdr_int(1) + _xdr_int(9)
             + _xdr_int(3) + b"foo" + _xdr_int(254))
    ints = _xdr_int(13) + _xdr_int(3) + b"".join(
        _xdr_int(v) for v in (7, -1, -2147483648))
    lgl = _xdr_int(10) + _xdr_int(2) + _xdr_int(1) + _xdr_int(-2147483648)
    strs = (_xdr_int(16) + _xdr_int(2) + _xdr_int(9) + _xdr_int(2) + b"ab"
            + _xdr_int(9) + _xdr_int(-1))
    cplx = _xdr_int(15) + _xdr_int(1) + struct.pack(">2d", 1.0, -2.0)
    raw = _xdr_int(24) + _xdr_int(3) + b"\x01\x02\x03"
    # A binding whose dim tag is a back-reference (REFSXP 0x2FF: the
    # symbols read so far are m, dim, y, so reference 2 is "dim").
    y = (_xdr_int(14 | 0x200) + _xdr_int(2) + struct.pack(">2d", 1.5, 2.5)
         + _xdr_int(2 | 0x400) + _xdr_int(0x2FF) + _xdr_int(13)
         + _xdr_int(2) + _xdr_int(1) + _xdr_int(2) + _xdr_int(254))
    ws = _xdr_workspace([
        ("m", _xdr_real_matrix(np.arange(6.0), (2, 3))), ("y", y),
        ("lst", named), ("xs", ints), ("flags", lgl), ("ss", strs),
        ("z", cplx), ("r", raw)])
    ws3 = _xdr_workspace([("v", _xdr_real_matrix([4.25], (1, 1)))], 3)
    rds = (b"X\n" + _xdr_int(2) + _xdr_int(0x030303) + _xdr_int(0x020300)
           + _xdr_real_matrix(np.arange(4.0), (2, 2)))
    import lzma

    return {"plain": ws, "gzip": gzip.compress(ws), "bzip2": bz2.compress(ws),
            "xz": lzma.compress(ws, format=lzma.FORMAT_XZ), "v3": ws3,
            "rds": rds}


@pytest.mark.parametrize("kind", ["plain", "gzip", "bzip2", "xz", "v3",
                                  "rds"])
def test_parse_rdata_bytes_matches_jax(kind):
    raw = _streams()[kind]
    got, want = rdata.parse_rdata_bytes(raw), jax_rdata.parse_rdata_bytes(raw)
    _equal(got, want)
    if kind == "plain":
        np.testing.assert_array_equal(got["m"],
                                      np.arange(6.0).reshape(2, 3, order="F"))
        np.testing.assert_array_equal(got["y"], [[1.5, 2.5]])
        assert got["lst"]["foo"].tolist() == [5.0, 6.0]
        assert got["flags"].tolist() == [1, -1] and got["ss"][1] is None


def test_rdata_to_mat_and_its_refusal(tmp_path):
    p = tmp_path / "flow.RData"
    p.write_bytes(gzip.compress(_streams()["v3"]))
    out = rdata.rdata_to_mat(str(p), str(tmp_path / "flow.mat"))
    back = scipy.io.loadmat(str(tmp_path / "flow.mat"))
    np.testing.assert_array_equal(back["v"], out["v"])
    _equal(out, jax_rdata.rdata_to_dict(str(p)))
    bad = tmp_path / "env.RData"
    bad.write_bytes(b"RDX2\nX\n" + _xdr_int(2) + _xdr_int(0) + _xdr_int(0)
                    + _xdr_int(4))  # ENVSXP: outside the reader's subset
    with pytest.raises(RuntimeError, match="cannot read"):
        rdata.rdata_to_dict(str(bad))
