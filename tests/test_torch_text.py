"""The port's text pipeline (``data/text.py``) and the 20NEWS topology
cell on the CPU against the JAX package and scikit-learn, on the same
NumPy inputs.

Held exactly: ``clean_text`` in every ``num`` mode, ``vectorize`` (the
vocabulary and the CSR arrays: CountVectorizer's, with the stop list
equal to scikit-learn's set), ``normalize`` (scikit-learn's arrays, l1,
l2 and max), ``remove_short_documents``, ``keep_top_words``,
``synthetic_text_dataset``, the word2vec reader, ``Text20News`` on a
cache written here with scikit-learn (documents, labels and order of
``fetch_20newsgroups``), and RCV1's ``remove_classes`` and
``select_documents`` on arrays.

``embed`` runs the same SciPy ``svds``: held up to a sign per column
(the kNN graph does not see it).  The kNN graph: the dense route's W
exactly; the ``"auto"`` route (a ``cKDTree`` here, scikit-learn's
``NearestNeighbors`` in JAX) the same neighbours of every word and W
within 1e-6 of its largest entry, since scikit-learn computes the
distances of float32 points by another formula (differences of about
1e-7).

The 20NEWS cell at 400 documents (bench.py:619-741 cut down): W, the
RCM permutation and L equal, the ``auto`` format dense in both, the bf16
K=5 ``cheby_finals`` chain within 2e-2 of its largest entry (bf16
carries summed in another order), the int8 chain bit-exact, and the
NodeClassifier trained in JAX and carried over: bf16 and int8 test
accuracy within 0.005 of JAX's (a node whose top two logits nearly tie
may flip)."""

import codecs
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse
import sklearn.datasets
import sklearn.preprocessing
import torch
from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS as SK_STOP
from sklearn.utils import Bunch

from cnn_graph_tpu.data import text as jtext
from cnn_graph_tpu.graphs import construction as jgc
from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.ops import cheby_finals as jax_cheby_finals
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import quantize_dense as jax_quantize_dense
from cnn_graph_tpu_torch.convert import node_classifier_params_from_jax
from cnn_graph_tpu_torch.data import text
from cnn_graph_tpu_torch.data.stop_words import ENGLISH_STOP_WORDS
from cnn_graph_tpu_torch.graphs import construction as gc
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.ops import (
    DenseLaplacian,
    cheby_finals,
    device_laplacian,
    quantize_dense,
)

CSR_FIELDS = ("indptr", "indices", "data")


def _same_csr(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _pair(**kw):
    """The same synthetic corpus from both packages, with digits, a
    dollar sign and stop words appended so every cleaning rule acts."""
    a = text.synthetic_text_dataset(**kw)
    b = jtext.synthetic_text_dataset(**kw)
    assert a.documents == b.documents
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.class_names == b.class_names
    extra = [f" the 4{i} and $ {i % 7}x our" for i in range(len(a.documents))]
    a.documents = [d + e for d, e in zip(a.documents, extra)]
    b.documents = [d + e for d, e in zip(b.documents, extra)]
    return a, b


@pytest.mark.parametrize("num", ["substitute", "spell", "remove", "keep"])
def test_clean_text_matches_jax(num):
    a, b = _pair(n_docs=60, vocab_size=80, seed=3)
    a.clean_text(num=num)
    b.clean_text(num=num)
    assert a.documents == b.documents


def test_stop_list_is_scikit_learns():
    assert ENGLISH_STOP_WORDS == SK_STOP


@pytest.mark.parametrize("stop_words", [None, "english", ["wbaaa", "one"]])
def test_vectorize_matches_scikit_learn(stop_words):
    a, b = _pair(n_docs=150, vocab_size=300, seed=4)
    for ds in (a, b):
        ds.clean_text(num="spell")
        ds.vectorize(stop_words=stop_words)
    assert a.vocab == b.vocab and len(a.vocab) > 100
    assert type(a.data) is type(b.data)
    _same_csr(a.data, b.data)


def test_vectorize_refuses_unported_parameters():
    a, _ = _pair(n_docs=10, vocab_size=20, seed=0)
    with pytest.raises(NotImplementedError, match="max_df"):
        a.vectorize(max_df=0.5)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_normalize_matches_scikit_learn(norm):
    a, _ = _pair(n_docs=120, vocab_size=200, seed=5)
    a.clean_text()
    a.vectorize()
    X = a.data.copy()
    X[3] = 0  # an empty row stays empty
    X.eliminate_zeros()
    a.data = X
    a.normalize(norm)
    want = sklearn.preprocessing.normalize(X.astype(np.float64), axis=1,
                                           norm=norm)
    _same_csr(a.data, want)


def test_filters_and_embedding_match_jax():
    """``remove_short_documents`` (both vocab modes), ``keep_top_words``,
    ``normalize`` and ``embed`` through both packages; embeddings equal
    up to a sign per column."""
    a, b = _pair(n_docs=300, vocab_size=600, seed=6)
    for ds in (a, b):
        ds.clean_text()
        ds.vectorize()
    np.testing.assert_array_equal(
        a.remove_short_documents(62, vocab="full"),
        b.remove_short_documents(62, vocab="full"))
    np.testing.assert_array_equal(a.remove_short_documents(55),
                                  b.remove_short_documents(55))
    np.testing.assert_array_equal(a.keep_top_words(400, Mprint=0),
                                  b.keep_top_words(400, Mprint=0))
    assert a.vocab == b.vocab and a.documents == b.documents
    np.testing.assert_array_equal(a.labels, b.labels)
    _same_csr(a.data, b.data)
    for ds in (a, b):
        ds.normalize("l1")
    _same_csr(a.data, b.data)
    ea, eb = a.embed(size=32, seed=0), b.embed(size=32, seed=0)
    assert ea.shape == eb.shape == (400, 32) and ea.dtype == np.float32
    sign = np.sign(np.sum(ea * eb, axis=0))
    np.testing.assert_allclose(ea * sign, eb, rtol=1e-5, atol=1e-6)


def _embedded(n_docs=400, vocab_size=1600, top=1200, dim=64):
    """bench.py's 20NEWS recipe (:637-645) at a small size, both
    packages."""
    out = []
    for mod in (text, jtext):
        ds = mod.synthetic_text_dataset(n_docs=n_docs, vocab_size=vocab_size,
                                        seed=0)
        ds.clean_text()
        ds.vectorize()
        ds.remove_short_documents(nwords=5)
        ds.keep_top_words(top, Mprint=0)
        ds.embed(size=dim, seed=0)
        out.append(ds)
    return out


def test_knn_graphs_of_embeddings_match_jax():
    a, b = _embedded()
    za, zb = a.embeddings.astype(np.float32), b.embeddings.astype(np.float32)
    # The dense route: W exactly.
    Wa, Wb = gc.knn_graph(za, k=8), jgc.knn_graph(zb, k=8)
    assert abs(Wa - Wb).max() == 0 and Wa.nnz == Wb.nnz
    # The tree route against scikit-learn's: the same neighbours.
    da, ia = gc.knn(za, k=16, algorithm="auto")
    db, ib = jgc.knn(zb, k=16, algorithm="auto")
    np.testing.assert_array_equal(ia, ib)
    Wa, Wb = gc.adjacency(da, ia), jgc.adjacency(db, ib)
    assert ((Wa != 0) != (Wb != 0)).nnz == 0
    assert abs(Wa - Wb).max() <= 1e-6 * abs(Wb).max()


def test_knn_ties_of_duplicate_points():
    """Equidistant points (here two identical embeddings, as words whose
    PPMI rows are all zero would give) are the one place where the
    packages' neighbour lists differ.  The dense route breaks ties as
    JAX's does.  The tree route (``cKDTree``) lists two equidistant
    points in another order than scikit-learn's ``NearestNeighbors``:
    the distances agree row by row, the indices differ only by a swap
    of the twins, and where the twins straddle the k-th place the graphs
    keep a different twin.  ROADMAP queue 3 records this decision."""
    rng = np.random.default_rng(8)
    z = rng.normal(size=(60, 4)).astype(np.float32)
    z[10] = z[11] = 0.0
    da, ia = gc.knn(z, k=5, algorithm="dense")
    db, ib = jgc.knn(z, k=5, algorithm="dense")
    np.testing.assert_array_equal(ia, ib)
    assert abs(gc.adjacency(da, ia) - jgc.adjacency(db, ib)).max() == 0
    da, ia = gc.knn(z, k=5, algorithm="auto")
    db, ib = jgc.knn(z, k=5, algorithm="auto")
    np.testing.assert_allclose(da, db, rtol=1e-6)
    rows = np.flatnonzero((ia != ib).any(axis=1))
    assert len(rows) > 0
    assert set(ia[ia != ib]) | set(ib[ia != ib]) == {10, 11}
    for r in rows:
        assert sorted(ia[r]) == sorted(ib[r]) or not (
            {10, 11} <= set(ia[r]) and {10, 11} <= set(ib[r]))
    Wa, Wb = gc.adjacency(da, ia), jgc.adjacency(db, ib)
    differ = ((Wa != 0) != (Wb != 0)).tocoo()
    assert differ.nnz > 0
    assert set(differ.row) | set(differ.col) >= {10, 11}
    assert all(r in (10, 11) or c in (10, 11)
               for r, c in zip(differ.row, differ.col))


def _write_20news_cache(home):
    rng = np.random.default_rng(9)
    names = ["alt.atheism", "comp.graphics", "sci.space", "talk.politics"]

    def part(n, tag):
        target = rng.integers(0, 4, n)
        return Bunch(
            data=[f"{tag} document {i} about {names[t]} " * 3
                  for i, t in enumerate(target)],
            filenames=np.array([f"/{tag}/{names[t]}/{i}"
                                for i, t in enumerate(target)]),
            target_names=list(names), target=target,
            DESCR="fixture")

    cache = {"train": part(30, "train"), "test": part(20, "test")}
    with open(home / "20news-bydate_py3.pkz", "wb") as f:
        f.write(codecs.encode(pickle.dumps(cache), "zlib_codec"))


@pytest.mark.parametrize("subset,categories", [
    ("all", ["sci.space", "alt.atheism", "talk.politics"]),
    ("train", None), ("test", ["comp.graphics", "sci.space"])])
def test_20news_reads_the_scikit_learn_cache(tmp_path, subset, categories):
    _write_20news_cache(tmp_path)
    ds = text.Text20News(data_home=str(tmp_path), subset=subset,
                         categories=categories)
    want = sklearn.datasets.fetch_20newsgroups(
        data_home=str(tmp_path), subset=subset, categories=categories,
        download_if_missing=False)
    assert ds.documents == list(want.data)
    np.testing.assert_array_equal(ds.labels, want.target)
    assert ds.class_names == list(want.target_names)
    raw = text.load_20newsgroups(data_home=str(tmp_path), subset=subset,
                                 categories=categories)
    np.testing.assert_array_equal(raw["filenames"], want.filenames)


def test_20news_without_a_cache_raises_jax_error(tmp_path):
    with pytest.raises(RuntimeError, match="not cached locally"):
        text.Text20News(data_home=str(tmp_path / "none"))


def test_cache_reader_refuses_other_classes(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("ran",))

    with open(tmp_path / "20news-bydate_py3.pkz", "wb") as f:
        f.write(codecs.encode(pickle.dumps({"train": Evil()}), "zlib_codec"))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        text.load_20newsgroups(data_home=str(tmp_path))


def test_rcv1_selection_matches_jax():
    rng = np.random.default_rng(10)
    data = scipy.sparse.random(40, 30, density=0.2, format="csr",
                               random_state=1)
    target = scipy.sparse.csr_matrix(
        (rng.random((40, 6)) < 0.3).astype(np.int64))
    names = ["C15", "C18", "C31", "E21", "GCAT", "MCAT"]
    keep = ["C18", "E21", "MCAT"]
    a = text.TextRCV1.__new__(text.TextRCV1)
    b = jtext.TextRCV1.__new__(jtext.TextRCV1)
    for ds in (a, b):
        ds.data, ds.target, ds.class_names = (data.copy(), target.copy(),
                                               list(names))
    for ds in (a, b):
        ds.remove_classes(keep)
        ds.select_documents()
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.class_names == b.class_names == keep
    _same_csr(a.data, b.data)
    with pytest.raises(RuntimeError, match="queue 1 item 1"):
        text.TextRCV1()


def test_word2vec_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    words = ["alpha", "beta", "gamma", "delta"]
    vecs = rng.normal(size=(4, 5)).astype(np.float32)
    path = tmp_path / "v.bin"
    with open(path, "wb") as f:
        f.write(b"4 5\n")
        for w, v in zip(words, vecs):
            f.write(w.encode() + b" " + v.tobytes() + b"\n")
    a = text._read_word2vec_binary(str(path))
    b = jtext._read_word2vec_binary(str(path))
    assert list(a) == list(b) == words
    for w in words:
        np.testing.assert_array_equal(a[w], b[w])
    dsa, dsb = text.TextDataset(), jtext.TextDataset()
    for ds in (dsa, dsb):
        ds.vocab = ["beta", "delta", "alpha"]
        ds.data = scipy.sparse.csr_matrix(np.eye(3))
    np.testing.assert_array_equal(dsa.embeddings_from_file(str(path)),
                                  dsb.embeddings_from_file(str(path)))
    assert dsa.vocab == dsb.vocab
    # A word without a vector: dropped here; JAX's keep_words indexes the
    # vectors it has just set with the old positions and raises.
    for ds in (dsa, dsb):
        ds.vocab = ["beta", "zeta", "alpha"]
    np.testing.assert_array_equal(dsa.embeddings_from_file(str(path)),
                                  vecs[[1, 0]])
    assert dsa.vocab == ["beta", "alpha"] and dsa.data.shape == (3, 2)
    with pytest.raises(IndexError):
        dsb.embeddings_from_file(str(path))


# ------------------------------------------- the 20NEWS cell at 400 documents

K, C, FIN, CLASSES, STEPS = 5, 64, 64, 8, 80


@pytest.fixture(scope="module")
def cell():
    a, b = _embedded()
    out = []
    for ds, g in ((a, gc), (b, jgc)):
        dist, idx = g.knn(ds.embeddings.astype(np.float32), k=16,
                          algorithm="auto")
        W = g.adjacency(dist, idx)
        perm = g.bandwidth_reducing_permutation(W)
        W = W[perm][:, perm].tocsr()
        out.append((W, perm, g.laplacian(W, normalized=True)))
    return out


def test_cell_graph_and_format_match_jax(cell):
    (Wa, pa, La), (Wb, pb, Lb) = cell
    np.testing.assert_array_equal(pa, pb)
    assert abs(Wa - Wb).max() <= 1e-6 * abs(Wb).max()
    assert abs(La - Lb).max() <= 1e-6
    op = device_laplacian(La, fmt="auto", dtype=torch.bfloat16,
                          device="cpu")
    op_j = jax_device_laplacian(Lb, fmt="auto", dtype=jnp.bfloat16)
    assert isinstance(op, DenseLaplacian)
    assert type(op_j).__name__ == "DenseLaplacian"
    assert op.m == op_j.m == 1200 and op.m_padded == op_j.m_padded


@pytest.fixture(scope="module")
def cell_ops(cell):
    """The port's operators, and JAX's built on the same L, so that the
    chains and the model compare on one matrix."""
    L = cell[0][2]
    op = device_laplacian(L, fmt="auto", dtype=torch.bfloat16, device="cpu")
    op_j = jax_device_laplacian(L, fmt="auto", dtype=jnp.bfloat16)
    return op, quantize_dense(op, sample_x=3.0), op_j, jax_quantize_dense(
        op_j, sample_x=3.0)


def test_cell_chains_match_jax(cell_ops):
    op, qop, op_j, qop_j = cell_ops
    x = np.random.default_rng(0).normal(size=(op.m_padded, C))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = cheby_finals(op, xb, K).float().numpy()
    y_j = np.asarray(jax_cheby_finals(
        op_j, jnp.asarray(x, jnp.bfloat16), K)).astype(np.float32)
    assert float(np.abs(y - y_j).max()) <= 2e-2 * float(np.abs(y_j).max())
    q = cheby_finals(qop, qop.quantize(xb.float()), K)
    q_j = jax_cheby_finals(qop_j, qop_j.quantize(
        jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), K)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    # The int32 accumulator equals the float64 one it replaced.
    xq = qop.quantize(xb.float())
    assert torch.equal(qop._acc(xq).double(), qop._acc_f64(xq))


def test_cell_node_classifier_accuracy_matches_jax(cell_ops):
    """bench.py:697-741: planted-partition features, trained in JAX for
    80 adam steps on the bf16 operator, carried over; the float and int8
    test accuracies agree with JAX's."""
    op, qop, op_j, qop_j = cell_ops
    rng = np.random.default_rng(0)
    rng.normal(size=(op.m_padded, C))  # the chain's draw, as in the bench
    m, mp = op.m, op.m_padded
    labels = (np.arange(m) * CLASSES // m).astype(np.int64)
    sig = rng.normal(0, 1, (CLASSES, FIN)).astype(np.float32)
    feats = sig[labels] + rng.normal(0, 1.0, (m, FIN)).astype(np.float32)
    fp = np.zeros((mp, FIN), np.float32)
    fp[:m] = feats
    yp = np.zeros((mp,), np.int64)
    yp[:m] = labels
    train = np.zeros(mp, bool)
    train[:m] = rng.random(m) < 0.1
    test = np.zeros(mp, bool)
    test[:m] = ~train[:m]

    def mk(o):
        return JaxNodeClassifier(o, input_features=FIN,
                                 num_classes=CLASSES, hidden=[], K=K)

    params = mk(op_j).init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-2)
    state = opt.init(params)
    f, y, tm, em = map(jnp.asarray, (fp, yp, train, test))

    @jax.jit
    def step(params, state):
        g = jax.grad(mk(op_j).loss)(params, f, y, tm)
        up, state = opt.update(g, state, params)
        return optax.apply_updates(params, up), state

    for _ in range(STEPS):
        params, state = step(params, state)
    acc_j = {"f32": float(mk(op_j).accuracy(params, f, y, em)),
             "int8": float(mk(qop_j).accuracy(params, f, y, em))}
    tp = node_classifier_params_from_jax(jax.tree.map(np.asarray, params))
    ft, yt, et = map(torch.from_numpy, (fp, yp, test))
    with torch.inference_mode():
        acc = {lab: float(NodeClassifier(o, FIN, CLASSES, hidden=[], K=K)
                          .accuracy(tp, ft, yt, et))
               for lab, o in (("f32", op), ("int8", qop))}
    assert acc_j["f32"] >= 0.9
    for lab in acc:
        assert abs(acc[lab] - acc_j[lab]) <= 0.005, (lab, acc, acc_j)
