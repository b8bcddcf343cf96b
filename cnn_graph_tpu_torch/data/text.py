"""Text-classification datasets: 20NEWS / RCV1 bag-of-words graph signals.

Counterpart of ``cnn_graph_tpu/data/text.py``: ``TextDataset`` (:34) with
its cleaning, vectorizing, filtering and embedding steps (``clean_text``
:48 to ``embeddings_from_file`` :171), ``Text20News`` (:187),
``TextRCV1`` (:211), ``synthetic_text_dataset`` (:249) and
``_read_word2vec_binary`` (:280).  Documents become word-count rows, and a
kNN graph over word embeddings becomes the feature graph of a ChebNet
(nips2016/20news.ipynb, rcv1.ipynb).

The JAX package calls scikit-learn for three steps, and the card's
machine has no scikit-learn, so they are NumPy copies here, held equal
to scikit-learn by ``tests/test_torch_text.py``:

* ``vectorize`` is ``CountVectorizer``'s ``fit_transform`` for the
  parameters the repo passes (``lowercase``, ``token_pattern``,
  ``stop_words`` None, ``"english"`` or a list): the same sorted
  vocabulary and the same int64 CSR arrays.  Other parameters raise.
* ``normalize`` is ``sklearn.preprocessing.normalize(..., axis=1)`` for
  ``l1``, ``l2`` and ``max``; zero rows stay as they are.
* ``Text20News`` reads scikit-learn's own cache of the corpus (a
  zlib-compressed pickle) through an unpickler that admits NumPy's array
  classes and nothing executable, then selects, relabels and shuffles
  as ``fetch_20newsgroups`` does.  Nothing is downloaded.

``TextRCV1``'s loader is not ported: scikit-learn caches RCV1 with
joblib, which cannot be read without joblib.  Its ``remove_classes`` and
``select_documents`` are, on the dataset's arrays.
"""

from __future__ import annotations

import codecs
import io
import os
import pickle
import re

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from cnn_graph_tpu_torch.data.stop_words import ENGLISH_STOP_WORDS

__all__ = [
    "TextDataset",
    "Text20News",
    "TextRCV1",
    "count_vectorize",
    "normalize_rows",
    "synthetic_text_dataset",
]

_TOKEN_PATTERN = r"(?u)\b\w\w+\b"  # CountVectorizer's default


def count_vectorize(documents, lowercase: bool = True,
                    token_pattern: str = _TOKEN_PATTERN, stop_words=None):
    """``CountVectorizer(...).fit_transform(documents)`` and its
    ``get_feature_names_out()``: ``(int64 CSR [N, M], sorted vocabulary)``.
    ``stop_words`` is None, ``"english"`` or a list of words.  As in
    scikit-learn, each row lists its words in the order they first
    appear in the corpus (not sorted by column), and an empty vocabulary
    raises."""
    if stop_words == "english":
        stop = ENGLISH_STOP_WORDS
    elif isinstance(stop_words, str):
        raise ValueError(f"not a built-in stop list: {stop_words!r}")
    else:
        stop = frozenset(stop_words or ())
    tokenize = re.compile(token_pattern).findall
    vocab: dict[str, int] = {}
    j_indices, values, indptr = [], [], [0]
    for doc in documents:
        counter: dict[int, int] = {}
        for word in tokenize(doc.lower() if lowercase else doc):
            if word in stop:
                continue
            j = vocab.setdefault(word, len(vocab))
            counter[j] = counter.get(j, 0) + 1
        for j in sorted(counter):
            j_indices.append(j)
            values.append(counter[j])
        indptr.append(len(j_indices))
    if not vocab:
        raise ValueError(
            "empty vocabulary; perhaps the documents only contain stop words")
    names = sorted(vocab)
    remap = np.empty(len(vocab), dtype=np.int32)
    remap[[vocab[w] for w in names]] = np.arange(len(names), dtype=np.int32)
    X = scipy.sparse.csr_matrix(
        (np.asarray(values, dtype=np.int64),
         remap[np.asarray(j_indices, dtype=np.int64)],
         np.asarray(indptr, dtype=np.int32)),
        shape=(len(indptr) - 1, len(names)))
    return X, names


def normalize_rows(X: scipy.sparse.spmatrix, norm: str = "l2"):
    """``sklearn.preprocessing.normalize(X.astype(float64), norm, axis=1)``
    for a sparse matrix: each row divided by its ``l1``, ``l2`` or
    ``max`` norm, summed over each row's columns in order as
    scikit-learn's validation sorts them and its loops sum them; rows
    whose norm is zero are left as they are.  Returns a new CSR."""
    X = scipy.sparse.csr_matrix(X, dtype=np.float64, copy=True)
    X.sort_indices()
    data = X.data
    counts = np.diff(X.indptr)
    rows = np.repeat(np.arange(X.shape[0]), counts)
    norms = np.zeros(X.shape[0])
    if norm == "l1":
        np.add.at(norms, rows, np.abs(data))
    elif norm == "l2":
        np.add.at(norms, rows, data * data)
        norms = np.sqrt(norms)
    elif norm == "max":
        np.maximum.at(norms, rows, np.abs(data))
    else:
        raise ValueError(f"unsupported norm {norm!r}: l1, l2 or max")
    each = norms[rows]
    nz = each != 0
    data[nz] /= each[nz]
    return X


class TextDataset:
    """Bag-of-words dataset with cleaning, filtering and embedding steps.

    Attributes: ``documents`` (list[str]), ``labels`` (int array),
    ``class_names``, and after ``vectorize``: ``data`` (CSR [N, M]) and
    ``vocab`` (list[str]); after ``embed``: ``embeddings`` ([M, dim]).
    """

    documents: list
    labels: np.ndarray
    class_names: list
    data: scipy.sparse.csr_matrix
    vocab: list

    def clean_text(self, num: str = "substitute"):
        """Lowercase, strip non-letters, normalize digits
        (lib/utils.py:14-42)."""
        digit_words = ["zero", "one", "two", "three", "four",
                       "five", "six", "seven", "eight", "nine"]
        for i, doc in enumerate(self.documents):
            if num == "spell":
                for d, word in enumerate(digit_words):
                    doc = doc.replace(str(d), f" {word} ")
            elif num == "substitute":
                doc = re.sub(r"(\d+)", " NUM ", doc)
            elif num == "remove":
                doc = re.sub(r"[0-9]", " ", doc)
            doc = doc.replace("$", " dollar ")
            doc = doc.lower()
            doc = re.sub("[^a-z]", " ", doc)
            self.documents[i] = " ".join(doc.split())

    def vectorize(self, **params):
        """Word counts by ``count_vectorize`` (CountVectorizer's); the
        parameters it does not take raise."""
        unknown = set(params) - {"lowercase", "token_pattern", "stop_words"}
        if unknown:
            raise NotImplementedError(
                f"vectorize parameters {sorted(unknown)} are not ported: the "
                "port copies CountVectorizer for lowercase, token_pattern "
                "and stop_words only")
        self.data, self.vocab = count_vectorize(self.documents, **params)

    def data_info(self, show_classes: bool = False):
        N, M = self.data.shape
        sparsity = self.data.nnz / N / M * 100
        print(f"N = {N} documents, M = {M} words, sparsity={sparsity:.4f}%")
        if show_classes:
            for i, name in enumerate(self.class_names):
                print(f"  {np.sum(self.labels == i):5d} documents in class "
                      f"{i:2d} ({name})")

    def show_document(self, i: int):
        """Print one document's label, word count and nonzero counts
        (lib/utils.py:60-77)."""
        label = self.labels[i]
        name = self.class_names[label]
        text = self.documents[i] if hasattr(self, "documents") else None
        wc = len(text.split()) if text is not None else "N/A"
        print(f"document {i}: label {label} --> {name}, {wc} words")
        if hasattr(self, "data"):
            row = self.data[i]
            for j in row.nonzero()[1]:
                print(f"  {row[0, j]:.2f} \"{self.vocab[j]}\" ({j})")
        return text

    def keep_documents(self, idx):
        self.documents = [self.documents[i] for i in idx]
        self.labels = self.labels[idx]
        self.data = self.data[idx, :]

    def keep_words(self, idx):
        self.data = self.data[:, idx]
        self.vocab = [self.vocab[i] for i in idx]
        if hasattr(self, "embeddings"):
            self.embeddings = self.embeddings[idx, :]

    def remove_short_documents(self, nwords: int, vocab: str = "selected"):
        """Drop documents under ``nwords`` words (lib/utils.py:94-107)."""
        if vocab == "selected":
            wc = np.squeeze(np.asarray(self.data.sum(axis=1)))
        else:
            wc = np.array([len(d.split()) for d in self.documents])
        idx = np.flatnonzero(wc >= nwords)
        self.keep_documents(idx)
        return wc

    def keep_top_words(self, M: int, Mprint: int = 20):
        """Keep the M most frequent words (lib/utils.py:109-119)."""
        freq = np.squeeze(np.asarray(self.data.sum(axis=0)))
        idx = np.argsort(freq)[::-1][:M]
        self.keep_words(idx)
        for i in range(min(Mprint, len(self.vocab))):
            print(f"  {i:3d}: {self.vocab[i]:10s} "
                  f"{int(freq[idx][i]):6d} counts")
        return freq[idx]

    def normalize(self, norm: str = "l1"):
        self.data = normalize_rows(self.data, norm)

    def embed(self, size: int = 100, window: int = 5, seed: int = 0):
        """Word embeddings from the corpus: PPMI co-occurrence and a
        truncated SVD (the JAX package's stand-in for the reference's
        gensim word2vec, lib/utils.py:127-150).  The signs of the singular
        vectors are SciPy's; a sign flip of a column leaves every distance,
        and so the kNN graph, unchanged.  The co-occurrences are the JAX
        loop's pairs (each word with the ``window`` before it in its
        document, both ways), gathered by distance with NumPy: the counts
        are sums of ones, equal in any order."""
        vocab_index = {w: i for i, w in enumerate(self.vocab)}
        M = len(self.vocab)
        ids, doc_of = [], []
        for d, doc in enumerate(self.documents):
            kept = [vocab_index[w] for w in doc.split() if w in vocab_index]
            ids.extend(kept)
            doc_of.extend([d] * len(kept))
        ids, doc_of = np.asarray(ids, np.int64), np.asarray(doc_of)
        rows, cols = [], []
        for dist in range(1, window + 1):
            same = doc_of[dist:] == doc_of[:-dist]
            a, b = ids[dist:][same], ids[:-dist][same]
            rows += [a, b]
            cols += [b, a]
        rows = np.concatenate(rows) if rows else np.empty(0, np.int64)
        cols = np.concatenate(cols) if cols else np.empty(0, np.int64)
        if not rows.size:
            raise ValueError("no co-occurrences; did you call vectorize()?")
        C = scipy.sparse.coo_matrix(
            (np.ones(len(rows)), (rows, cols)), shape=(M, M)).tocsr()

        # Positive pointwise mutual information.
        total = C.sum()
        wc = np.asarray(C.sum(axis=1)).ravel() + 1e-12
        C = C.tocoo()
        pmi = np.log((C.data * total) / (wc[C.row] * wc[C.col]))
        pmi = np.maximum(pmi, 0)
        P = scipy.sparse.coo_matrix((pmi, (C.row, C.col)), shape=(M, M))

        k = min(size, M - 1)
        u, s, _ = scipy.sparse.linalg.svds(
            P.tocsr().astype(np.float64), k=k, rng=seed)
        self.embeddings = (u * np.sqrt(s)).astype(np.float32)
        return self.embeddings

    def embeddings_from_file(self, filename: str):
        """Load pretrained vectors in word2vec binary format; drops words
        without a vector (lib/utils.py:129-131, 141-150).  The words are
        dropped before the vectors are set: the JAX package sets them
        first, and its ``keep_words`` then indexes the shorter array with
        the old positions and raises once a word is missing."""
        vectors = _read_word2vec_binary(filename)
        keep, emb = [], []
        for i, word in enumerate(self.vocab):
            if word in vectors:
                keep.append(i)
                emb.append(vectors[word])
        print(f"{len(self.vocab) - len(keep)} words not found in corpus")
        if hasattr(self, "embeddings"):
            del self.embeddings
        self.keep_words(keep)
        self.embeddings = np.asarray(emb, np.float32)
        return self.embeddings


def _data_home(data_home=None) -> str:
    """scikit-learn's ``get_data_home``: ``$SCIKIT_LEARN_DATA`` or
    ``~/scikit_learn_data``, without creating it."""
    if data_home is None:
        data_home = os.environ.get("SCIKIT_LEARN_DATA",
                                   os.path.join("~", "scikit_learn_data"))
    return os.path.expanduser(data_home)


class _Bunch(dict):
    """Stands in for scikit-learn's ``Bunch`` (a dict) when the cache is
    unpickled; the pickled instance state is dropped, as ``Bunch``'s
    ``__setstate__`` drops it."""

    def __setstate__(self, state):
        pass


_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}
_BUILTIN_NAMES = {"list", "dict", "set", "frozenset", "tuple", "str",
                  "bytes", "bytearray", "int", "float", "complex", "bool",
                  "slice", "range"}


class _CacheUnpickler(pickle.Unpickler):
    """Admits scikit-learn's ``Bunch`` (as ``_Bunch``), NumPy's array
    classes and plain builtin types; refuses every other class."""

    def find_class(self, module, name):
        if name == "Bunch" and module.startswith("sklearn."):
            return _Bunch
        if module.split(".")[0] == "numpy" and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTIN_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing {module}.{name} in a dataset cache")


def load_20newsgroups(data_home=None, subset: str = "train",
                      categories=None, shuffle: bool = True,
                      random_state: int = 42) -> dict:
    """``fetch_20newsgroups(download_if_missing=False)`` from scikit-learn's
    cache ``<data_home>/20news-bydate_py3.pkz``, without scikit-learn:
    ``{"data", "target", "target_names", "filenames"}``.  ``subset`` is
    ``train``, ``test`` or ``all``; ``categories`` selects and relabels
    in the order of the names' indices; ``shuffle`` permutes with
    ``np.random.RandomState(random_state)``.  Raises ``OSError`` when the
    cache is absent."""
    if subset not in ("train", "test", "all"):
        raise ValueError(f"subset {subset!r}: train, test or all")
    path = os.path.join(_data_home(data_home), "20news-bydate_py3.pkz")
    if not os.path.exists(path):
        raise OSError("20Newsgroups dataset not found")
    with open(path, "rb") as f:
        raw = codecs.decode(f.read(), "zlib_codec")
    cache = _CacheUnpickler(io.BytesIO(raw)).load()
    parts = (subset,) if subset != "all" else ("train", "test")
    docs, target, filenames = [], [], []
    for part in parts:
        docs.extend(cache[part]["data"])
        target.extend(cache[part]["target"])
        filenames.extend(cache[part]["filenames"])
    names = list(cache[parts[-1]]["target_names"])
    target, filenames = np.array(target), np.array(filenames)
    if categories is not None:
        labels = sorted((names.index(cat), cat) for cat in categories)
        labels, categories = zip(*labels)
        mask = np.isin(target, labels)
        filenames, target = filenames[mask], target[mask]
        target = np.searchsorted(labels, target)
        names = list(categories)
        docs = np.array(docs, dtype=object)[mask].tolist()
    if shuffle:
        indices = np.arange(target.shape[0])
        np.random.RandomState(random_state).shuffle(indices)
        filenames, target = filenames[indices], target[indices]
        docs = np.array(docs, dtype=object)[indices].tolist()
    return {"data": docs, "target": target, "target_names": names,
            "filenames": filenames}


class Text20News(TextDataset):
    """20 Newsgroups from scikit-learn's local cache (lib/utils.py
    :152-160).  ``params``: ``data_home``, ``subset``, ``categories``,
    ``shuffle``, ``random_state`` of ``fetch_20newsgroups``."""

    def __init__(self, **params):
        try:
            dataset = load_20newsgroups(**params)
        except OSError as e:
            raise RuntimeError(
                "20NEWS is not cached locally and this environment has no "
                "network egress; place the sklearn cache under "
                "~/scikit_learn_data or use synthetic_text_dataset() for "
                "shape-compatible experiments"
            ) from e
        self.documents = list(dataset["data"])
        self.labels = np.asarray(dataset["target"])
        self.class_names = list(dataset["target_names"])
        assert self.labels.max() + 1 == len(self.class_names)


class TextRCV1(TextDataset):
    """RCV1 (103 categories; lib/utils.py:162-218).  scikit-learn caches
    it with joblib, which the port does not read, so the constructor
    raises (ROADMAP queue 1 item 1); ``remove_classes`` and
    ``select_documents`` work on the ``data``, ``target`` (indicator
    CSR) and ``class_names`` attributes of an instance given them."""

    def __init__(self, **params):
        raise RuntimeError(
            "RCV1 is not cached locally and this environment has no network "
            "egress; cnn_graph_tpu_torch cannot read scikit-learn's joblib "
            "cache of it either (ROADMAP queue 1 item 1)")

    def remove_classes(self, keep):
        lookup = {name: i for i, name in enumerate(self.class_names)}
        idx = [lookup[name] for name in keep]
        self.target = self.target[:, idx]
        self.class_names = list(keep)

    def select_documents(self):
        """Keep single-label documents; labels from the indicator columns
        (lib/utils.py:205-218)."""
        per_doc = np.asarray(self.target.sum(axis=1)).ravel()
        single = per_doc == 1
        self.target = self.target[single]
        self.data = self.data[single, :]
        self.labels = self.target.tocoo().col
        assert self.labels.min() == 0
        assert self.labels.max() == self.target.shape[1] - 1


def synthetic_text_dataset(n_docs: int = 400, vocab_size: int = 200,
                           n_classes: int = 4, doc_len: int = 60,
                           seed: int = 0) -> TextDataset:
    """Fabricated topic-model corpus with the TextDataset interface: each
    class prefers a distinct vocabulary band, so word embeddings cluster
    and the kNN word graph has structure.  The same draws as the JAX
    package's for the same seed."""
    rng = np.random.default_rng(seed)

    def word(i):  # purely alphabetic so clean_text() keeps words distinct
        letters = []
        for _ in range(4):
            letters.append(chr(ord("a") + i % 26))
            i //= 26
        return "w" + "".join(letters)

    words = [word(i) for i in range(vocab_size)]
    ds = TextDataset()
    ds.class_names = [f"class{i}" for i in range(n_classes)]
    ds.labels = rng.integers(0, n_classes, n_docs).astype(np.int64)
    band = vocab_size // n_classes
    docs = []
    for y in ds.labels:
        topic = np.full(vocab_size, 0.2 / vocab_size)
        topic[y * band:(y + 1) * band] += 0.8 / band
        ids = rng.choice(vocab_size, size=doc_len, p=topic / topic.sum())
        docs.append(" ".join(words[i] for i in ids))
    ds.documents = docs
    return ds


def _read_word2vec_binary(filename: str) -> dict:
    """Minimal word2vec .bin parser (replaces gensim's loader)."""
    vectors = {}
    with open(filename, "rb") as f:
        header = f.readline().split()
        n_words, dim = int(header[0]), int(header[1])
        for _ in range(n_words):
            word = b""
            while True:
                ch = f.read(1)
                if ch in (b" ", b""):
                    break
                if ch != b"\n":
                    word += ch
            vec = np.frombuffer(f.read(4 * dim), dtype=np.float32)
            vectors[word.decode("utf-8", errors="replace")] = vec
    return vectors
