"""RCV1 text classification over a word graph (rcv1.ipynb).

The JAX package's ``experiments/rcv1.py`` on the port: keep the selected
categories and the single-label documents, keep the top words, embed the
words by a truncated SVD of the document-term matrix, kNN word graph,
ChebNet classification.  The port cannot read scikit-learn's RCV1 cache
(``data.text.TextRCV1``; ROADMAP queue 1 item 1), so the script runs the
synthetic corpus shaped like the selected-category subset, as the JAX
script does without the cache.

Run:  python -m cnn_graph_tpu_torch.experiments.rcv1 [--classes C15 ...]
          [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Run the experiment; returns the test metrics and ``fit``'s
    seconds per step."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--classes", nargs="*", default=["CCAT", "ECAT", "GCAT",
                                                    "MCAT"])
    p.add_argument("--top-words", type=int, default=1000)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from cnn_graph_tpu_torch.data.text import (
        TextRCV1,
        synthetic_text_dataset,
    )
    from cnn_graph_tpu_torch.graphs import construction as gc
    from cnn_graph_tpu_torch.models import ChebNet
    from cnn_graph_tpu_torch.ops import device_laplacian
    from cnn_graph_tpu_torch.train import TrainConfig, Trainer

    try:
        ds = TextRCV1()
        ds.remove_classes(args.classes)
        ds.select_documents()
        ds.vocab = [f"w{i}" for i in range(ds.data.shape[1])]
        # RCV1 ships pre-vectorized tf-idf: keep the top words first, so
        # that the word space below stays [top_words, dim].
        ds.keep_top_words(args.top_words, Mprint=0)
        X = ds.data
        # Word embedding: the word loadings of a truncated SVD of the
        # document-term matrix.
        import scipy.sparse.linalg

        _, s, vt = scipy.sparse.linalg.svds(
            X.astype(np.float64), k=min(64, X.shape[1] - 1), rng=args.seed)
        emb = (vt.T * s).astype(np.float32)
    except RuntimeError as e:
        print(f"{e}\nfalling back to a synthetic corpus")
        ds = synthetic_text_dataset(n_docs=1500, vocab_size=800,
                                    n_classes=len(args.classes),
                                    seed=args.seed)
        ds.clean_text()
        ds.vectorize()
        ds.keep_top_words(args.top_words, Mprint=0)
        ds.normalize("l1")
        emb = ds.embed(size=64, seed=args.seed)
        X = ds.data

    W = gc.knn_graph(np.asarray(emb, np.float64), k=args.knn)
    L = gc.laplacian(W, normalized=True)
    op = device_laplacian(L, device=args.device)

    Xd = np.asarray(X.todense(), np.float32)
    y = ds.labels.astype(np.int64)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(y))
    Xd, y = Xd[order], y[order]
    ntr, nva = int(len(y) * 0.7), int(len(y) * 0.1)

    C = int(y.max()) + 1
    model = ChebNet([op], F=[32], K=[5], p=[1], M=[C], dropout=0.5,
                    regularization=1e-3)
    cfg = TrainConfig(num_epochs=args.epochs, learning_rate=5e-3,
                      decay_rate=0.95, decay_steps=max(ntr // 100, 1),
                      batch_size=100, eval_frequency=100, seed=args.seed)
    trainer = Trainer(model, cfg, task="classification")
    _, _, t_step = trainer.fit(Xd[:ntr], y[:ntr], Xd[ntr:ntr + nva],
                               y[ntr:ntr + nva])
    string, metrics = trainer.evaluate(Xd[ntr + nva:], y[ntr + nva:])
    print(f"test  {string}")
    return metrics, t_step


if __name__ == "__main__":
    main()
