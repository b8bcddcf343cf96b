"""20NEWS-style text classification over a word-embedding graph.

The JAX package's ``experiments/text20news.py`` on the port: clean ->
vectorize -> filter short documents -> keep the top M words -> normalize
-> embed -> kNN word graph -> ChebNet GC32 (F=[32], K=[5], M=[C]; the
paper's Table 4 reports 68.26% on the real corpus).  Reads the real
corpus from scikit-learn's local cache when it is there, else falls back
to the synthetic topic corpus.  ``--baselines`` also runs the classical
baselines (``utils.harness.baseline``, which needs scikit-learn) on the
same split.

Run:  python -m cnn_graph_tpu_torch.experiments.text20news [--synthetic]
          [--top-words 1000] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Run the experiment; returns the test metrics and ``fit``'s
    seconds per step."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--top-words", type=int, default=1000)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--baselines", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from cnn_graph_tpu_torch.data.text import (
        Text20News,
        synthetic_text_dataset,
    )
    from cnn_graph_tpu_torch.graphs import construction as gc
    from cnn_graph_tpu_torch.models import ChebNet
    from cnn_graph_tpu_torch.ops import device_laplacian
    from cnn_graph_tpu_torch.train import TrainConfig, Trainer

    if args.synthetic:
        ds = synthetic_text_dataset(n_docs=2000, vocab_size=1200,
                                    n_classes=8, seed=args.seed)
    else:
        try:
            ds = Text20News(subset="all")
        except RuntimeError as e:
            print(f"{e}\nfalling back to --synthetic")
            ds = synthetic_text_dataset(n_docs=2000, vocab_size=1200,
                                        n_classes=8, seed=args.seed)

    ds.clean_text(num="substitute")
    ds.vectorize(stop_words="english" if not args.synthetic else None)
    ds.remove_short_documents(nwords=20, vocab="full")
    ds.keep_top_words(args.top_words, Mprint=5)
    ds.normalize("l1")
    emb = ds.embed(size=args.embed_dim, seed=args.seed)

    W = gc.knn_graph(emb, k=args.knn)
    L = gc.laplacian(W, normalized=True)
    op = device_laplacian(L, device=args.device)

    X = np.asarray(ds.data.todense(), np.float32)
    y = ds.labels.astype(np.int64)
    n = len(y)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n)
    X, y = X[order], y[order]
    ntr, nva = int(n * 0.7), int(n * 0.1)

    if args.baselines:
        from cnn_graph_tpu_torch.utils.harness import baseline

        baseline(X[:ntr], y[:ntr], X[ntr + nva:], y[ntr + nva:])

    C = int(y.max()) + 1
    model = ChebNet([op], F=[32], K=[5], p=[1], M=[C], dropout=0.5,
                    regularization=1e-3)
    cfg = TrainConfig(num_epochs=args.epochs, learning_rate=5e-3,
                      decay_rate=0.95, decay_steps=max(ntr // 100, 1),
                      batch_size=100, eval_frequency=100, seed=args.seed)
    trainer = Trainer(model, cfg, task="classification")
    _, _, t_step = trainer.fit(X[:ntr], y[:ntr], X[ntr:ntr + nva],
                               y[ntr:ntr + nva])
    string, metrics = trainer.evaluate(X[ntr + nva:], y[ntr + nva:])
    print(f"test  {string}")
    return metrics, t_step


if __name__ == "__main__":
    main()
