"""End-to-end classification demo: the reference's usage.ipynb as a
command line.

The JAX package's ``experiments/usage_demo.py`` on the port: synthetic
community-structured features, a kNN graph of the feature coordinates,
coarsening, ChebNet (F=[32, 64], K=[20, 20], p=[4, 2], M=[512, C]),
``Trainer.fit`` and the evaluation, tabulated by
``utils.harness.ModelPerf`` (usage.ipynb cells 3-18).

Run:  python -m cnn_graph_tpu_torch.experiments.usage_demo [--epochs 40]
          [--n 10000] [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Run the demo; returns the ``ModelPerf`` that holds its results."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=10000)
    p.add_argument("--d", type=int, default=100)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=2e-3)
    p.add_argument("--pool", choices=["max", "average"], default="average")
    p.add_argument("--filter", default="chebyshev",
                   choices=["chebyshev", "fourier", "spline"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    import torch

    from cnn_graph_tpu_torch.data.synthetic import community_classification
    from cnn_graph_tpu_torch.graphs import construction as gc
    from cnn_graph_tpu_torch.models import ChebNet
    from cnn_graph_tpu_torch.ops import device_laplacian
    from cnn_graph_tpu_torch.train import TrainConfig, Trainer
    from cnn_graph_tpu_torch.utils.harness import ModelPerf

    splits, graphs, _ = community_classification(n=args.n, d=args.d,
                                                 seed=args.seed)
    Ls = [gc.laplacian(g, normalized=True) for g in graphs]
    ops = [device_laplacian(L, device=args.device) for L in Ls]

    C = int(splits["train_labels"].max()) + 1
    model = ChebNet(ops, F=[32, 64], K=[20, 20], p=[4, 2], M=[512, C],
                    laplacians=Ls, filter=args.filter, pool=args.pool,
                    dropout=0.5, regularization=5e-4,
                    generator=torch.Generator().manual_seed(args.seed))
    cfg = TrainConfig(num_epochs=args.epochs,
                      learning_rate=args.learning_rate, decay_rate=0.95,
                      decay_steps=args.n // args.batch_size,
                      batch_size=args.batch_size, eval_frequency=200,
                      seed=2017)
    trainer = Trainer(model, cfg, task="classification")

    perf = ModelPerf()
    perf.test(trainer, "cgconv_softmax", vars(args),
              splits["train_data"], splits["train_labels"],
              splits["val_data"], splits["val_labels"],
              splits["test_data"], splits["test_labels"])
    perf.show()
    return perf


if __name__ == "__main__":
    main()
