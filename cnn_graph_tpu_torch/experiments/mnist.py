"""MNIST grid-graph classification: the reference's headline experiment.

The JAX package's ``experiments/mnist.py`` on the port: the 28x28 8-NN
grid graph, 4-level Graclus coarsening, ChebNet with the paper's
configuration (F=[32, 64], K=[25, 25], p=[4, 4], M=[512, 10];
nips2016/mnist.ipynb cells 14-17; the paper's Table 2 reports 99.14%),
trained by ``Trainer`` on the real IDX files of ``--data-dir`` or else
on the synthetic class-structured digits, with the ``--filter``
(chebyshev, fourier, spline or lanczos) and ``--edge-noise`` (a fraction
of the grid's edges replaced by random ones) of the JAX script.

``--mesh-data N`` trains data-parallel over a ``(data = N, nodes = 1)``
mesh through ``TrainConfig.mesh`` (JAX :31-33, :76-87), one process per
rank, each batch split over the ranks:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m cnn_graph_tpu_torch.experiments.mnist --mesh-data N

``--n-val`` and ``--n-test`` size the synthetic validation and test sets
(the JAX script's are fixed at 5,000 and 10,000).

Run:  python -m cnn_graph_tpu_torch.experiments.mnist [--epochs 20]
          [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Run the experiment; returns the test metrics and ``fit``'s
    seconds per step."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--K", type=int, default=25)
    p.add_argument("--filter", default="chebyshev",
                   choices=["chebyshev", "fourier", "spline", "lanczos"])
    p.add_argument("--mesh-data", type=int, default=0,
                   help="batch data parallelism: split each batch over an "
                   "N-rank 'data' mesh axis (TrainConfig.mesh)")
    p.add_argument("--n-train", type=int, default=55000,
                   help="synthetic-data size when no --data-dir")
    p.add_argument("--n-val", type=int, default=5000)
    p.add_argument("--n-test", type=int, default=10000)
    p.add_argument("--edge-noise", dest="edge_noise", type=float,
                   default=0.0,
                   help="fraction of graph edges replaced with random ones "
                        "(robustness experiment, mnist.ipynb cell 3)")
    p.add_argument("--seed", type=int, default=2017)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    mesh, say = None, print
    if args.mesh_data:
        import torch.distributed as dist

        from cnn_graph_tpu_torch.parallel import make_mesh

        mesh = make_mesh(data=args.mesh_data, nodes=1, device=args.device)
        if dist.get_rank():
            def say(*a, **k):
                return None
        say(f"data-parallel training over mesh {dict(mesh.shape)}")

    from cnn_graph_tpu_torch.data import (
        load_mnist,
        mnist_graph_data,
        synthetic_mnist,
    )
    from cnn_graph_tpu_torch.models import ChebNet
    from cnn_graph_tpu_torch.ops import device_laplacian
    from cnn_graph_tpu_torch.train import TrainConfig, Trainer

    if args.data_dir:
        tr_x, tr_y, te_x, te_y = load_mnist(args.data_dir)
        # The reference's 55k / 5k split; a smaller drop keeps a tenth
        # (at least one sample) for validation, as the JAX script does.
        n_tr = min(55000, max(len(tr_x) - max(len(tr_x) // 10, 1), 1))
        splits = {"train_data": tr_x[:n_tr], "train_labels": tr_y[:n_tr],
                  "val_data": tr_x[n_tr:], "val_labels": tr_y[n_tr:],
                  "test_data": te_x, "test_labels": te_y}
    else:
        say("no --data-dir: using synthetic class-structured digits")
        splits = synthetic_mnist(n_train=args.n_train, n_val=args.n_val,
                                 n_test=args.n_test, seed=args.seed)
    splits, Ls, perm = mnist_graph_data(splits, k=8, levels=4,
                                        seed=args.seed,
                                        edge_noise=args.edge_noise)
    ops = [device_laplacian(L, device=mesh.device if mesh else args.device)
           for L in Ls]

    model = ChebNet(ops, F=[32, 64], K=[args.K, args.K], p=[4, 4],
                    M=[512, 10], laplacians=Ls, filter=args.filter,
                    dropout=0.5, regularization=5e-4)
    n = splits["train_data"].shape[0]
    cfg = TrainConfig(
        num_epochs=args.epochs, learning_rate=args.learning_rate,
        decay_rate=0.95, decay_steps=n // args.batch_size,
        batch_size=args.batch_size, eval_frequency=200, seed=args.seed,
        mesh=mesh)
    trainer = Trainer(model, cfg, task="classification")
    hist, losses, t_step = trainer.fit(
        splits["train_data"], splits["train_labels"],
        splits["val_data"], splits["val_labels"])
    string, metrics = trainer.evaluate(splits["test_data"],
                                       splits["test_labels"])
    say(f"test  {string}")
    say(f"time per step: {t_step * 1000:.2f} ms")
    if mesh is not None:
        dist.destroy_process_group()
    return metrics, t_step


if __name__ == "__main__":
    main()
