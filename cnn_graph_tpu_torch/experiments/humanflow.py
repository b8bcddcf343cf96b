"""Human-flow forecasting: ResGNN / gconvLSTM over a city region graph.

The JAX package's ``experiments/humanflow.py`` on the port (the fork's
nips2016/humanflow*.py + gconvTest.py): load a HumanTraffic dataset
directory (``.mat`` files) through one of its nine loaders, build the
region graph's normalized Laplacian from the edge matrix, train a
forecasting model through ``Trainer(task="regression")``, and report
RMSE (after ``reverse_normalize``, humanflow.py:183-184) and MAPE over
targets above 20 (gconvTest.py:178-183).  Without ``--data-dir`` a
synthetic flow dataset with the same structure is written to a
temporary directory first, as JAX's ``build_dataset`` does.

``--model resgnn`` (``--filter chebyshev`` or ``fourier``), ``glstm``
(a ``GConvForecaster`` ``--variant``) or ``lstm`` (the graph-free
per-node LSTM baseline, ``load_lstm_data``).

Run:  python -m cnn_graph_tpu_torch.experiments.humanflow --model resgnn
          [--nres 4] [--device cpu]
      python -m cnn_graph_tpu_torch.experiments.humanflow --model glstm
          --variant glstm_gconv
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np

LOADERS = ("ln_period", "street", "unisolate", "threshold", "split_ln",
           "split_ln_period", "bj", "bj_clus", "bj_clus_period")


def write_synthetic(data_dir: str, nodes: int, seed: int):
    """The synthetic ``.mat`` files of JAX's ``build_dataset``: the LN
    flows with slow/fast splits, the edge matrix, the BJ flows and a BJ
    cluster variant with a missing (-1) stretch."""
    import scipy.io

    from cnn_graph_tpu_torch.data import synthetic_flow

    in_m, out_m, edges = synthetic_flow(n_nodes=nodes, n_steps=1400,
                                        seed=seed)
    rng = np.random.default_rng(seed + 1)
    frac = rng.uniform(0.3, 0.7, in_m.shape)
    split_in = np.stack([in_m * frac, in_m * (1 - frac)], axis=2)
    frac = rng.uniform(0.3, 0.7, out_m.shape)
    split_out = np.stack([out_m * frac, out_m * (1 - frac)], axis=2)
    scipy.io.savemat(os.path.join(data_dir, "ln_data.mat"),
                     {"inmatrix": in_m, "outmatrix": out_m,
                      "split_in_traffic": split_in,
                      "split_out_traffic": split_out})
    scipy.io.savemat(os.path.join(data_dir, "edge_matrix.mat"),
                     {"edge_matrix": edges})
    scipy.io.savemat(os.path.join(data_dir, "bj_data.mat"),
                     {"inmatrix": in_m, "outmatrix": out_m})
    in_bad = in_m.copy()
    in_bad[:, 700:705] = -1
    scipy.io.savemat(os.path.join(data_dir, "bj_clus.mat"),
                     {"inmatrix": in_bad, "outmatrix": out_m})


def load(ht, args):
    """The loader's splits and edge matrix; ``bj`` ships none, so an 8-NN
    grid graph over the square region lattice stands in (humanflow.py
    :73-88)."""
    from cnn_graph_tpu_torch.graphs import construction as gc

    loaders = {
        "ln_period": lambda: ht.load_ln_data_period(
            args.seq, args.seq_period, args.seq_trend, args.datafile),
        "street": lambda: ht.load_lndata_street(args.seq, args.datafile),
        "unisolate": lambda: ht.load_unisolate_data(args.seq),
        "threshold": lambda: ht.load_data(args.seq),
        "split_ln": lambda: ht.load_split_ln_data(args.seq, args.datafile),
        "split_ln_period": lambda: ht.load_split_ln_data_period(
            args.seq, args.seq_period, args.seq_trend, args.datafile),
        "bj": lambda: (*ht.load_bj_data(args.seq), None),
        "bj_clus": lambda: ht.load_bj_clus_data(args.seq),
        "bj_clus_period": lambda: ht.load_bj_clus_period_trend(args.seq),
    }
    out = loaders[args.loader]()
    splits, edges = out[:6], out[6]
    if edges is None:
        side = math.isqrt(splits[0].shape[1])
        if side * side != splits[0].shape[1]:
            raise ValueError("the bj loader needs a square region grid")
        edges = gc.knn_graph(gc.grid(side), k=8)
    return splits, edges


def main(argv=None):
    """Run the experiment; returns the test metrics (with ``rmse`` and
    ``mape`` in real units) and ``fit``'s seconds per step."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--datafile", default="ln_data.mat")
    p.add_argument("--loader", default="ln_period", choices=LOADERS)
    p.add_argument("--model", default="resgnn",
                   choices=["resgnn", "glstm", "lstm"],
                   help="'lstm' is the graph-free per-node LSTM baseline")
    p.add_argument("--variant", default="glstm_gconv")
    p.add_argument("--filter", default="chebyshev",
                   choices=["chebyshev", "fourier"],
                   help="spectral filter for resgnn")
    p.add_argument("--seq", type=int, default=4)
    p.add_argument("--seq-period", dest="seq_period", type=int, default=1)
    p.add_argument("--seq-trend", dest="seq_trend", type=int, default=1)
    p.add_argument("--nres", type=int, default=4)
    p.add_argument("--nfilter", type=int, default=64)
    p.add_argument("--K", type=int, default=2)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--nodes", type=int, default=64,
                   help="synthetic graph size without --data-dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-predictions", default=None,
                   help=".mat path for test predictions (gconvTest.py:171)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="flow_") as tmp:
        if args.data_dir is None:
            print("no --data-dir: fabricating a synthetic flow dataset")
            write_synthetic(tmp, args.nodes, args.seed)
        return _run(args, args.data_dir or tmp)


def _run(args, data_dir: str):
    import scipy.io
    import torch
    from scipy.sparse import csr_matrix

    from cnn_graph_tpu_torch.data import HumanTraffic
    from cnn_graph_tpu_torch.graphs import construction as gc
    from cnn_graph_tpu_torch.models import (
        GConvForecaster,
        PerNodeLSTM,
        ResGNN,
        stack_lstm_collection,
    )
    from cnn_graph_tpu_torch.ops import device_laplacian
    from cnn_graph_tpu_torch.train import TrainConfig, Trainer
    from cnn_graph_tpu_torch.utils.metrics import mape, rmse

    ht = HumanTraffic(data_dir)
    (tr, va, te, trl, val, tel), edges = load(ht, args)
    gen = torch.Generator().manual_seed(args.seed)

    if args.model == "lstm":
        # The loader has no validation split (85/15 train/test,
        # humantraffic.py:354-383): test doubles as the fit-time eval.
        d = stack_lstm_collection(ht.load_lstm_data(args.seq, 0,
                                                    args.datafile))
        tr, trl = d["train_data"], d["train_labels"]
        va = te = d["test_data"]
        val = tel = d["test_labels"]
        model = PerNodeLSTM(n_nodes=tr.shape[1], seq=args.seq,
                            num_hidden=args.nfilter, generator=gen,
                            device=args.device)
    else:
        L = gc.laplacian(csr_matrix(edges), normalized=True)
        op = device_laplacian(L, device=args.device)
        if args.model == "resgnn":
            fourier_u = (gc.fourier(L)[1] if args.filter == "fourier"
                         else None)
            model = ResGNN(op, input_features=tr.shape[2], K=args.K,
                           nfilter=args.nfilter, nres_layer_count=args.nres,
                           filter=args.filter, fourier_u=fourier_u,
                           generator=gen)
        else:
            model = GConvForecaster(
                op, seq_closeness=args.seq, seq_period=args.seq_period,
                seq_trend=args.seq_trend, variant=args.variant,
                num_hidden=args.nfilter, K=args.K, generator=gen)
            print("model:", model.to_string())

    cfg = TrainConfig(
        num_epochs=args.epochs, learning_rate=args.learning_rate,
        decay_rate=0.95, decay_steps=max(tr.shape[0] // args.batch_size, 1),
        batch_size=args.batch_size, eval_frequency=100, seed=args.seed)
    trainer = Trainer(model, cfg, task="regression")
    hist, losses, t_step = trainer.fit(
        tr.astype(np.float32), trl.astype(np.float32),
        va.astype(np.float32), val.astype(np.float32))
    string, metrics = trainer.evaluate(te.astype(np.float32),
                                       tel.astype(np.float32))
    print(f"test  {string}")
    preds_real = ht.reverse_normalize(metrics["predictions"])
    targets_real = ht.reverse_normalize(tel)
    metrics["rmse"] = rmse(targets_real, preds_real)
    metrics["mape"] = mape(targets_real, preds_real)
    print(f"RMSE (real units): {metrics['rmse']:.4f}")
    print(f"MAPE (targets>20): {metrics['mape']:.4f}")
    if args.save_predictions:
        scipy.io.savemat(args.save_predictions,
                         {"predictions": preds_real, "targets": targets_real})
        print(f"saved predictions to {args.save_predictions}")
    return metrics, t_step


if __name__ == "__main__":
    main()
