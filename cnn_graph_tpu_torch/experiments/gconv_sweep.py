"""Hyper-parameter sweep over the gLSTM forecasters (the reference's
gconvTest.py).

The JAX package's ``experiments/gconv_sweep.py`` on the port: closeness
lengths x learning rates x variants x layer counts, each trial isolated
(a trial that raises is reported and the sweep goes on), RMSE and MAPE
in real units per trial and a final ranking by RMSE.  Without
``--data-dir`` a synthetic flow dataset is written to a temporary
directory first.

Run:  python -m cnn_graph_tpu_torch.experiments.gconv_sweep
          [--data-dir DIR] [--trials-limit N] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import tempfile

import numpy as np

# The gconvTest.py:82-111 grid, trimmed to tractable defaults as JAX's.
GRID = (
    [3, 4],                      # seq_num_closeness
    [1e-3, 5e-3],                # learning rate
    ["glstm", "glstm_gconv"],    # infer variant
    [1, 2],                      # lstm layer count
)


def main(argv=None):
    """Run the sweep; returns ``[(tag, rmse, mape)]`` in grid order."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-dir", default=None)
    p.add_argument("--nodes", type=int, default=48)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--trials-limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="flow_") as tmp:
        data_dir = args.data_dir
        if data_dir is None:
            import scipy.io

            from cnn_graph_tpu_torch.data import synthetic_flow

            data_dir = tmp
            in_m, out_m, edges = synthetic_flow(n_nodes=args.nodes,
                                                n_steps=1400, seed=args.seed)
            scipy.io.savemat(os.path.join(data_dir, "ln_data.mat"),
                             {"inmatrix": in_m, "outmatrix": out_m})
            scipy.io.savemat(os.path.join(data_dir, "edge_matrix.mat"),
                             {"edge_matrix": edges})
        return _sweep(args, data_dir)


def _sweep(args, data_dir: str) -> list:
    import torch
    from scipy.sparse import csr_matrix

    from cnn_graph_tpu_torch.data import HumanTraffic
    from cnn_graph_tpu_torch.graphs import construction as gc
    from cnn_graph_tpu_torch.models import GConvForecaster
    from cnn_graph_tpu_torch.ops import device_laplacian
    from cnn_graph_tpu_torch.train import TrainConfig, Trainer
    from cnn_graph_tpu_torch.utils.metrics import mape, rmse

    grid = list(itertools.product(*GRID))
    if args.trials_limit:
        grid = grid[:args.trials_limit]
    print(f"sweep: {len(grid)} trials")

    results = []
    for seq, lr, variant, layers in grid:
        tag = f"seq={seq} lr={lr} variant={variant} layers={layers}"
        try:
            ht = HumanTraffic(data_dir)
            # The gLSTM variants reshape channels by the closeness length,
            # so they take closeness-only windows, as JAX's sweep does.
            tr, va, te, trl, val, tel, edges = ht.load_ln_data_period(
                seq, 0, 0)
            L = gc.laplacian(csr_matrix(edges), normalized=True)
            op = device_laplacian(L, device=args.device)
            model = GConvForecaster(
                op, seq_closeness=seq, variant=variant, num_hidden=32,
                lstm_layer_count=layers,
                generator=torch.Generator().manual_seed(args.seed))
            cfg = TrainConfig(num_epochs=args.epochs, learning_rate=lr,
                              decay_steps=max(tr.shape[0] // 50, 1),
                              batch_size=50, eval_frequency=10**9,
                              seed=args.seed)
            trainer = Trainer(model, cfg, task="regression")
            trainer.fit(tr.astype(np.float32), trl.astype(np.float32),
                        va.astype(np.float32), val.astype(np.float32),
                        verbose=False)
            _, metrics = trainer.evaluate(te.astype(np.float32),
                                          tel.astype(np.float32))
            targets = ht.reverse_normalize(tel)
            preds = ht.reverse_normalize(metrics["predictions"])
            r, m = rmse(targets, preds), mape(targets, preds)
            print(f"{model.to_string()} | RMSE {r:.4f} | MAPE {m:.4f}")
            results.append((tag, r, m))
        except Exception as e:  # per-trial isolation
            print(f"{tag} FAILED: {type(e).__name__}: {e}")
            results.append((tag, float("inf"), float("inf")))

    print("\n=== ranking (by RMSE) ===")
    for tag, r, m in sorted(results, key=lambda t: t[1]):
        print(f"RMSE {r:9.4f}  MAPE {m:7.4f}  {tag}")
    return results


if __name__ == "__main__":
    main()
