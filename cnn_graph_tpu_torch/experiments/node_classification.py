"""Large-graph transductive node classification, and the serving
artifact of the trained model.

The JAX package's ``experiments/node_classification.py`` on the port,
single chip: a planted-partition graph on a planar layout (``build_graph``:
communities are spatial patches, so the kNN graph is RCM-bandable and
label-correlated), ``device_laplacian(fmt="auto")`` (banded at the
default 100,000 nodes, K1 on the card), a NodeClassifier (hidden 64,
K=3, keep probability 0.8) trained full-batch by
``train.train_node_classifier`` (optax's adam), train and test accuracy.
``--int8`` quantizes the trained operator to its int8 twin and prints the
accuracy delta and the f32 and int8 inference times with Gedges/s over
20 chained calls (CUDA events on the card, the host clock on the CPU);
``--export DIR`` writes the trained model as a serving artifact
(``serve.export_serving``, int8 with ``--int8``; single chip only).

``--mesh-nodes N`` shards the operator's rows over a ``(data = world //
N, nodes = N)`` mesh (JAX :108-126) with ``--halo``: ``banded`` (the
default, ``parallel.banded_halo_laplacian``, its hops K1 on
halo-extended x), ``sparse`` (``parallel.sparse_halo_laplacian``, the
block-sparse shard, K8) or ``sparse-banded`` (its per-shard banded
format, K5).  Every rank builds the graph, keeps its rows of the
features, labels and masks, and trains; rank 0 prints, and also the
per-rank launches per training step of the operator's kernel.  Launch
one process per rank:

    python -m torch.distributed.run --standalone --nproc-per-node W \\
        -m cnn_graph_tpu_torch.experiments.node_classification \\
        --mesh-nodes N [--halo sparse] [--int8]

Each rank takes ``cuda:(LOCAL_RANK % device_count())``; ranks that share
a card exchange over gloo (``parallel.mesh``).

Run:  python -m cnn_graph_tpu_torch.experiments.node_classification
          [--nodes 100000] [--int8] [--export DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

CHAIN = 20  # chained inference calls per timing, as the JAX driver


def build_graph(n_nodes: int, n_classes: int, feat_dim: int, seed: int):
    """The JAX driver's graph (:26-53): points on a jittered grid, labels
    by 8 x 8 spatial patch, features a class signature plus noise, the
    8-NN Gaussian graph in RCM order.  Returns ``(L, features,
    labels)`` in that order."""
    from cnn_graph_tpu_torch import graphs

    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_nodes)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([xs.ravel(), ys.ravel()], 1)[:n_nodes].astype(np.float32)
    pos += rng.normal(0, 0.3, pos.shape).astype(np.float32)
    patch = (pos[:, 0] // (side / 8)).astype(int) * 8 + (
        pos[:, 1] // (side / 8)).astype(int)
    labels = (patch % n_classes).astype(np.int64)
    signatures = rng.normal(0, 1, (n_classes, feat_dim)).astype(np.float32)
    feats = signatures[labels] + rng.normal(0, 1.0, (n_nodes, feat_dim)
                                            ).astype(np.float32)
    dist, idx = graphs.knn(pos, k=8, algorithm="auto")
    W = graphs.adjacency(dist, idx)
    perm = graphs.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return graphs.laplacian(W, normalized=True), feats[perm], labels[perm]


def node_data(feats, labels, m_padded: int, train_frac: float, seed: int):
    """The features and labels zero-padded to the operator's rows, and
    the train and test masks (a ``train_frac`` share of the real nodes
    for training, the rest for testing), as the JAX driver draws them."""
    n, f = feats.shape
    fp = np.zeros((m_padded, f), np.float32)
    fp[:n] = feats
    yp = np.zeros((m_padded,), np.int64)
    yp[:n] = labels
    rng = np.random.default_rng(seed)
    train = np.zeros(m_padded, bool)
    train[:n] = rng.random(n) < train_frac
    test = np.zeros(m_padded, bool)
    test[:n] = ~train[:n]
    return fp, yp, train, test


def _chain_ms(model, params, features, dev) -> float:
    """ms per call over ``CHAIN`` chained calls, each input scaled by its
    predecessor's output (the JAX driver's data-dependent chain), after
    one untimed chain that checks the output is finite."""
    import torch

    def chain():
        x = features
        for _ in range(CHAIN):
            logits = model.apply(params, x)
            x = x * (1.0 + 1e-6 * torch.tanh(logits.mean()))
        return x

    with torch.inference_mode():
        if not bool(torch.isfinite(chain()).all()):
            raise RuntimeError("the inference chain is not finite")
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            chain()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / CHAIN
        t0 = time.perf_counter()
        chain()
        return (time.perf_counter() - t0) * 1e3 / CHAIN


def parser() -> argparse.ArgumentParser:
    """The driver's arguments, with the JAX driver's defaults."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nodes", type=int, default=100000)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--hidden", type=int, nargs="*", default=[64])
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--train-frac", type=float, default=0.1)
    p.add_argument("--mesh-nodes", type=int, default=0,
                   help=">0: shard the operator's rows over a (data = "
                   "world // N, nodes = N) mesh")
    p.add_argument("--halo", choices=["sparse", "banded", "sparse-banded"],
                   default="banded", help="the sharded operator: the "
                   "banded ring halo, the block-sparse all_to_all halo or "
                   "its per-shard banded format")
    p.add_argument("--int8", action="store_true",
                   help="after training, quantize the operator to int8 and "
                   "report the accuracy delta and inference timing")
    p.add_argument("--export", metavar="DIR", default=None,
                   help="write the trained model as a serving artifact "
                   "(serve.export_serving; int8 with --int8; single chip)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p


def main(argv=None) -> dict:
    """Run the driver; returns its accuracies and times."""
    args = parser().parse_args(argv)
    if args.mesh_nodes > 0 and args.export:
        raise ValueError("--export writes the single-chip artifact; it "
                         "takes no --mesh-nodes")

    import torch

    from cnn_graph_tpu_torch import serve
    from cnn_graph_tpu_torch.models import NodeClassifier
    from cnn_graph_tpu_torch.models.common import (
        operator_device,
        quantize_model_operators,
    )
    from cnn_graph_tpu_torch.ops import (
        banded_dkw,
        banded_uniform,
        bsr_csr,
        device_laplacian,
    )
    from cnn_graph_tpu_torch.train import train_node_classifier

    mesh = None
    if args.mesh_nodes > 0:
        import torch.distributed as dist

        from cnn_graph_tpu_torch.parallel import (
            banded_halo_laplacian,
            init_distributed,
            make_mesh,
            sparse_halo_laplacian,
        )

        init_distributed(args.device)
        mesh = make_mesh(data=dist.get_world_size() // args.mesh_nodes,
                         nodes=args.mesh_nodes, device=args.device)
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    t0 = time.perf_counter()
    L, feats, labels = build_graph(args.nodes, args.classes, args.features,
                                   args.seed)
    say(f"graph: {L.shape[0]} nodes, {L.nnz} nnz "
        f"({time.perf_counter() - t0:.1f}s host precompute)")
    if mesh is None:
        op = device_laplacian(L, fmt="auto", device=args.device)
        say(f"operator: {type(op).__name__} on {operator_device(op)}")
    elif args.halo == "banded":
        op = banded_halo_laplacian(L, mesh)
        say(f"banded-halo operator: band {tuple(op.band.shape[1:])} /shard, "
            f"halo {op.halo_left}+{op.halo_right} block-rows, mesh "
            f"{dict(mesh.shape)}, rank 0 on {mesh.device}")
    elif args.halo == "sparse-banded":
        op = sparse_halo_laplacian(L, mesh, fmt="banded")
        say(f"sparse-banded operator: band {tuple(op.band.shape[1:])} x "
            f"{op.band.shape[0]} block-rows/shard, halo {op.halo} "
            f"rows/peer, mesh {dict(mesh.shape)}, rank 0 on {mesh.device}")
    else:
        op = sparse_halo_laplacian(L, mesh)
        say(f"sparse-halo operator: {op.blocks.shape[0]} blocks on rank 0, "
            f"halo {op.halo} rows/peer, mesh {dict(mesh.shape)}, rank 0 on "
            f"{mesh.device}")
    dev = operator_device(op)
    fp, yp, train, test = node_data(feats, labels, op.m_padded,
                                    args.train_frac, args.seed)
    sample = float(np.abs(fp).max())
    if mesh is not None:
        fp, yp, train, test = (op.local_rows(a) for a in (fp, yp, train,
                                                          test))
    features, y, train_mask, test_mask = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (fp, yp, train, test))

    model = NodeClassifier(op, args.features, args.classes,
                           hidden=args.hidden, K=args.K, dropout=0.8,
                           generator=torch.Generator().manual_seed(args.seed))
    # The kernel of the operator's products: K1 (the banded ring halo
    # and a single-chip banded operator), K5 (sparse-banded) or the BSR
    # row kernel as K8 (sparse).
    kernel, kname = {"sparse": (bsr_csr, "K8"),
                     "sparse-banded": (banded_uniform, "K5")}.get(
        args.halo if mesh is not None else "", (banded_dkw, "K1"))
    k_before = kernel.launches
    t0 = time.perf_counter()
    params, losses = train_node_classifier(
        model, model.param_tree(), features, y, train_mask,
        steps=args.steps, learning_rate=args.learning_rate,
        generator=torch.Generator(device=dev).manual_seed(1))
    losses = losses.tolist()  # waits for the device
    wall = time.perf_counter() - t0
    k_per_step = (kernel.launches - k_before) / args.steps
    with torch.inference_mode():
        train_acc = float(model.accuracy(params, features, y, train_mask))
        test_acc = float(model.accuracy(params, features, y, test_mask))
    say(f"trained {args.steps} steps in {wall:.1f}s "
        f"({wall / args.steps * 1000:.1f} ms/step)")
    say(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} | "
        f"train acc {train_acc:.3f} | test acc {test_acc:.3f}")
    out = {"train_acc": train_acc, "test_acc": test_acc, "losses": losses,
           "ms_per_step": wall / args.steps * 1e3}
    if mesh is not None:
        ranks = mesh.all_gather(torch.tensor(
            [k_per_step], dtype=torch.float64, device=dev), "nodes").tolist()
        say(f"{kname} launches per training step by rank: {ranks}")
        out["kernel_launches_per_step"] = ranks

    if args.int8:
        qmodel = quantize_model_operators(model, sample_x=sample)
        with torch.inference_mode():
            int8_acc = float(qmodel.accuracy(params, features, y,
                                             test_mask))
        say(f"int8 test acc {int8_acc:.4f} "
            f"(delta vs f32 {int8_acc - test_acc:+.4f})")
        out["int8_test_acc"] = int8_acc
        n_spmm = (len(args.hidden) + 1) * (args.K - 1)
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")
        for name, m in (("f32 ", model), ("int8", qmodel)):
            ms = _chain_ms(m, params, features, dev)
            say(f"{name} inference {ms:7.2f} ms/graph  "
                f"{op.nnz * n_spmm / ms / 1e6:6.3f} Gedges/s "
                f"({n_spmm} spmm/inference) [{where}]")
            out[f"{name.strip()}_ms"] = ms

    if args.export:
        serve.export_serving(model, params, features, args.export,
                             int8=args.int8, sample_x=sample)
        print(f"serving artifact written to {args.export} "
              f"(int8={args.int8}); load with "
              f"cnn_graph_tpu_torch.serve.load_serving")
    if mesh is not None:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
