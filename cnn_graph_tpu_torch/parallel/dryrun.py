"""A dp x nodes dry run on tiny shapes: the torch twin of
``__graft_entry__.dryrun_multichip`` (:57-155).

Every rank of the world runs it:

* ResGNN on the dense halo operator (``halo_sharded_laplacian``) over a
  ``(data = world / 2, nodes = 2)`` mesh (``nodes = 1`` on an odd
  world): one adam step with the batch split over ``data``, each rank's
  node rows, and the gradients made global;
* NodeClassifier on the banded halo operator over a ``(1, world)`` mesh
  on ``city_graph(96)``: the loss and its gradients;
* one fused hop of each sparse halo format (``bsr``, ``banded``) on the
  same graph and mesh: ``sum |y|`` over every rank's rows.

Every value must be finite; rank 0 prints ``dryrun_multichip OK``.

Run:  python -m torch.distributed.run --standalone --nproc-per-node W \\
          -m cnn_graph_tpu_torch.parallel.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.models import NodeClassifier, ResGNN
from cnn_graph_tpu_torch.models.common import tree_leaves, tree_map
from cnn_graph_tpu_torch.parallel.banded_halo import banded_halo_laplacian
from cnn_graph_tpu_torch.parallel.halo import halo_sharded_laplacian
from cnn_graph_tpu_torch.parallel.mesh import (
    data_sharding,
    init_distributed,
    make_mesh,
    node_sum,
    replicated,
)
from cnn_graph_tpu_torch.parallel.sparse_halo import sparse_halo_laplacian
from cnn_graph_tpu_torch.train.optim import Optimizer
from cnn_graph_tpu_torch.train.trainer import TrainConfig

__all__ = ["dryrun_multichip"]


def dryrun_multichip(device=None) -> dict:
    """One sharded training step of each model on this rank and one hop
    of each sparse halo format (the process group is joined from the
    environment where it is not joined yet).  Returns the losses and the
    hops' ``sum |y|``."""
    if not dist.is_initialized():
        init_distributed(device)
    world = dist.get_world_size()
    nodes_ax = 2 if world % 2 == 0 else 1
    mesh = make_mesh(data=world // nodes_ax, nodes=nodes_ax, device=device)

    rng = np.random.default_rng(0)
    z = rng.uniform(size=(48, 2)).astype(np.float32)
    W = graphs.knn_graph(z, k=4)
    perm = graphs.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    op = halo_sharded_laplacian(graphs.laplacian(W, normalized=True), mesh)
    model = ResGNN(op, input_features=4, K=3, nfilter=8, nres_layer_count=1,
                   generator=torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                      replicated(mesh, model.param_tree()))
    leaves = tree_leaves(params)
    opt = Optimizer(TrainConfig(optimizer="adam", learning_rate=1e-3))
    state = opt.init(leaves)

    batch = 2 * mesh.shape["data"]
    x = rng.normal(size=(batch, 48, 4)).astype(np.float32)
    y = rng.normal(size=(batch, 48, 2)).astype(np.float32)
    x, y = (torch.from_numpy(np.ascontiguousarray(
        op.local_rows(data_sharding(mesh, a), axis=1))).to(mesh.device)
        for a in (x, y))
    loss = model.loss(params, x, y)
    grads = mesh.sync_grads(list(torch.autograd.grad(loss, leaves)))
    with torch.no_grad():
        updates, state = opt.update(grads, state)
        for p, u in zip(leaves, updates):
            p.add_(u)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite loss in the dp x nodes dry run")

    nodes_mesh = make_mesh(data=1, nodes=world, device=device)
    Lc, _ = graphs.city_graph(96, k=8, seed=0)
    bop = banded_halo_laplacian(Lc, nodes_mesh, rows_per_step=1)
    nc = NodeClassifier(bop, 3, 2, hidden=[4], K=3, dropout=1.0,
                        generator=torch.Generator().manual_seed(1))
    nc_params = nc.param_tree()
    feats = rng.normal(size=(bop.m_padded, 3)).astype(np.float32)
    labels = rng.integers(0, 2, bop.m_padded)
    dev = nodes_mesh.device
    f, lab = (torch.from_numpy(np.ascontiguousarray(bop.local_rows(a))).to(
        dev) for a in (feats, labels))
    mask = torch.ones(bop.rows_per_shard, dtype=torch.bool, device=dev)
    nc_loss = nc.loss(nc_params, f, lab, mask)
    nc_grads = nodes_mesh.sync_grads(list(torch.autograd.grad(
        nc_loss, tree_leaves(nc_params))))
    if not (bool(torch.isfinite(nc_loss)) and all(
            bool(torch.isfinite(g).all()) for g in nc_grads)):
        raise RuntimeError("non-finite banded-halo loss in the dry run")

    # One fused hop of each sparse halo format (JAX :138-155).
    x1, x0 = (rng.normal(size=(bop.m_padded, 4)).astype(np.float32)
              for _ in range(2))
    sparse = {}
    for fmt in ("bsr", "banded"):
        shop = sparse_halo_laplacian(Lc, nodes_mesh, fmt=fmt)
        a, b = (torch.from_numpy(np.ascontiguousarray(shop.local_rows(
            v[:shop.m_padded]))).to(dev) for v in (x1, x0))
        with torch.no_grad():
            val = float(node_sum(shop.cheby_hop(a, b).abs().sum(),
                                 nodes_mesh))
        if not np.isfinite(val):
            raise RuntimeError(f"non-finite sparse-halo[{fmt}] hop")
        sparse[f"sparse_{fmt}"] = val
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: world {world}, dp x nodes "
              f"{dict(mesh.shape)} loss {float(loss.detach()):.4f}, banded "
              f"halo loss {float(nc_loss.detach()):.4f}, sparse halo hops "
              f"{sparse}", flush=True)
    return {"loss": float(loss.detach()),
            "banded_loss": float(nc_loss.detach()), **sparse}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    dryrun_multichip(args.device)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
