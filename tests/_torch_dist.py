"""Worker processes for the port's distributed CPU tests.

``run_world(task, world, tmp_path, **inputs)`` starts ``world`` Python
processes running this file; each joins a gloo process group through a
``file://`` store in ``tmp_path`` (no TCP port, so that test workers
running side by side cannot collide), runs ``TASKS[task]`` on its rank
and writes its results to ``tmp_path/out<rank>.npz``, which the caller
gets back as one dict per rank.  Inputs travel the same way, as NumPy
arrays in ``tmp_path/in.npz``.  This module imports torch and the port
only: the tests' parent process holds JAX (tests/conftest.py imports
it), the workers never do.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(task: str, world: int, tmp_path, timeout: float = 300,
              **inputs) -> list:
    """Run ``task`` on ``world`` ranks; returns each rank's results."""
    tmp = str(tmp_path)
    np.savez(os.path.join(tmp, "in.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         tmp], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {task!r} failed "
                               f"({p.returncode}):\n{err[-6000:]}")
    return [dict(np.load(os.path.join(tmp, f"out{r}.npz"), allow_pickle=False))
            for r in range(world)]


def gathered(results: list, key: str, axis: int = 0,
             mesh: str = "") -> np.ndarray:
    """``key`` of the ranks with data coordinate 0, concatenated along
    ``axis`` in nodes order: the global array from each rank's rows.
    ``mesh`` names the coordinates a worker saved with ``_coords``."""
    ranks = sorted((r for r in results if int(r[f"coord{mesh}"][0]) == 0),
                   key=lambda r: int(r[f"coord{mesh}"][1]))
    return np.concatenate([r[key] for r in ranks], axis=axis)


# ------------------------------------------------------------- workers


def _csr(inp):
    import scipy.sparse

    return scipy.sparse.csr_matrix(
        (inp["L_data"], inp["L_indices"], inp["L_indptr"]),
        shape=tuple(inp["L_shape"]))


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _coords(out, mesh, name: str = ""):
    out[f"coord{name}"] = np.array([mesh.coord("data"), mesh.coord("nodes")])


def _per_hop(op, v, K):
    import torch

    b = [v]
    if K > 1:
        b.append(op.matmul(v))
    for _ in range(2, K):
        b.append(op.cheby_hop(b[-1], b[-2]))
    return torch.stack(b)


def _task_banded(inp, rank, world):
    """The banded halo operator over a (1, world) mesh: every case of
    tests/test_torch_banded_halo.py on this rank's rows."""
    import torch

    from cnn_graph_tpu_torch.models import NodeClassifier, common
    from cnn_graph_tpu_torch.ops import cheby_basis, cheby_conv
    from cnn_graph_tpu_torch.parallel import (
        QuantBandedHaloLaplacian,
        banded_halo_laplacian,
        make_mesh,
        quantize_banded_halo,
    )
    from cnn_graph_tpu_torch.train import train_node_classifier

    L = _csr(inp)
    G = int(inp["G"])
    mesh = make_mesh(data=1, nodes=world, device="cpu")
    out = {}
    _coords(out, mesh)
    op = banded_halo_laplacian(L, mesh, rows_per_step=G, use_pallas=False)
    uni = banded_halo_laplacian(L, mesh, rows_per_step=G, use_pallas=False,
                                ragged=False)
    dkw = banded_halo_laplacian(L, mesh, rows_per_step=G, use_pallas=True)
    split = banded_halo_laplacian(L, mesh, rows_per_step=1, use_pallas=True)
    flat = dataclasses.replace(split, overlap=False)
    for name, o in (("op", op), ("uni", uni), ("dkw", dkw),
                    ("split", split)):
        out[f"{name}_meta"] = np.array([
            o.m_padded, o.halo_left, o.halo_right, o.boundary_pre,
            o.boundary_suf, int(o.overlap), o.rows_per_shard])
    out["levels"] = np.array(op.levels)
    loc = op.local_rows

    x = _t(loc(inp["x64"]))
    for name, o in (("op", op), ("uni", uni), ("dkw", dkw),
                    ("split", split)):
        out[f"matmul_{name}"] = _np(o.matmul(x))
        out[f"chain5_{name}"] = _np(o.cheby_chain(_t(loc(inp["x32"])), 5))
    x1, x0 = _t(loc(inp["x1"])), _t(loc(inp["x0"]))
    out["hop"] = _np(op.cheby_hop(x1, x0))

    v = _t(loc(inp["x16"])).requires_grad_()
    (op.cheby_hop(v, 0.5 * v) ** 2).sum().backward()
    out["hop_grad"] = _np(v.grad)

    # The interior/boundary split against the single pass: y and grad.
    a, b = (_t(split.local_rows(inp[k])) for k in ("s1", "s0"))
    for name, o in (("split", split), ("flat", flat)):
        out[f"split_y_{name}"] = _np(o.cheby_hop(a, b))
        ag = a.clone().requires_grad_()
        (o.cheby_hop(ag, b) ** 2).sum().backward()
        out[f"split_g_{name}"] = _np(ag.grad)

    # The chain: bit-exact with per hop; its adjoint against autodiff
    # through the per-hop autograd functions; small K.
    xc = _t(loc(inp["xc"]))
    out["chain7"] = _np(op.cheby_chain(xc, 7))
    out["chain7_hops"] = _np(_per_hop(op, xc, 7))
    for K in (1, 2, 3, 6):
        t = _t(loc(inp[f"t{K}"], axis=1))
        xs = _t(loc(inp[f"xg{K}"]))
        for way, f in (("chain", lambda o, u, K=K: o.cheby_chain(u, K)),
                       ("hops", lambda o, u, K=K: _per_hop(o, u, K))):
            u = xs.clone().requires_grad_()
            y = f(op, u)
            (y * t).sum().backward()
            out[f"g{K}_{way}"] = _np(u.grad)
            out[f"y{K}_{way}"] = _np(y)

    # The chain and its adjoint through the interior/boundary split.
    xs6 = _t(split.local_rows(inp["xg6"]))
    t6 = _t(split.local_rows(inp["t6"], axis=1))
    u = xs6.clone().requires_grad_()
    y = split.cheby_chain(u, 6)
    (y * t6).sum().backward()
    out["y6_split"], out["g6_split"] = _np(y), _np(u.grad)

    # cheby_basis dispatches the one-call chain.
    xb = _t(loc(inp["xb"], axis=1))
    out["basis"] = _np(cheby_basis(xb, op, 5))

    # int8: the chain against per hop; the split; the payload.
    qop = quantize_banded_halo(op, sample_x=3.0)
    out["band_scale"] = np.float64(qop.band_scale)
    xq = _t(loc(inp["xq16"]))
    out["qchain"] = _np(qop.cheby_chain_q(xq, 6))
    out["qchain_hops"] = _np(torch.stack(
        _quant_hops(qop, xq, 6)))
    xq32 = _t(loc(inp["xq32"]))
    out["qchain9"] = _np(torch.stack(_quant_hops(qop, xq32, 9)))
    qs = quantize_banded_halo(split, sample_x=3.0)
    qf = dataclasses.replace(qs, overlap=False)
    q1, q0 = (_t(split.local_rows(inp[k])) for k in ("q1", "q0"))
    out["qsplit_split"] = _np(qs.cheby_hop_q(q1, q0))
    out["qsplit_flat"] = _np(qf.cheby_hop_q(q1, q0))
    qd = quantize_banded_halo(dkw, sample_x=3.0)
    out["qchain9_dkw"] = _np(torch.stack(_quant_hops(qd, xq32, 9)))
    mesh.traffic.clear()
    qop.spmm_q(torch.zeros((op.rows_per_shard, 16), dtype=torch.int8))
    out["traffic_int8"] = np.int64(mesh.traffic["torch.int8"])
    out["traffic_all"] = np.int64(sum(mesh.traffic.values()))

    # cheby_conv and the model through the int8 twin.
    w = _t(inp["w_conv"])
    xs = _t(loc(inp["x_conv"], axis=1))
    model = NodeClassifier(op, input_features=16, num_classes=4, hidden=[8],
                           K=4)
    params = _params(inp, "srv_")
    qmodel = common.quantize_model_operators(model, sample_x=3.0)
    out["quant_is_halo"] = np.bool_(isinstance(qmodel.op,
                                               QuantBandedHaloLaplacian))
    with torch.no_grad():
        out["qconv"] = _np(cheby_conv(xs, qmodel.op, w))
        out["y_f"] = _np(model.apply(params, xs[0]))
        out["y_q"] = _np(qmodel.apply(params, xs[0]))

    # The NodeClassifier: logits, loss and gradients, then 20 adam steps.
    nc = NodeClassifier(op, input_features=8, num_classes=2, hidden=[8],
                        K=3, dropout=1.0)
    p = _params(inp, "nc_")
    feats, labels, mask = (_t(loc(inp[k])) for k in ("feats", "labels",
                                                     "mask"))
    leaves = [p["convs"][i][k] for i in range(2) for k in ("w", "b")]
    for t in leaves:
        t.requires_grad_()
    loss = nc.loss(p, feats, labels, mask)
    grads = mesh.sync_grads(list(torch.autograd.grad(loss, leaves)))
    out["nc_logits"] = _np(nc.apply(p, feats))
    out["nc_loss"] = _np(loss)
    for i, g in enumerate(grads):
        out[f"nc_grad{i}"] = _np(g)
    out["nc_acc"] = _np(nc.accuracy(p, feats, labels, mask))
    _, losses = train_node_classifier(nc, _params(inp, "nc_"), feats, labels,
                                      mask, steps=20, learning_rate=1e-2)
    out["nc_losses"] = _np(losses)
    return out


def _quant_hops(q, x, K):
    b = [x, q.spmm_q(x)]
    for _ in range(2, K):
        b.append(q.cheby_hop_q(b[-1], b[-2]))
    return b


def _params(inp, prefix):
    """A NodeClassifier parameter tree from ``<prefix>w<i>``/``b<i>``."""
    n = sum(1 for k in inp if k.startswith(prefix + "w"))
    return {"convs": [{"w": _t(inp[f"{prefix}w{i}"]),
                       "b": _t(inp[f"{prefix}b{i}"])} for i in range(n)]}


def _tree(inp, prefix):
    """A tree flattened as ``<prefix><path joined by '.'>``."""
    import torch

    tree = {}
    for k, v in inp.items():
        if not k.startswith(prefix):
            continue
        *path, last = k[len(prefix):].split(".")
        node = tree
        for a in path:
            node = node.setdefault(a, {})
        node[last] = torch.from_numpy(np.array(v))

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def tree_map_np(tree):
    from cnn_graph_tpu_torch.models.common import tree_map

    return tree_map(_np, tree)


def flat_tree(tree, prefix: str = "") -> dict:
    """The inverse of ``_tree``: ``{prefix + path: array}``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _task_halo(inp, rank, world):
    """The dense all_to_all halo operator over (2, 2) and (1, 4)
    meshes: every case of tests/test_torch_halo.py."""
    import torch

    from cnn_graph_tpu_torch.ops import cheby_conv
    from cnn_graph_tpu_torch.parallel import (
        halo_sharded_laplacian,
        make_mesh,
        node_sum,
    )

    L = _csr(inp)
    out = {}
    for nodes in (2, 4):
        mesh = make_mesh(data=world // nodes, nodes=nodes, device="cpu")
        _coords(out, mesh, f"n{nodes}")
        op = halo_sharded_laplacian(L, mesh)
        out[f"meta_n{nodes}"] = np.array([op.m_padded, op.halo,
                                          op.rows_per_shard])
        x = _t(op.local_rows(inp["x16"])).requires_grad_()
        y = op.matmul(x)
        (y * _t(op.local_rows(inp["t16"]))).sum().backward()
        out[f"matmul_n{nodes}"] = _np(y)
        out[f"matmul_grad_n{nodes}"] = _np(x.grad)
        if nodes != 2:
            continue
        xc = _t(op.local_rows(inp["x_conv"], axis=1))
        with torch.no_grad():
            out["conv"] = _np(cheby_conv(xc, op, _t(inp["w_conv"])))
        xg = _t(op.local_rows(inp["x_grad"], axis=1))
        w = _t(inp["w_grad"]).requires_grad_()
        y = cheby_conv(xg, op, w)[:, :op.real_rows]
        loss = node_sum((y ** 2).sum(), mesh)
        (g,) = mesh.sync_grads(list(torch.autograd.grad(loss, [w])))
        out["conv_loss"] = _np(loss)
        out["conv_grad"] = _np(g)
    return out


def _resgnn_step(op, mesh, inp, lr):
    """One sgd step of JAX's ResGNN test on this rank's slice: the batch
    over ``data``, the node rows over ``nodes``."""
    import torch

    from cnn_graph_tpu_torch.models import ResGNN
    from cnn_graph_tpu_torch.models.common import tree_leaves, tree_map
    from cnn_graph_tpu_torch.parallel import data_sharding

    model = ResGNN(op, input_features=4, K=3, nfilter=8, nres_layer_count=1)
    params = _tree(inp, "resgnn.")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    x, y = (_t(op.local_rows(data_sharding(mesh, inp[k]), axis=1))
            for k in ("x_step", "y_step"))
    loss = model.loss(params, x, y)
    grads = mesh.sync_grads(list(torch.autograd.grad(loss, leaves)))
    if mesh.shape["data"] > 1:
        loss = mesh.all_reduce(loss.detach().clone(), "data") / (
            mesh.shape["data"])
    new = iter([(p - lr * g).detach() for p, g in zip(leaves, grads)])
    return loss, tree_map(lambda _: next(new), params)


def _fit(model, cfg, x, y, task):
    from cnn_graph_tpu_torch.models.common import tree_leaves
    from cnn_graph_tpu_torch.train import Trainer

    tr = Trainer(model, cfg, task=task)
    _, losses, _ = tr.fit(x, y, x[:8], y[:8], verbose=False)
    return [_np(t) for t in tree_leaves(tr.params)], np.array(losses)


def _task_parallel(inp, rank, world):
    """The mesh, the all-gather operator, dp x nodes training (one step
    against JAX's, and the Trainer against one process), the dry run
    and the export refusal: every case of tests/test_torch_parallel.py."""
    import torch

    from cnn_graph_tpu_torch import serve
    from cnn_graph_tpu_torch.models import ChebNet, NodeClassifier, ResGNN
    from cnn_graph_tpu_torch.ops import cheby_conv, device_laplacian
    from cnn_graph_tpu_torch.parallel import (
        data_sharding,
        halo_sharded_laplacian,
        make_mesh,
        node_sharded_laplacian,
        replicated,
    )
    from cnn_graph_tpu_torch.parallel.dryrun import dryrun_multichip
    from cnn_graph_tpu_torch.train import TrainConfig

    L = _csr(inp)
    out = {}
    mesh = make_mesh(device="cpu")
    out["default_shape"] = np.array([mesh.shape["data"], mesh.shape["nodes"]])
    mesh22 = make_mesh(data=2, nodes=2, device="cpu")
    out["shape22"] = np.array([mesh22.shape["data"], mesh22.shape["nodes"]])
    try:
        make_mesh(data=3, nodes=2, device="cpu")
        out["bad_factorization"] = np.bool_(False)
    except AssertionError:
        out["bad_factorization"] = np.bool_(True)
    try:
        data_sharding(mesh22, np.zeros((3, 2)))
        out["indivisible_batch"] = np.bool_(False)
    except ValueError:
        out["indivisible_batch"] = np.bool_(True)
    t = torch.full((3,), float(rank))
    replicated(mesh22, {"a": [t]})
    out["replicated"] = _np(t)

    for nodes in (1, 2, 4):
        m = make_mesh(data=world // nodes, nodes=nodes, device="cpu")
        _coords(out, m, f"n{nodes}")
        op = node_sharded_laplacian(L, m)
        out[f"ns_matmul_n{nodes}"] = _np(op.matmul(_t(op.local_rows(
            inp["x_ns"]))))
        if nodes == 2:
            xc = _t(op.local_rows(inp["x_conv"], axis=1))
            with torch.no_grad():
                out["ns_conv"] = _np(cheby_conv(xc, op, _t(inp["w_conv"])))

    # dp x nodes: JAX's one sgd step, through the all-gather and the
    # dense halo operators.
    Lr = _csr({k[1:]: v for k, v in inp.items() if k.startswith("R")})
    _coords(out, mesh22, "22")
    for name, build in (("ns", node_sharded_laplacian),
                        ("halo", halo_sharded_laplacian)):
        loss, new = _resgnn_step(build(Lr, mesh22), mesh22, inp, 0.1)
        out[f"step_loss_{name}"] = _np(loss)
        out.update(flat_tree(tree_map_np(new), f"step_{name}."))

    # The Trainer on the (2, 2) mesh against one process: ResGNN over
    # the dense halo operator, regression.
    x, y = inp["x_fit"], inp["y_fit"]
    cfg = TrainConfig(num_epochs=2, batch_size=8, eval_frequency=4,
                      learning_rate=0.01, decay_steps=None, seed=7)
    hop = halo_sharded_laplacian(Lr, mesh22)
    dense = device_laplacian(Lr, fmt="dense", device="cpu")
    gen = torch.Generator().manual_seed(0)
    for name, o, c in (("one", dense, cfg),
                       ("mesh", hop, dataclasses.replace(cfg, mesh=mesh22))):
        model = ResGNN(o, input_features=3, K=3, nfilter=4,
                       nres_layer_count=1, out_features=2,
                       generator=gen.manual_seed(0))
        leaves, losses = _fit(model, c, x, y, "regression")
        out[f"fit_{name}_losses"] = losses
        for i, p in enumerate(leaves):
            out[f"fit_{name}_{i}"] = p

    # Batch data parallelism (data = world): ChebNet with dropout, whose
    # masks are the one-process run's.
    xc, yc = inp["x_cls"], inp["y_cls"]
    Lc = _csr({k[1:]: v for k, v in inp.items() if k.startswith("C")})
    cfg = TrainConfig(num_epochs=2, batch_size=16, eval_frequency=4,
                      learning_rate=0.05, decay_steps=None, seed=7)
    for name, c in (("one", cfg), ("mesh", dataclasses.replace(cfg, mesh=mesh))):
        op = device_laplacian(Lc, fmt="dense", device="cpu")
        model = ChebNet([op], F=[4], K=[3], p=[1], M=[3], dropout=0.5,
                        generator=torch.Generator().manual_seed(0))
        leaves, losses = _fit(model, c, xc, yc, "classification")
        out[f"dp_{name}_losses"] = losses
        for i, p in enumerate(leaves):
            out[f"dp_{name}_{i}"] = p

    # The torch dry run, and the export refusal of a sharded model.
    dry = dryrun_multichip("cpu")
    out["dryrun"] = np.array(list(dry.values()))
    out["dryrun_keys"] = np.array(list(dry))
    hop = halo_sharded_laplacian(L, mesh22)
    nc = NodeClassifier(hop, 3, 2, hidden=[4], K=3)
    try:
        serve.export_serving(nc, nc.param_tree(),
                             torch.zeros(hop.rows_per_shard, 3), "unused")
        out["export_refused"] = np.bool_(False)
    except ValueError as e:
        out["export_refused"] = np.bool_("single-chip serving unit" in str(e))
    return out


def _sparse_variants(L, mesh):
    """The sparse halo operators tests/test_torch_sparse_halo.py holds
    against JAX's, by name: BSR at 8x8 blocks on the gather route and on
    the row walk's plain version (``use_pallas``), BSR at 128x128, and
    the per-shard banded format at 128x128 and at 8x8 (JAX's test
    shape)."""
    from cnn_graph_tpu_torch.parallel import sparse_halo_laplacian

    return {
        "bsr8": sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                      use_pallas=False),
        "bsr8p": sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                       use_pallas=True),
        "bsr128": sparse_halo_laplacian(L, mesh, use_pallas=False),
        "band": sparse_halo_laplacian(L, mesh, fmt="banded",
                                      use_pallas=False),
        "band8": sparse_halo_laplacian(L, mesh, fmt="banded",
                                       block_shape=(8, 8), use_pallas=False),
    }


def _task_sparse(inp, rank, world):
    """The sparse halo operators over a (1, world) mesh: every case of
    tests/test_torch_sparse_halo.py on this rank's rows."""
    import torch

    from cnn_graph_tpu_torch import serve
    from cnn_graph_tpu_torch.models import NodeClassifier, common
    from cnn_graph_tpu_torch.parallel import (
        BandedSparseHaloLaplacian,
        QuantBandedSparseHaloLaplacian,
        QuantSparseHaloLaplacian,
        SparseHaloLaplacian,
        make_mesh,
        quantize_sparse_halo,
        sparse_halo_laplacian,
    )

    L = _csr(inp)
    mesh = make_mesh(data=1, nodes=world, device="cpu")
    out = {}
    _coords(out, mesh)
    ops = _sparse_variants(L, mesh)
    for name, o in ops.items():
        out[f"{name}_meta"] = np.array([o.m_padded, o.rows_per_shard,
                                        o.halo, o.ext_cols_padded])
        out[f"{name}_send_idx"] = _np(o.send_idx)
        fields = (("band", "base", "colperm") if name.startswith("band")
                  else ("blocks", "block_rows", "block_cols"))
        for f in fields:
            src = o if f == "colperm" else o.local
            out[f"{name}_{f}"] = _np(getattr(src, f))
        loc = o.local_rows
        x, x0, t = (_t(loc(inp[k][:o.m_padded])) for k in ("x", "x0", "t"))
        out[f"{name}_matmul"] = _np(o.matmul(x))
        out[f"{name}_hop"] = _np(o.cheby_hop(x, x0))
        xg = x.clone().requires_grad_()
        (o.matmul(xg) * t).sum().backward()
        out[f"{name}_grad_mm"] = _np(xg.grad)
        x1g, x0g = x.clone().requires_grad_(), x0.clone().requires_grad_()
        (o.cheby_hop(x1g, x0g) * t).sum().backward()
        out[f"{name}_grad_hop1"] = _np(x1g.grad)
        out[f"{name}_grad_hop0"] = _np(x0g.grad)
    out["kinds"] = np.array([isinstance(ops["bsr8"], SparseHaloLaplacian),
                             isinstance(ops["band"],
                                        BandedSparseHaloLaplacian),
                             isinstance(ops["band8"],
                                        BandedSparseHaloLaplacian)])

    # bf16 on the gather route: JAX's per-block rounding.
    b16 = sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                dtype=torch.bfloat16, use_pallas=False)
    xb, xb0 = (_t(b16.local_rows(inp[k][:b16.m_padded])).to(torch.bfloat16)
               for k in ("x", "x0"))
    out["bf16_matmul"] = _np(b16.matmul(xb).float())
    out["bf16_hop"] = _np(b16.cheby_hop(xb, xb0).float())

    # The int8 chains (K = 7) and the band scale; the exchange's bytes.
    for name in ("bsr8", "bsr8p", "band", "band8"):
        q = quantize_sparse_halo(ops[name], sample_x=3.0)
        out[f"{name}_band_scale"] = np.float64(q.band_scale)
        xq = _t(q.local_rows(inp["xq"][:q.m_padded]))
        with torch.no_grad():
            out[f"{name}_qchain"] = _np(q.cheby_chain_q(xq, 7))
            mesh.traffic.clear()
            q.spmm_q(xq)
        out[f"{name}_traffic_int8"] = np.int64(mesh.traffic["torch.int8"])

    # fmt="auto" (banded wherever every shard fits, at any block shape)
    # and the refusal.
    auto_wide = sparse_halo_laplacian(L, mesh, fmt="auto", max_band_width=0)
    auto = sparse_halo_laplacian(L, mesh, fmt="auto")
    auto8 = sparse_halo_laplacian(L, mesh, fmt="auto", block_shape=(8, 8))
    out["auto"] = np.array([isinstance(auto_wide, SparseHaloLaplacian),
                            isinstance(auto, BandedSparseHaloLaplacian),
                            isinstance(auto8, BandedSparseHaloLaplacian)
                            and auto8.local.block_shape == (8, 8)])
    refused = []
    for kw in (dict(fmt="banded", max_band_width=0),):
        try:
            sparse_halo_laplacian(L, mesh, **kw)
            refused.append("")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = np.array(refused)

    # NodeClassifier logits, loss and gradients; the int8 twins in
    # quantize_model_operators; the export refusal.
    p = _params(inp, "nc_")
    quant = []
    for name in ("bsr8", "band"):
        o = ops[name]
        f, lab, msk = (_t(o.local_rows(inp[k][:256]))
                       for k in ("feats", "labels", "mask"))
        nc = NodeClassifier(o, input_features=8, num_classes=4, hidden=[16],
                            K=3)
        leaves = [p["convs"][i][k] for i in range(2) for k in ("w", "b")]
        for t in leaves:
            t.requires_grad_()
        loss = nc.loss(p, f, lab, msk)
        grads = mesh.sync_grads(list(torch.autograd.grad(loss, leaves)))
        out[f"{name}_nc_loss"] = _np(loss)
        for i, g in enumerate(grads):
            out[f"{name}_nc_grad{i}"] = _np(g)
        with torch.no_grad():
            out[f"{name}_nc_logits"] = _np(nc.apply(p, f))
            qm = common.quantize_model_operators(nc, sample_x=5.0)
            quant.append(isinstance(qm.op, QuantBandedSparseHaloLaplacian
                                    if name == "band"
                                    else QuantSparseHaloLaplacian))
            quant.append(common.quantize_model_operators(
                qm, sample_x=5.0).op is qm.op)
            out[f"{name}_nc_qlogits"] = _np(qm.apply(p, f))
        try:
            serve.export_serving(nc, p, f, "unused")
            quant.append(False)
        except ValueError as e:
            quant.append("single-chip serving unit" in str(e))
    out["quant"] = np.array(quant)
    return out


TASKS = {"banded": _task_banded, "halo": _task_halo,
         "parallel": _task_parallel, "sparse": _task_sparse}


def main(argv):
    task, rank, world, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch
    import torch.distributed as dist

    from cnn_graph_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(tmp, "in.npz"), allow_pickle=False))
    init_distributed("cpu", init_method=f"file://{tmp}/store", rank=rank,
                     world_size=world)
    try:
        out = TASKS[task](inp, rank, world)
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise RuntimeError("a worker imported JAX")


if __name__ == "__main__":
    main(sys.argv[1:])
