"""Multi-chip overhead: the JAX package's ``experiments/multichip.py``
on the port.

    python -m cnn_graph_tpu_torch.experiments.multichip wrapper [side]
    python -m cnn_graph_tpu_torch.experiments.multichip chain [side]
    python -m cnn_graph_tpu_torch.experiments.multichip comm [side] [n ...]

``wrapper`` (the card): the K=25 Chebyshev chain of ``city_graph(side)``
(default 224, the bench's 50,176 nodes) at C = 512, in bf16 and int8,
through ``parallel.banded_halo_laplacian`` on a world of one rank (NCCL,
a ``nodes=1`` mesh, so no exchange) against the single-chip banded
operator, hop by hop (JAX :94 ``main_wrapper``).  The difference bounds
the sharded operator's own cost.  ``chain`` (the card) adds the halo
operator's ``cheby_chain``, the whole chain in one call (JAX :201
``main_chain``).  Every time is per SpMM, from ``utils.profiling.
slope_time`` (two chain lengths differenced, so the per-call constants
cancel).

``comm`` (the CPU; no process group): for n shards (default 2, 4 and 8)
the columns of JAX :256 ``main_comm``, read from the banded halo
operator's host plan (``parallel.banded_halo._plan``): the halo extents
``h_l``/``h_r`` in block rows, the MB a hop exchanges in bf16 and in
int8, the cut edges and boundary nodes of the contiguous row partition,
the MB an exchange of just the boundary nodes would move, the ratio,
and the share of each shard's rows that needs no halo.  Its G is the
port's default, ``min(8, block rows / 2n)``; JAX sizes G by its TPU VMEM
model first (6 on ``city_graph(64)`` at n = 2), and G sets the rows'
padding, so the shards' rows, so the cut: ``comm_rows(...,
rows_per_step=G)`` at JAX's G gives JAX's table.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile

import numpy as np

K_CHAIN = 25
C_CHAIN = 512
OUTER = 4


def _rescaled(x, dtype):
    import torch

    s = torch.rsqrt(x.float().pow(2).mean() + 1e-6)
    return (x * s).to(dtype)


def hop_chain_seconds(op, x, K: int = K_CHAIN, outer: int = OUTER) -> float:
    """Seconds per SpMM of the hop-by-hop recurrence on ``op``, by
    ``slope_time`` over ``outer`` and ``4 * outer`` blocks of K-1 hops
    (JAX :35-83): float operators take ``matmul`` then ``cheby_hop``s and
    rescale the older carry between blocks; int8 ones (with
    ``cheby_hop_q``) quantize ``x`` once and carry int8 through
    ``spmm_q`` and ``cheby_hop_q``."""
    import torch

    from cnn_graph_tpu_torch.utils.profiling import slope_time

    quant = hasattr(op, "cheby_hop_q")

    def make_run(u):
        def run(x):
            with torch.no_grad():
                if quant:
                    p = op.quantize(x.float())
                    q = op.spmm_q(p)
                else:
                    p, q = x, op.matmul(x)
                for _ in range(u):
                    for _ in range(K - 1):
                        p, q = q, (op.cheby_hop_q(q, p) if quant
                                   else op.cheby_hop(q, p))
                    if not quant:
                        p = _rescaled(p, x.dtype)
                out = op.dequantize(q) if quant else q.float()
                return out.pow(2).mean()
        return run

    per_block, _ = slope_time(make_run, (x,), units=(outer, 4 * outer))
    return per_block / (K - 1)


def region_chain_seconds(op, x, K: int = K_CHAIN,
                         outer: int = OUTER) -> float:
    """Seconds per SpMM of the halo operator's whole-chain call
    (JAX :159-198): ``cheby_chain``, its last term rescaled and fed back
    between chains, or for the int8 twin ``cheby_chain_q`` on int8
    carries."""
    import torch

    from cnn_graph_tpu_torch.utils.profiling import slope_time

    quant = hasattr(op, "cheby_chain_q")

    def make_run(u):
        def run(x):
            with torch.no_grad():
                v = op.quantize(x.float()) if quant else x
                for _ in range(u):
                    if quant:
                        v = op.cheby_chain_q(v, K)[K - 1]
                    else:
                        v = _rescaled(op.cheby_chain(v, K)[K - 1], x.dtype)
                out = op.dequantize(v) if quant else v.float()
                return out.pow(2).mean()
        return run

    per_block, _ = slope_time(make_run, (x,), units=(outer, 4 * outer))
    return per_block / (K - 1)


def one_rank_times(single, halo, x, region: bool, K: int = K_CHAIN,
                   outer: int = OUTER) -> dict:
    """Seconds per SpMM of the K-term chain in bf16 and int8: the
    single-chip banded operator ``single`` and the bf16 banded halo
    operator ``halo`` of the same graph on a ``nodes=1`` mesh, hop by
    hop and, with ``region``, through ``cheby_chain``; the int8 twins
    quantized at ``max|x|``.  ``x``: ``[m_padded, C]`` bf16 on the card.
    Keys ``{bf16,int8}_{plain,halo[,region]}``."""
    from cnn_graph_tpu_torch.ops import quantize_banded
    from cnn_graph_tpu_torch.parallel import quantize_banded_halo

    sample = float(x.abs().max())
    qsingle = quantize_banded(single, sample_x=sample)
    qhalo = quantize_banded_halo(halo, sample_x=sample)
    out = {"bf16_plain": hop_chain_seconds(single, x, K, outer),
           "bf16_halo": hop_chain_seconds(halo, x, K, outer),
           "int8_plain": hop_chain_seconds(qsingle, x, K, outer),
           "int8_halo": hop_chain_seconds(qhalo, x, K, outer)}
    if region:
        out["bf16_region"] = region_chain_seconds(halo, x, K, outer)
        out["int8_region"] = region_chain_seconds(qhalo, x, K, outer)
    return out


@contextlib.contextmanager
def one_rank_mesh(device):
    """A ``nodes=1`` mesh over a process group of one rank (NCCL on the
    card), joined through a ``file://`` store in a temporary directory
    and left on exit."""
    import torch.distributed as dist

    from cnn_graph_tpu_torch.parallel import init_distributed, make_mesh

    with tempfile.TemporaryDirectory() as d:
        init_distributed(device, init_method=f"file://{d}/store", rank=0,
                         world_size=1)
        try:
            yield make_mesh(data=1, nodes=1, device=device)
        finally:
            dist.destroy_process_group()


def _card_times(side: int, region: bool):
    """``one_rank_times`` on ``city_graph(side)`` with the input of JAX's
    experiment (N(0, 1) from NumPy seed 0, in bf16); returns the times,
    the single-chip operator and the halo extents."""
    import torch

    from cnn_graph_tpu_torch.graphs import city_graph
    from cnn_graph_tpu_torch.ops import device_laplacian
    from cnn_graph_tpu_torch.parallel import banded_halo_laplacian

    if not torch.cuda.is_available():
        raise RuntimeError("multichip wrapper/chain time the card; no CUDA "
                           "device is visible (comm runs on the CPU)")
    dev = torch.device("cuda", 0)
    L, _ = city_graph(side, k=8, seed=0)
    op = device_laplacian(L, fmt="banded", dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(op.m_padded, C_CHAIN)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    with one_rank_mesh(dev) as mesh:
        halo = banded_halo_laplacian(L, mesh, dtype=torch.bfloat16,
                                     rows_per_step=op.rows_per_step)
        t = one_rank_times(op, halo, x, region)
    return t, op, (halo.halo_left, halo.halo_right)


def _per_spmm(t: float, nnz: int) -> str:
    return f"{t * 1e6:7.1f} us/spmm {nnz / t / 1e9:.4f} Gedges/s"


def main_wrapper(side: int = 224):
    """The one-rank halo chain against the single-chip one, hop by hop."""
    t, op, (h_l, h_r) = _card_times(side, region=False)
    print(f"nodes={op.m} nnz={op.nnz}; halo op at n=1: h_l={h_l} "
          f"h_r={h_r}", flush=True)
    for lab in ("bf16", "int8"):
        p, h = t[f"{lab}_plain"], t[f"{lab}_halo"]
        print(f"{lab} plain kernel {_per_spmm(p, op.nnz)}")
        print(f"{lab} halo wrapper {_per_spmm(h, op.nnz)}")
        print(f"{lab} wrapper overhead {(h - p) * 1e6:+.1f} us/spmm "
              f"({(h / p - 1) * 100:+.1f}%)", flush=True)
    return t


def main_chain(side: int = 224):
    """The one-rank halo chain hop by hop and in one ``cheby_chain``
    call, against the single-chip one."""
    t, _, _ = _card_times(side, region=True)
    for lab in ("bf16", "int8"):
        p, h, c = (t[f"{lab}_{k}"] for k in ("plain", "halo", "region"))
        print(f"{lab} plain kernel   {p * 1e6:7.1f} us/spmm")
        print(f"{lab} per-hop halo   {h * 1e6:7.1f} us/spmm "
              f"(overhead {(h - p) * 1e6:+.1f} us/spmm)")
        print(f"{lab} one-region     {c * 1e6:7.1f} us/spmm "
              f"(overhead {(c - p) * 1e6:+.1f} us/spmm, "
              f"{(c - p) * (K_CHAIN - 1) * 1e6:+.1f} us/chain)", flush=True)
    return t


def comm_rows(L, ns=(2, 4, 8), rows_per_step: int | None = None,
              C: int = C_CHAIN, e: int = 2) -> list:
    """``main_comm``'s numbers for each n in ``ns``, from the banded halo
    operator's host plan of ``L`` (the raw Laplacian; rescaled as
    ``banded_halo_laplacian`` rescales it) at G = ``rows_per_step``
    (None: ``banded_halo_laplacian``'s default).  One dict per n."""
    from cnn_graph_tpu_torch.graphs import rescale_laplacian
    from cnn_graph_tpu_torch.ops import packing
    from cnn_graph_tpu_torch.parallel.banded_halo import _plan

    Lr = rescale_laplacian(L).tocsr()
    Lr.eliminate_zeros()
    m = L.shape[0]
    coo = L.tocoo()
    br = packing.BLOCK
    rows = []
    for n in ns:
        p = _plan(Lr, int(n), rows_per_step, packing.MAX_BAND_WIDTH,
                  ragged=False, force_boundary=0, dkw=False)
        h_l, h_r, nbr_s = p["halo_left"], p["halo_right"], p["nbr_s"]
        # Every directed halo is sent by n - 1 shards (the ring's ends
        # have no peer past them).
        bytes_hop = (n - 1) * (h_l + h_r) * br * C * e
        shard_of = np.minimum(np.arange(m) // (nbr_s * br), n - 1)
        cross = shard_of[coo.row] != shard_of[coo.col]
        bnd = len(np.unique(coo.col[cross]))
        ideal = bnd * C * e
        rows.append(dict(
            n=int(n), h_l=h_l, h_r=h_r, mb_hop=bytes_hop / 2**20,
            mb_int8=bytes_hop / 2 / 2**20, cut_edges=int(cross.sum()),
            boundary_nodes=bnd, mb_ideal=ideal / 2**20,
            ratio=bytes_hop / max(ideal, 1),
            interior=1 - (p["boundary_pre"] + p["boundary_suf"]) / nbr_s))
    return rows


def main_comm(side: int = 224, ns=(2, 4, 8),
              rows_per_step: int | None = None):
    """Exchanged bytes against the graph cut for each shard count."""
    from cnn_graph_tpu_torch.graphs import city_graph

    L, _ = city_graph(side, k=8, seed=0)
    print(f"nodes={L.shape[0]} nnz={L.nnz} C={C_CHAIN} bf16 "
          f"(int8 serving: MB/hop and MB_ideal halve)")
    print(f"{'n':>2} {'h_l':>4} {'h_r':>4} {'MB/hop':>8} {'MB_int8':>8} "
          f"{'cut_edges':>10} "
          f"{'bnd_nodes':>10} {'MB_ideal':>9} {'ratio':>6} {'interior%':>9}")
    rows = comm_rows(L, ns, rows_per_step)
    for r in rows:
        print(f"{r['n']:>2} {r['h_l']:>4} {r['h_r']:>4} "
              f"{r['mb_hop']:>8.2f} {r['mb_int8']:>8.2f} "
              f"{r['cut_edges']:>10d} {r['boundary_nodes']:>10d} "
              f"{r['mb_ideal']:>9.2f} {r['ratio']:>6.2f} "
              f"{r['interior'] * 100:>8.1f}%")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("wrapper", "chain", "comm"))
    ap.add_argument("side", nargs="?", type=int, default=224,
                    help="city_graph side (side**2 nodes; default 224)")
    ap.add_argument("ns", nargs="*", type=int, default=[2, 4, 8],
                    help="comm: the shard counts (default 2 4 8)")
    args = ap.parse_args(argv)
    if args.mode == "comm":
        return main_comm(args.side, args.ns)
    return (main_wrapper if args.mode == "wrapper" else main_chain)(
        args.side)


if __name__ == "__main__":
    main()
