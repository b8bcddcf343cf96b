"""The ``(data, nodes)`` device mesh on ``torch.distributed``, and the
collectives the sharded operators and the Trainer issue on it.

Counterpart of ``cnn_graph_tpu/parallel/mesh.py`` (``make_mesh`` :25,
``data_sharding`` :41, ``replicated`` :46).  JAX's mesh is one program
over all devices; here every rank is one process that runs the same
program (SPMD) on its own device, and a collective that GSPMD inserted
silently is issued explicitly on the ``data`` or ``nodes`` process
group:

* ``data``: batch data parallelism; each rank takes its slice of the
  batch (``data_sharding``) and the gradients are averaged over it;
* ``nodes``: graph-node parallelism; each rank holds one contiguous
  block of the operator's rows and of the node activations, and the
  replicated weights' gradients are summed over it (``sync_grads``).

Rendezvous is ``torch.distributed.run``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or an
explicit ``init_method`` (a ``file://`` store in the tests).  The
backend follows one rule, printed once by rank 0:

* NCCL where every rank has a CUDA device of its own;
* gloo for CPU tensors, and for ranks that share one card.  gloo's
  point-to-point calls refuse CUDA tensors, so with CUDA tensors every
  collective here is staged through pinned host memory, in one place
  (``Mesh._host``), and the printed rule says so.

Nothing catches an error to switch backend or device.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["Mesh", "init_distributed", "make_mesh", "data_sharding",
           "replicated", "node_sum", "device_of_rank"]

AXES = ("data", "nodes")
_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def device_of_rank(device=None) -> torch.device:
    """This rank's device: ``device`` where given (``"cpu"`` in the
    tests), else the card ``cuda:(LOCAL_RANK % device_count())``.
    Raises where there is no card rather than falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to run the "
                           "mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def _backend_rule(dev: torch.device, local_world: int) -> tuple[str, str]:
    """The backend and the reason, by the module's one rule."""
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl", "every rank has a CUDA device of its own"
    if dev.type == "cuda":
        return "gloo", (f"{local_world} ranks share "
                        f"{torch.cuda.device_count()} card(s); collectives "
                        "staged through pinned host memory")
    return "gloo", "CPU tensors"


def init_distributed(device=None, *, init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``init_method`` None reads ``torch.distributed.run``'s environment;
    otherwise ``rank`` and ``world_size`` are given with it.  The
    backend follows the module's rule; rank 0 prints it."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if init_method is None and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "no process group to join: launch one process per rank with "
            "torch.distributed.run (which sets RANK, WORLD_SIZE, "
            "MASTER_ADDR and MASTER_PORT), or pass init_method, rank and "
            "world_size")
    dev = device_of_rank(device)
    world = world_size if world_size is not None else int(
        os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend, why = _backend_rule(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if init_method is None else dict(
        init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(backend, **kw)
    if dist.get_rank() == 0:
        print(f"distributed: world {dist.get_world_size()}, backend "
              f"{backend} ({why}), rank 0 on {dev}", flush=True)
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the ``(data, nodes)`` mesh: the
    ``DeviceMesh``, this rank's device, the backend and whether CUDA
    tensors are staged through the host.  ``shape`` maps each axis to
    its size, as JAX's ``mesh.shape``.  ``traffic`` counts the bytes this
    rank has sent by ``all_to_all``, by dtype."""

    device_mesh: object
    device: torch.device
    backend: str
    staged: bool
    shape: dict
    traffic: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    axis_names = AXES

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it, else a pinned host copy."""
        if self.staged and t.is_cuda:
            return t.to("cpu").pin_memory()
        return t

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced in place over ``axis`` (``sum`` or ``max``);
        returns it.  A size-1 axis issues nothing."""
        if self.shape[axis] == 1:
            return t
        h = self._host(t)
        dist.all_reduce(h, _REDUCE[op], group=self.group(axis))
        if h is not t:
            t.copy_(h)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on dim 0 in
        axis order."""
        n = self.shape[axis]
        if n == 1:
            return t
        h = self._host(t.contiguous())
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=self.group(axis))
        return torch.cat(parts).to(t.device)

    def all_to_all(self, send: torch.Tensor, send_splits: list,
                   recv_splits: list, axis: str, async_op: bool = False):
        """One ``all_to_all_single`` over ``axis`` with per-peer split
        sizes (rows of dim 0).  Returns a handle whose ``wait()`` gives
        the received rows on this rank's device; with ``async_op`` the
        exchange runs while the caller computes."""
        self.traffic[str(send.dtype)] += send.numel() * send.element_size()
        h = self._host(send.contiguous())
        recv = h.new_empty((sum(recv_splits),) + tuple(send.shape[1:]))
        work = dist.all_to_all_single(recv, h, recv_splits, send_splits,
                                      group=self.group(axis),
                                      async_op=async_op)
        return _Pending(work, recv, send.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place by global rank ``src``'s."""
        if dist.get_world_size() == 1:
            return t
        h = self._host(t)
        dist.broadcast(h, src)
        if h is not t:
            t.copy_(h)
        return t

    def sync_grads(self, grads: list) -> list:
        """The replicated weights' gradients made global, in place: the
        sum over ``nodes`` (each rank's are the partials of its rows) and
        the mean over ``data``, one flat collective per axis."""
        live = [g for g in grads if g is not None]
        if not live or (self.shape["nodes"] == 1 and self.shape["data"] == 1):
            return grads
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in live])
        self.all_reduce(flat, "nodes")
        if self.shape["data"] > 1:
            self.all_reduce(flat, "data").div_(self.shape["data"])
        off = 0
        for g in live:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return grads


class _Pending:
    """An exchange in flight: ``wait()`` returns the received rows on
    the device they are wanted on."""

    def __init__(self, work, recv, device):
        self.work, self.recv, self.device = work, recv, device

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return self.recv.to(self.device, non_blocking=False)


def make_mesh(data: int | None = None, nodes: int = 1, devices=None, *,
              device=None) -> Mesh:
    """Build the ``(data, nodes)`` mesh over every rank (default: all on
    ``data``), joining the process group from the environment if it is
    not joined yet.  ``devices`` is the ranks' count or list, as JAX's
    device list (default: the world); the mesh covers the whole world.
    ``device`` is this rank's, as ``device_of_rank`` resolves it (the
    card by default)."""
    if not dist.is_initialized():
        init_distributed(device)
    world = dist.get_world_size()
    n_dev = world if devices is None else (
        devices if isinstance(devices, int) else len(devices))
    if data is None:
        data = n_dev // nodes
    assert data * nodes == n_dev, f"mesh {data}x{nodes} != {n_dev} devices"
    if n_dev != world:
        raise ValueError(f"the mesh covers every rank: {n_dev} devices in "
                         f"a world of {world}")
    backend = dist.get_backend()
    dev = device_of_rank(device)
    dm = init_device_mesh(dev.type, (data, nodes), mesh_dim_names=AXES)
    return Mesh(device_mesh=dm, device=dev, backend=backend,
                staged=backend == "gloo" and dev.type == "cuda",
                shape={"data": data, "nodes": nodes})


def data_sharding(mesh: Mesh, x):
    """This rank's slice of a batch-leading array over ``data`` (JAX's
    ``P("data")``): ``x[d*b:(d+1)*b]`` with ``b = len(x) / data``."""
    n = mesh.shape["data"]
    b, rem = divmod(x.shape[0], n)
    if rem:
        raise ValueError(f"batch {x.shape[0]} not divisible by the mesh's "
                         f"data axis ({n})")
    d = mesh.coord("data")
    return x[d * b:(d + 1) * b]


def replicated(mesh: Mesh, tree):
    """Every tensor of ``tree`` (dicts, lists, tensors) overwritten in
    place by global rank 0's (JAX's ``P()``); returns the tree."""
    from cnn_graph_tpu_torch.models.common import tree_leaves

    with torch.no_grad():
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                mesh.broadcast(t)
    return tree


class _NodeSum(torch.autograd.Function):
    """The sum of ``t`` over the ``nodes`` axis; the backward passes the
    cotangent through unchanged.  Every rank computes the same global
    value from it, so each rank's share of the gradient is the cotangent
    itself: ``torch.distributed.nn``'s all_reduce, whose backward sums
    the cotangents again, would scale it by the axis size."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce(t.clone(), "nodes")

    @staticmethod
    def backward(ctx, g):
        return g, None


def node_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the mesh's ``nodes`` axis, differentiable as the
    global value every rank computes from it (see ``_NodeSum``)."""
    if mesh.shape["nodes"] == 1:
        return t
    return _NodeSum.apply(t, mesh)


class ShardedOperator:
    """What the node-sharded operators share.  Each rank's operator
    holds its own block of ``rows_per_shard`` rows of the globally
    padded ``[m_padded, m_padded]`` operator, rows ``row_range`` of it,
    and its ``matmul``/``cheby_hop`` take and return that rank's rows
    ``[rows_per_shard, C]`` (JAX's ``shard_map`` with ``P("nodes",
    None)``).  ``real_rows`` of them are graph nodes, the rest padding."""

    @property
    def shard(self) -> int:
        """This rank's index on the ``nodes`` axis."""
        return self.mesh.coord("nodes")

    @property
    def row_range(self) -> tuple[int, int]:
        lo = self.shard * self.rows_per_shard
        return lo, lo + self.rows_per_shard

    @property
    def real_rows(self) -> int:
        return max(0, min(self.rows_per_shard,
                          self.m - self.row_range[0]))

    def local_rows(self, x, axis: int = 0):
        """This rank's rows of ``x`` along ``axis``, ``x`` holding all
        ``m_padded`` rows (or only the ``m`` real ones, zero-padded
        here)."""
        lo, hi = self.row_range
        if x.shape[axis] < hi:
            pad = list(x.shape)
            pad[axis] = hi - x.shape[axis]
            if isinstance(x, torch.Tensor):
                x = torch.cat([x, x.new_zeros(pad)], dim=axis)
            else:
                import numpy as np

                x = np.concatenate([x, np.zeros(pad, x.dtype)], axis=axis)
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(lo, hi)
        return x[tuple(idx)]

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """``2 (L @ x1) - x0`` from ``matmul`` (JAX's ``ChebyHopMixin``)."""
        return (2.0 * self.matmul(x1) - x0).to(x1.dtype)
