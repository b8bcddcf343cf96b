"""The banded halo operator: row-sharded banded SpMM whose exchange is
two neighbour shifts per hop, and its int8 twin.

Counterpart of ``cnn_graph_tpu/parallel/banded_halo.py``
(``BandedHaloLaplacian`` :74, the builder ``banded_halo_laplacian``
:840, ``_ragged_from_uniform`` :162, ``_dkw_per_shard`` :261, the
exchange ``_exchange_parts`` :293, the shard hop ``_shard_hop`` :317,
the chain and its adjoint :547/:588 with the custom VJPs :643-689,
``QuantBandedHaloLaplacian`` :708 and ``quantize_banded_halo`` :774).

After an RCM ordering, shard s's band reads x rows of its own and of
shards s-1 and s+1 only: a tail of h_l block rows of its left
neighbour and a head of h_r block rows of its right one.  Each hop
ships exactly those, in one ``all_to_all_single`` over the ``nodes``
axis with per-peer split sizes (the head to the left neighbour, the
tail to the right one, nothing elsewhere; it runs alike on NCCL and on
gloo), and runs the single-chip operator's kernel on the extended x
``[left | local | right]``: K1 (``banded_dkw``) on the deep-K-window
layout, built by default where the kernels run; K6 (``banded_ragged``)
on the flat ragged band of an operator built without it; K5
(``banded_uniform``) with ``ragged=False``.  Edge shards get zeros from
the side with no neighbour, which their band never reads.  The window
bases index the extended columns, so the bases of a shard's first rows
start inside its left halo.

With ``overlap`` each hop starts the exchange asynchronously, runs the
interior rows (whose windows read only local columns) on ``x_local``,
then waits and runs the halo-touching prefix and suffix rows: the torch
form of the data independence the JAX version gives XLA's scheduler.

Every rank builds the whole plan on the host from the global matrix (a
NumPy copy of JAX's, byte-equal; ``_plan``) and keeps its own shard on
its device.  Each region of a shard (all rows, and the prefix, interior
and suffix of the split) is a single-chip ``BandedLaplacian`` holding
that region's bases, schedule and row index, so the region passes run
through ``ops.band.layout_call`` like every banded product, and on the
CPU through the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import torch
from torch.autograd.function import once_differentiable

from cnn_graph_tpu_torch.graphs import rescale_laplacian
from cnn_graph_tpu_torch.ops import packing
from cnn_graph_tpu_torch.ops.band import layout_call
from cnn_graph_tpu_torch.ops.laplacian import BandedLaplacian, QuantOpMixin
from cnn_graph_tpu_torch.ops.packing import BLOCK, _round_up
from cnn_graph_tpu_torch.parallel.mesh import Mesh, ShardedOperator

__all__ = ["BandedHaloLaplacian", "QuantBandedHaloLaplacian",
           "banded_halo_laplacian", "quantize_banded_halo"]

def _ragged_from_uniform(band, base_local, h_l, h_r, G, pre, suf):
    """Per-shard flat ragged bands and int32 schedules from the uniform
    per-shard band ``[n, nbr_s, W, 128, 128]`` (JAX :162, without the TPU
    ring size).  Returns ``(levels, flat [n, total_max, 128, 128], sched
    [n, 3, nsb], sched_int, sched_suf)``: ``sched`` in extended
    coordinates (the full pass, and sliced, the prefix pass),
    ``sched_int`` over the interior steps with bases shifted to x_local
    coordinates, ``sched_suf`` over the suffix steps with the running
    column high-water restarted there.  One set of levels for all
    shards."""
    n, nbr_s, W, br, bc = band.shape
    assert nbr_s % G == 0
    nsb = nbr_s // G
    n_cb_ext = nbr_s + h_l + h_r

    nz = band.reshape(n, nbr_s, W, -1).any(axis=3)
    has = nz.any(axis=2)
    dmax = W - 1 - np.argmax(nz[:, :, ::-1], axis=2)
    span = np.where(has, dmax + 1, 1).astype(np.int64)

    ws = span.reshape(n, nsb, G).max(axis=2)
    levels = packing.choose_band_levels(ws.reshape(-1))
    lv = np.asarray(levels, np.int64)
    lvl_idx = np.searchsorted(lv, ws)
    wl = lv[lvl_idx]

    offs = np.zeros((n, nsb), np.int64)
    offs[:, 1:] = np.cumsum(G * wl, axis=1)[:, :-1]
    total_max = int((G * wl).sum(axis=1).max())
    flat = np.zeros((n, total_max, br, bc), band.dtype)
    for s in range(n):
        for t_ in range(nsb):
            L_ = int(wl[s, t_])
            o = int(offs[s, t_])
            flat[s, o:o + G * L_] = (
                band[s, t_ * G:(t_ + 1) * G, :L_].reshape(G * L_, br, bc))

    base64 = base_local.astype(np.int64)

    def hw_of(base_rows, lo, hi, col_count):
        last_rows = (np.arange(lo, hi) + 1) * G - 1
        step_hi = base_rows[:, last_rows] + wl[:, lo:hi]
        return np.minimum(np.maximum.accumulate(step_hi, axis=1), col_count)

    def sched_of(lo, hi, hw):
        return np.stack([
            np.broadcast_to(offs[:, lo:hi], hw.shape),
            np.broadcast_to(lvl_idx[:, lo:hi], hw.shape),
            hw,
        ], axis=1).astype(np.int32)

    pre_sb, suf_sb = pre // G, suf // G
    sched = sched_of(0, nsb, hw_of(base64, 0, nsb, n_cb_ext))
    int_lo, int_hi = pre_sb, nsb - suf_sb
    if int_hi > int_lo and (pre_sb or suf_sb):
        sched_int = sched_of(int_lo, int_hi,
                             hw_of(base64 - h_l, int_lo, int_hi, nbr_s))
    else:
        sched_int = sched[:, :, :1]  # unused placeholder
    if suf_sb:
        sched_suf = sched_of(nsb - suf_sb, nsb,
                             hw_of(base64, nsb - suf_sb, nsb, n_cb_ext))
    else:
        sched_suf = sched[:, :, :1]  # unused placeholder
    return levels, flat, sched, sched_int, sched_suf


def _dkw_per_shard(flat, sched_np, levels, G):
    """Each shard's deep-K-window repack of its flat band (JAX :261),
    every level's rows padded to the most of any shard.  Returns
    ``(bands, row0)``: ``bands[l]`` ``[n, rows_l, 128, W_l*128]`` and
    each shard's schedule row 0, the per-level row offsets."""
    n = flat.shape[0]
    nl = len(levels)
    per = [packing.pack_dkw_from_ragged(
        flat[s], (sched_np[s, 0], sched_np[s, 1], sched_np[s, 2]), levels, G)
        for s in range(n)]
    rows_max = [max(p[0][i].shape[0] for p in per) for i in range(nl)]
    bands = [np.zeros((n, rows_max[i], BLOCK, levels[i] * BLOCK), flat.dtype)
             for i in range(nl)]
    row0 = np.zeros((n, sched_np.shape[2]), np.int32)
    for s, (bs, sd) in enumerate(per):
        for i in range(nl):
            bands[i][s, : bs[i].shape[0]] = bs[i]
        row0[s] = sd[0]
    return bands, row0


def _plan(L, n: int, G: int | None, max_band_width: int, ragged: bool,
          force_boundary: int, dkw: bool) -> dict:
    """The whole host plan of JAX's builder (:865-1023) for ``n`` shards,
    as NumPy arrays over every shard (float32 band): JAX's fields
    ``band``, ``base``, ``sched``, ``sched_int``, ``sched_suf``,
    ``bands_dkw``, ``sched_dkw``, ``sched_dkw_int``, ``sched_dkw_suf``,
    ``levels``, the extents and the split, and ``G``, ``mp``,
    ``nbr_s``.  ``G`` None: ``min(8, block rows)`` (the port's default;
    JAX sizes it by its VMEM model), capped at half a shard as JAX caps
    its own."""
    stats = packing.band_stats(L)
    base0, W, _, _ = stats
    if W > max_band_width:
        raise ValueError(
            f"band width {W} blocks exceeds {max_band_width}; "
            "RCM-reorder the graph or use a sparse halo operator")
    if G is None:
        G = max(1, min(packing.ROWS_PER_STEP, len(base0) // (2 * n)))
    band, base, _, mp = packing.pack_banded(
        L, max_band_width=max_band_width, rows_per_step=G, stats=stats,
        row_multiple=n * G)
    nbr = mp // BLOCK
    nbr_s = nbr // n

    starts = np.arange(n) * nbr_s
    ends = starts + nbr_s - 1
    h_l = int(np.max(starts - base[starts]))
    h_r = int(np.max(np.maximum(base[ends] + W - (ends + 1), 0)))
    if h_l > nbr_s or h_r > nbr_s:
        raise ValueError(
            f"halo ({h_l} left / {h_r} right block-rows) exceeds the "
            f"{nbr_s} block-rows per shard: too many shards for this band; "
            "use fewer shards or a sparse halo operator")

    shard_of_row = np.repeat(np.arange(n), nbr_s)
    base_local = (base - shard_of_row * nbr_s + h_l).astype(np.int32)
    base_local = base_local.reshape(n, nbr_s)
    assert np.all(base_local >= 0)
    assert np.all(base_local + W <= nbr_s + h_l + h_r)
    band = band.reshape(n, nbr_s, W, BLOCK, BLOCK)

    # Trailing padded rows (zero band) inherit the last real row's base;
    # re-base them into the local window space (JAX :925-939).
    nz = band.reshape(n, nbr_s, -1).any(axis=2).reshape(-1)
    last_real = int(np.max(np.nonzero(nz)[0])) if nz.any() else -1
    for gi in range(last_real + 1, n * nbr_s):
        s_i, i = divmod(gi, nbr_s)
        prev = base_local[s_i, i - 1] if i > 0 else h_l
        base_local[s_i, i] = np.clip(max(int(prev), h_l), 0,
                                     nbr_s + h_l + h_r - W)
    assert np.all(np.diff(base_local, axis=1) >= 0)

    pre = max(int(np.searchsorted(base_local[s], h_l, side="left"))
              for s in range(n))
    suf = max(nbr_s - int(np.searchsorted(base_local[s], h_l + nbr_s - W,
                                          side="right"))
              for s in range(n))
    pre, suf = _round_up(pre, G), _round_up(suf, G)
    if force_boundary:
        pre = suf = max(pre, suf, _round_up(force_boundary, G))
    overlap = pre + suf < nbr_s and (pre > 0 or suf > 0)
    if not overlap:
        pre = suf = 0

    plan = dict(G=G, mp=mp, nbr_s=nbr_s, halo_left=h_l, halo_right=h_r,
                boundary_pre=pre, boundary_suf=suf, overlap=overlap,
                base=base_local, levels=(), band=band, sched=None,
                sched_int=None, sched_suf=None, bands_dkw=None,
                sched_dkw=None, sched_dkw_int=None, sched_dkw_suf=None)
    if not ragged:
        return plan
    levels, flat, sched, sched_int, sched_suf = _ragged_from_uniform(
        band, base_local, h_l, h_r, G, pre, suf)
    plan.update(levels=levels, band=flat, sched=sched, sched_int=sched_int,
                sched_suf=sched_suf)
    if dkw:
        bands, row0 = _dkw_per_shard(flat, sched, levels, G)
        nsb_s = nbr_s // G
        pre_sb, suf_sb = pre // G, suf // G
        sched_dkw = sched.copy()
        sched_dkw[:, 0, :] = row0
        sched_dkw_int = sched_int.copy()
        if nsb_s - suf_sb > pre_sb and (pre_sb or suf_sb):
            sched_dkw_int[:, 0, :] = row0[:, pre_sb:nsb_s - suf_sb]
        sched_dkw_suf = sched_suf.copy()
        if suf_sb:
            sched_dkw_suf[:, 0, :] = row0[:, nsb_s - suf_sb:]
        plan.update(bands_dkw=bands, sched_dkw=sched_dkw,
                    sched_dkw_int=sched_dkw_int, sched_dkw_suf=sched_dkw_suf)
    return plan


def _shard_index(L, s: int, nbr_s: int, h_l: int, h_r: int, base_s):
    """Shard s's row index (``packing.band_row_index``) over its extended
    columns: its rows of L, each column shifted so that column 0 is the
    first row of its left halo."""
    ms = nbr_s * BLOCK
    block = L[s * ms:(s + 1) * ms].tocoo()
    shift = (s * nbr_s - h_l) * BLOCK
    ext = scipy.sparse.csr_matrix(
        (block.data, (block.row, block.col - shift)),
        shape=(ms, (nbr_s + h_l + h_r) * BLOCK))
    return packing.band_row_index(ext, base_s, ms)


class _BandedHaloMixin(ShardedOperator):
    """What the float and int8 banded halo operators share: the regions
    built from the shard's fields, the exchange and the shard hop."""

    def __post_init__(self):
        G, nbr_s = self.rows_per_step, self.rows_per_shard // BLOCK
        pre, suf = self.boundary_pre, self.boundary_suf
        ranges = {"full": (0, nbr_s)}
        if self.split:
            ranges.update(pre=(0, pre), int=(pre, nbr_s - suf),
                          suf=(nbr_s - suf, nbr_s))
        rowptr = self.nz_rowptr.cpu().to(torch.int64)
        regions = {}
        for name, (a, b) in ranges.items():
            if b <= a:
                continue
            e0, e1 = int(rowptr[a * BLOCK]), int(rowptr[b * BLOCK])
            base = self.base[a:b] - (self.halo_left if name == "int" else 0)
            scheds = {}
            if self.levels:
                src = {"full": ("sched", "sched_dkw"),
                       "pre": ("sched", "sched_dkw"),
                       "int": ("sched_int", "sched_dkw_int"),
                       "suf": ("sched_suf", "sched_dkw_suf")}[name]
                cols = slice(0, (b - a) // G) if name == "pre" else slice(None)
                for key, field in zip(("sched", "sched_dkw"), src):
                    t = getattr(self, field)
                    scheds[key] = (None if t is None
                                   else t[:, cols].contiguous())
                band = self.band
            else:
                band = self.band[a:b]
            regions[name] = BandedLaplacian(
                band=band, base=base.to(torch.int32).contiguous(),
                m=(b - a) * BLOCK, m_padded=(b - a) * BLOCK, nnz=e1 - e0,
                rows_per_step=G, use_pallas=self.use_pallas,
                levels=self.levels, bands_dkw=self.bands_dkw,
                nz_rowptr=(self.nz_rowptr[a * BLOCK:b * BLOCK + 1]
                           - e0).contiguous(),
                nz_win=self.nz_win[e0:e1].contiguous(), **scheds)
        object.__setattr__(self, "regions", regions)

    @property
    def split(self) -> bool:
        """Whether hops run the interior apart from the halo rows."""
        nbr_s = self.rows_per_shard // BLOCK
        return bool(self.overlap and (self.boundary_pre or self.boundary_suf)
                    and nbr_s - self.boundary_pre - self.boundary_suf > 0)

    def _exchange(self, x_local: torch.Tensor):
        """Start the neighbour shifts (JAX :293): this shard's head to
        its left neighbour and its tail to its right one, in one
        ``all_to_all_single`` over ``nodes``.  Returns a function that
        waits and gives ``(left, right)`` halos, zeros on the side
        without a neighbour; None when the operator has no halo (one
        shard has none)."""
        hl, hr = self.halo_left * BLOCK, self.halo_right * BLOCK
        n, r = self.mesh.shape["nodes"], self.shard
        if n == 1 or not (hl or hr):
            return None
        send_splits, recv_splits, send = [0] * n, [0] * n, []
        if r > 0:
            send_splits[r - 1], recv_splits[r - 1] = hr, hl
            send.append(x_local[:hr])
        if r < n - 1:
            send_splits[r + 1], recv_splits[r + 1] = hl, hr
            send.append(x_local[x_local.shape[0] - hl:])
        pending = self.mesh.all_to_all(torch.cat(send), send_splits,
                                       recv_splits, "nodes", async_op=True)

        def finish():
            recv = pending.wait()
            zeros = x_local.new_zeros
            left = recv[:hl] if r > 0 else zeros((hl, x_local.shape[1]))
            right = (recv[recv.shape[0] - hr:] if r < n - 1
                     else zeros((hr, x_local.shape[1])))
            return left, right

        return finish

    def _hop(self, x, x0=None, c=None, band_scale=None) -> torch.Tensor:
        """One shard hop (JAX :317) on this rank's rows in the band
        dtype: ``L @ x``, ``2 L @ x - x0`` or ``2 L @ x - x0 + c``."""
        finish = self._exchange(x)
        regions = self.regions

        def rows(t, a, b):
            return None if t is None else t[a * BLOCK:b * BLOCK]

        def run(name, xs, a, b):
            return layout_call(regions[name], xs, rows(x0, a, b),
                               rows(c, a, b), band_scale=band_scale)

        nbr_s = self.rows_per_shard // BLOCK
        if self.split:
            pre, suf = self.boundary_pre, self.boundary_suf
            ys = [run("int", x, pre, nbr_s - suf)]
            x_ext = self._extended(x, finish)
            if pre:
                ys.insert(0, run("pre", x_ext, 0, pre))
            if suf:
                ys.append(run("suf", x_ext, nbr_s - suf, nbr_s))
            return torch.cat(ys)
        return run("full", self._extended(x, finish), 0, nbr_s)

    @staticmethod
    def _extended(x, finish):
        """``[left | x | right]`` once the exchange ``finish``es; ``x``
        itself where there is no halo (``finish`` None)."""
        if finish is None:
            return x
        left, right = finish()
        return torch.cat([left, x, right])

    def _chain(self, x, K: int, band_scale=None) -> torch.Tensor:
        """The stacked K-term basis ``[K, rows_per_shard, C]`` (JAX
        :547)."""
        basis = [x]
        if K > 1:
            basis.append(self._hop(x, band_scale=band_scale))
        for _ in range(2, K):
            basis.append(self._hop(basis[-1], basis[-2],
                                   band_scale=band_scale))
        return torch.stack(basis)


def _cast(op, t):
    return None if t is None else t.to(op.compute_dtype).contiguous()


def _apply(op, x, x0=None, c=None) -> torch.Tensor:
    """One hop with the kernel boundary's casts to the band dtype and
    back to x's, as ``ops.band._band_call``."""
    return op._hop(_cast(op, x), _cast(op, x0), _cast(op, c)).to(x.dtype)


def _adjoint_chain(op, g: torch.Tensor) -> torch.Tensor:
    """The adjoint of the K-term chain (JAX :588), L symmetric:
    ``s_{K-1} = g_{K-1}``, ``s_{K-2} = g_{K-2} + 2 L s_{K-1}``, ``s_k =
    g_k + 2 L s_{k+1} - s_{k+2}``, ``dx = g_0 + L s_1 - s_2``, each
    ``2 L s - s' + g_k`` one kernel pass with ``g_k`` as the emission's
    ``c``, as the single-chip adjoint chain does."""
    K = g.shape[0]
    if K == 1:
        return g[0]
    if K == 2:
        return g[0] + _apply(op, g[1])
    s_next = _apply(op, g[K - 1], torch.zeros_like(g[K - 1]), g[K - 2])
    s_next2 = g[K - 1]
    for k in range(K - 3, 0, -1):
        s_next, s_next2 = _apply(op, s_next, s_next2, g[k]), s_next
    return g[0] + _apply(op, s_next) - s_next2


class _HaloMatmul(torch.autograd.Function):
    """``L @ x``; ``dx = L g`` (JAX :643-658)."""

    @staticmethod
    def forward(ctx, op, x):
        ctx.op = op
        return _apply(op, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, _apply(ctx.op, g)


class _HaloHop(torch.autograd.Function):
    """``2 L @ x1 - x0``; ``dx1 = 2 L g``, ``dx0 = -g`` (:661-675)."""

    @staticmethod
    def forward(ctx, op, x1, x0):
        ctx.op, ctx.x0_dtype = op, x0.dtype
        return _apply(op, x1, x0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dx1 = (2.0 * _apply(ctx.op, g)).to(g.dtype)
        return None, dx1, (-g).to(ctx.x0_dtype)


class _HaloChain(torch.autograd.Function):
    """The K-term chain; its backward is the adjoint chain, which needs
    only the operator (:678-693)."""

    @staticmethod
    def forward(ctx, op, x, K):
        ctx.op = op
        return op._chain(_cast(op, x), K).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, _adjoint_chain(ctx.op, g), None


@dataclasses.dataclass(frozen=True, eq=False)
class BandedHaloLaplacian(_BandedHaloMixin):
    """This rank's shard of the row-sharded banded Laplacian.

    ``band`` is the shard's flat ragged band ``[total, 128, 128]`` (or,
    with ``levels`` empty, its uniform band ``[nbr_s, W, 128, 128]``),
    ``base`` its window bases into the extended columns ``[left halo |
    local | right halo]``; ``sched``/``sched_int``/``sched_suf`` and the
    deep-K-window twin ``bands_dkw`` with ``sched_dkw*`` are JAX's
    fields, this shard's slices.  ``nz_rowptr``/``nz_win`` are the
    shard's row index over its extended columns, which K1, K5 and K6
    walk.  ``matmul``, ``cheby_hop`` and ``cheby_chain`` take and return
    this rank's rows and are differentiable."""

    band: torch.Tensor
    base: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo_left: int
    halo_right: int
    rows_per_shard: int
    rows_per_step: int
    use_pallas: bool
    nz_rowptr: torch.Tensor
    nz_win: torch.Tensor
    boundary_pre: int = 0
    boundary_suf: int = 0
    overlap: bool = False
    levels: tuple = ()
    sched: torch.Tensor | None = None
    sched_int: torch.Tensor | None = None
    sched_suf: torch.Tensor | None = None
    bands_dkw: tuple | None = None
    sched_dkw: torch.Tensor | None = None
    sched_dkw_int: torch.Tensor | None = None
    sched_dkw_suf: torch.Tensor | None = None

    @property
    def compute_dtype(self):
        return self.band.dtype

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for this rank's rows ``x`` ``[rows_per_shard, C]``."""
        return _HaloMatmul.apply(self, x)

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """The fused hop ``2 (L @ x1) - x0``, one kernel pass per
        region."""
        return _HaloHop.apply(self, x1, x0)

    def cheby_chain(self, x: torch.Tensor, K: int) -> torch.Tensor:
        """The stacked basis ``[K, rows_per_shard, C]``; differentiable,
        its backward the adjoint chain."""
        return _HaloChain.apply(self, x, K)


@dataclasses.dataclass(frozen=True, eq=False)
class QuantBandedHaloLaplacian(_BandedHaloMixin, QuantOpMixin):
    """The int8 twin for sharded serving (JAX :708): the float shard's
    layout and tables with int8 bands, ``band_scale = max|L| / 127`` over
    every shard; carries and halo payloads ride int8 (half the bf16
    operator's exchange bytes).  Inference only."""

    band: torch.Tensor
    base: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo_left: int
    halo_right: int
    rows_per_shard: int
    rows_per_step: int
    use_pallas: bool
    nz_rowptr: torch.Tensor
    nz_win: torch.Tensor
    band_scale: float = 1.0
    act_scale: float = 1.0
    headroom: float = 2.0
    boundary_pre: int = 0
    boundary_suf: int = 0
    overlap: bool = False
    levels: tuple = ()
    sched: torch.Tensor | None = None
    sched_int: torch.Tensor | None = None
    sched_suf: torch.Tensor | None = None
    bands_dkw: tuple | None = None
    sched_dkw: torch.Tensor | None = None
    sched_dkw_int: torch.Tensor | None = None
    sched_dkw_suf: torch.Tensor | None = None

    def _call(self, x_q, x0_q):
        return self._hop(x_q, x0_q, band_scale=self.band_scale)

    def cheby_chain_q(self, x_q: torch.Tensor, K: int) -> torch.Tensor:
        """The stacked int8 K-term basis; bit-exact with the per-hop
        path."""
        return self._chain(x_q, K, band_scale=self.band_scale)


def _quantize_tensor(t: torch.Tensor, s32: torch.Tensor) -> torch.Tensor:
    """``clip(round(t / s), +-127)`` in float32, half to even, as
    ``packing.quantize_band``, on t's device, a slab at a time."""
    q = torch.empty(t.shape, dtype=torch.int8, device=t.device)
    for lo in range(0, t.shape[0], 4096):
        chunk = t[lo:lo + 4096].to(torch.float32)
        q[lo:lo + 4096] = torch.clamp(torch.round(chunk / s32), -127, 127)
    return q


def quantize_banded_halo(op: BandedHaloLaplacian, headroom: float = 2.0,
                         sample_x: float = 1.0) -> QuantBandedHaloLaplacian:
    """The int8 twin of a sharded banded operator (JAX :774): one global
    band scale ``max|L| / 127``, the max taken over every shard's band
    (an ``all_reduce(MAX)`` over ``nodes``), and one activation scale
    with ``headroom``.  The deep-K-window bands hold the flat band's
    values rearranged, so they quantize to the bytes JAX re-derives from
    the quantized flat band."""
    local = op.band.abs().amax().to(torch.float32).reshape(1)
    s_b = float(op.mesh.all_reduce(local, "nodes", "max"))
    s_b = s_b / 127.0 if s_b > 0.0 else 1.0
    s32 = torch.tensor(s_b, dtype=torch.float32, device=op.band.device)
    fields = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)}
    fields.update(
        band=_quantize_tensor(op.band, s32),
        bands_dkw=(None if op.bands_dkw is None else tuple(
            _quantize_tensor(b, s32) for b in op.bands_dkw)),
        band_scale=s_b, act_scale=float(sample_x) * headroom / 127.0,
        headroom=headroom)
    return QuantBandedHaloLaplacian(**fields)


def banded_halo_laplacian(
    L: scipy.sparse.spmatrix,
    mesh: Mesh,
    lmax: float = 2.0,
    rescale: bool = True,
    dtype=torch.float32,
    rows_per_step: int | None = None,
    use_pallas: bool | None = None,
    max_band_width: int = packing.MAX_BAND_WIDTH,
    ragged: bool = True,
    force_boundary: int = 0,
) -> BandedHaloLaplacian:
    """This rank's shard of the row-sharded banded operator over
    ``mesh``'s ``nodes`` axis (JAX :840), on the mesh's device.

    Needs an RCM-bandable matrix whose halo fits within one neighbour
    shard on each side; raises ``ValueError`` otherwise.  ``ragged``
    (default) stores each G-row step at one of at most 4 width levels;
    ``use_pallas`` (default: wherever CUDA is available, as the
    single-chip builder) adds the deep-K-window layout, so hops run K1;
    a ragged operator without it runs K6, ``ragged=False`` K5.
    ``force_boundary`` forces a prefix/interior/suffix split even with
    no halo (a test hook of JAX's), so that the region passes run on
    one rank."""
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    L.eliminate_zeros()
    n = mesh.shape["nodes"]
    if use_pallas is None:
        use_pallas = torch.cuda.is_available()
    p = _plan(L, n, rows_per_step, max_band_width, ragged, force_boundary,
              dkw=bool(use_pallas) and ragged)
    s = mesh.coord("nodes")
    dev = mesh.device
    nbr_s = p["nbr_s"]

    def put(a, dt=None):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a[s])).to(dev)
        return t if dt is None else t.to(dt)

    rowptr, win = _shard_index(L, s, nbr_s, p["halo_left"], p["halo_right"],
                               p["base"][s])
    return BandedHaloLaplacian(
        band=put(p["band"], dtype), base=put(p["base"]), mesh=mesh,
        m=L.shape[0], m_padded=p["mp"], nnz=int(L.nnz),
        halo_left=p["halo_left"], halo_right=p["halo_right"],
        rows_per_shard=nbr_s * BLOCK, rows_per_step=p["G"],
        use_pallas=bool(use_pallas),
        nz_rowptr=torch.from_numpy(rowptr).to(dev),
        nz_win=torch.from_numpy(win).to(dev),
        boundary_pre=p["boundary_pre"], boundary_suf=p["boundary_suf"],
        overlap=p["overlap"], levels=p["levels"], sched=put(p["sched"]),
        sched_int=put(p["sched_int"]), sched_suf=put(p["sched_suf"]),
        bands_dkw=(None if p["bands_dkw"] is None else tuple(
            put(b, dtype) for b in p["bands_dkw"])),
        sched_dkw=put(p["sched_dkw"]), sched_dkw_int=put(p["sched_dkw_int"]),
        sched_dkw_suf=put(p["sched_dkw_suf"]))
