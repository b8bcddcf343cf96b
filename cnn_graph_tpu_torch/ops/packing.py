"""NumPy packers: for the banded operator the uniform and the ragged
band, the deep-K-window ("dkw") layout, and the int8 band quantizer; for
the block-sparse (BSR) operator the block tiling, its column-streamed
layout and the choice of block shape and row group.

Copies of ``cnn_graph_tpu/ops/laplacian.py`` (``band_stats`` :796,
``pack_banded`` :864, ``choose_band_levels`` :924,
``pack_banded_ragged`` :944, the quantizer
of ``quantize_banded`` :756-760, ``choose_block_shape`` :1022,
``pack_block_sparse`` :1048, ``colstream_pack`` :1093,
``choose_bsr_row_group`` :1167) and ``cnn_graph_tpu/ops/pallas_band.py:405
pack_dkw_from_ragged``, which the port cannot import because those
modules import JAX.  ``tests/test_torch_graphs.py`` and
``tests/test_torch_bsr.py`` hold every output byte-equal to the JAX
packers' for the same arguments.  One difference: ``colstream_pack``
checks that each block's row in its group and column slot fit the 16-bit
fields of its ``meta`` word, where the original packs them unchecked.
``row_index`` (with ``colstream_order``) and ``band_row_index`` are the
port's own: the nonzero index by output row that the GPU's row walks
take through the BSR operators (``ops/bsr.py``) and the banded
operators' dkw and uniform layouts (``ops/band.py``).

Every banded packer takes ``block_shape=(br, bc)``, default 128x128, as
the JAX packers do: rows and columns pad to ``lcm(G*br, bc)``, block-row
r holds rows ``[r*br, (r+1)*br)`` and its window starts at column
``base[r]*bc``.

Left out: the TPU VMEM models (``auto_rows_per_step``, ``ring_span``)
that size G and the x ring, so ``pack_banded`` returns no ring size.  G
defaults to ``min(8, block rows)``, which is what the VMEM model picks
at the serving shape; the x ring has no counterpart on the GPU, where
the x window is contiguous in device memory.  Schedule row 2 (column
high-water) is still computed, so the schedule stays byte-equal, but the
GPU kernel does not read it.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse

__all__ = [
    "BLOCK",
    "MAX_LEVELS",
    "ROWS_PER_STEP",
    "band_stats",
    "pack_banded",
    "choose_band_levels",
    "pack_banded_ragged",
    "pack_dkw_from_ragged",
    "MAX_BAND_WIDTH",
    "band_row_index",
    "band_scale_of",
    "quantize_band",
    "COLSTREAM_CHUNK",
    "COLSTREAM_UNROLL",
    "choose_block_shape",
    "pack_block_sparse",
    "colstream_pack",
    "colstream_order",
    "row_index",
    "choose_bsr_row_group",
]

# The default block edge (JAX's MXU_TILE) and the most width levels the
# kernel takes (csrc/band.cu kMaxLevels).
BLOCK = 128
MAX_LEVELS = 4
ROWS_PER_STEP = 8  # default G: block-rows per schedule step
# The widest band the packers take, in blocks.  band_row_index's window
# offsets lie below MAX_BAND_WIDTH * bc, which must fit int16 (bc <= 682).
MAX_BAND_WIDTH = 48
_INT16_LIMIT = 1 << 15


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_stats(L: scipy.sparse.spmatrix,
               block_shape: tuple = (BLOCK, BLOCK)):
    """Per-block-row monotone window bases (suffix-min of the first nonzero
    block column), the band width W covering every row's span, the number
    of occupied blocks, and the size padded to ``lcm(br, bc)``.  Returns
    ``(base, W, n_blocks, m_padded)``."""
    br, bc = block_shape
    mp = _round_up(L.shape[0], int(np.lcm(br, bc)))
    n_rb, n_cb = mp // br, mp // bc
    coo = L.tocoo()
    brow = coo.row // br
    bcol = coo.col // bc
    n_blocks = len(np.unique(brow.astype(np.int64) * n_cb + bcol))

    lo = np.full(n_rb, n_cb, np.int64)
    hi = np.full(n_rb, -1, np.int64)
    np.minimum.at(lo, brow, bcol)
    np.maximum.at(hi, brow, bcol)

    base = np.minimum.accumulate(lo[::-1])[::-1]
    W = min(int(max((hi - base).max() + 1, 1)), n_cb)
    base = np.clip(base, 0, n_cb - W).astype(np.int32)
    return base, W, n_blocks, mp


def pack_banded(L: scipy.sparse.spmatrix,
                max_band_width: int = MAX_BAND_WIDTH,
                rows_per_step: int | None = None, stats: tuple | None = None,
                row_multiple: int | None = None, band_dtype=np.float32,
                block_shape: tuple = (BLOCK, BLOCK)):
    """Pack a block-banded matrix into the uniform band ``[n_rb, W, br,
    bc]`` with monotone window bases: ``band[i, d]`` is the block at
    block coordinates ``(i, base[i] + d)``.

    The rows are padded to a multiple of ``lcm(G*br, bc)`` with G =
    ``rows_per_step`` (default ``min(8, block rows)``), or
    ``row_multiple`` where given (the sharded packer needs whole steps
    per shard): zero band rows, base held at its last value.
    ``band_dtype`` is the host staging dtype.  Returns ``(band, base, G,
    m_padded)``.  Raises ``ValueError`` when the band is wider than
    ``max_band_width`` blocks."""
    br, bc = block_shape
    base, W, _, mp = stats if stats is not None else band_stats(
        L, block_shape)
    if W > max_band_width:
        raise ValueError(
            f"band width {W} blocks exceeds {max_band_width}; "
            "RCM-reorder the graph or use fmt='bsr'"
        )
    G = min(ROWS_PER_STEP, len(base)) if rows_per_step is None \
        else rows_per_step
    mp = _round_up(mp, int(np.lcm((row_multiple or G) * br, bc)))
    n_rb = mp // br
    base = np.concatenate(
        [base, np.full(n_rb - len(base), base[-1], np.int32)]
    )
    band = np.zeros((n_rb, W, br, bc), np.dtype(band_dtype))
    coo = L.tocoo()
    brow = coo.row // br
    band[brow, coo.col // bc - base[brow], coo.row % br,
         coo.col % bc] = coo.data.astype(band.dtype)
    return band, base, G, mp


def choose_band_levels(ws) -> tuple:
    """At most ``MAX_LEVELS`` width levels (always including the max) that
    minimise the padded band blocks when every step width in ``ws`` is
    rounded up to its level.  Exhaustive over the distinct widths."""
    uniq, cnt = np.unique(np.asarray(ws, np.int64), return_counts=True)
    if len(uniq) <= MAX_LEVELS:
        return tuple(int(u) for u in uniq)
    best = None
    for combo in itertools.combinations(range(len(uniq) - 1),
                                        MAX_LEVELS - 1):
        lv = np.concatenate([uniq[list(combo)], uniq[-1:]])
        cost = int((cnt * lv[np.searchsorted(lv, uniq)]).sum())
        if best is None or cost < best[0]:
            best = (cost, lv)
    return tuple(int(v) for v in best[1])


def pack_banded_ragged(L: scipy.sparse.spmatrix, G: int | None = None,
                       max_band_width: int = MAX_BAND_WIDTH,
                       stats: tuple | None = None,
                       block_shape: tuple = (BLOCK, BLOCK)):
    """Pack a block-banded matrix with one width per G-block-row step.

    Each step stores ``W_s`` = its widest row span, rounded up to one of at
    most ``MAX_LEVELS`` width levels, laid out flat.  Returns
    ``(band_flat, base, sched, levels, G, m_padded)``: ``band_flat`` is
    ``[sum_s G*W_s, br, bc]`` float32 (the device dtype is set when the
    operator is built), ``sched`` int32 ``[3, nsb]`` holds each
    step's block offset, level index and column high-water mark.
    Raises ``ValueError`` when the band is wider than ``max_band_width``.
    """
    br, bc = block_shape
    base, W, _, mp = stats if stats is not None else band_stats(
        L, block_shape)
    if W > max_band_width:
        raise ValueError(
            f"band width {W} blocks exceeds {max_band_width}; "
            "RCM-reorder the graph"
        )
    if G is None:
        G = min(ROWS_PER_STEP, len(base))
    mp = _round_up(mp, int(np.lcm(G * br, bc)))
    n_rb, n_cb = mp // br, mp // bc
    base = np.concatenate(
        [base, np.full(n_rb - len(base), base[-1], np.int32)]
    )
    nsb = n_rb // G

    coo = L.tocoo()
    brow = coo.row // br
    bcol = coo.col // bc
    hi = np.full(n_rb, -1, np.int64)
    np.maximum.at(hi, brow, bcol)
    span = np.maximum(hi - base.astype(np.int64) + 1, 1)
    ws = span.reshape(nsb, G).max(axis=1)
    levels = choose_band_levels(ws)
    lvl_idx = np.searchsorted(np.asarray(levels), ws).astype(np.int64)
    wl = np.asarray(levels, np.int64)[lvl_idx]
    offs = np.zeros(nsb, np.int64)
    offs[1:] = np.cumsum(G * wl)[:-1]
    total = int((G * wl).sum())

    band = np.zeros((total, br, bc), np.float32)
    s_of_row = brow // G
    pos = (offs[s_of_row] + (brow % G) * wl[s_of_row]
           + (bcol - base[brow]))
    band[pos, coo.row % br, coo.col % bc] = coo.data.astype(band.dtype)

    step_hi = base[(np.arange(nsb) + 1) * G - 1].astype(np.int64) + wl
    hw = np.minimum(np.maximum.accumulate(step_hi), n_cb)
    sched = np.stack([offs, lvl_idx, hw]).astype(np.int32)
    return band, base, sched, levels, G, mp


def pack_dkw_from_ragged(band_flat, sched, levels, G: int,
                         block_shape: tuple = (BLOCK, BLOCK)):
    """Repack the flat ragged band into the deep-K-window layout: one array
    per width level, ``[n_rows_l, br, W_l*bc]``, each block-row's W_l
    blocks side by side along the contraction axis, rows ordered by step.
    Returns ``(bands, sched_dkw)``; ``sched_dkw`` row 0 holds each step's
    ROW offset into its level's array (rows 1-2 as in ``sched``)."""
    br, bc = block_shape
    offs, lvl_idx, hw = (np.asarray(v, np.int64) for v in sched)
    nsb = len(offs)
    counts = np.zeros(len(levels), np.int64)
    row_off = np.zeros(nsb, np.int64)
    for s in range(nsb):
        li = int(lvl_idx[s])
        row_off[s] = counts[li]
        counts[li] += G
    bands = [
        np.zeros((max(int(counts[i]), G), br, levels[i] * bc),
                 band_flat.dtype)
        for i in range(len(levels))
    ]
    for s in range(nsb):
        li = int(lvl_idx[s])
        w = levels[li]
        blk = band_flat[int(offs[s]): int(offs[s]) + G * w]
        blk = blk.reshape(G, w, br, bc).transpose(0, 2, 1, 3)
        bands[li][int(row_off[s]): int(row_off[s]) + G] = (
            blk.reshape(G, br, w * bc)
        )
    sched_dkw = np.stack([row_off, lvl_idx, hw]).astype(np.int32)
    return bands, sched_dkw


def band_row_index(L: scipy.sparse.spmatrix, base, m_padded: int,
                   block_shape: tuple = (BLOCK, BLOCK)):
    """The banded operators' nonzero index by output row: ``(rowptr,
    win)`` with ``rowptr`` int32 ``[m_padded + 1]`` and, for each nonzero
    of ``L`` (once per position, in row order, columns sorted), ``win``
    (int16), its offset in its block-row's window, ``col - bc *
    base[row // br]``.  A value's place follows from (row, offset) and
    the block-row's band in each layout (csrc/band.cu ``band_off``), so
    the index holds no positions and serves the dkw, uniform and flat
    ragged bands that K1, K5 and K6 walk, their int8 twins and bases
    shifted for an extended-column x.
    Raises ``ValueError`` on a nonzero before its window, an offset past
    ``MAX_BAND_WIDTH`` blocks or past int16, or a row past ``m_padded``
    or ``base``."""
    br, bc = block_shape
    coo = L.tocoo()
    n = max(L.shape[1], 1)
    key = np.unique(coo.row.astype(np.int64) * n + coo.col)
    rows, cols = key // n, key % n
    base = np.asarray(base, np.int64)
    if len(rows) and (rows[-1] >= m_padded
                      or rows[-1] // br >= len(base)):
        raise ValueError(f"band_row_index: a row past m_padded {m_padded} "
                         f"or the {len(base)} block-row bases")
    k = cols - bc * base[rows // br]
    if len(k) and int(k.min()) < 0:
        raise ValueError("band_row_index: a nonzero lies before its row's "
                         "window")
    limit = min(MAX_BAND_WIDTH * bc, _INT16_LIMIT)
    if len(k) and int(k.max()) >= limit:
        raise ValueError(f"band_row_index: a window offset {int(k.max())} "
                         f"past {MAX_BAND_WIDTH} blocks of {bc} columns or "
                         "past int16")
    rowptr = np.searchsorted(rows, np.arange(m_padded + 1)).astype(np.int32)
    return rowptr, k.astype(np.int16)


def band_scale_of(bands) -> float:
    """The int8 band's dequant scale ``max|band| / 127`` (1.0 for an
    all-zero band), as a Python float."""
    s = max(float(np.max(np.abs(np.asarray(b, np.float32)))) for b in bands)
    s /= 127.0
    return s if s != 0.0 else 1.0


def quantize_band(band: np.ndarray, scale: float) -> np.ndarray:
    """Symmetric int8 quantization ``clip(round(band / scale), +-127)`` with
    NumPy's float32 arithmetic and half-to-even rounding."""
    band = np.asarray(band, np.float32)
    return np.clip(np.round(band / scale), -127, 127).astype(np.int8)


# ------------------------------------------------------------ block sparse


def choose_block_shape(
    L: scipy.sparse.spmatrix,
    candidates=((8, 128), (16, 128), (32, 128), (64, 128), (128, 128)),
    dma_overhead: int = 11000,
) -> tuple:
    """The block shape minimising ``blocks * (br*bc + dma_overhead)``: the
    padded entries plus a fixed cost per block.  ``dma_overhead`` is the
    JAX package's, fitted on a TPU v5e (a per-block DMA cost); it is kept
    for parity and is to be re-fitted on Hopper."""
    coo = L.tocoo()
    best, best_cost = None, None
    for br, bc in candidates:
        mp = _round_up(L.shape[0], int(np.lcm(br, bc)))
        n_cb = mp // bc
        nb = len(np.unique((coo.row // br).astype(np.int64) * n_cb
                           + coo.col // bc))
        cost = nb * (br * bc + dma_overhead)
        if best_cost is None or cost < best_cost:
            best, best_cost = (br, bc), cost
    return best


def pack_block_sparse(L: scipy.sparse.spmatrix,
                      block_shape: tuple = (BLOCK, BLOCK)):
    """Tile a sparse matrix into dense ``br x bc`` float32 blocks, keeping
    the nonzero tiles only, sorted by (row, column).  Returns ``(blocks,
    block_rows, block_cols, block_rowptr, m_padded)``.  A square matrix
    pads both sides to ``lcm(br, bc)``; a rectangular one pads each side
    on its own, and ``m_padded`` is then the padded row count."""
    br_sz, bc_sz = block_shape
    rows, cols = L.shape
    if rows == cols:
        mp = _round_up(rows, int(np.lcm(br_sz, bc_sz)))
        mp_r = mp_c = mp
    else:
        mp_r = _round_up(rows, br_sz)
        mp_c = _round_up(cols, bc_sz)
    n_rb = mp_r // br_sz
    n_cb = mp_c // bc_sz
    coo = L.tocoo()
    br = coo.row // br_sz
    bc = coo.col // bc_sz
    block_ids = br.astype(np.int64) * n_cb + bc
    unique_ids = np.unique(block_ids)

    blocks = np.zeros((len(unique_ids), br_sz, bc_sz), dtype=np.float32)
    slot = np.searchsorted(unique_ids, block_ids)
    blocks[slot, coo.row % br_sz, coo.col % bc_sz] = coo.data

    brows = (unique_ids // n_cb).astype(np.int32)
    rowptr = np.searchsorted(brows, np.arange(n_rb + 1)).astype(np.int32)
    return blocks, brows, (unique_ids % n_cb).astype(np.int32), rowptr, mp_r


# The column-streamed layout's padding: each group's block run is padded
# to a multiple of COLSTREAM_UNROLL blocks and the block array carries a
# COLSTREAM_CHUNK-block zero tail.  Both sizes come from the TPU kernel
# (an 8-block unrolled walk over 64-block DMA chunks); the GPU kernel
# reads the layout as it is and needs neither, but the layout stays the
# JAX package's byte for byte.
COLSTREAM_CHUNK = 64
COLSTREAM_UNROLL = 8
_META_FIELD = 1 << 16  # meta = (row in group << 16) | column slot


def colstream_pack(blocks: np.ndarray, brows: np.ndarray,
                   bcols: np.ndarray, rowptr: np.ndarray, G: int,
                   unroll: int = COLSTREAM_UNROLL):
    """The column-streamed layout of a block-CSR matrix, with its kernel
    metadata.

    Each group of G block-rows has its blocks reordered by (column, row),
    so that each distinct column's x tile is read once per group, and
    padded with zero blocks to a multiple of ``unroll``.  Returns
    ``(blocks2, brows2, bcols2, meta, gcols, gcolptr, groupptr)``:
    ``meta[b] = (row of b in its group << 16) | (slot of b's column in
    the group's list)``, ``gcols[gcolptr[s]:gcolptr[s+1]]`` lists group
    s's distinct columns and ``groupptr[s]:groupptr[s+1]`` its padded run
    of blocks.  Pad blocks are zero, sit in the group's row 0 and carry
    its last column and column slot.  Raises ``ValueError`` when a row in
    a group or a column slot does not fit its 16-bit field."""
    n_rb = len(rowptr) - 1
    nsb = n_rb // G
    if n_rb % G or COLSTREAM_CHUNK % unroll:
        raise ValueError(f"colstream_pack: {n_rb} block-rows are not whole "
                         f"groups of G = {G}, or the unroll {unroll} does "
                         f"not divide {COLSTREAM_CHUNK}")
    if G > _META_FIELD:
        raise ValueError(f"colstream_pack: G = {G} rows per group does not "
                         "fit meta's 16-bit row field")
    bshape = blocks.shape[1:]
    out_blocks, out_rows, out_cols = [], [], []
    meta_parts, gcols_parts = [], []
    gcolptr = np.zeros(nsb + 1, np.int64)
    groupptr = np.zeros(nsb + 1, np.int64)
    for s in range(nsb):
        lo, hi = int(rowptr[s * G]), int(rowptr[(s + 1) * G])
        idx = np.arange(lo, hi)
        order = np.lexsort((brows[idx], bcols[idx]))
        p = idx[order]
        cols = bcols[p]
        uniq, local = np.unique(cols, return_inverse=True)
        if len(uniq) > _META_FIELD:
            raise ValueError(
                f"colstream_pack: group {s} has {len(uniq)} distinct "
                f"columns; meta's 16-bit column slot holds {_META_FIELD}")
        mt = ((brows[p] - s * G) << 16) | local
        pad = (-len(p)) % unroll
        out_blocks.append(blocks[p])
        if pad:
            out_blocks.append(np.zeros((pad,) + bshape, blocks.dtype))
        out_rows.append(np.concatenate(
            [brows[p], np.full(pad, s * G, brows.dtype)]))
        out_cols.append(np.concatenate(
            [cols, np.full(pad, uniq[-1] if len(uniq) else 0,
                           bcols.dtype)]))
        pad_slot = int(local[-1]) if len(local) else 0
        meta_parts.append(np.concatenate(
            [mt, np.full(pad, pad_slot, np.int64)]))
        gcols_parts.append(uniq)
        gcolptr[s + 1] = gcolptr[s] + len(uniq)
        groupptr[s + 1] = groupptr[s] + len(p) + pad
    blocks2 = (np.concatenate(out_blocks) if out_blocks
               else blocks[:0])
    return (
        blocks2,
        np.concatenate(out_rows) if out_rows else brows[:0],
        np.concatenate(out_cols) if out_cols else bcols[:0],
        (np.concatenate(meta_parts) if meta_parts
         else np.zeros(0)).astype(np.int32),
        (np.concatenate(gcols_parts) if gcols_parts
         else np.zeros(0)).astype(np.int32),
        gcolptr.astype(np.int32),
        groupptr.astype(np.int32),
    )


def colstream_order(brows: np.ndarray, bcols: np.ndarray,
                    rowptr: np.ndarray, groupptr: np.ndarray,
                    G: int) -> np.ndarray:
    """Where ``colstream_pack`` puts each block of the block-CSR order:
    its ``blocks2[order[b]]`` is ``blocks[b]``.  Group s's real blocks,
    sorted by (column, row), open its run at ``groupptr[s]``; its pads
    follow them and are no block's place."""
    s = brows.astype(np.int64) // G
    k = np.lexsort((brows, bcols, s))
    sk = s[k]
    order = np.empty(len(brows), np.int64)
    order[k] = (groupptr.astype(np.int64)[sk] + np.arange(len(k))
                - rowptr.astype(np.int64)[sk * G])
    return order


def row_index(L: scipy.sparse.spmatrix, brows: np.ndarray,
              bcols: np.ndarray, block_shape: tuple, m_padded: int,
              order: np.ndarray | None = None):
    """The nonzero index of a BSR operator, by output row: ``(rowptr,
    cols, pos)`` with ``rowptr`` int32 ``[m_padded + 1]``, and for each
    nonzero of ``L`` (once per position, in row order, columns sorted)
    its column ``cols`` (int32) and ``pos`` (int64), its flat place in
    the operator's ``blocks`` array, ``block * br * bc + r * bc + c``.
    ``brows``/``bcols`` are the block-CSR order that ``pack_block_sparse``
    returns and ``order`` where a reordered layout puts each of those
    blocks (``colstream_order``; none: in place).  The row kernel reads
    each value as ``blocks.view(-1)[pos]``, in whatever dtype the blocks
    have."""
    br, bc = block_shape
    coo = L.tocoo()
    n = max(L.shape[1], 1)
    key = np.unique(coo.row.astype(np.int64) * n + coo.col)
    rows, cols = key // n, key % n
    n_cb = -(-n // bc)
    block_key = brows.astype(np.int64) * n_cb + bcols
    want = (rows // br) * n_cb + cols // bc
    slot = np.searchsorted(block_key, want)
    if len(slot) and (slot.max() >= len(block_key)
                      or not np.array_equal(block_key[slot], want)):
        raise ValueError("row_index: a nonzero of L lies in no block")
    if order is not None:
        slot = order[slot]
    pos = slot * (br * bc) + (rows % br) * bc + cols % bc
    rowptr = np.searchsorted(rows, np.arange(m_padded + 1)).astype(np.int32)
    if len(rows) >= 2**31:
        raise ValueError("row_index: more nonzeros than int32 holds")
    return rowptr, cols.astype(np.int32), pos.astype(np.int64)


def choose_bsr_row_group(rowptr: np.ndarray, br: int, bc: int,
                         elem_bytes: int, budget: int = 6 << 20,
                         max_overfetch: float = 1.35,
                         max_g: int = 16) -> tuple:
    """The block-CSR layout's rows per group G and its static group
    extent ``Lg`` (the most blocks in any group of G rows): the largest G
    whose two slabs of ``Lg`` blocks fit ``budget`` bytes and whose
    ``Lg``-long slabs read at most ``max_overfetch`` times the real
    blocks.  Returns ``(1, 0)`` when no G > 1 qualifies.  The budget is a
    TPU VMEM size, kept for parity: the GPU kernel reads no slab."""
    counts = np.diff(rowptr)
    n_rb = len(counts)
    nb = int(rowptr[-1])
    if nb == 0 or n_rb == 0:
        return 1, 0
    for G in (16, 12, 8, 4, 2):
        if G > max_g or G > n_rb:
            continue
        nsb = -(-n_rb // G)
        pad = np.full(nsb * G - n_rb, 0, counts.dtype)
        ext = np.concatenate([counts, pad]).reshape(nsb, G).sum(axis=1)
        Lg = int(ext.max())
        if 2 * Lg * br * bc * elem_bytes > budget:
            continue
        if nsb * Lg > max_overfetch * nb:
            continue
        return G, Lg
    return 1, 0
