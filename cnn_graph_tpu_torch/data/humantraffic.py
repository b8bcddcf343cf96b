"""HumanTraffic: the urban in/out-flow dataset pipeline.

A NumPy/SciPy copy of ``cnn_graph_tpu/data/humantraffic.py``:
``FlowSplits`` (:38), ``HumanTraffic`` (:51) with its normalizers, the
windowing core ``make_windows`` (:140) and ``make_split_windows``, the
train/val/test split and every loader of the reference's
(nips2016/humantraffic.py:17-488), with the same float64 arithmetic, so
that the arrays are equal byte for byte.  It reads ``.mat`` flow
matrices (``inmatrix``/``outmatrix`` [M, T], optionally
``split_in_traffic``/``split_out_traffic`` [M, T, 2], and an
``edge_matrix`` [M, M]) and turns them into sliding-window samples for
the forecasting models.

Sample layout ([N, M, C], labels [N, M, 2]):
  closeness window  in[t-s..t), out[t-s..t)            (2*seq_num chans)
  period window     centred at t-48, width seq_period   (2*seq_period)
  trend window      centred at t-336, width seq_trend   (2*seq_trend)
(48 half-hour slots a day, 336 a week.)  Windows that touch a missing
(-1) observation are dropped, the mask taken from the raw data.  Split:
the last 168 steps are test, the rest 80/20 train/val.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io
from scipy.sparse import csr_matrix

from cnn_graph_tpu_torch.data.stl import decompose

__all__ = ["HumanTraffic", "FlowSplits"]

DAY = 48  # half-hour slots per day
WEEK = 48 * 7
TEST_STEPS = 168


class FlowSplits(dict):
    """Dict of train/val/test data+labels with attribute access; unpacks in
    the reference's 6-tuple order for drop-in use."""

    def __iter__(self):
        return iter(
            (
                self["train_data"], self["val_data"], self["test_data"],
                self["train_labels"], self["val_labels"], self["test_labels"],
            )
        )


class HumanTraffic:
    def __init__(self, data_set_path: str):
        self.dataset_path = data_set_path
        self.max_val = 0.0
        self.min_val = 0.0

    # ---- IO ----

    def _loadmat(self, name: str):
        return scipy.io.loadmat(os.path.join(self.dataset_path, name))

    def _edge_matrix(self) -> csr_matrix:
        return csr_matrix(self._loadmat("edge_matrix.mat")["edge_matrix"])

    # ---- normalization (humantraffic.py:415-488) ----

    def normalize(self, in_matrix, out_matrix):
        """Divide by the global maximum (humantraffic.py:476-482)."""
        self.min_val = 0.0
        self.max_val = float(max(np.amax(in_matrix), np.amax(out_matrix)))
        return in_matrix / self.max_val, out_matrix / self.max_val

    def normalize_split(self, in_m, out_m, split_in, split_out):
        self.min_val = 0.0
        self.max_val = float(max(np.amax(in_m), np.amax(out_m)))
        return (
            in_m / self.max_val,
            out_m / self.max_val,
            split_in / self.max_val,
            split_out / self.max_val,
        )

    def normalize_seasonal_decompose(self, in_matrix, out_matrix):
        """Replace each node's series by its STL residual, then min-max
        scale globally (humantraffic.py:455-474).  Seasonal components are
        kept on the instance for reconstruction."""
        in_matrix = np.asarray(in_matrix, np.float64).copy()
        out_matrix = np.asarray(out_matrix, np.float64).copy()
        self.seasonal_in_matrix = np.zeros_like(in_matrix)
        self.seasonal_out_matrix = np.zeros_like(out_matrix)
        for i in range(in_matrix.shape[0]):
            stl = decompose(in_matrix[i], period=DAY)
            self.seasonal_in_matrix[i] = stl.seasonal
            in_matrix[i] = stl.resid
            stl = decompose(out_matrix[i], period=DAY)
            self.seasonal_out_matrix[i] = stl.seasonal
            out_matrix[i] = stl.resid
        self.max_val = float(max(in_matrix.max(), out_matrix.max()))
        self.min_val = float(min(in_matrix.min(), out_matrix.min()))
        scale = self.max_val - self.min_val
        return (in_matrix - self.min_val) / scale, (out_matrix - self.min_val) / scale

    def split_normalize_seasonal_decompose(self, in_m, out_m, split_in, split_out):
        """STL-residual normalization of slow/fast split traffic, with the
        totals adjusted by both channels' seasonal+trend components
        (humantraffic.py:415-443)."""
        in_m = np.asarray(in_m, np.float64).copy()
        out_m = np.asarray(out_m, np.float64).copy()
        split_in = np.asarray(split_in, np.float64).copy()
        split_out = np.asarray(split_out, np.float64).copy()
        for i in range(in_m.shape[0]):
            for split, total in ((split_in, in_m), (split_out, out_m)):
                stl_slow = decompose(split[i, :, 0], period=DAY)
                split[i, :, 0] = stl_slow.resid
                stl_fast = decompose(split[i, :, 1], period=DAY)
                split[i, :, 1] = stl_fast.resid
                total[i] -= (
                    stl_slow.seasonal + stl_slow.trend
                    + stl_fast.seasonal + stl_fast.trend
                )
        self.max_val = float(
            max(in_m.max(), out_m.max(), split_in.max(), split_out.max())
        )
        self.min_val = float(
            min(in_m.min(), out_m.min(), split_in.min(), split_out.min())
        )
        scale = self.max_val - self.min_val
        return tuple(
            (m - self.min_val) / scale for m in (in_m, out_m, split_in, split_out)
        )

    def reverse_normalize(self, data):
        """Undo the global scaling for metric computation
        (humantraffic.py:484-488)."""
        return data * (self.max_val - self.min_val)

    # ---- windowing core ----

    @staticmethod
    def make_windows(
        in_matrix,
        out_matrix,
        seq_num: int,
        seq_period: int = 0,
        seq_trend: int = 0,
        label_in=None,
        label_out=None,
        missing_mask=None,
        start: int | None = None,
    ):
        """Sliding closeness/period/trend windows.

        Returns ``(samples [N, M, C], labels [N, M, 2])``.  ``label_*``
        default to the input matrices (they differ for split-traffic inputs
        whose labels are the totals).  ``missing_mask`` ([M, T] bool) skips
        windows that touch missing observations — the intent of the
        reference's -1 filtering (humantraffic.py:201, 259), which it
        applies *after* normalization where the marker can no longer match;
        here the mask is computed from the raw data.
        """
        label_in = in_matrix if label_in is None else label_in
        label_out = out_matrix if label_out is None else label_out
        T = in_matrix.shape[1]
        if start is None:
            # Earliest t-index such that the deepest lookback is in range.
            if seq_trend > 0:
                start = (WEEK - seq_num) + seq_trend // 2
            elif seq_period > 0:
                start = (DAY - seq_num) + seq_period // 2
            else:
                start = 0

        def centered(mat, center, width):
            lo = center - width // 2
            return mat[:, lo : lo + width]

        def gather(a, b, i, t):
            parts = [a[:, i:t], b[:, i:t]]
            if seq_period > 0:
                parts += [
                    centered(a, t - DAY, seq_period),
                    centered(b, t - DAY, seq_period),
                ]
            if seq_trend > 0:
                parts += [
                    centered(a, t - WEEK, seq_trend),
                    centered(b, t - WEEK, seq_trend),
                ]
            return np.concatenate(parts, axis=1)

        samples, labels = [], []
        for i in range(start, T - seq_num):
            t = i + seq_num
            if missing_mask is not None and (
                np.any(gather(missing_mask, missing_mask, i, t))
                or np.any(missing_mask[:, t])
            ):
                continue
            samples.append(gather(in_matrix, out_matrix, i, t))
            labels.append(np.stack([label_in[:, t], label_out[:, t]], axis=1))
        return np.asarray(samples), np.asarray(labels)

    def dataset_split(self, samples, labels) -> FlowSplits:
        """Last 168 steps test; 80/20 train/val of the rest
        (humantraffic.py:25-36)."""
        total = samples.shape[0]
        n_train = int((total - TEST_STEPS) * 0.8)
        n_val = total - TEST_STEPS - n_train
        return FlowSplits(
            train_data=samples[:n_train],
            val_data=samples[n_train : n_train + n_val],
            test_data=samples[n_train + n_val :],
            train_labels=labels[:n_train],
            val_labels=labels[n_train : n_train + n_val],
            test_labels=labels[-TEST_STEPS:],
        )

    # ---- loaders (reference entry points) ----

    def load_ln_data_period(self, seq_num, seq_num_period=1, seq_num_trend=1,
                            datafile="ln_data.mat"):
        """Closeness+period+trend windows over the LN city data
        (humantraffic.py:38-81; series truncated to 1344 steps = 4 weeks)."""
        mat = self._loadmat(datafile)
        edges = self._edge_matrix()
        in_m = mat["inmatrix"][:, :1344]
        out_m = mat["outmatrix"][:, :1344]
        in_m, out_m = self.normalize(in_m, out_m)
        samples, labels = self.make_windows(
            in_m, out_m, seq_num, seq_num_period, seq_num_trend
        )
        return (*self.dataset_split(samples, labels), edges)

    @staticmethod
    def make_split_windows(split_in, split_out, label_in, label_out,
                           seq_num: int, seq_period: int = 0,
                           start: int = 0):
        """Windows over [M, T, 2] slow/fast split series; labels are the
        scalar totals.  Per sample the window channels are gathered as
        [slow-of-(in,out windows), fast-of-(in,out windows)] — the
        transpose+reshape layout of humantraffic.py:101-110."""
        T = split_in.shape[1]
        samples, labels = [], []
        for i in range(start, T - seq_num):
            t = i + seq_num
            parts = [split_in[:, i:t], split_out[:, i:t]]
            if seq_period > 0:
                lo = (t - DAY) - seq_period // 2
                parts += [
                    split_in[:, lo : lo + seq_period],
                    split_out[:, lo : lo + seq_period],
                ]
            x = np.concatenate(parts, axis=1)  # [M, C, 2]
            x = np.transpose(x, (0, 2, 1)).reshape(x.shape[0], -1)
            samples.append(x)
            labels.append(np.stack([label_in[:, t], label_out[:, t]], axis=1))
        return np.asarray(samples), np.asarray(labels)

    def load_split_ln_data_period(self, seq_num, seq_num_period=1,
                                  seq_num_trend=1, datafile="ln_data.mat"):
        """Slow/fast split traffic with period windows; labels are the
        totals (humantraffic.py:83-116)."""
        mat = self._loadmat(datafile)
        edges = self._edge_matrix()
        in_m, out_m, split_in, split_out = self.normalize_split(
            mat["inmatrix"], mat["outmatrix"],
            mat["split_in_traffic"], mat["split_out_traffic"],
        )
        start = (DAY - seq_num) + seq_num_trend // 2
        samples, labels = self.make_split_windows(
            split_in, split_out, in_m, out_m, seq_num, seq_num_period,
            start=start,
        )
        return (*self.dataset_split(samples, labels), edges)

    def load_split_ln_data(self, seq_num, datafile="split_lndata_street.mat"):
        """2-channel split traffic input -> total in/out target
        (humantraffic.py:118-159)."""
        mat = self._loadmat(datafile)
        edges = self._edge_matrix()
        in_m, out_m, split_in, split_out = self.normalize_split(
            mat["inmatrix"], mat["outmatrix"],
            mat["split_in_traffic"], mat["split_out_traffic"],
        )
        samples, labels = self.make_split_windows(
            split_in, split_out, in_m, out_m, seq_num
        )
        return (*self.dataset_split(samples, labels), edges)

    def load_bj_data(self, seq_num):
        """BJ taxi flows, closeness only, no edge matrix
        (humantraffic.py:161-182)."""
        mat = self._loadmat("bj_data.mat")
        in_m, out_m = self.normalize(mat["inmatrix"], mat["outmatrix"])
        samples, labels = self.make_windows(in_m, out_m, seq_num)
        return tuple(self.dataset_split(samples, labels))

    def load_bj_clus_data(self, seq_num):
        """BJ cluster flows; windows containing -1 (missing) are dropped
        (humantraffic.py:184-210)."""
        mat = self._loadmat("bj_clus.mat")
        edges = self._edge_matrix()
        raw_in, raw_out = mat["inmatrix"], mat["outmatrix"]
        mask = (raw_in == -1) | (raw_out == -1)
        in_m, out_m = self.normalize(raw_in, raw_out)
        samples, labels = self.make_windows(
            in_m, out_m, seq_num, missing_mask=mask
        )
        return (*self.dataset_split(samples, labels), edges)

    def load_bj_data_period_trend(self, seq_num, seq_num_period=1,
                                  seq_num_trend=1):
        """BJ taxi with a daily-period window (humantraffic.py:213-237)."""
        mat = self._loadmat("bj_data.mat")
        in_m, out_m = self.normalize(mat["inmatrix"], mat["outmatrix"])
        samples, labels = self.make_windows(
            in_m, out_m, seq_num, seq_num_period, seq_num_trend
        )
        return tuple(self.dataset_split(samples, labels))

    def load_bj_clus_period_trend(self, seq_num):
        """BJ clusters with yesterday/day-before samples at the target slot
        (humantraffic.py:239-268) and missing-window filtering."""
        mat = self._loadmat("bj_clus.mat")
        edges = self._edge_matrix()
        raw_in, raw_out = mat["inmatrix"], mat["outmatrix"]
        mask = (raw_in == -1) | (raw_out == -1)
        in_m, out_m = self.normalize(raw_in, raw_out)
        T = in_m.shape[1]
        samples, labels = [], []
        for i in range(2 * DAY - seq_num, T - seq_num):
            t = i + seq_num
            cols = np.r_[i:t, t - 2 * DAY : t - 1 : DAY, t]
            if np.any(mask[:, cols]):
                continue
            x = np.concatenate(
                [
                    in_m[:, i:t], out_m[:, i:t],
                    in_m[:, t - 2 * DAY : t - 1 : DAY],
                    out_m[:, t - 2 * DAY : t - 1 : DAY],
                ],
                axis=1,
            )
            samples.append(x)
            labels.append(np.stack([in_m[:, t], out_m[:, t]], axis=1))
        samples, labels = np.asarray(samples), np.asarray(labels)
        return (*self.dataset_split(samples, labels), edges)

    def load_unisolate_data(self, seq_num):
        """Drop isolated nodes, symmetrize the edge matrix, then window
        (humantraffic.py:271-319)."""
        mat = self._loadmat("ln_data.mat")
        in_m, out_m = mat["inmatrix"], mat["outmatrix"]
        edges = np.asarray(self._edge_matrix().todense())

        keep = np.flatnonzero(edges.sum(axis=1) != 0)
        edges = edges[np.ix_(keep, keep)]
        in_m, out_m = in_m[keep], out_m[keep]

        edges = edges + edges.T
        keep = np.flatnonzero(edges.sum(axis=1) != 0)
        edges = csr_matrix(edges[np.ix_(keep, keep)])
        in_m, out_m = in_m[keep], out_m[keep]

        in_m, out_m = self.normalize(in_m, out_m)
        samples, labels = self.make_windows(in_m, out_m, seq_num)
        return (*self.dataset_split(samples, labels), edges)

    def load_data(self, seq_num, edge_threshold: float = 700.0):
        """LN data with the edge matrix binarized at a weight threshold
        (humantraffic.py:321-352, threshold >= 700 at :326)."""
        mat = self._loadmat("ln_data.mat")
        edges = self._edge_matrix()
        edges = edges + edges.T
        dense = np.asarray(edges.todense())
        edges = csr_matrix((dense >= edge_threshold).astype(np.float64))
        in_m, out_m = self.normalize(mat["inmatrix"], mat["outmatrix"])
        samples, labels = self.make_windows(in_m, out_m, seq_num)
        return (*self.dataset_split(samples, labels), edges)

    def load_lstm_data(self, seq_num, neighbor_num, datafile):
        """Per-node series for the plain-LSTM baseline: one dataset per
        node, 85/15 train/test (humantraffic.py:354-383)."""
        mat = self._loadmat(datafile)
        in_m, out_m = self.normalize(mat["inmatrix"], mat["outmatrix"])
        collection = []
        for node in range(in_m.shape[0]):
            T = in_m.shape[1]
            xs = np.stack(
                [
                    np.concatenate([in_m[node, i : i + seq_num],
                                    out_m[node, i : i + seq_num]])
                    for i in range(T - seq_num)
                ]
            )
            ys = np.stack(
                [
                    [in_m[node, i + seq_num], out_m[node, i + seq_num]]
                    for i in range(T - seq_num)
                ]
            )
            n_train = int(xs.shape[0] * 0.85)
            collection.append(
                {
                    "train_data": xs[:n_train],
                    "test_data": xs[n_train:],
                    "train_labels": ys[:n_train],
                    "test_labels": ys[n_train:],
                }
            )
        return collection

    def load_lndata_street(self, seq_num, datafile="lndata_street.mat"):
        """Street-graph LN flows, closeness only (humantraffic.py:385-413)."""
        mat = self._loadmat(datafile)
        edges = self._edge_matrix()
        in_m, out_m = self.normalize(mat["inmatrix"], mat["outmatrix"])
        samples, labels = self.make_windows(in_m, out_m, seq_num)
        return (*self.dataset_split(samples, labels), edges)


