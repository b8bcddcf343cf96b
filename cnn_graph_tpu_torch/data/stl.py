"""Seasonal-trend decomposition for flow normalization.

A NumPy copy of ``cnn_graph_tpu/data/stl.py:36 decompose``: the classical
additive decomposition that stands in for ``stldecompose.decompose``
(nips2016/humantraffic.py:15), which neither package imports.  The trend
is a centred moving average over one period (2 x period for an even
period), extended at the edges with the nearest value; the seasonal
component the period-position means of the detrended series, de-meaned;
the residual what is left.  The same float64 arithmetic as the JAX
package's, so the arrays are equal byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["decompose", "Decomposition"]


@dataclasses.dataclass
class Decomposition:
    observed: np.ndarray
    trend: np.ndarray
    seasonal: np.ndarray
    resid: np.ndarray


def decompose(x: np.ndarray, period: int) -> Decomposition:
    """Additive seasonal decomposition of a 1-D series of at least two
    periods."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n < 2 * period:
        raise ValueError(f"need at least two periods ({2 * period}), got {n}")
    if period % 2 == 0:
        kernel = np.ones(period + 1) / period
        kernel[0] = kernel[-1] = 0.5 / period
    else:
        kernel = np.ones(period) / period
    trend = np.convolve(x, kernel, mode="same")
    half = len(kernel) // 2
    trend[:half] = trend[half]
    trend[-half:] = trend[-half - 1]
    detrended = x - trend
    seasonal_means = np.array(
        [detrended[i::period].mean() for i in range(period)])
    seasonal_means -= seasonal_means.mean()
    seasonal = np.tile(seasonal_means, n // period + 1)[:n]
    resid = x - trend - seasonal
    return Decomposition(observed=x, trend=trend, seasonal=seasonal,
                         resid=resid)
