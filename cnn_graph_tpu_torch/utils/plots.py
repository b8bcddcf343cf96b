"""Plotting: the spectra of a coarsened Laplacian pyramid.

Counterpart of ``cnn_graph_tpu/utils/plots.py`` (``plot_spectrum`` :16;
the reference's lib/graph.py:169-181), on the port's
``graphs.construction.fourier``.  matplotlib is imported when a plot is
drawn; the function returns the figure and touches no global pyplot
state beyond creating it.
"""

from __future__ import annotations

__all__ = ["plot_spectrum", "spectrum_lines"]


def spectrum_lines(laplacians, algo: str = "eig") -> list:
    """What ``plot_spectrum`` draws: for level i, ``(x, eigenvalues,
    label)``, the level's eigenvalues ascending at the stride 2^i that
    aligns the levels' nodes."""
    from cnn_graph_tpu_torch.graphs.construction import fourier

    lines = []
    for i, lap in enumerate(laplacians):
        lamb, _ = fourier(lap, algo)
        step = 2**i
        x = range(step // 2, laplacians[0].shape[0], step)
        label = f"L_{i} spectrum in [{lamb[0]:1.2e}, {lamb[-1]:1.2e}]"
        lines.append((x, lamb, label))
    return lines


def plot_spectrum(laplacians, algo: str = "eig"):
    """Plot the eigenvalue spectra of a multi-scale Laplacian pyramid:
    level i at stride 2^i, so that the x axis aligns nodes across
    coarsening levels.  Returns the figure."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(17, 5))
    for x, lamb, label in spectrum_lines(laplacians, algo):
        ax.plot(x, lamb, ".", label=label)
    ax.legend(loc="best")
    ax.set_xlim(0, laplacians[0].shape[0])
    ax.set_ylim(bottom=0)
    return fig
