"""Host-side graph construction and coarsening (NumPy/SciPy).

Mirrors ``cnn_graph_tpu.graphs``: ``construction`` builds grids, kNN
graphs, Laplacians and the city graph; ``coarsening`` holds Graclus and
the pooling permutation.  Everything is re-exported here.
"""

from cnn_graph_tpu_torch.graphs import coarsening, construction
from cnn_graph_tpu_torch.graphs.coarsening import (
    coarsen,
    compute_perm,
    graclus,
    graclus_pairing,
    perm_adjacency,
    perm_data,
)
from cnn_graph_tpu_torch.graphs.construction import (
    adjacency,
    bandwidth_reducing_permutation,
    chebyshev_basis,
    city_graph,
    fourier,
    grid,
    knn,
    knn_graph,
    lanczos_basis,
    laplacian,
    lmax,
    replace_random_edges,
    rescale_laplacian,
)

__all__ = [
    "coarsening",
    "construction",
    "coarsen",
    "compute_perm",
    "graclus",
    "graclus_pairing",
    "perm_adjacency",
    "perm_data",
    "adjacency",
    "bandwidth_reducing_permutation",
    "chebyshev_basis",
    "city_graph",
    "fourier",
    "grid",
    "knn",
    "knn_graph",
    "lanczos_basis",
    "laplacian",
    "lmax",
    "replace_random_edges",
    "rescale_laplacian",
]
