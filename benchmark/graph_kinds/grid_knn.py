"""``grid_knn``: the paper's MNIST graph (``harness/graphs.py``): the
``side x side`` pixel grid's ``k``-NN graph, Graclus-coarsened ``levels``
times with its visit order fixed by ``seed``.  Gives each level's
Laplacian, finest first, and the permutation that orders a sample's
pixels as the coarsening's binary tree (``graphs.perm_data``)."""

from harness import graphs


def make(spec: dict) -> dict:
    W = graphs.grid_knn_graph(spec["side"], spec["k"])
    coarse, perm = graphs.coarsen(W, spec["levels"], spec["seed"])
    return {"laplacians": [graphs.laplacian(a) for a in coarse],
            "perm": perm}
