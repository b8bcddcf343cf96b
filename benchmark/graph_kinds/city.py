"""``city``: the bench's 2-D city graph (``harness/graphs.py city_graph``):
a jittered ``side x side`` grid, its ``k``-NN Gaussian graph, RCM-ordered.
Gives the Laplacian and the nodes' grid positions."""

from harness import graphs


def make(spec: dict) -> dict:
    L, pos = graphs.city_graph(spec["side"], spec["k"], spec["seed"],
                               spec["jitter"])
    return {"laplacians": [L], "positions": pos}
