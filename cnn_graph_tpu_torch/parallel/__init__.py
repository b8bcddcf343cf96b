"""Node-sharded operators and data x node parallelism on
``torch.distributed``: the mesh, the all-gather operator, the dense
all_to_all halo, the banded ring halo and the sparse halo operators
(block-sparse and per-shard banded), with their int8 twins.

Counterpart of ``cnn_graph_tpu/parallel/``.  Every rank runs the same
program on its own device; an operator holds the rank's rows and its
products take and return them.  ``dryrun`` is the torch twin of
``__graft_entry__.dryrun_multichip``.
"""

from cnn_graph_tpu_torch.parallel.banded_halo import (
    BandedHaloLaplacian,
    QuantBandedHaloLaplacian,
    banded_halo_laplacian,
    quantize_banded_halo,
)
from cnn_graph_tpu_torch.parallel.halo import (
    HaloShardedLaplacian,
    build_halo_plan,
    halo_exchange_columns,
    halo_sharded_laplacian,
)
from cnn_graph_tpu_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    init_distributed,
    make_mesh,
    node_sum,
    replicated,
)
from cnn_graph_tpu_torch.parallel.node_sharded import (
    NodeShardedLaplacian,
    node_sharded_laplacian,
)
from cnn_graph_tpu_torch.parallel.sparse_halo import (
    BandedSparseHaloLaplacian,
    QuantBandedSparseHaloLaplacian,
    QuantSparseHaloLaplacian,
    SparseHaloLaplacian,
    quantize_sparse_halo,
    sparse_halo_laplacian,
)

__all__ = [
    "BandedHaloLaplacian",
    "QuantBandedHaloLaplacian",
    "banded_halo_laplacian",
    "quantize_banded_halo",
    "HaloShardedLaplacian",
    "build_halo_plan",
    "halo_exchange_columns",
    "halo_sharded_laplacian",
    "Mesh",
    "data_sharding",
    "init_distributed",
    "make_mesh",
    "node_sum",
    "replicated",
    "NodeShardedLaplacian",
    "node_sharded_laplacian",
    "BandedSparseHaloLaplacian",
    "QuantBandedSparseHaloLaplacian",
    "QuantSparseHaloLaplacian",
    "SparseHaloLaplacian",
    "quantize_sparse_halo",
    "sparse_halo_laplacian",
]
