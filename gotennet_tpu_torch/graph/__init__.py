"""Graph substrate: fixed-capacity batches, segment ops, neighbour lists.

The names of ``gotennet_tpu/graph/__init__.py``, with two differences:
``radius_graph`` stands for ``radius_graph_jax`` (the same arrays, on the
tensors' device), and ``pad_sizes_for`` is not here.  It sizes a batch
with a leading device axis, and this package runs one process per device,
each rank holding a batch of its own, so nothing would call it.
"""

from gotennet_tpu_torch.graph.batch import GraphBatch
from gotennet_tpu_torch.graph.dense_batch import (DenseBatch, collate_dense,
                                                  flatten_nodes)
from gotennet_tpu_torch.graph.neighborlist import (build_edges_np,
                                                   collate_graphs,
                                                   radius_graph)
from gotennet_tpu_torch.graph.segment import (segment_max, segment_mean,
                                              segment_softmax, segment_sum)

__all__ = [
    "GraphBatch",
    "DenseBatch",
    "collate_dense",
    "flatten_nodes",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_softmax",
    "build_edges_np",
    "collate_graphs",
    "radius_graph",
]
