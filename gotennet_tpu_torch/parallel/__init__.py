"""More than one device (``gotennet_tpu/parallel/``), over
``torch.distributed`` with one process per device.

  * **Data parallel**: each rank trains on its own batch; gradients, loss
    and logs are averaged over the ``data`` axis of the mesh.
  * **Edge parallel**: the ranks of one ``edge`` line share a batch.  The
    edge-list layout splits its edge list among them and every segment
    reduction ends in one all-reduce (``graph/segment.py``'s
    ``psum_axis``); the ELL layout gives each rank a block of destination
    rows and rebuilds the node tables by an all-reduce.

Both compose in one ``(data, edge)`` grid of ranks (``make_mesh``).
"""

from gotennet_tpu_torch.parallel.collectives import pmax, pmean, psum
from gotennet_tpu_torch.parallel.data_parallel import (
    make_parallel_train_step, pmean_grads, pspec_for_layout,
    shard_graph_batch)
from gotennet_tpu_torch.parallel.distributed import (global_mesh,
                                                     initialize_distributed)
from gotennet_tpu_torch.parallel.mesh import Mesh, current_mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "current_mesh", "psum", "pmean", "pmax",
           "pspec_for_layout", "shard_graph_batch", "pmean_grads",
           "make_parallel_train_step", "initialize_distributed",
           "global_mesh"]
