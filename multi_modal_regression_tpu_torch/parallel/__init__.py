"""Data and tensor parallelism over torch.distributed (port of the JAX
package's parallel/).

  multihost  initialize (init_process_group from arguments or torchrun's
             variables), host_info, global_batch_from_local
  mesh       Mesh, make_mesh, shard_batch; the data group's collectives:
             global BN sums, gradient and metric means, broadcasts, gathers
  tp         make_2d_mesh, shard_state (head banks split over 'model'),
             the f / g ops, checkpoints gathered and re-sliced
"""

from multi_modal_regression_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from multi_modal_regression_tpu_torch.parallel.tp import (
    HEAD_BANK_NAMES,
    make_2d_mesh,
    shard_state,
)

__all__ = ["HEAD_BANK_NAMES", "Mesh", "make_2d_mesh", "make_mesh", "shard_batch",
           "shard_state"]
