"""Data parallelism and vertex sharding over ``torch.distributed``, and
the member mesh of ensembles and sweeps (counterpart of the JAX
package's ``parallel/``)."""

from .mesh import (DATA_AXIS, MEMBER_AXIS, Mesh, make_data_mesh,
                   make_member_mesh, replicate, replicate_model, shard_batch,
                   shard_member_axis)
from .multihost import (MultihostBatchIterator, global_batch_from_local,
                        initialize_multihost, local_batch_slice)
from .train_parallel import (make_parallel_eval_step,
                             make_parallel_train_step,
                             make_scanned_parallel_epochs,
                             make_scanned_parallel_step)

__all__ = ["DATA_AXIS", "MEMBER_AXIS", "Mesh", "make_data_mesh",
           "make_member_mesh", "shard_member_axis", "shard_batch",
           "replicate", "replicate_model", "make_parallel_train_step",
           "make_parallel_eval_step", "make_scanned_parallel_step",
           "make_scanned_parallel_epochs", "initialize_multihost",
           "local_batch_slice", "global_batch_from_local",
           "MultihostBatchIterator"]
