"""Data parallelism and vertex sharding over ``torch.distributed``
(counterpart of the JAX package's ``parallel/``, less the member half,
which comes with the ensembles)."""

from .mesh import (DATA_AXIS, Mesh, make_data_mesh, replicate,
                   replicate_model, shard_batch)
from .multihost import (MultihostBatchIterator, global_batch_from_local,
                        initialize_multihost, local_batch_slice)
from .train_parallel import (make_parallel_eval_step,
                             make_parallel_train_step,
                             make_scanned_parallel_epochs,
                             make_scanned_parallel_step)

__all__ = ["DATA_AXIS", "Mesh", "make_data_mesh", "shard_batch",
           "replicate", "replicate_model", "make_parallel_train_step",
           "make_parallel_eval_step", "make_scanned_parallel_step",
           "make_scanned_parallel_epochs", "initialize_multihost",
           "local_batch_slice", "global_batch_from_local",
           "MultihostBatchIterator"]
