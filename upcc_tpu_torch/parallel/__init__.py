"""Multi-device paths of the port over ``torch.distributed`` and worker
threads: multi-process set-up (``multihost``), data-parallel training
(``data_parallel``), 2-D data x model training (``model_parallel``),
block-parallel inference (``block_parallel``) and a CPU dry run of the
data-parallel step (``dryrun``).

``DataParallelStep`` stands for the JAX package's ``make_dp_train_step`` and
``shard_batch``; ``ShardedTrainStep`` and ``sharded`` for
``make_sharded_train_step``, ``shard_inputs`` and ``shard_state``.
"""

from .data_parallel import make_mesh, DataParallelStep
from .block_parallel import parallel_map_blocks, shard_points_by_block
from .model_parallel import make_mesh_2d, ShardedTrainStep, sharded
