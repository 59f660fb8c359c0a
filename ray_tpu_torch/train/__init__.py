"""ray_tpu_torch.train: training on the card (port of ray_tpu/train).

`TrainStep` + `optim.adamw` take a step; `TorchTrainer` (JaxTrainer's
counterpart, its in-process `spmd` mode) runs a `train_fn` under a
session (`report`, `get_checkpoint`, `get_dataset_shard`) with
checkpoint retention and restarts; `async_save` / `restore` write and
reshard checkpoints in the JAX package's format.
"""
from .config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    ShardingConfig,
)
from .checkpoint import Checkpoint, CheckpointManager  # noqa: F401
from .async_checkpoint import (  # noqa: F401
    AsyncCheckpoint,
    AsyncCheckpointer,
    async_save,
    restore,
)
from .session import (  # noqa: F401
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_step_timer,
    preemption_requested,
    report,
)
from .trainer import Result, TorchTrainer, TrainStep  # noqa: F401
