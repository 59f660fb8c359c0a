"""ray_tpu_torch.mpmd: multi-program (MPMD) pipeline parallelism across
slices (port of ray_tpu/mpmd/).

Each stage runs as its OWN program on its own stage-gang (arXiv
2412.14374): the :class:`PipelineConductor` forms one stage-gang per
slice through the conductor's pipeline registry, every stage runs its
own forward and backward independently, and microbatch activations and
gradients stream point-to-point between adjacent stages over the object
plane's chunked transfer (``util.chunks``, the weight fabric's
no-gather path). ``schedule`` drives the ticks: 1F1B (warm-up, steady
1F/1B alternation, cool-down) by default, GPipe fill-drain as the
fallback.

Stages may be heterogeneous: one may run on the CPU and the next on the
card (``device=["cpu", "cuda"]``).

Surfaces: ``util.state.pipeline_status()``, per-stage ``bubble_wait`` in
the step records (``util.state.train_progress()``), the stages' metric
snapshots (``ray_tpu_pipeline_bubble_fraction`` /
``ray_tpu_pipeline_activations_bytes_total``) in the registry's stats,
and a ``pipeline`` lane of instant markers in the merged timeline.
"""
from .channels import ActivationChannel, ChannelStats  # noqa: F401
from .conductor import PipelineConductor  # noqa: F401
from .schedule import (  # noqa: F401
    SCHEDULES,
    Tick,
    bubble_fraction,
    gpipe_schedule,
    one_f_one_b_schedule,
    stage_schedule,
)
from .trainer import PipelineTrainer  # noqa: F401
