"""ray_tpu_torch.online: the online learning loop (port of
ray_tpu/online).

- Samplers (:class:`RolloutSampler` / :func:`spawn_samplers`): actor
  processes, each a ``ContinuousBatchingEngine`` behind a ``WeightSync``,
  so weights hot-swap between decode ticks. Rollouts carry the prompt,
  the completion, per-token logprobs and the weights version.
- The rollout buffer (:class:`RolloutBuffer` / :func:`from_rollouts`): a
  bounded actor between samplers and learner; a full buffer rejects puts
  (backpressure), and ``from_rollouts()`` hands the learner a
  streaming-split dataset with background prefetch.
- The learner (:class:`OnlineTrainer`): `train.TorchTrainer` in the
  driver, training an online-distillation objective on the rollouts and
  delta-publishing weights every K steps through ``train.report``.
- :class:`TenantLoraTrainer`: adapter-only training per tenant,
  published under ``lora/<tenant>`` for the serving pools.

Sampler staleness stays <= 1 version while the learner steps. Surfaces:
``util.state.online_status()`` and the timeline's ``online`` lane.
"""
from .buffer import RolloutBuffer, RolloutStream, from_rollouts  # noqa: F401
from .loop import OnlineConfig, OnlineResult, OnlineTrainer  # noqa: F401
from .lora import TenantLoraTrainer  # noqa: F401
from .sampler import RolloutSampler, spawn_samplers  # noqa: F401

__all__ = ["OnlineConfig", "OnlineResult", "OnlineTrainer",
           "RolloutBuffer", "RolloutSampler", "RolloutStream",
           "TenantLoraTrainer", "from_rollouts", "spawn_samplers"]
