"""Config dataclasses (port of ray_tpu/train/config.py): ScalingConfig,
RunConfig, CheckpointConfig and FailureConfig as in Ray's air/config.py,
plus ShardingConfig, the named mesh axes.

Fields named for JAX or the TPU take the port's names, with the same
defaults: `ScalingConfig.use_tpu` is `use_gpu`, and
`ScalingConfig.setup_jax_distributed` is `setup_torch_distributed`
(the process-group rendezvous of `parallel.distributed`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    """num_workers + resources: worker processes for host-side work; the
    cards belong to the mesh."""

    num_workers: int = 1
    # mode="workers": each rank's bundle leases one GPU unless
    # resources_per_worker names its own count; False gives CPU ranks
    use_gpu: bool = True
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    # mode="workers": rendezvous the gang into one torch.distributed
    # process group before train_fn runs (waits for the actor runtime)
    setup_torch_distributed: bool = True
    # mode="workers" across slices: workers get slice ids contiguously
    num_slices: int = 1
    # elastic floor: a restart with less capacity re-forms the gang at
    # the largest feasible size >= this; None = never shrink
    min_workers: Optional[int] = None
    # MPMD pipeline stages, one stage-gang per slice; 1 = single program
    num_stages: int = 1


def assign_worker_slices(num_workers: int, num_slices: int) -> list:
    """Contiguous balanced slice assignment for a worker gang: one slice
    id per rank, or all-None for single-slice gangs."""
    if num_slices <= 1:
        return [None] * num_workers
    if num_workers % num_slices != 0:
        raise ValueError(
            f"num_workers={num_workers} not divisible by "
            f"num_slices={num_slices}")
    return [i * num_slices // num_workers for i in range(num_workers)]


@dataclass
class ShardingConfig:
    """Named mesh axis sizes (-1 fills the remaining ranks); maps 1:1 onto
    `parallel.mesh.MeshConfig`, or `parallel.multislice.HybridMeshConfig`
    when a dcn_* axis is set."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1
    remat: bool = False  # checkpoint the model forward
    dcn_dp: int = 1
    dcn_fsdp: int = 1
    dcn_pp: int = 1

    @property
    def is_hybrid(self) -> bool:
        return any(v != 1 for v in (self.dcn_dp, self.dcn_fsdp,
                                    self.dcn_pp))

    def mesh_config(self):
        if self.is_hybrid:
            from ..parallel.multislice import HybridMeshConfig

            return HybridMeshConfig(
                dp=self.dp, fsdp=self.fsdp, pp=self.pp, sp=self.sp,
                ep=self.ep, tp=self.tp, dcn_dp=self.dcn_dp,
                dcn_fsdp=self.dcn_fsdp, dcn_pp=self.dcn_pp)
        from ..parallel.mesh import MeshConfig

        return MeshConfig(dp=self.dp, fsdp=self.fsdp, pp=self.pp,
                          sp=self.sp, ep=self.ep, tp=self.tp)

    def build_mesh(self, ranks=None, device="cuda"):
        """A DeviceMesh over `ranks` (default: every rank of the default
        process group): hybrid when a dcn_* axis is set, flat otherwise."""
        return self.mesh_config().build(ranks, device=device)


@dataclass
class CheckpointConfig:
    """Keep the top `num_to_keep` checkpoints by a metric (by recency
    without one)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class FailureConfig:
    """Restarts after a failed attempt; -1 means unbounded."""

    max_failures: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    verbose: int = 1

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
        return os.path.join(base, self.name or "experiment")
