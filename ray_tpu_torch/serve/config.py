"""Serve configuration (the port of ray_tpu/serve/config.py): plain
dataclasses, as the JAX package's are (the reference's
python/ray/serve/config.py is pydantic).

Where the port differs: JAX's ``RAY_TPU_SERVE_MAX_QUEUE_DEPTH`` override
of ``max_queued_requests`` is not ported (the deployment's
``max_queued_requests`` sets the queue bound), and the gRPC ingress is not ported: the card machine
has no ``grpc`` package, so ``HTTPOptions(grpc_port=<int>)`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

GRPC_NOT_PORTED = ("the gRPC ingress is not ported (ROADMAP Queue 1 item "
                   "3): the port's machines have no grpc package")


@dataclass
class AutoscalingConfig:
    """Queue-length-driven autoscaling — reference
    python/ray/serve/config.py AutoscalingConfig + autoscaling_policy.py.
    Target replicas = ceil(total ongoing requests / target_ongoing_requests),
    clamped to [min_replicas, max_replicas], smoothed by upscale/downscale
    delays."""
    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 60.0
    metrics_interval_s: float = 0.5

    def validate(self) -> None:
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                f"invalid autoscaling bounds [{self.min_replicas}, "
                f"{self.max_replicas}]")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")


@dataclass
class DeploymentConfig:
    """Per-deployment config — reference serve/config.py DeploymentConfig."""
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    # admission control (router load shedding): each replica may hold
    # at most max_ongoing + max_queued_requests in-flight through a
    # handle; past that the router rejects with RequestShedError +
    # retry_after instead of queueing unboundedly. -1 disables (the
    # pre-admission behavior).
    max_queued_requests: int = -1
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> None:
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_ongoing_requests < 1:
            raise ValueError("max_ongoing_requests must be >= 1")
        if self.max_queued_requests < -1:
            raise ValueError("max_queued_requests must be >= -1 "
                             "(-1 disables admission control)")
        if self.autoscaling_config is not None:
            self.autoscaling_config.validate()


@dataclass
class HTTPOptions:
    """Proxy options — reference python/ray/serve/config.py HTTPOptions.
    ``grpc_port`` must stay None: the gRPC ingress is not ported."""
    host: str = "127.0.0.1"
    port: int = 8000
    grpc_port: Optional[int] = None
    # "EveryNode" runs a proxy replica on each cluster node (reference
    # ProxyLocation.EveryNode, proxy_state.py); "HeadOnly" restricts to
    # the head. Non-head proxies bind ephemeral ports; discover them via
    # serve.status()["proxies"].
    proxy_location: str = "EveryNode"

    def __post_init__(self) -> None:
        if self.grpc_port is not None:
            raise NotImplementedError(GRPC_NOT_PORTED)
