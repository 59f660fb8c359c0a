"""ray_tpu_torch.serve — the model-serving library (the port of
ray_tpu/serve/__init__.py), analog of the reference's python/ray/serve
(api.py: serve.run :543, @serve.deployment; _private/api.py:208
serve_start; _private/client.py:243 deploy_application).

A singleton ServeController actor reconciles deployment targets into
ReplicaActors and runs an HTTP ProxyActor per node; handles route
requests pow-2 over replica queue lengths. A replica may hold a model on
the card (``ray_actor_options={"num_gpus": 1}``); ``@serve.batch`` keeps
it fed with batched forward passes, ``@serve.multiplexed`` LRU-loads
weight sets.

The serving modules beside the deployments (``autoscale``, ``disagg``,
``gateway``, ``qos``) are re-exported as JAX's file does; ``disagg``'s
names load on first use, so a replica, the controller and the proxy do
not import torch unless their own code does.

Where the port differs: no gRPC ingress (``grpc_address`` and
``grpc_call`` are not exported; ``HTTPOptions(grpc_port=...)`` raises).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Union

import cloudpickle

from .asgi import ingress  # noqa: F401
from .autoscale import (DisaggAutoscaler, DisaggPolicy,  # noqa: F401
                        ScalingPolicy, SlidingWindow, TierSpec)
from .batching import batch  # noqa: F401
from .config import AutoscalingConfig, DeploymentConfig, HTTPOptions  # noqa: F401
from .context import get_request_context  # noqa: F401
from .controller import ServeController
from .gateway import GatewayServer  # noqa: F401
from .handle import (CONTROLLER_NAME, DeploymentHandle,  # noqa: F401
                     DeploymentResponse, RequestShedError)
from .http_util import Request, Response  # noqa: F401
from .multiplex import (get_multiplexed_model_id, multiplexed,  # noqa: F401
                        request_tenant)
from .qos import (BATCH, INTERACTIVE, QosGate,  # noqa: F401
                  TenantPolicy, TokenBucket)
from .replica import HandleMarker

# disaggregated serving builds on the engine (torch): loaded on first use
_LAZY = {"DecodeServer": "disagg", "DisaggRouter": "disagg",
         "PrefillServer": "disagg", "ReplicaDeadError": "disagg"}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


class Application:
    """A deployment bound to init args — reference serve/_private/
    deployment_graph_build.py's DeploymentNode, minus the DAG generality Serve
    dropped upstream too."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs


class Deployment:
    """Created by @serve.deployment — reference python/ray/serve/
    deployment.py."""

    def __init__(self, func_or_class, name: str,
                 config: Optional[DeploymentConfig] = None):
        self._func_or_class = func_or_class
        self.name = name
        self.config = config or DeploymentConfig()

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[Union[int, str]] = None,
                max_ongoing_requests: Optional[int] = None,
                max_queued_requests: Optional[int] = None,
                user_config: Optional[Any] = None,
                autoscaling_config: Optional[Union[dict, AutoscalingConfig]] = None,
                health_check_period_s: Optional[float] = None,
                health_check_timeout_s: Optional[float] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None
                ) -> "Deployment":
        import dataclasses
        cfg = dataclasses.replace(self.config)
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        if num_replicas == "auto":
            autoscaling_config = autoscaling_config or AutoscalingConfig(
                min_replicas=1, max_replicas=8)
            num_replicas = None
        for field, value in [("num_replicas", num_replicas),
                             ("max_ongoing_requests", max_ongoing_requests),
                             ("max_queued_requests", max_queued_requests),
                             ("user_config", user_config),
                             ("autoscaling_config", autoscaling_config),
                             ("health_check_period_s", health_check_period_s),
                             ("health_check_timeout_s", health_check_timeout_s),
                             ("graceful_shutdown_timeout_s",
                              graceful_shutdown_timeout_s),
                             ("ray_actor_options", ray_actor_options)]:
            if value is not None:
                setattr(cfg, field, value)
        return Deployment(self._func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __call__(self, *a, **kw):
        raise TypeError(
            f"deployment {self.name} cannot be called directly; use "
            f".bind() + serve.run(), then handle.remote(...)")


def deployment(_func_or_class=None, *, name: Optional[str] = None, **options):
    """@serve.deployment — reference serve/api.py deployment decorator."""

    def deco(fc):
        d = Deployment(fc, name or fc.__name__)
        if options:
            d = d.options(**options)
        return d

    if _func_or_class is not None:
        return deco(_func_or_class)
    return deco


# -- controller lifecycle ---------------------------------------------------

def _get_controller(create: bool = True, http_options:
                    Optional[HTTPOptions] = None):
    import ray_tpu_torch as rt
    if not rt.is_initialized():
        rt.init(ignore_reinit_error=True)
    try:
        return rt.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001 — not started yet
        if not create:
            raise RuntimeError("Serve is not running on this cluster")
    http_options = http_options or HTTPOptions()
    ctrl = rt.remote(ServeController).options(
        name=CONTROLLER_NAME, max_concurrency=64).remote(
            http_options.host, http_options.port, http_options.grpc_port,
            http_options.proxy_location)
    return ctrl


def start(http_options: Optional[HTTPOptions] = None,
          **http_kwargs) -> None:
    """Start the Serve control plane — reference serve/_private/api.py:208."""
    if http_options is None and http_kwargs:
        http_options = HTTPOptions(**http_kwargs)
    _get_controller(create=True, http_options=http_options)


def _build_app_config(target: Union[Application, Deployment], name: str,
                      route_prefix: str) -> Dict[str, Any]:
    if isinstance(target, Deployment):
        target = target.bind()
    seen: Dict[str, Dict[str, Any]] = {}

    def visit(app: Application) -> str:
        dep = app._deployment

        def swap(obj):
            if isinstance(obj, Application):
                return HandleMarker(visit(obj))
            if isinstance(obj, (list, tuple)):
                return type(obj)(swap(x) for x in obj)
            if isinstance(obj, dict):
                return {k: swap(v) for k, v in obj.items()}
            return obj

        args = tuple(swap(a) for a in app._args)
        kwargs = {k: swap(v) for k, v in app._kwargs.items()}
        if dep.name not in seen:
            seen[dep.name] = {
                "name": dep.name,
                "serialized_callable": cloudpickle.dumps(dep._func_or_class),
                "init_args": cloudpickle.dumps((args, kwargs)),
                "config": dep.config,
            }
        return dep.name

    ingress = visit(target)
    return {"name": name, "route_prefix": route_prefix, "ingress": ingress,
            "deployments": list(seen.values())}


def run(target: Union[Application, Deployment], *, name: str = "default",
        route_prefix: str = "/", blocking_timeout_s: float = 120.0,
        _blocking: bool = True) -> DeploymentHandle:
    """Deploy an application and wait for it to be RUNNING — reference
    serve/api.py:543."""
    import ray_tpu_torch as rt
    ctrl = _get_controller(create=True)
    cfg = _build_app_config(target, name, route_prefix)
    rt.get(ctrl.deploy_application.remote(cfg), timeout=60.0)
    if _blocking:
        deadline = time.monotonic() + blocking_timeout_s
        while time.monotonic() < deadline:
            st = rt.get(ctrl.get_serve_status.remote(), timeout=30.0)
            app = st["applications"].get(name)
            if app is not None and app["status"] == "RUNNING":
                break
            time.sleep(0.1)
        else:
            raise TimeoutError(
                f"application '{name}' did not become RUNNING within "
                f"{blocking_timeout_s}s")
    return DeploymentHandle(cfg["ingress"], name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    import ray_tpu_torch as rt
    ctrl = _get_controller(create=False)
    st = rt.get(ctrl.get_serve_status.remote(), timeout=30.0)
    app = st["applications"].get(name)
    if app is None:
        raise ValueError(f"no application named '{name}'")
    return DeploymentHandle(app["ingress"], name)


def get_deployment_handle(deployment_name: str, app_name: str = "default"
                          ) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def status() -> Dict[str, Any]:
    import ray_tpu_torch as rt
    ctrl = _get_controller(create=False)
    return rt.get(ctrl.get_serve_status.remote(), timeout=30.0)


def proxy_address() -> Optional[tuple]:
    import ray_tpu_torch as rt
    ctrl = _get_controller(create=False)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        addr = rt.get(ctrl.get_proxy_address.remote(), timeout=30.0)
        if addr is not None:
            return tuple(addr)
        time.sleep(0.1)
    return None


def delete(name: str) -> None:
    import ray_tpu_torch as rt
    from .handle import _drop_routers
    ctrl = _get_controller(create=False)
    rt.get(ctrl.delete_application.remote(name), timeout=60.0)
    _drop_routers(name)


def shutdown() -> None:
    """Tear down all of Serve — reference serve/api.py serve.shutdown."""
    import ray_tpu_torch as rt
    from .handle import _drop_routers
    _drop_routers()
    try:
        ctrl = _get_controller(create=False)
    except RuntimeError:
        return
    try:
        rt.get(ctrl.graceful_shutdown.remote(), timeout=30.0)
    except Exception:  # noqa: BLE001 — force-kill below
        pass
    try:
        rt.kill(ctrl)
    except Exception:  # noqa: BLE001
        pass
