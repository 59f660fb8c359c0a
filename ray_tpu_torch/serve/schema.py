"""Declarative Serve application schema + YAML deploy path (the port of
ray_tpu/serve/schema.py).

Analog of the reference's python/ray/serve/schema.py (ServeDeploySchema /
ServeApplicationSchema / DeploymentSchema, pydantic there — plain
dataclasses with strict key validation here) and the config-file half of
serve/scripts.py `serve run|deploy` (:147-746).

A config file looks like:

    http_options:
      host: 127.0.0.1
      port: 8000
    applications:
      - name: default
        route_prefix: /
        import_path: my_module:app        # module:attr -> Application
        deployments:                       # optional per-name overrides
          - name: Model
            num_replicas: 3
            max_ongoing_requests: 16
            autoscaling_config:
              min_replicas: 1
              max_replicas: 8

`deploy_config(schema)` imports each application, applies the overrides,
deploys through the controller, and records the config in the cluster KV
so `serve config` can echo it back from any process.

`yaml` is imported only inside `ServeDeploySchema.from_yaml_file`: the
rest of serve runs where no yaml is installed.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .config import AutoscalingConfig, HTTPOptions

_KV_CONFIG_KEY = b"serve:deploy_config"


def _check_keys(data: Dict[str, Any], cls, where: str) -> None:
    allowed = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - allowed
    if unknown:
        raise ValueError(
            f"unknown field(s) {sorted(unknown)} in {where}; "
            f"allowed: {sorted(allowed)}")


@dataclass
class DeploymentSchema:
    """Per-deployment override block — reference schema.py
    DeploymentSchema. Unset fields (None) leave the code-side value."""
    name: str = ""
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    user_config: Optional[Any] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    health_check_period_s: Optional[float] = None
    health_check_timeout_s: Optional[float] = None
    graceful_shutdown_timeout_s: Optional[float] = None
    ray_actor_options: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DeploymentSchema":
        _check_keys(data, cls, f"deployment {data.get('name', '?')!r}")
        if not data.get("name"):
            raise ValueError("every deployment override needs a 'name'")
        return cls(**data)

    def to_options(self) -> Dict[str, Any]:
        opts = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name != "name" and getattr(self, f.name) is not None}
        if "autoscaling_config" in opts:
            _check_keys(opts["autoscaling_config"], AutoscalingConfig,
                        f"autoscaling_config of {self.name!r}")
        return opts


@dataclass
class ServeApplicationSchema:
    """One application — reference schema.py ServeApplicationSchema."""
    import_path: str = ""
    name: str = "default"
    route_prefix: str = "/"
    args: Dict[str, Any] = field(default_factory=dict)
    deployments: List[DeploymentSchema] = field(default_factory=list)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ServeApplicationSchema":
        _check_keys(data, cls, f"application {data.get('name', '?')!r}")
        if not data.get("import_path"):
            raise ValueError(
                f"application {data.get('name', '?')!r} needs an "
                "'import_path' of the form 'module:attribute'")
        deployments = [DeploymentSchema.from_dict(d)
                       for d in data.get("deployments", [])]
        return cls(import_path=data["import_path"],
                   name=data.get("name", "default"),
                   route_prefix=data.get("route_prefix", "/"),
                   args=dict(data.get("args", {})),
                   deployments=deployments)

    def to_dict(self) -> Dict[str, Any]:
        return {"import_path": self.import_path, "name": self.name,
                "route_prefix": self.route_prefix, "args": self.args,
                "deployments": [dataclasses.asdict(d)
                                for d in self.deployments]}


@dataclass
class ServeDeploySchema:
    """Top-level config — reference schema.py ServeDeploySchema."""
    applications: List[ServeApplicationSchema] = field(default_factory=list)
    http_options: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ServeDeploySchema":
        _check_keys(data, cls, "serve config")
        apps = [ServeApplicationSchema.from_dict(a)
                for a in data.get("applications", [])]
        if not apps:
            raise ValueError("serve config declares no applications")
        names = [a.name for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate application names: {names}")
        http = dict(data.get("http_options", {}))
        _check_keys(http, HTTPOptions, "http_options")
        return cls(applications=apps, http_options=http)

    @classmethod
    def from_yaml_file(cls, path: str) -> "ServeDeploySchema":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        if not isinstance(data, dict):
            raise ValueError(f"{path} is not a mapping")
        return cls.from_dict(data)

    def to_dict(self) -> Dict[str, Any]:
        return {"applications": [a.to_dict() for a in self.applications],
                "http_options": self.http_options}


def import_attr(import_path: str):
    """'pkg.module:attr' -> the attribute (reference
    ray._private.utils.import_attr)."""
    if ":" not in import_path:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'")
    module_name, _, attr = import_path.partition(":")
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _override_deployments(target, overrides: List[DeploymentSchema]):
    """Apply per-name option overrides to every Deployment reachable from
    the bound application graph. Returns the names actually overridden so
    a typo'd name fails loudly instead of silently deploying defaults."""
    from . import Application, Deployment

    by_name = {o.name: o for o in overrides}
    hit = set()

    def visit(obj):
        if isinstance(obj, Application):
            dep = obj._deployment
            o = by_name.get(dep.name)
            if o is not None and dep.name not in hit:
                hit.add(dep.name)
                newdep = dep.options(**o.to_options())
                dep.config = newdep.config
            for a in obj._args:
                visit(a)
            for v in obj._kwargs.values():
                visit(v)
        elif isinstance(obj, (list, tuple)):
            for x in obj:
                visit(x)
        elif isinstance(obj, dict):
            for v in obj.values():
                visit(v)

    if isinstance(target, Deployment):
        target = target.bind()
    visit(target)
    missing = set(by_name) - hit
    if missing:
        raise ValueError(
            f"deployment override(s) {sorted(missing)} match no deployment "
            "in the application graph")
    return target


def deploy_config(schema: ServeDeploySchema) -> List[str]:
    """Build and deploy every application in the schema; returns the
    deployed app names. Idempotent: re-deploying an existing app replaces
    it (the controller drains the old replicas) — the declarative
    update path of reference `serve deploy`."""
    from . import run, start
    from .config import HTTPOptions as HTTP

    start(HTTP(**schema.http_options) if schema.http_options else None)
    deployed = []
    for app in schema.applications:
        from . import Application, Deployment

        target = import_attr(app.import_path)
        if isinstance(target, Deployment):
            target = target.bind(**app.args) if app.args else target.bind()
        elif isinstance(target, Application):
            if app.args:
                raise ValueError(
                    f"application {app.name!r}: 'args' requires the "
                    "import_path to point at a Deployment or a builder "
                    "function, not an already-bound Application")
        elif callable(target):
            # app builder: def build(args: dict) -> Application
            # (reference: serve.run's builder-function import path)
            target = target(app.args)
        else:
            raise TypeError(
                f"{app.import_path} resolved to {type(target).__name__}; "
                "expected Deployment, Application, or builder function")
        target = _override_deployments(target, app.deployments)
        run(target, name=app.name, route_prefix=app.route_prefix)
        deployed.append(app.name)
    _record_config(schema)
    return deployed


def _record_config(schema: ServeDeploySchema) -> None:
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        return
    try:
        w.conductor.call(
            "kv_put", _KV_CONFIG_KEY,
            json.dumps(schema.to_dict()).encode(), True, "serve",
            timeout=10.0)
    except Exception:  # noqa: BLE001 — config echo is best-effort
        pass


def get_deployed_config() -> Optional[Dict[str, Any]]:
    """The last schema deployed through deploy_config, from cluster KV —
    reference `serve config` (scripts.py:543)."""
    from .._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        return None
    raw = w.conductor.call("kv_get", _KV_CONFIG_KEY, "serve", timeout=10.0)
    return json.loads(raw.decode()) if raw else None
