"""The declarative serve path of the port (serve/schema.py's
`ServeDeploySchema`, `deploy_config`, `get_deployed_config`, and the
CLI's `serve` commands) against the JAX package's, on the CPU.

Twins of the 5 cases of tests/test_serve_yaml.py. Schema validation runs
here on both packages; the four cluster cases are functions of
`_private/deploy_checks.py` run with a cluster of their own
(`isolated.run_checks`). Their ``import_path`` is
``ray_tpu_torch._private.deploy_checks:app`` (``:build``), a module of
the package, as the JAX twins name ``tests/serve_yaml_app.py``.

Parity: `ServeDeploySchema.from_dict` errors against JAX's on seeded
random configurations; `yaml` is imported by the port only inside
`from_yaml_file`.
"""
from __future__ import annotations

import random

import pytest

from ray_tpu.serve import schema as jschema
from ray_tpu_torch._private import isolated
from ray_tpu_torch.serve import schema as tschema

CLUSTER = {"num_cpus": 8}
CHECKS = {name: CLUSTER for name in (
    "yaml_deploy_and_hot_update",
    "yaml_builder_function_with_args",
    "yaml_override_unknown_deployment_fails",
    "yaml_cli_serve_deploy_and_status")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_yaml_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def _config(num_replicas: int) -> dict:
    return {"applications": [{
        "name": "yamlapp", "route_prefix": "/yaml",
        "import_path": "ray_tpu_torch._private.deploy_checks:app",
        "deployments": [{"name": "Doubler",
                         "num_replicas": num_replicas}]}]}


@pytest.mark.parametrize("mod", [tschema, jschema], ids=["port", "jax"])
def test_schema_validation(mod):
    S = mod.ServeDeploySchema
    with pytest.raises(ValueError, match="no applications"):
        S.from_dict({})
    with pytest.raises(ValueError, match="import_path"):
        S.from_dict({"applications": [{"name": "x"}]})
    with pytest.raises(ValueError, match="unknown field"):
        S.from_dict({"applications": [
            {"import_path": "m:a", "replicas": 3}]})
    with pytest.raises(ValueError, match="duplicate"):
        S.from_dict({"applications": [
            {"import_path": "m:a", "name": "x"},
            {"import_path": "m:b", "name": "x"}]})
    s = S.from_dict(_config(2))
    assert s.applications[0].deployments[0].num_replicas == 2


def _random_config(rng: random.Random):
    """A config with a random mix of valid and invalid parts."""
    def maybe(d, key, value, p=0.5):
        if rng.random() < p:
            d[key] = value

    cfg: dict = {}
    apps = []
    for i in range(rng.randint(0, 3)):
        app: dict = {}
        maybe(app, "import_path", rng.choice(["m:a", "", "mod:b.c"]), 0.8)
        maybe(app, "name", rng.choice(["a", "b", f"n{i}"]))
        maybe(app, "route_prefix", rng.choice(["/", "/x"]))
        maybe(app, "args", {"bias": rng.randint(0, 3)}, 0.2)
        maybe(app, "replicas", 3, 0.1)
        deps = []
        for _ in range(rng.randint(0, 2)):
            d: dict = {}
            maybe(d, "name", rng.choice(["D", "", "E"]), 0.8)
            maybe(d, "num_replicas", rng.randint(0, 3))
            maybe(d, "max_ongoing_requests", rng.randint(1, 4), 0.3)
            maybe(d, "bogus", 1, 0.1)
            deps.append(d)
        maybe(app, "deployments", deps, 0.6)
        apps.append(app)
    maybe(cfg, "applications", apps, 0.9)
    maybe(cfg, "http_options", rng.choice([
        {"host": "0.0.0.0"}, {"port": 9000, "proxy_location": "HeadOnly"},
        {"nope": 1}]), 0.3)
    maybe(cfg, "extra", True, 0.1)
    return cfg


def _outcome(mod, cfg):
    try:
        return ("ok", mod.ServeDeploySchema.from_dict(cfg).to_dict())
    except Exception as e:  # noqa: BLE001 — the error is the result
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(3))
def test_from_dict_matches_jax(seed):
    rng = random.Random(seed)
    for _ in range(300):
        cfg = _random_config(rng)
        assert _outcome(tschema, cfg) == _outcome(jschema, cfg), cfg


def test_yaml_is_imported_only_by_from_yaml_file():
    import inspect

    src = inspect.getsource(tschema)
    lines = [ln.strip() for ln in src.splitlines()
             if ln.strip() in ("import yaml", "from yaml import")]
    assert lines == ["import yaml"]
    fn = inspect.getsource(tschema.ServeDeploySchema.from_yaml_file)
    assert "import yaml" in fn
