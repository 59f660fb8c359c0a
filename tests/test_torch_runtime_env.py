"""Twins of tests/test_runtime_env_shims.py, test_runtime_env_pip.py and
test_runtime_env_conda_uv.py for the port (ray_tpu_torch): env_vars,
working_dir, py_modules, pip and uv venvs from local artifacts, conda
activation, the plugin protocol, the multiprocessing Pool and joblib
shims; and where the port differs: CUDA_VISIBLE_DEVICES refused in
env_vars, a job's whole runtime_env, a venv that keeps the worker's
torch.

The cluster cases run in a driver process of their own
(`ray_tpu_torch._private.isolated.run_checks`): they are functions of
`ray_tpu_torch/_private/surface_checks.py`, each a case here, and
`__session_ended__` holds that every process of the run had exited.
Validation and conda resolution are pure and run here, beside parity
cases that hand the same specs and the same directory to both
packages.
"""
from __future__ import annotations

import os
import random

import pytest

from ray_tpu import exceptions as jexc
from ray_tpu._private import runtime_env as jrenv
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch._private import isolated
from ray_tpu_torch._private import runtime_env as trenv
from ray_tpu_torch._private import surface_checks as sc

C4 = {"num_cpus": 4}
C2 = {"num_cpus": 2}
CHECKS = {
    # test_runtime_env_shims.py (its module fixture: 4 CPUs)
    "renv_env_vars_applied_and_restored": C4,
    "renv_working_dir_staged": C4, "renv_py_modules": C4,
    "renv_actor_runtime_env_permanent": C4,
    "renv_unsupported_keys_rejected": C4,
    "pool_map": C4, "pool_apply_and_async": C4, "pool_imap_orders": C4,
    "pool_starmap_and_errors": C4, "joblib_backend": C4,
    # test_runtime_env_pip.py (2 CPUs)
    "pip_wheel_env": C2, "pip_env_cached_across_tasks": C2,
    "pip_actor_env": C2, "pip_custom_plugin": None,
    # test_runtime_env_conda_uv.py
    "uv_env_installs_local_package": None,
    "conda_env_activates_in_task": None,
    # the port's own
    "port_renv_cuda_visible_devices_refused": C4,
    "port_job_whole_runtime_env": C4,
    "port_pip_env_keeps_the_workers_torch": C2,
}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=400.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_runtime_env(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


# ------------------------------------------------- pure twins (no cluster)

def test_conda_still_rejected():
    with pytest.raises(ValueError, match="conda"):
        trenv.validate({"conda": {"deps": ["x"]}})


def test_unknown_key_rejected():
    with pytest.raises(ValueError, match="unknown runtime_env key"):
        trenv.validate({"no_such_key": 1})


def test_validate_uv_and_conda_accepted(tmp_path):
    pkg = sc.make_pkg(str(tmp_path), "uvpkg", 1)
    out = trenv.validate({"uv": [pkg]})
    assert out["uv"] == [pkg]
    assert trenv.validate({"conda": "myenv"})["conda"] == "myenv"
    assert trenv.validate({"conda": {"prefix": "/x"}})
    with pytest.raises(ValueError, match="OR"):
        trenv.validate({"pip": [pkg], "uv": [pkg]})
    with pytest.raises(ValueError, match="dependencies"):
        trenv.validate({"conda": {"dependencies": ["numpy"]}})
    with pytest.raises(ValueError, match="container"):
        trenv.validate({"container": {"image": "x"}})
    with pytest.raises(ValueError, match="not"):
        trenv.validate({"uv": ["requests==2.0"]})  # network spec rejected


def test_resolve_conda_prefix_by_path_and_name(tmp_path, monkeypatch):
    prefix = sc.make_fake_conda_env(str(tmp_path), "env_a")
    assert trenv.resolve_conda_prefix(prefix) == prefix
    monkeypatch.setenv("CONDA_ENVS_PATH", str(tmp_path))
    assert trenv.resolve_conda_prefix("env_a") == prefix
    assert trenv.resolve_conda_prefix({"name": "env_a"}) == prefix
    with pytest.raises(texc.RuntimeEnvSetupError, match="not found"):
        trenv.resolve_conda_prefix("no_such_env")
    with pytest.raises(texc.RuntimeEnvSetupError, match="bin/python"):
        trenv.resolve_conda_prefix(str(tmp_path))  # dir but not an env


def test_cuda_visible_devices_refused_in_env_vars():
    """A known difference: the JAX package accepts the variable."""
    spec = {"env_vars": {"CUDA_VISIBLE_DEVICES": "0"}}
    assert jrenv.validate(spec) == spec
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
        trenv.validate(spec)


def test_merge_puts_a_task_over_its_job():
    job = {"env_vars": {"A": "job", "B": "job"}, "working_dir": "/j",
           "py_modules": ["/m"]}
    task = {"env_vars": {"B": "task"}, "working_dir": "/t"}
    assert trenv.merge(job, task) == {
        "env_vars": {"A": "job", "B": "task"}, "working_dir": "/t",
        "py_modules": ["/m"]}
    assert trenv.merge({}, task) == task and trenv.merge(job, None) == job


# ------------------------------------------------------------ parity

def _random_spec(rng: random.Random, files: list) -> dict:
    """A runtime_env drawn from keys and values that validate() accepts
    and refuses (never CUDA_VISIBLE_DEVICES: a known difference)."""
    keys = ["env_vars", "working_dir", "py_modules", "pip", "uv", "conda",
            "config", "container", "image_uri", "bogus_key"]
    spec = {}
    for key in rng.sample(keys, rng.randint(0, 3)):
        if key == "env_vars":
            spec[key] = {f"V{i}": rng.choice(["x", "1", 2, None])
                         for i in range(rng.randint(0, 3))}
        elif key in ("pip", "uv"):
            spec[key] = rng.choice([
                [rng.choice(files)], [rng.choice(files), "requests==2.0"],
                "requests", [3], []])
        elif key == "conda":
            spec[key] = rng.choice([
                "myenv", {"prefix": "/x"}, {"name": "e"}, {},
                {"dependencies": ["numpy"]}, {"channels": ["c"]}, 7])
        else:
            spec[key] = rng.choice(["/tmp", ["/tmp"], {"image": "x"}, 1])
    return spec


def _outcome(validate, spec):
    try:
        return ("ok", validate(dict(spec)))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e).split(":")[0].split(";")[0])


@pytest.mark.parametrize("seed", range(8))
def test_validate_matches_jax(seed, tmp_path):
    files = []
    for i in range(2):
        p = tmp_path / f"art{i}.whl"
        p.write_bytes(b"x")
        files.append(str(p))
    files.append(str(tmp_path))  # a directory is a local spec too
    rng = random.Random(seed)
    for _ in range(40):
        spec = _random_spec(rng, files)
        assert _outcome(trenv.validate, spec) == \
            _outcome(jrenv.validate, spec), spec


class _DictKV:
    """The conductor's kv_get / kv_put over a dict."""

    def __init__(self):
        self.kv = {}

    def call(self, method, key, *args, timeout=None):
        if method == "kv_get":
            return self.kv.get((args[0], key))
        assert method == "kv_put"
        value, overwrite, ns = args
        self.kv[(ns, key)] = value
        return True


def test_package_dir_digest_matches_jax(tmp_path):
    rng = random.Random(5)
    for i in range(6):
        sub = tmp_path / "pkg" / f"d{i % 3}"
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"f{i}.py").write_bytes(rng.randbytes(200 + 97 * i))
    (tmp_path / "pkg" / "__pycache__").mkdir()
    (tmp_path / "pkg" / "__pycache__" / "x.pyc").write_bytes(b"skip")
    t, j = _DictKV(), _DictKV()
    uri = trenv.package_dir(t, str(tmp_path / "pkg"))
    assert uri == jrenv.package_dir(j, str(tmp_path / "pkg"))
    assert uri.startswith("kv://") and uri.endswith(".zip")
    assert list(t.kv.values()) == list(j.kv.values())
    wheel = sc.make_wheel(str(tmp_path))
    assert trenv.package_file(t, wheel) == jrenv.package_file(j, wheel)


def test_runtime_env_setup_error_matches_jax():
    assert texc.RuntimeEnvSetupError.__name__ == \
        jexc.RuntimeEnvSetupError.__name__
    assert issubclass(texc.RuntimeEnvSetupError, texc.RayTpuError)
    assert os.path.join("ray_tpu_torch", "runtime_env") in \
        trenv._cache_root()
