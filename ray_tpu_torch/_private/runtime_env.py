"""Runtime environments (the port's copy of the JAX package's
runtime_env.py) — analog of the reference's
python/ray/_private/runtime_env/ (working_dir/py_modules packaging.py: zip
to GCS KV, URI-cached per node; env_vars; pip plugin pip.py; the plugin
protocol plugin.py) + the runtime-env agent flow
(agent/runtime_env_agent.py:161).

Built-in keys: env_vars, working_dir, py_modules, pip, uv, conda.
Directories are zipped, content-addressed, staged through the conductor
KV (the GCS-KV analog), and extracted once per worker into a hash-keyed
cache. `pip`/`uv` create a content-keyed venv (--system-site-packages,
--no-index: this runtime installs LOCAL wheels/dirs at env-setup time,
never from the network — images are baked; `uv` uses the uv
installer when the binary exists, reference runtime_env/uv.py, and
falls back to pip otherwise). `conda` ACTIVATES an existing local env
by prefix or name (reference runtime_env/conda.py minus env creation —
same zero-egress stance). container/image_uri stay rejected: workers
come from a pre-started process pool on baked images, there is no
container runtime to launch them in. Third-party keys hook in via
register_plugin (reference plugin.py RuntimeEnvPlugin).

Where the port differs: the cache lives under
`$TMPDIR/ray_tpu_torch/runtime_env` (the two packages never share a
venv); worker-side plugin classes come from RTT_RUNTIME_ENV_PLUGINS;
`env_vars` may not set CUDA_VISIBLE_DEVICES (a GPU reaches a worker only
through its lease). A pip/uv venv is made from `sys.executable` with
--system-site-packages, and the worker puts only the venv's own
site-packages on its `sys.path`: the torch it already imported stays
the one it uses, whatever the venv's base interpreter holds."""
from __future__ import annotations

import contextlib
import hashlib
import io
import os
import shutil as _shutil
import subprocess
import sys
import tempfile
import zipfile
from typing import Any, Dict, List, Optional

_KV_NS = "runtime_env"
_MAX_PACKAGE_BYTES = 256 * 1024 * 1024
_UNSUPPORTED = ("container", "image_uri")
_BUILTIN = ("env_vars", "working_dir", "py_modules", "pip", "uv", "conda",
            "config")
# worker processes find plugin classes here ("module:Class,...")
ENV_PLUGINS = "RTT_RUNTIME_ENV_PLUGINS"
# a job's whole runtime_env (JSON), set by the head for the job's driver
ENV_JOB = "RTT_JOB_RUNTIME_ENV"


class RuntimeEnvPlugin:
    """Extension point for custom runtime_env keys (reference
    python/ray/_private/runtime_env/plugin.py). Subclass, set `name`,
    and register_plugin() an instance; `validate` runs driver-side at
    submission, `apply` runs worker-side around execution and may mutate
    os.environ / sys.path (restored for non-permanent task envs by the
    surrounding context manager)."""

    name: str = ""

    def validate(self, value: Any) -> Any:
        return value

    def prepare(self, conductor, value: Any) -> Any:
        """Driver-side staging (e.g. upload); returns the wire value."""
        return value

    def apply(self, conductor, value: Any) -> None:
        """Worker-side activation before task/actor code runs."""


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}
_ENV_PLUGINS_LOADED: Optional[str] = None


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name or plugin.name in _BUILTIN:
        raise ValueError(f"invalid plugin name {plugin.name!r}")
    _PLUGINS[plugin.name] = plugin


def _plugins() -> Dict[str, RuntimeEnvPlugin]:
    """register_plugin()'d instances + classes named in
    RTT_RUNTIME_ENV_PLUGINS ("module:Class,module:Class") — the env
    var is how plugins reach WORKER processes, which never ran the
    driver's register_plugin call (reference RAY_RUNTIME_ENV_PLUGINS,
    runtime_env/plugin.py:40)."""
    global _ENV_PLUGINS_LOADED
    spec = os.environ.get(ENV_PLUGINS, "")
    if spec and spec != _ENV_PLUGINS_LOADED:
        import importlib

        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            mod_name, _, cls_name = item.partition(":")
            plugin = getattr(importlib.import_module(mod_name), cls_name)()
            _PLUGINS.setdefault(plugin.name, plugin)
        _ENV_PLUGINS_LOADED = spec
    return _PLUGINS


def validate(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if not runtime_env:
        return {}
    env = dict(runtime_env)
    for key in _UNSUPPORTED:
        if key in env:
            raise ValueError(
                f"runtime_env[{key!r}] is not supported: workers come "
                "from a pre-started process pool on baked images — "
                "there is no container runtime to launch them in; bake "
                "the image instead. Supported keys: env_vars, "
                "working_dir, py_modules, pip/uv (local wheels/dirs), "
                "conda (existing local env)")
    for key in env:
        if key not in _BUILTIN and key not in _plugins():
            raise ValueError(
                f"unknown runtime_env key {key!r}; built-ins: {_BUILTIN}, "
                f"registered plugins: {sorted(_PLUGINS)}")
    ev = env.get("env_vars") or {}
    if not all(isinstance(k, str) and isinstance(v, str)
               for k, v in ev.items()):
        raise ValueError("runtime_env['env_vars'] must be Dict[str, str]")
    if "CUDA_VISIBLE_DEVICES" in ev:
        raise ValueError(
            "runtime_env['env_vars'] may not set CUDA_VISIBLE_DEVICES: "
            "host workers see no GPU, and a GPU reaches a worker only "
            "through a lease (num_gpus=)")
    if "pip" in env and "uv" in env:
        raise ValueError("runtime_env accepts 'pip' OR 'uv', not both "
                         "(they describe the same environment)")
    for installer in ("pip", "uv"):
        specs = env.get(installer)
        if specs is None or (isinstance(specs, dict) and "key" in specs):
            continue  # absent, or already prepared
        if not (isinstance(specs, list)
                and all(isinstance(s, str) for s in specs)):
            raise ValueError(
                f"runtime_env[{installer!r}] must be List[str] of local "
                "wheel/sdist/directory paths")
        for s in specs:
            if not (os.path.isfile(s) or os.path.isdir(s)):
                raise ValueError(
                    f"runtime_env[{installer!r}] entry {s!r} is not "
                    "supported: network installs at task time never "
                    "happen in ray_tpu_torch (images are baked; zero "
                    "egress) — pass a local wheel/sdist/directory path "
                    "instead")
    conda = env.get("conda")
    if conda is not None:
        if isinstance(conda, dict) and ("dependencies" in conda
                                        or "channels" in conda):
            raise ValueError(
                "runtime_env['conda'] with an environment spec "
                "(dependencies/channels) is not supported: ray_tpu_torch never "
                "creates envs from the network at task time — pass the "
                "NAME or PREFIX PATH of an env that already exists on "
                "the workers")
        if isinstance(conda, dict):
            if not (conda.get("prefix") or conda.get("name")):
                raise ValueError("runtime_env['conda'] dict needs "
                                 "'prefix' or 'name'")
        elif not isinstance(conda, str):
            raise ValueError("runtime_env['conda'] must be an env name, "
                             "a prefix path, or {'prefix'|'name': ...}")
    for key, plugin in _plugins().items():
        if key in env:
            env[key] = plugin.validate(env[key])
    return env


def merge(base: Optional[Dict[str, Any]],
          override: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """`override`'s keys over `base`'s, their env_vars merged: how a
    task's own runtime_env sits on its job's (reference
    runtime_env/utils.py merge semantics)."""
    out = dict(base or {})
    out.update(override or {})
    if (base or {}).get("env_vars") and (override or {}).get("env_vars"):
        out["env_vars"] = {**base["env_vars"], **override["env_vars"]}
    return out


def job_runtime_env() -> Dict[str, Any]:
    """The runtime_env of the job this driver runs (empty outside one)."""
    import json

    return json.loads(os.environ.get(ENV_JOB) or "{}")


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    base = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(base):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", ".git", ".venv")]
            for f in files:
                if f.endswith(".pyc"):
                    continue
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, base))
    data = buf.getvalue()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path} is {len(data)} bytes "
            f"(limit {_MAX_PACKAGE_BYTES}); exclude large data files")
    return data


def package_dir(conductor, path: str) -> str:
    """Zip + upload a directory to the conductor KV; returns a
    content-addressed URI (reference packaging.py upload_package_if_needed).
    """
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory {path!r} does not exist")
    data = _zip_dir(path)
    digest = hashlib.sha256(data).hexdigest()[:24]
    uri = f"kv://{digest}.zip"
    key = uri.encode()
    if conductor.call("kv_get", key, _KV_NS, timeout=30.0) is None:
        conductor.call("kv_put", key, data, True, _KV_NS, timeout=60.0)
    return uri


def package_file(conductor, path: str) -> str:
    """Upload one artifact (wheel/sdist) to the KV, content-addressed."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise ValueError(f"runtime_env artifact {path} too large")
    digest = hashlib.sha256(data).hexdigest()[:24]
    uri = f"kv://{digest}.bin"
    key = uri.encode()
    if conductor.call("kv_get", key, _KV_NS, timeout=30.0) is None:
        conductor.call("kv_put", key, data, True, _KV_NS, timeout=60.0)
    return uri


def _prepare_pip(conductor, specs: List[str]) -> Dict[str, Any]:
    """Stage local artifacts so remote workers can install them offline
    (reference pip.py + packaging.py upload flow)."""
    staged = []
    for s in specs:
        if os.path.isfile(s):  # wheel/sdist: filename carries pip's tags
            staged.append({"kind": "file", "uri": package_file(conductor, s),
                           "filename": os.path.basename(s)})
        elif os.path.isdir(s):
            staged.append({"kind": "dir", "uri": package_dir(conductor, s)})
        else:  # validate() rejected bare requirements before this point
            raise ValueError(f"runtime_env['pip'] entry {s!r} vanished "
                             "between validation and staging")
    key = hashlib.sha256(repr(staged).encode()).hexdigest()[:24]
    return {"key": key, "specs": staged}


def prepare(conductor, runtime_env: Dict[str, Any]) -> Dict[str, Any]:
    """Driver-side: replace local dirs/artifacts with uploaded URIs.
    Idempotent."""
    env = validate(runtime_env)
    if not env:
        return {}
    out = dict(env)
    wd = env.get("working_dir")
    if wd and not wd.startswith("kv://"):
        out["working_dir"] = package_dir(conductor, wd)
    mods = []
    for m in env.get("py_modules") or []:
        mods.append(m if m.startswith("kv://")
                    else package_dir(conductor, m))
    if mods:
        out["py_modules"] = mods
    for installer in ("pip", "uv"):
        specs = env.get(installer)
        if specs and not (isinstance(specs, dict) and "key" in specs):
            out[installer] = _prepare_pip(conductor, specs)
    for key, plugin in _plugins().items():
        if key in env:
            out[key] = plugin.prepare(conductor, env[key])
    return out


def _cache_root() -> str:
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                        "runtime_env")


def ensure_local(conductor, uri: str) -> str:
    """Worker-side: fetch + extract a kv:// package once; returns its
    directory (reference uri_cache.py — content-addressed, shared across
    tasks on the worker)."""
    digest = uri[len("kv://"):-len(".zip")]
    dest = os.path.join(_cache_root(), digest)
    if os.path.isdir(dest):
        return dest
    data = conductor.call("kv_get", uri.encode(), _KV_NS, timeout=60.0)
    if data is None:
        raise RuntimeError(f"runtime_env package {uri} not found in KV")
    tmp = dest + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        z.extractall(tmp)
    try:
        os.replace(tmp, dest)
    except OSError:  # another worker won the race
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def ensure_pip_env(conductor, prepared: Dict[str, Any],
                   installer: str = "pip") -> str:
    """Worker-side: materialize the staged pip/uv env once; returns its
    site-packages dir. A content-keyed venv (--system-site-packages so
    the base interpreter's packages stay visible to the installer;
    --no-index so nothing touches the network) mirrors the reference's per-env virtualenv (pip.py:282) —
    shared by every task/actor with the same spec on this machine.
    installer='uv' uses the uv binary when present (reference uv.py's
    faster installs) and falls back to pip — the resulting env is
    identical either way."""
    key = prepared["key"]
    venv_dir = os.path.join(_cache_root(), "venvs", key)
    ok_marker = os.path.join(venv_dir, ".ray_tpu_torch_ok")
    lib = os.path.join(venv_dir, "lib",
                       f"python{sys.version_info.major}."
                       f"{sys.version_info.minor}", "site-packages")
    if os.path.exists(ok_marker):
        return lib
    # localize staged artifacts
    art_dir = os.path.join(_cache_root(), "artifacts", key)
    os.makedirs(art_dir, exist_ok=True)
    targets: List[str] = []
    for s in prepared["specs"]:
        if s["kind"] == "file":
            dest = os.path.join(art_dir, s["filename"])
            if not os.path.exists(dest):
                data = conductor.call("kv_get", s["uri"].encode(), _KV_NS,
                                      timeout=60.0)
                if data is None:
                    raise RuntimeError(f"pip artifact {s['uri']} lost")
                with open(dest + ".tmp", "wb") as f:
                    f.write(data)
                os.replace(dest + ".tmp", dest)
            targets.append(dest)
        elif s["kind"] == "dir":
            targets.append(ensure_local(conductor, s["uri"]))
        else:
            targets.append(s["spec"])
    uv = _shutil.which("uv") if installer == "uv" else None
    if uv:
        subprocess.run([uv, "venv", "--system-site-packages",
                        "--python", sys.executable, venv_dir],
                       check=True, capture_output=True)
        cmd = [uv, "pip", "install", "--quiet", "--no-index",
               "--no-build-isolation",
               "--python", os.path.join(venv_dir, "bin", "python"),
               *targets]
    else:
        subprocess.run([sys.executable, "-m", "venv",
                        "--system-site-packages", venv_dir],
                       check=True, capture_output=True)
        cmd = [os.path.join(venv_dir, "bin", "pip"), "install", "--quiet",
               "--no-index", "--no-build-isolation", *targets]
    _see_parent_packages(lib)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"{installer} runtime_env failed (offline install of "
            f"{targets}): {r.stdout}\n{r.stderr}")
    with open(ok_marker, "w") as f:
        f.write("ok")
    return lib


def _see_parent_packages(lib: str) -> None:
    """Let the venv's own interpreter (the installer's build backend)
    see this interpreter's site-packages. Where `sys.executable` is
    itself a venv, --system-site-packages reaches only its BASE
    interpreter's packages, which may lack setuptools. A .pth file does
    it; a worker puts `lib` on its sys.path without reading .pth files,
    so its imports (torch among them) stay its own."""
    import site

    os.makedirs(lib, exist_ok=True)
    with open(os.path.join(lib, "_rtt_parent.pth"), "w") as f:
        f.write("".join(p + "\n" for p in site.getsitepackages()))


def resolve_conda_prefix(value: Any) -> str:
    """Locate an EXISTING local conda env (reference conda.py
    get_conda_env_dir — minus creation). Accepts a prefix path directly;
    names are searched in CONDA_ENVS_PATH, the active conda install's
    envs/ dir, and the conventional roots."""
    from .. import exceptions as exc

    if isinstance(value, dict):
        value = value.get("prefix") or value.get("name")
    value = str(value)
    if os.path.sep in value or os.path.isdir(value):
        prefix = os.path.abspath(os.path.expanduser(value))
        if os.path.exists(os.path.join(prefix, "bin", "python")):
            return prefix
        raise exc.RuntimeEnvSetupError(
            f"runtime_env['conda'] prefix {value!r} has no bin/python — "
            "not a conda env (ray_tpu_torch never creates envs at task "
            "time; "
            "create it beforehand)")
    roots: List[str] = []
    for d in os.environ.get("CONDA_ENVS_PATH", "").split(os.pathsep):
        if d:
            roots.append(d)
    conda_exe = os.environ.get("CONDA_EXE") or _shutil.which("conda")
    if conda_exe:
        roots.append(os.path.join(
            os.path.dirname(os.path.dirname(conda_exe)), "envs"))
    for base in ("~/miniconda3", "~/anaconda3", "/opt/conda"):
        roots.append(os.path.join(os.path.expanduser(base), "envs"))
    for root in roots:
        prefix = os.path.join(root, value)
        if os.path.exists(os.path.join(prefix, "bin", "python")):
            return prefix
    raise exc.RuntimeEnvSetupError(
        f"runtime_env['conda'] env {value!r} not found on this worker "
        f"(searched {roots}); ray_tpu_torch activates EXISTING envs "
        "only — "
        "create it on every node beforehand (baked images, zero egress)")


def _apply_conda(value: Any) -> Dict[str, Optional[str]]:
    """Activate an existing conda env for this process: PATH, CONDA_*
    env vars, and its site-packages at the front of sys.path. Returns
    {env_var: previous} so a task-scoped application can be undone."""
    prefix = resolve_conda_prefix(value)
    saved: Dict[str, Optional[str]] = {
        "PATH": os.environ.get("PATH"),
        "CONDA_PREFIX": os.environ.get("CONDA_PREFIX"),
        "CONDA_DEFAULT_ENV": os.environ.get("CONDA_DEFAULT_ENV"),
    }
    os.environ["PATH"] = (os.path.join(prefix, "bin") + os.pathsep
                          + os.environ.get("PATH", ""))
    os.environ["CONDA_PREFIX"] = prefix
    os.environ["CONDA_DEFAULT_ENV"] = os.path.basename(prefix)
    lib = os.path.join(prefix, "lib")
    if os.path.isdir(lib):
        for entry in sorted(os.listdir(lib)):
            sp = os.path.join(lib, entry, "site-packages")
            if entry.startswith("python") and os.path.isdir(sp):
                if sp not in sys.path:
                    sys.path.insert(0, sp)
                break
    return saved


@contextlib.contextmanager
def applied(conductor, runtime_env: Optional[Dict[str, Any]],
            permanent: bool = False):
    """Apply a (prepared) runtime_env around execution. For tasks the
    previous env/cwd/sys.path are restored afterwards (shared worker);
    actors pass permanent=True (dedicated process, reference behavior)."""
    env = runtime_env or {}
    if not env:
        yield
        return
    saved_env: Dict[str, Optional[str]] = {}
    saved_cwd = os.getcwd()
    saved_path = list(sys.path)
    try:
        for k, v in (env.get("env_vars") or {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        wd = env.get("working_dir")
        if wd:
            local = ensure_local(conductor, wd)
            os.chdir(local)
            if local not in sys.path:
                sys.path.insert(0, local)
        for uri in env.get("py_modules") or []:
            local = ensure_local(conductor, uri)
            if local not in sys.path:
                sys.path.insert(0, local)
        for installer in ("pip", "uv"):
            specs = env.get(installer)
            if specs:
                sp = ensure_pip_env(conductor, specs, installer=installer)
                if sp not in sys.path:
                    sys.path.insert(0, sp)
        conda = env.get("conda")
        if conda:
            for var, old in _apply_conda(conda).items():
                saved_env.setdefault(var, old)
        for key, plugin in _plugins().items():
            if key in env:
                plugin.apply(conductor, env[key])
        yield
    finally:
        if not permanent:
            for k, old in saved_env.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            try:
                os.chdir(saved_cwd)
            except OSError:
                pass
            sys.path[:] = saved_path
