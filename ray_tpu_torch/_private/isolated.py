"""Runtime checks in a driver process of their own.

    outcomes = run_checks({"core_put_get": {"num_cpus": 4},
                           "config_unknown_flag_rejected": None})
    ok, text = outcomes["core_put_get"]

Each named check is a function of `runtime_checks.py`,
`cluster_checks.py`, `fabric_checks.py`, `serve_checks.py`,
`online_checks.py`, `mpmd_checks.py`, `surface_checks.py`,
`telemetry_checks.py`, `deploy_checks.py` or `dashboard_checks.py`
(modules of the package, so worker processes can import what a check
pickles by reference). `run_checks` starts a fresh `python -m
ray_tpu_torch._private.isolated` driver in a new session. For each check
the driver starts a cluster with `init(**kwargs)` (None: the check
starts and stops its own), runs the check, shuts the cluster down and
records the outcome: (True, "") or (False, traceback); a check that
returns a value other than None has it as JSON in place of "". A
caller may hand the checks JSON `inputs` (e.g. the path of a weights
file a test wrote); a check reads them with `inputs()`.

The parent waits under a hard timeout and kills the driver when it
expires. Either way it then finds every process of the run — the
driver, the conductor's workers and the fork template, each of which
carries the run's directory in `RTT_SESSION_DIR` — kills any that
remain, and sweeps dead processes' shm segments. The outcome
`SESSION_ENDED` says whether every process had exited on its own once
the driver was done. No cluster, arena or worker ever lives in the
calling process.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

SESSION_ENDED = "__session_ended__"
# every cluster of a run: orphans of a killed driver exit within about
# twice this
SYSTEM_CONFIG = {"worker_orphan_grace": 2.0}

Outcomes = Dict[str, Tuple[bool, str]]

_INPUTS: Dict[str, Any] = {}


def inputs() -> Dict[str, Any]:
    """The `inputs` the running checks were handed by `run_checks`."""
    return _INPUTS


def session_processes(root: str) -> List[int]:
    """Pids of live processes whose environment has RTT_SESSION_DIR
    under `root` (this process excluded)."""
    from .worker_spawn import ENV_SESSION_DIR

    key = (ENV_SESSION_DIR + "=").encode()
    want = os.fsencode(root)
    me = os.getpid()
    found = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == me:
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        for item in env.split(b"\0"):
            if item.startswith(key) and item[len(key):].startswith(want):
                found.append(int(d))
                break
    return found


def _kill_all(root: str) -> None:
    """SIGKILL every process of the run until none is left."""
    for _ in range(50):
        pids = session_processes(root)
        if not pids:
            return
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        time.sleep(0.1)


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_checks(checks: Dict[str, Optional[dict]],
               timeout: float = 240.0,
               inputs: Optional[Dict[str, Any]] = None) -> Outcomes:
    """Run `checks` (name -> init kwargs, or None) in a driver process
    of their own; see the module docstring."""
    from .. import session_root
    from .object_store import cleanup_leaked_segments
    from .worker_spawn import ENV_SESSION_DIR

    os.makedirs(session_root(), exist_ok=True)
    root = tempfile.mkdtemp(prefix="isolated-", dir=session_root())
    payload = os.path.join(root, "payload.json")
    results = os.path.join(root, "results.json")
    log = os.path.join(root, "driver.log")
    with open(payload, "w") as f:
        json.dump({"checks": list(checks.items()), "root": root,
                   "results": results, "inputs": inputs or {}}, f)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env = dict(os.environ)
    child_env[ENV_SESSION_DIR] = root
    child_env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([child_env["PYTHONPATH"]] if child_env.get("PYTHONPATH")
                  else []))
    timed_out = False
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.isolated",
             payload], env=child_env, cwd=root, stdout=out,
            stderr=subprocess.STDOUT, start_new_session=True)
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
    # a clean run leaves nothing: give exiting processes a moment
    deadline = time.monotonic() + 10.0
    while not timed_out and session_processes(root) \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    left = session_processes(root)
    _kill_all(root)
    cleanup_leaked_segments()
    try:
        with open(results) as f:
            got = {k: (bool(v[0]), v[1]) for k, v in json.load(f).items()}
    except (OSError, ValueError):
        got = {}
    clean = not timed_out and proc.returncode == 0
    why = (f"the driver did not finish within {timeout}s" if timed_out
           else f"the driver exited with code {proc.returncode}")
    outcomes: Outcomes = {
        name: got.get(name) or (False, f"{name}: no outcome; {why}")
        for name in checks}
    if not clean:
        outcomes[SESSION_ENDED] = (False, why)
    elif left:
        outcomes[SESSION_ENDED] = (
            False, f"processes of the run still alive after shutdown: "
            f"{left}")
    else:
        outcomes[SESSION_ENDED] = (True, "")
    log_tail = "\n--- driver log ---\n" + _tail(log)
    outcomes = {name: (ok, text + log_tail if not ok else text)
                for name, (ok, text) in outcomes.items()}
    shutil.rmtree(root, ignore_errors=True)
    return outcomes


def _driver_main(payload_path: str) -> int:
    with open(payload_path) as f:
        p = json.load(f)
    import ray_tpu_torch as rt

    from . import (cluster_checks, dashboard_checks, deploy_checks,
                   fabric_checks, mpmd_checks, online_checks,
                   runtime_checks, serve_checks, surface_checks,
                   telemetry_checks)
    from .config import config

    # sessions (a check's own too) live under the run's directory,
    # where the parent finds their processes
    rt.session_root = lambda: p["root"]
    config.apply(SYSTEM_CONFIG)
    # checks import this module by name; the driver runs as __main__
    from . import isolated as named

    named._INPUTS.update(p.get("inputs") or {})
    results: Dict[str, list] = {}

    def record(name: str, ok: bool, text: str) -> None:
        results[name] = [ok, text]
        tmp = p["results"] + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f)
        os.replace(tmp, p["results"])

    for name, init_kwargs in p["checks"]:
        try:
            fn = getattr(runtime_checks, name, None) \
                or getattr(cluster_checks, name, None) \
                or getattr(fabric_checks, name, None) \
                or getattr(serve_checks, name, None) \
                or getattr(online_checks, name, None) \
                or getattr(mpmd_checks, name, None) \
                or getattr(surface_checks, name, None) \
                or getattr(telemetry_checks, name, None) \
                or getattr(deploy_checks, name, None) \
                or getattr(dashboard_checks, name)
            if init_kwargs is not None:
                rt.init(**init_kwargs)
            value = fn()
            ok, text = True, ("" if value is None else json.dumps(value))
        except Exception:  # noqa: BLE001 — reported to the parent
            ok, text = False, traceback.format_exc()
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001 — reported to the parent
            ok, text = False, text + traceback.format_exc()
        record(name, ok, text)
    return 0


if __name__ == "__main__":
    sys.exit(_driver_main(sys.argv[1]))
