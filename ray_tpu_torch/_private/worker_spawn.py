"""Worker process spawning for the conductor's pool (reference: raylet
WorkerPool starting default_worker.py, src/ray/raylet/worker_pool.h:343).

Two paths:
- fork server (host workers): a pre-warmed template process forks
  workers in ~10ms (see fork_server.py) — the analog of the reference
  pool's prestarted workers, sized for actor churn.
- cold start (`python -m ray_tpu_torch._private.worker_main`): GPU
  workers, whose CUDA runtime must start in a fresh process; every
  worker when the `no_fork_server` flag is set; and the fallback when
  the template is unavailable or died.

Every process a spawn starts carries `RTT_SESSION_DIR` in its
environment, which is how the isolated test harness finds a session's
processes (isolated.py). The flag table reaches a forked worker in the
template's request and a cold-started one through a file in the session
directory (`RTT_SYSTEM_CONFIG`). A node agent spawns with its own `tag`
(its node id): its template and its flag-table file are its own, beside
the head's in a session directory the two may share on one machine.
"""
from __future__ import annotations

import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from .fork_server import REPLY, proc_start_time

# the process wiring variables (never RAY_TPU_*: the JAX package's)
ENV_WORKER_ID = "RTT_WORKER_ID"
ENV_CONDUCTOR = "RTT_CONDUCTOR"
ENV_SESSION_DIR = "RTT_SESSION_DIR"
ENV_NODE_ID = "RTT_NODE_ID"
ENV_DRIVER_SYS_PATH = "RTT_DRIVER_SYS_PATH"
ENV_SYSTEM_CONFIG = "RTT_SYSTEM_CONFIG"
ENV_GPU_INDICES = "RTT_GPU_INDICES"


class ForkedProc:
    """Popen-shaped handle for a fork-server worker. The worker is the
    TEMPLATE's child (the template reaps it), so waitpid is not ours to
    call: liveness is read from /proc, and the exit code is unknowable
    here and reported as 0.

    The handle knows the worker by pid AND start time. A pid whose start
    time differs belongs to another process that reused it after the
    worker exited: the handle then reports the worker as exited and
    never signals that process. Where the kernel has pidfds, a signal
    goes through one opened before the identity check, so the pid cannot
    be reused between the check and the signal; elsewhere the check runs
    just before os.kill."""

    def __init__(self, pid: int, start_time: int):
        self.pid = pid
        self.start_time = start_time
        self.returncode: Optional[int] = None

    def _same_process(self) -> bool:
        """The worker still runs: same pid and start time, not a zombie
        (a zombie has exited and released everything it held)."""
        try:
            return proc_start_time(self.pid) == self.start_time \
                and not pid_exited(self.pid)
        except (OSError, ValueError, IndexError):
            return False

    def poll(self) -> Optional[int]:
        if self.returncode is None and not self._same_process():
            self.returncode = 0
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.01)
        return self.returncode or 0

    def send_signal(self, sig: int) -> None:
        if self.poll() is not None:
            return
        try:
            fd: Optional[int] = os.pidfd_open(self.pid)
        except ProcessLookupError:
            self.returncode = 0
            return
        except OSError:
            fd = None  # no pidfds on this kernel: check, then signal
        try:
            if not self._same_process():
                self.returncode = 0
            elif fd is None:
                os.kill(self.pid, sig)
            else:
                signal.pidfd_send_signal(fd, sig)
        except ProcessLookupError:
            self.returncode = 0
        finally:
            if fd is not None:
                os.close(fd)

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)


def pid_exited(pid: int) -> bool:
    """The process is gone or a zombie: it has exited and released
    everything it held, its CUDA context included."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
    except OSError:
        return True
    return stat[stat.rindex(b")") + 2:].split()[0] == b"Z"


class _ForkServer:
    """Client + lifecycle for one template process, keyed by session."""

    def __init__(self, sock_path: str, proc: subprocess.Popen):
        self.sock_path = sock_path
        self.proc = proc
        self.lock = threading.Lock()

    def spawn(self, env: Dict[str, str], log_path: str,
              system_config: dict) -> ForkedProc:
        req = pickle.dumps({"env": env, "log_path": log_path,
                            "config": system_config})
        with self.lock:  # template serves sequentially
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                conn.settimeout(10.0)
                conn.connect(self.sock_path)
                conn.sendall(struct.pack("<I", len(req)) + req)
                buf = b""
                while len(buf) < REPLY.size:
                    chunk = conn.recv(REPLY.size - len(buf))
                    if not chunk:
                        raise EOFError("fork server closed mid-reply")
                    buf += chunk
            finally:
                conn.close()
        pid, start = REPLY.unpack(buf)
        return ForkedProc(pid, start)

    def stop(self) -> None:
        try:
            self.proc.terminate()
            self.proc.wait(timeout=3.0)
        except Exception:  # noqa: BLE001 — best-effort teardown
            try:
                self.proc.kill()
                self.proc.wait(timeout=3.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass


_fork_servers: Dict[str, _ForkServer] = {}
_fork_servers_lock = threading.Lock()


def _repo_env(env: Dict[str, str]) -> None:
    """Make the package importable in a child whatever its cwd."""
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    paths = [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else [])
    env["PYTHONPATH"] = os.pathsep.join(paths)


def _tagged(session_dir: str, name: str, ext: str, tag: str) -> str:
    return os.path.join(session_dir,
                        f"{name}-{tag}{ext}" if tag else f"{name}{ext}")


def _fork_key(session_dir: str, tag: str) -> str:
    return f"{session_dir}#{tag}" if tag else session_dir


def _get_fork_server(session_dir: str, base_env: Dict[str, str],
                     tag: str = "") -> Optional[_ForkServer]:
    from .config import config

    if sys.platform != "linux" or config.no_fork_server:
        return None
    key = _fork_key(session_dir, tag)
    with _fork_servers_lock:
        fs = _fork_servers.get(key)
        if fs is not None and fs.proc.poll() is None:
            return fs
        if fs is not None:
            _fork_servers.pop(key, None)
        sock_path = _tagged(session_dir, "fork_server", ".sock", tag)
        tmpl_env = dict(base_env)
        tmpl_env[ENV_SESSION_DIR] = session_dir
        _repo_env(tmpl_env)
        proc = None
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.fork_server",
                 sock_path],
                env=tmpl_env, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, start_new_session=True)
            # bounded readiness wait: a wedged template import must not
            # hold _fork_servers_lock forever (that would freeze every
            # future spawn); on timeout, kill + cold-spawn
            import select

            ready, _, _ = select.select([proc.stdout], [], [], 60.0)
            line = proc.stdout.readline() if ready else b""
            if b"READY" not in line:
                raise RuntimeError(f"fork server not ready: {line!r}")
        except Exception:  # noqa: BLE001 — caller falls back to subprocess
            if proc is not None:
                try:
                    proc.kill()
                    proc.wait(timeout=3.0)
                except Exception:  # noqa: BLE001 — already gone
                    pass
            return None
        fs = _ForkServer(sock_path, proc)
        _fork_servers[key] = fs
        return fs


def stop_fork_server(session_dir: str, tag: str = "") -> None:
    with _fork_servers_lock:
        fs = _fork_servers.pop(_fork_key(session_dir, tag), None)
    if fs is not None:
        fs.stop()


def system_config_path(session_dir: str, tag: str = "") -> str:
    """Where a cold-started worker reads the flag table."""
    return _tagged(session_dir, "system_config", ".pkl", tag)


def write_system_config(session_dir: str, tag: str = "") -> None:
    """Record this process's flag table for the session's cold spawns."""
    from .config import config

    path = system_config_path(session_dir, tag)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(config.snapshot(), f)
    os.replace(tmp, path)


def spawn_worker_process(worker_id: str,
                         conductor_address: Tuple[str, int],
                         session_dir: str,
                         worker_env: Optional[Dict[str, str]] = None,
                         env_extra: Optional[Dict[str, str]] = None,
                         node_id: Optional[str] = None,
                         cold: bool = False, tag: str = ""):
    """Start one worker wired to the conductor; returns a Popen-shaped
    handle (subprocess.Popen or ForkedProc). `cold` forces a fresh
    interpreter (GPU workers); `tag` names the spawning node's template
    and flag-table file (empty for the head's)."""
    from .config import config

    host, port = conductor_address
    env = dict(os.environ)
    env.update(worker_env or {})
    if env_extra:
        env.update(env_extra)
    env[ENV_WORKER_ID] = worker_id
    env[ENV_CONDUCTOR] = f"{host}:{port}"
    env[ENV_SESSION_DIR] = session_dir
    if node_id:
        env[ENV_NODE_ID] = node_id
    logs = os.path.join(session_dir, "logs")
    os.makedirs(logs, exist_ok=True)
    log_path = os.path.join(logs, f"worker-{worker_id[:12]}.log")

    if not cold:
        fs = _get_fork_server(
            session_dir, dict(os.environ, **(worker_env or {})), tag)
        if fs is not None:
            try:
                return fs.spawn(env, log_path, config.snapshot())
            except Exception:  # noqa: BLE001 — template died: cold spawn
                stop_fork_server(session_dir, tag)
    env[ENV_SYSTEM_CONFIG] = system_config_path(session_dir, tag)
    _repo_env(env)
    with open(log_path, "ab") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
