"""Pre-warmed worker fork server.

Worker spawn latency is interpreter + import cost paid on every pool
scale-up and every actor creation — the dominant term in actor churn.
This template process pre-imports the worker stack ONCE, then serves
spawn requests by forking: the child becomes the worker (reaped by this
template's SIGCHLD handler the moment it exits) and starts in ~10ms with
all modules hot.

Reference anchor: the raylet worker pool amortizes the same cost by
prestarting idle workers (src/ray/raylet/worker_pool.h:343 PopWorker /
prestart); CPython's multiprocessing "forkserver" start method is the
standard shape of this solution. We need the explicit version because
each spawn needs its own env + log wiring.

Fork safety: this process must stay single-threaded — it imports the
worker modules (imports start no threads; threads appear only when a
Worker object is constructed in the forked child) and serves a unix
socket sequentially. It never imports torch: torch's thread pools do not
survive a fork, so a worker imports torch itself when a payload or the
user's code needs it, and GPU workers are spawned cold (worker_spawn.py).
Liveness is tied to the parent conductor via a ppid poll in the accept
loop, not PDEATHSIG (which has per-thread semantics on linux and the
conductor forks from pool threads).

Each reply carries the child's pid and its start time (field 22 of
/proc/<pid>/stat), so the conductor's handle can tell the worker from an
unrelated process that later reuses its pid (worker_spawn.ForkedProc).
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import sys

REPLY = struct.Struct("<iQ")  # pid, start time in clock ticks


def proc_start_time(pid: int) -> int:
    """Start time of process `pid` (clock ticks after boot, field 22 of
    /proc/<pid>/stat); raises OSError if there is no such process."""
    with open(f"/proc/{pid}/stat", "rb") as f:
        stat = f.read()
    # the command name (field 2) may hold spaces and parentheses: count
    # the fields after its closing parenthesis, which start at field 3
    return int(stat[stat.rindex(b")") + 2:].split()[19])


def _read_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise EOFError("fork-server request truncated")
        buf += chunk
    return buf


def _spawn_from_request(srv: socket.socket, conn: socket.socket,
                        req: dict) -> None:
    # single fork: the worker stays a direct child of the template, which
    # reaps it via its SIGCHLD handler the moment it exits
    import signal

    pid = os.fork()
    if pid == 0:
        # child: become the worker
        conn_fd = conn.fileno()
        srv.close()
        os.setsid()
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        log_fd = os.open(req["log_path"],
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(log_fd, 1)
        os.dup2(log_fd, 2)
        os.close(log_fd)
        os.close(conn_fd)
        os.environ.clear()
        os.environ.update(req["env"])
        from ray_tpu_torch._private import worker_main
        from ray_tpu_torch._private.config import config

        try:
            config.load(req["config"])
            worker_main.main()
        finally:
            os._exit(0)
    try:
        start = proc_start_time(pid)
    except OSError:
        start = 0  # already gone and reaped: the handle sees it exited
    conn.sendall(REPLY.pack(pid, start))


def serve(sock_path: str) -> None:
    # warm the import cache before any fork — this is the entire point
    import encodings.idna  # noqa: F401 — the first getaddrinfo's codec
    import signal

    import ray_tpu_torch._private.refcount  # noqa: F401
    import ray_tpu_torch._private.serialization  # noqa: F401
    import ray_tpu_torch._private.worker  # noqa: F401
    import ray_tpu_torch._private.worker_main  # noqa: F401
    from ray_tpu_torch import _native

    # a worker's store maps the arena: ctypes and the dlopen of the built
    # library are paid here once, not in each child (a failure here is
    # met again, and raised, in a child that needs the arena)
    try:
        _native.load_shm_store()
    except (OSError, RuntimeError):
        pass

    def _reap(_sig, _frm):
        try:
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        except ChildProcessError:
            pass

    # prompt reaping: dead workers must vanish from the pid table at once
    signal.signal(signal.SIGCHLD, _reap)

    parent = os.getppid()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv.bind(sock_path)
    srv.listen(16)
    srv.settimeout(2.0)
    sys.stdout.write("READY\n")
    sys.stdout.flush()
    while True:
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            if os.getppid() != parent:  # conductor gone: die with it
                break
            continue
        except OSError:
            break
        try:
            (size,) = struct.unpack("<I", _read_exact(conn, 4))
            req = pickle.loads(_read_exact(conn, size))
            _spawn_from_request(srv, conn, req)
        except (EOFError, OSError, pickle.UnpicklingError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
    try:
        os.unlink(sock_path)
    except OSError:
        pass


if __name__ == "__main__":
    serve(sys.argv[1])
