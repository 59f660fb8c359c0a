"""Lightweight RPC: length-prefixed pickle frames over TCP.

Fills the role of the reference's gRPC wrapper layer
(src/ray/rpc/grpc_server.h, client_call.h): async server calls
dispatched to handler methods, clients with persistent connections, concurrent
in-flight requests demultiplexed by request id, and error propagation. We use
framed cloudpickle instead of protobuf because the control-plane schema here is
Python-internal; large payloads ride it only as the object store hands them out: on one
host they move through shared memory (see object_store.py), and device
tensors travel as host bytes (see serialization.py).

Wire format: 8-byte big-endian length, then a pickled tuple:
  request:  (req_id, method_name, args, kwargs)   req_id < 0 => one-way
  response: (req_id, ok_flag, payload)            payload = result | exc info
"""
from __future__ import annotations

import socket
import struct
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

from . import serialization

_LEN = struct.Struct(">Q")


class RpcError(RuntimeError):
    pass


class ConnectionLost(RpcError):
    pass


class RemoteError(RpcError):
    """An exception raised inside the remote handler."""

    def __init__(self, exc: BaseException, tb: str):
        super().__init__(f"{type(exc).__name__}: {exc}\n--- remote traceback ---\n{tb}")
        self.cause = exc
        self.remote_traceback = tb


def _send_frame(sock: socket.socket, payload: bytes, lock: threading.Lock) -> None:
    with lock:
        sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionLost("socket closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(_recv_exact(sock, 8))
    return _recv_exact(sock, length)


class RpcServer:
    """Threaded RPC server dispatching frames to methods of a handler object.

    Handler methods are looked up by name; names starting with '_' are not
    callable remotely. Each request runs on a pool thread so slow handlers
    don't block the connection's read loop (needed for concurrent actor calls).
    """

    def __init__(self, handler: Any, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 16, warn_slow: bool = False):
        self._handler = handler
        # per-method latency accounting (reference instrumented_io_context
        # .h: post/dispatch counts + queueing and execution times).
        # warn_slow is for CONTROL-PLANE servers (the conductor): worker
        # servers run user task code inline in push_task, where >1s is
        # normal, not dispatch lag. Handlers that block BY DESIGN
        # (lease_worker parks on a condition variable until capacity
        # frees) opt out via the handler's _slow_ok_methods set.
        # 5s default: create_actor legitimately takes ~2-3s (process
        # spawn + imports); the warning is for wedged handlers.
        self._warn_slow = warn_slow
        from .config import config

        self._warn_handler_s = config.rpc_warn_ms / 1e3
        self._slow_ok = frozenset(getattr(handler, "_slow_ok_methods",
                                          ()))
        self._stats: Dict[str, list] = {}
        self._stats_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if port == 0:
            self._sock.bind((host, port))
        else:
            # explicit port = a daemon restarting at a known address; the
            # previous incarnation's sockets may linger in FIN_WAIT for a
            # moment after its stop() — retry briefly instead of failing
            deadline = time.monotonic() + 5.0
            while True:
                try:
                    self._sock.bind((host, port))
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.1)
        self._sock.listen(128)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="rpc-handler")
        self._stopped = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="rpc-accept", daemon=True)
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def start(self) -> "RpcServer":
        # Every runtime process (conductor, workers, drivers) hosts an
        # RpcServer, so this is the one shared hook for the interpreter
        # switch interval. The 5ms CPython default turns concurrent RPC
        # dispatch into a GIL convoy — with 16 in-flight control-plane
        # calls, each handler waits ~n_runnable x 5ms for the GIL and
        # pipelined task throughput collapses ~6x below serial. 1ms keeps
        # dispatch latency bounded without measurably taxing compute
        # threads (torch releases the GIL during device execution).
        if sys.getswitchinterval() > 0.001:
            sys.setswitchinterval(0.001)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            for c in list(self._conns):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="rpc-conn", daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        # Methods listed here are invoked synchronously on this reader
        # thread with a reply callback as first argument, preserving frame
        # ARRIVAL order (needed for actor task ordering) and freeing pool
        # threads from blocking on long-running handlers.
        async_reply = getattr(self._handler, "_async_reply_methods",
                              frozenset())
        try:
            while not self._stopped.is_set():
                frame = _recv_frame(conn)
                req_id, method, args, kwargs = serialization.loads(frame)
                if method in async_reply and req_id >= 0:
                    self._dispatch_async_reply(conn, send_lock, req_id,
                                               method, args, kwargs)
                else:
                    self._pool.submit(self._dispatch, conn, send_lock,
                                      req_id, method, args, kwargs,
                                      time.perf_counter())
                # a reader blocked in the next _recv_frame must not pin
                # the previous request in its frame locals: task args can
                # hold large values and ObjectRefs whose refcount release
                # (and memory) would otherwise wait for the NEXT request
                del frame, args, kwargs
        except (ConnectionLost, OSError):
            pass
        except RuntimeError:
            # pool shut down mid-race with stop(); drop the request
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch_async_reply(self, conn, send_lock, req_id, method, args,
                              kwargs) -> None:
        """Run an enqueue-style handler inline; it replies later via cb."""

        def reply_cb(ok: bool, payload: Any) -> None:
            try:
                _send_frame(conn, serialization.dumps((req_id, ok, payload)),
                            send_lock)
            except (OSError, ConnectionLost):
                pass

        try:
            getattr(self._handler, method)(reply_cb, *args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — must cross the wire
            reply_cb(False, (e, traceback.format_exc()))

    def _record(self, method: str, queue_s: float, exec_s: float) -> None:
        with self._stats_lock:
            s = self._stats.get(method)
            if s is None:
                s = self._stats[method] = [0, 0.0, 0.0, 0.0, 0.0]
            s[0] += 1
            s[1] += queue_s
            s[2] += exec_s
            s[3] = max(s[3], queue_s)
            s[4] = max(s[4], exec_s)
        if self._warn_slow and exec_s > self._warn_handler_s \
                and method not in self._slow_ok:
            print(f"[rpc] slow handler {method}: {exec_s * 1e3:.0f}ms "
                  f"(queued {queue_s * 1e3:.0f}ms)", file=sys.stderr)

    def handler_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-method dispatch stats: count, mean/max queue and handler
        time (ms) — the instrumented_io_context analog for this server's
        thread pool."""
        with self._stats_lock:
            return {m: {"count": s[0],
                        "mean_queue_ms": s[1] / s[0] * 1e3,
                        "mean_handler_ms": s[2] / s[0] * 1e3,
                        "max_queue_ms": s[3] * 1e3,
                        "max_handler_ms": s[4] * 1e3}
                    for m, s in self._stats.items() if s[0]}

    def _dispatch(self, conn, send_lock, req_id, method, args, kwargs,
                  enqueued_at: float = 0.0) -> None:
        t0 = time.perf_counter()
        try:
            if method.startswith("_"):
                raise AttributeError(f"method {method!r} is not remotely callable")
            fn = getattr(self._handler, method)
            result = fn(*args, **kwargs)
            ok = True
        except BaseException as e:  # noqa: BLE001 — must cross the wire
            result = (e, traceback.format_exc())
            ok = False
        self._record(method, t0 - enqueued_at if enqueued_at else 0.0,
                     time.perf_counter() - t0)
        if req_id < 0:  # one-way
            return
        try:
            _send_frame(conn, serialization.dumps((req_id, ok, result)), send_lock)
        except (OSError, ConnectionLost):
            pass
        except Exception:
            # result unpicklable: send the error instead
            try:
                err = (RpcError(f"unpicklable result from {method}"),
                       traceback.format_exc())
                _send_frame(conn, serialization.dumps((req_id, False, err)), send_lock)
            except (OSError, ConnectionLost):
                pass


class RpcClient:
    """Persistent connection with concurrent in-flight calls."""

    def __init__(self, address: Tuple[str, int], connect_timeout: float = 10.0,
                 connect_retries: int = 0, retry_interval: float = 0.3):
        self.address = tuple(address)
        attempt = 0
        while True:
            try:
                self._sock = socket.create_connection(
                    self.address, timeout=connect_timeout)
                break
            except (ConnectionRefusedError, OSError) as e:
                attempt += 1
                if attempt > connect_retries:
                    raise ConnectionLost(
                        f"cannot connect to {self.address}: {e}") from e
                time.sleep(retry_interval)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._pending: Dict[int, "_Pending"] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 1
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name="rpc-reader", daemon=True)
        self._reader.start()

    def close(self) -> None:
        self._closed = True
        try:
            # shutdown() (not just close()) reliably wakes a reader thread
            # blocked in recv() on another thread's socket.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _read_loop(self) -> None:
        try:
            while True:
                frame = _recv_frame(self._sock)
                req_id, ok, payload = serialization.loads(frame)
                with self._pending_lock:
                    p = self._pending.pop(req_id, None)
                if p is not None:
                    p.ok, p.payload = ok, payload
                    p.event.set()
                    _run_callback(p)
                # idle reader must not pin the last reply (may be a large
                # task result) until the next one arrives
                del frame, payload, p
        except (ConnectionLost, OSError, EOFError):
            self._closed = True
            with self._pending_lock:
                pending, self._pending = self._pending, {}
            for p in pending.values():
                p.ok = False
                p.payload = (ConnectionLost(f"connection to {self.address} lost"), "")
                p.event.set()
                _run_callback(p)

    def start_call(self, method: str, *args, **kwargs) -> "_Pending":
        """Send the request; returns a pending to pass to finish_call.
        Splitting send from wait lets callers control frame ordering."""
        return self._start(_Pending(), method, args, kwargs)

    def call_async(self, on_done: Callable[["_Pending"], None], method: str,
                   *args, **kwargs) -> "_Pending":
        """Send the request; `on_done(p)` runs on the reader thread once
        `p` holds the reply or the connection's loss, so it must only hand
        work off. Raises ConnectionLost (and never calls `on_done`) when
        the request could not be sent."""
        p = _Pending()
        p.callback = on_done
        return self._start(p, method, args, kwargs)

    def _start(self, p: "_Pending", method: str, args: tuple,
               kwargs: dict) -> "_Pending":
        with self._pending_lock:
            req_id = self._next_id
            self._next_id += 1
            self._pending[req_id] = p
            p.req_id = req_id
        try:
            frame = serialization.dumps((req_id, method, args, kwargs))
        except BaseException:
            # nothing was sent: no reply (and no callback) will come
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise
        try:
            _send_frame(self._sock, frame, self._send_lock)
        except (OSError, ConnectionLost) as e:
            with self._pending_lock:
                mine = self._pending.pop(req_id, None) is not None
            if mine:
                raise ConnectionLost(str(e)) from e
            # the reader already delivered the loss (and ran the callback)
        return p

    def finish_call(self, p: "_Pending", method: str = "",
                    timeout: Optional[float] = None) -> Any:
        if not p.event.wait(timeout):
            with self._pending_lock:
                self._pending.pop(p.req_id, None)
            raise TimeoutError(f"rpc {method} to {self.address} timed out after {timeout}s")
        if p.ok:
            return p.payload
        exc, tb = p.payload
        if isinstance(exc, ConnectionLost):
            raise exc
        raise RemoteError(exc, tb) from exc

    def call(self, method: str, *args, timeout: Optional[float] = None, **kwargs) -> Any:
        return self.finish_call(self.start_call(method, *args, **kwargs),
                                method, timeout)

    def notify(self, method: str, *args, **kwargs) -> None:
        """Fire-and-forget."""
        frame = serialization.dumps((-1, method, args, kwargs))
        try:
            _send_frame(self._sock, frame, self._send_lock)
        except OSError as e:
            raise ConnectionLost(str(e)) from e


class _Pending:
    __slots__ = ("event", "ok", "payload", "req_id", "callback")

    def __init__(self):
        self.event = threading.Event()
        self.ok = False
        self.payload = None
        self.req_id = -1
        self.callback: Optional[Callable[["_Pending"], None]] = None


def _run_callback(p: _Pending) -> None:
    if p.callback is not None:
        try:
            p.callback(p)
        except Exception:  # noqa: BLE001 — a callback must not end the reader
            pass


class ClientPool:
    """Cache of RpcClients keyed by address — analog of the reference's
    core_worker_client_pool.h."""

    def __init__(self):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._lock = threading.Lock()

    def get(self, address: Tuple[str, int]) -> RpcClient:
        address = tuple(address)
        with self._lock:
            c = self._clients.get(address)
            if c is not None and not c._closed:
                return c
        c = RpcClient(address)
        with self._lock:
            old = self._clients.get(address)
            if old is not None and not old._closed:
                c.close()
                return old
            self._clients[address] = c
            return c

    def invalidate(self, address: Tuple[str, int]) -> None:
        with self._lock:
            c = self._clients.pop(tuple(address), None)
        if c is not None:
            c.close()

    def close_all(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()


class ReconnectingClient:
    """RpcClient facade that re-dials a lost connection on the NEXT call —
    lets drivers, workers, and node agents ride out a conductor restart
    (reference: the GCS client's reconnect-with-backoff,
    src/ray/gcs/gcs_client/gcs_client.cc).

    A call already in flight when the connection drops still raises
    ConnectionLost — re-sending it here could double-execute a
    non-idempotent method (e.g. lease_worker); recovery is the caller's
    retry, made cheap because the re-dial happens underneath."""

    def __init__(self, address: Tuple[str, int], connect_timeout: float = 10.0,
                 connect_retries: int = 0, retry_interval: float = 0.3):
        self.address = tuple(address)
        self._connect_timeout = connect_timeout
        self._retry_interval = retry_interval
        self._lock = threading.Lock()
        self._client = RpcClient(address, connect_timeout=connect_timeout,
                                 connect_retries=connect_retries,
                                 retry_interval=retry_interval)
        self._shutdown = False

    @property
    def _closed(self) -> bool:
        """Closed for good (close() was called). A dropped connection is
        not 'closed' — the next call re-dials."""
        return self._shutdown

    def _live(self) -> RpcClient:
        with self._lock:
            if self._shutdown:
                raise ConnectionLost(f"client to {self.address} shut down")
            if not self._client._closed:
                return self._client
        # dial outside the lock; a brief outage gets a couple of retries
        nc = RpcClient(self.address, connect_timeout=self._connect_timeout,
                       connect_retries=2,
                       retry_interval=self._retry_interval)
        with self._lock:
            if self._shutdown or not self._client._closed:
                nc.close()
                if self._shutdown:
                    raise ConnectionLost(
                        f"client to {self.address} shut down")
                return self._client
            self._client = nc
            return nc

    def call(self, method: str, *args, timeout: Optional[float] = None,
             **kwargs) -> Any:
        return self._live().call(method, *args, timeout=timeout, **kwargs)

    def notify(self, method: str, *args, **kwargs) -> None:
        self._live().notify(method, *args, **kwargs)

    def start_call(self, method: str, *args, **kwargs):
        return self._live().start_call(method, *args, **kwargs)

    def call_async(self, on_done, method: str, *args, **kwargs):
        return self._live().call_async(on_done, method, *args, **kwargs)

    def finish_call(self, p, method: str = "",
                    timeout: Optional[float] = None) -> Any:
        return self._client.finish_call(p, method, timeout)

    def close(self) -> None:
        with self._lock:
            self._shutdown = True
            self._client.close()
