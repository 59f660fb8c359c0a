"""Ray-Client-style proxy: ``ray_tpu_torch.init("ray://host:port")``
(the port's copy of the JAX package's client.py).

Reference: python/ray/util/client (the ray:// gRPC proxy that hosts a
server-side driver per remote client, so clients need only ONE outbound
connection and no inbound reachability — laptops behind NAT, notebook
kernels, CI). The rebuild keeps that shape on the native RPC plane:

- ``ClientProxy`` runs next to the head. Each client session gets its
  pins table (object refs + actor handles held alive server-side); the
  proxy executes submissions on its own driver Worker and returns
  opaque ids. Sessions idle past a timeout are reaped, dropping their
  pins so the distributed refcount can collect.
- ``ClientWorker`` is the client-side ``global_worker`` stand-in: the
  whole public API (put/get/wait/remote tasks/actors/cancel/kill and
  the conductor passthrough) routes through it unchanged — blocking
  calls block in the proxy, so the client polls nothing.

Scope matches the reference's client mode: the core API, not the
data-plane extras (Serve handles/compiled DAGs talk worker-to-worker
and need cluster-side execution). Pickled payloads mean the proxy
trusts its clients exactly as much as the reference's does.

Where the port differs: a client holds no GPU lease, whatever cards its
machine has. The proxy hands `get` the object's stored record unopened
(it never loads a client's value, so it rebuilds no CUDA tensor), and
the client loads it with CUDA refused: a CUDA tensor's `get` raises
GpuLeaseRequiredError naming the object, as a host task's does, and
never comes back as a CPU tensor. A client stages its own runtime_env
(working_dir, py_modules, wheels) into the conductor's KV through the
proxy.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from . import exceptions as exc
from ._private import serialization
from ._private.rpc import RemoteError, RpcClient, RpcServer

_MARKER = "__ray_tpu_torch_client_ref__"
SESSION_IDLE_TIMEOUT_S = 600.0


# --------------------------------------------------------------- server


class _Session:
    def __init__(self):
        self.refs: Dict[str, Any] = {}        # id -> ObjectRef (pins)
        self.last_active = time.monotonic()


class ClientProxyHandler:
    """RPC surface of the proxy. Every method takes the session id
    first; unknown sessions are (re)created on the fly so a proxy
    restart degrades to lost pins, not broken clients."""

    def __init__(self, worker):
        self.w = worker                        # server-side driver Worker
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()

    # -- session plumbing --------------------------------------------------
    def _session(self, sid: str) -> _Session:
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                s = self._sessions[sid] = _Session()
            s.last_active = time.monotonic()
            return s

    def reap_idle(self, timeout_s: float = SESSION_IDLE_TIMEOUT_S) -> int:
        now = time.monotonic()
        with self._lock:
            dead = [sid for sid, s in self._sessions.items()
                    if now - s.last_active > timeout_s]
            for sid in dead:
                del self._sessions[sid]
        return len(dead)

    def client_connect(self, sid: str) -> Dict[str, Any]:
        self._session(sid)
        return {"conductor": list(self.w.conductor_address)}

    def client_disconnect(self, sid: str) -> None:
        with self._lock:
            self._sessions.pop(sid, None)

    # -- ref marshalling ---------------------------------------------------
    def _pin(self, s: _Session, ref) -> Dict[str, Any]:
        s.refs[ref.id] = ref
        return {_MARKER: ref.id}

    def _unpin_swap(self, s: _Session, x: Any) -> Any:
        """Client arg structures carry {_MARKER: id} where they held a
        ClientObjectRef; swap back to the pinned real ref."""
        if isinstance(x, dict):
            if set(x.keys()) == {_MARKER}:
                ref = s.refs.get(x[_MARKER])
                if ref is None:
                    raise exc.ObjectLostError(
                        x[_MARKER], "client ref unknown to this session "
                        "(proxy restarted?)")
                return ref
            return {k: self._unpin_swap(s, v) for k, v in x.items()}
        if isinstance(x, list):
            return [self._unpin_swap(s, v) for v in x]
        if isinstance(x, tuple):
            return tuple(self._unpin_swap(s, v) for v in x)
        return x

    # -- data plane --------------------------------------------------------
    def client_put(self, sid: str, value: Any) -> Dict[str, Any]:
        s = self._session(sid)
        return self._pin(s, self.w.put(value))

    def client_get(self, sid: str, ids: List[str],
                   timeout: Optional[float]) -> List[Tuple[bytes, list]]:
        """Each object's stored record (meta, buffers), unopened: the
        client loads it (see the module docstring)."""
        s = self._session(sid)
        refs = []
        for oid in ids:
            ref = s.refs.get(oid)
            if ref is None:
                raise exc.ObjectLostError(oid, "unknown client ref")
            refs.append(ref)
        return self.w.get_records(refs, timeout=timeout)

    def client_wait(self, sid: str, ids: List[str], num_returns: int,
                    timeout: Optional[float]) -> Tuple[List[str], List[str]]:
        s = self._session(sid)
        refs = [s.refs[oid] for oid in ids]
        ready, not_ready = self.w.wait(refs, num_returns=num_returns,
                                       timeout=timeout)
        return [r.id for r in ready], [r.id for r in not_ready]

    def client_release(self, sid: str, ids: List[str]) -> None:
        s = self._session(sid)
        for oid in ids:
            s.refs.pop(oid, None)

    # -- submission --------------------------------------------------------
    def client_task(self, sid: str, fn_bytes: bytes, args, kwargs,
                    options: Dict[str, Any]):
        s = self._session(sid)
        fn = serialization.loads(fn_bytes)
        args = self._unpin_swap(s, tuple(args))
        kwargs = self._unpin_swap(s, dict(kwargs))
        out = self.w.submit_task(fn, args, kwargs, **options)
        refs = out if isinstance(out, list) else [out]
        wired = [self._pin(s, r) for r in refs]
        return wired if isinstance(out, list) else wired[0]

    def client_create_actor(self, sid: str, cls_bytes: bytes, args, kwargs,
                            options: Dict[str, Any]) -> Dict[str, Any]:
        s = self._session(sid)
        cls = serialization.loads(cls_bytes)
        args = self._unpin_swap(s, tuple(args))
        kwargs = self._unpin_swap(s, dict(kwargs))
        return self.w.create_actor(cls, args, kwargs, options)

    def client_actor_task(self, sid: str, actor_id: str, address, method,
                          args, kwargs, num_returns: int, seqno: int,
                          caller_id: str, max_task_retries: int):
        s = self._session(sid)
        args = self._unpin_swap(s, tuple(args))
        kwargs = self._unpin_swap(s, dict(kwargs))
        out = self.w.submit_actor_task(
            actor_id, tuple(address), method, args, kwargs, num_returns,
            seqno, caller_id, max_task_retries=max_task_retries)
        refs = out if isinstance(out, list) else [out]
        wired = [self._pin(s, r) for r in refs]
        return wired if isinstance(out, list) else wired[0]

    def client_cancel(self, sid: str, oid: str, force: bool) -> None:
        s = self._session(sid)
        ref = s.refs.get(oid)
        if ref is not None:
            self.w.cancel(ref, force=force)

    # -- control-plane passthrough ----------------------------------------
    def client_conductor(self, sid: str, method: str, args, kwargs):
        self._session(sid)
        return self.w.conductor.call(method, *args, timeout=60.0, **kwargs)


class ClientProxy:
    """Hosts a ClientProxyHandler on its own RpcServer next to the
    head (reference: the ray client server the head starts on :10001)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 10001):
        from ._private.worker import global_worker

        if global_worker is None:
            raise RuntimeError("start the proxy inside an initialized "
                               "cluster (ray_tpu_torch.init first)")
        self.handler = ClientProxyHandler(global_worker)
        self.server = RpcServer(self.handler, host=host, port=port,
                                max_workers=64).start()
        self._stopped = threading.Event()
        threading.Thread(target=self._reap_loop, daemon=True,
                         name="client-proxy-reap").start()

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def _reap_loop(self) -> None:
        while not self._stopped.wait(30.0):
            try:
                self.handler.reap_idle()
            except Exception:  # noqa: BLE001
                pass

    def stop(self) -> None:
        self._stopped.set()
        self.server.stop()


# --------------------------------------------------------------- client


class ClientObjectRef:
    """Opaque handle to an object pinned in the proxy session."""

    __slots__ = ("id", "_client")

    def __init__(self, id: str, client: "ClientWorker"):
        self.id = id
        self._client = client

    def __repr__(self):
        return f"ClientObjectRef({self.id[:12]}…)"

    def __del__(self):
        c = self._client
        if c is not None and not c._closed:
            c._release_later(self.id)


def _wire_ref(x: Any) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {_MARKER}


class _ConductorShim:
    def __init__(self, client: "ClientWorker"):
        self._c = client

    def call(self, method: str, *args, timeout: Optional[float] = None,
             **kwargs):
        return self._c._call("client_conductor", method, list(args), kwargs)

    def notify(self, method: str, *args, **kwargs) -> None:
        self.call(method, *args, **kwargs)


class ClientWorker:
    """global_worker stand-in for ray:// mode — same duck-typed surface
    the public API uses, every operation forwarded to the proxy."""

    mode = "client"

    def __init__(self, address: Tuple[str, int]):
        self._rpc = RpcClient(tuple(address), connect_retries=5)
        self.session_id = uuid.uuid4().hex
        self._closed = False
        self._pending_release: List[str] = []
        self._release_lock = threading.Lock()
        self._last_release_flush = time.monotonic()
        info = self._call("client_connect")
        self.conductor_address = tuple(info["conductor"])
        self.conductor = _ConductorShim(self)
        serialization.refuse_cuda_loads(True)

    # -- plumbing ----------------------------------------------------------
    def _call(self, method: str, *args):
        # Piggyback pending releases on session traffic every few seconds
        # regardless of batch size.
        if (self._pending_release
                and time.monotonic() - self._last_release_flush > 3.0):
            self._flush_releases()
        try:
            return self._rpc.call(method, self.session_id, *args,
                                  timeout=None)
        except RemoteError as e:
            raise e.cause if isinstance(e.cause, exc.RayTpuError) else e \
                from None

    def _release_later(self, oid: str) -> None:
        with self._release_lock:
            self._pending_release.append(oid)
        # Size-triggered flush; _flush_releases also runs time-based from
        # _call so a slow-dropping session cannot pin objects server-side
        # behind the 100-entry batch threshold indefinitely.
        self._flush_releases(min_batch=100)

    def _flush_releases(self, min_batch: int = 1) -> None:
        with self._release_lock:
            if len(self._pending_release) < min_batch:
                return
            batch, self._pending_release = self._pending_release, []
            self._last_release_flush = time.monotonic()
        try:
            self._rpc.notify("client_release", self.session_id, batch)
        except Exception:  # noqa: BLE001 — reaper will collect
            pass

    def _swap_out(self, x: Any) -> Any:
        if isinstance(x, ClientObjectRef):
            return {_MARKER: x.id}
        if isinstance(x, list):
            return [self._swap_out(v) for v in x]
        if isinstance(x, tuple):
            return tuple(self._swap_out(v) for v in x)
        if isinstance(x, dict):
            return {k: self._swap_out(v) for k, v in x.items()}
        return x

    def _wrap(self, wired):
        if isinstance(wired, list):
            return [self._wrap(w) for w in wired]
        return ClientObjectRef(wired[_MARKER], self)

    # -- public surface (mirrors Worker) ----------------------------------
    def put(self, value: Any) -> ClientObjectRef:
        return self._wrap(self._call("client_put", value))

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ClientObjectRef):
                raise TypeError(f"get() expects ClientObjectRef, got "
                                f"{type(r)}")
        records = self._call("client_get", [r.id for r in ref_list],
                             timeout)
        out = [self._load(r.id, meta, bufs)
               for r, (meta, bufs) in zip(ref_list, records)]
        return out[0] if single else out

    @staticmethod
    def _load(oid: str, meta: bytes, bufs: list) -> Any:
        try:
            value = serialization.deserialize(
                meta, [memoryview(b) for b in bufs])
        except serialization.GpuLeaseRequiredError as err:
            raise serialization.GpuLeaseRequiredError(
                f"object {oid}: {err}") from None
        if isinstance(value, exc.RayTpuError):
            raise value
        return value

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        by_id = {r.id: r for r in refs}
        ready, not_ready = self._call(
            "client_wait", [r.id for r in refs], num_returns, timeout)
        return [by_id[i] for i in ready], [by_id[i] for i in not_ready]

    def _staged(self, options: Dict[str, Any]) -> Dict[str, Any]:
        """`options` with its runtime_env staged from THIS machine."""
        options = dict(options)
        if options.get("runtime_env"):
            from ._private import runtime_env as renv

            options["runtime_env"] = renv.prepare(self.conductor,
                                                  options["runtime_env"])
        return options

    def submit_task(self, fn, args, kwargs, **options):
        options = self._staged(options)
        options.pop("fn_bytes", None)  # the proxy serializes `fn` anew
        wired = self._call(
            "client_task", serialization.dumps(fn),
            self._swap_out(tuple(args)), self._swap_out(dict(kwargs)),
            options)
        return self._wrap(wired)

    def create_actor(self, cls, args, kwargs, options: Dict[str, Any]):
        return self._call(
            "client_create_actor", serialization.dumps(cls),
            self._swap_out(tuple(args)), self._swap_out(dict(kwargs)),
            self._staged(options))

    def submit_actor_task(self, actor_id, address, method, args, kwargs,
                          num_returns, seqno, caller_id,
                          max_task_retries: int = 0):
        wired = self._call(
            "client_actor_task", actor_id, list(address or ()), method,
            self._swap_out(tuple(args)), self._swap_out(dict(kwargs)),
            num_returns, seqno, caller_id, max_task_retries)
        return self._wrap(wired)

    def cancel(self, ref, force: bool = False) -> None:
        self._call("client_cancel", ref.id, bool(force))

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        serialization.refuse_cuda_loads(False)
        self._flush_releases()
        try:
            self._rpc.call("client_disconnect", self.session_id,
                           timeout=5.0)
        except Exception:  # noqa: BLE001 — proxy may be gone
            pass
        self._rpc.close()


def connect(address: str) -> ClientWorker:
    """Connect to a ClientProxy; `address` is 'host:port' (the ray://
    prefix is stripped by ray_tpu_torch.init)."""
    host, port = address.rsplit(":", 1)
    return ClientWorker((host, int(port)))
