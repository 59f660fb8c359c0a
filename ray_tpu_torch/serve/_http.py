"""The HTTP/1.1 server layer of the port's serving front doors, on the
standard library's asyncio streams: the gateway (serve/gateway.py) and
the serve proxy (serve/proxy.py) both answer on it, where the JAX package
runs each on aiohttp.

`HttpServer` runs one event loop on a thread of its own and hands every
parsed request to an async `dispatch(request)`, which returns a
`_Response` (sent with Content-Length), a `_StreamResponse` it has
written itself (chunked transfer encoding), or `_CLOSED` when the
transport is gone. It reads a body by `Content-Length` only (over the
server's `max_body`: 413, refused before it is read; a
`Transfer-Encoding` body: 501), serves sequential requests on a
keep-alive connection, and stamps ``X-Request-Id`` on every whole
response.

A client that went away is seen by a task that reads the connection
while a response is pending (`_Conn.watch`: EOF or a reset), or by a
write that fails (`_CLIENT_GONE`). A watcher must be cancelled and
awaited (`_stop`) before the parser reads again: a StreamReader takes
one reader at a time.
"""
from __future__ import annotations

import asyncio
import email.utils
import http
import json
import logging
import threading
import uuid
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

_log = logging.getLogger(__name__)

# write failures that mean "the client went away", not "we broke"
_CLIENT_GONE = (ConnectionResetError, ConnectionAbortedError,
                BrokenPipeError)

_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"
_MAX_LINE = 64 * 1024
_MAX_HEADERS = 128


class _BadRequest(Exception):
    """A request the parser refuses: answered with `status` and `text`,
    then the connection closes."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


class _Headers:
    """Request headers, looked up without regard to case; `items()`
    gives them as the client sent them."""

    def __init__(self, items: List[Tuple[str, str]]):
        self._items = list(items)
        self._d = {k.lower(): v for k, v in items}

    def get(self, key: str, default: Optional[str] = None
            ) -> Optional[str]:
        return self._d.get(key.lower(), default)

    def items(self) -> List[Tuple[str, str]]:
        return list(self._items)


class _Conn:
    """One client connection. Every read goes through `_fill`, which
    appends to a buffer the parser consumes; a watcher task (`watch`)
    reads the same way while a response is pending, so EOF or a reset
    marks the connection gone and bytes a client sends early stay for
    the next request."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.buf = bytearray()
        self.gone = False
        self._on_gone: List[Any] = []

    async def _fill(self) -> bool:
        """Read more into the buffer; False at EOF or on a reset."""
        try:
            data = await self.reader.read(65536)
        except (ConnectionError, OSError):
            data = b""
        if not data:
            self._mark_gone()
            return False
        self.buf += data
        return True

    def _mark_gone(self) -> None:
        if self.gone:
            return
        self.gone = True
        for fn in self._on_gone:
            fn()

    def on_gone(self, fn) -> None:
        """Call `fn` (on the loop) once the client is gone; at once if it
        already is. Held until `clear_on_gone` (each request's end)."""
        if self.gone:
            fn()
        else:
            self._on_gone.append(fn)

    def clear_on_gone(self) -> None:
        self._on_gone.clear()

    async def readline(self) -> Optional[bytes]:
        """One CRLF-ended line without its ending; None at EOF before
        any byte of it."""
        while True:
            i = self.buf.find(b"\n")
            if i >= 0:
                line = bytes(self.buf[:i + 1])
                del self.buf[:i + 1]
                return line.rstrip(b"\r\n")
            if len(self.buf) > _MAX_LINE:
                raise _BadRequest(400, "Got more than 65536 bytes when "
                                       "reading a line")
            if not await self._fill():
                if self.buf:
                    raise _BadRequest(400, "incomplete request")
                return None

    async def readexactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self._fill():
                raise _BadRequest(400, "incomplete request body")
        data = bytes(self.buf[:n])
        del self.buf[:n]
        return data

    async def watch(self) -> None:
        """Read until the client goes (run while a response is pending,
        cancelled when it is written)."""
        while await self._fill():
            pass

    async def write(self, data: bytes) -> None:
        if self.writer.transport.is_closing():
            raise ConnectionResetError("client connection closed")
        self.writer.write(data)
        await self.writer.drain()

    def abort(self) -> None:
        self.writer.transport.abort()
        self._mark_gone()


class _Request:
    def __init__(self, conn: _Conn, method: str, path: str, version: str,
                 headers: _Headers, body: bytes, query_string: str = "",
                 server: str = ""):
        self.conn = conn
        self.method = method
        self.path = path
        self.version = version
        self.headers = headers
        self.body = body
        self.query_string = query_string
        self.server = server  # the Server header of this server's replies
        self.req_id: Optional[str] = None

    @property
    def keep_alive(self) -> bool:
        c = (self.headers.get("Connection") or "").lower()
        if self.version == "HTTP/1.0":
            return c == "keep-alive"
        return c != "close"


def _status_line(version: str, status: int) -> bytes:
    try:
        reason = http.HTTPStatus(status).phrase
    except ValueError:  # a status the standard library does not name
        reason = ""
    return f"{version} {status} {reason}\r\n".encode("latin-1")


def _header_block(headers: List[Tuple[str, str]]) -> bytes:
    return b"".join(f"{k}: {v}\r\n".encode("latin-1")
                    for k, v in headers) + b"\r\n"


class _Response:
    """A whole response, sent with Content-Length. `headers` is a dict,
    or a list of (name, value) pairs that keeps duplicates (several
    Set-Cookie); a Content-Type among them replaces `content_type`."""

    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = _JSON, headers: Any = None):
        self.body = body
        self.status = status
        self.pairs: List[Tuple[str, str]] = []
        if isinstance(headers, (list, tuple)):
            self.pairs = [(str(k), str(v)) for k, v in headers]
            self.headers: Dict[str, str] = {}
        else:
            self.headers = dict(headers or {})
        named = {k.lower() for k in self.headers} | \
            {k.lower() for k, _ in self.pairs}
        if "content-type" not in named:
            self.headers["Content-Type"] = content_type

    def encode(self, version: str, close: bool = False,
               server: str = "") -> bytes:
        hdrs = list(self.headers.items()) + self.pairs
        hdrs.append(("Content-Length", str(len(self.body))))
        hdrs.append(("Date", email.utils.formatdate(usegmt=True)))
        if server:
            hdrs.append(("Server", server))
        if close:
            hdrs.append(("Connection", "close"))
        return (_status_line(version, self.status) + _header_block(hdrs)
                + self.body)


def _json_response(obj: Any, status: int = 200,
                   headers: Optional[Dict[str, str]] = None) -> _Response:
    return _Response(json.dumps(obj).encode(), status, _JSON, headers)


def _text_response(text: str, status: int = 200,
                   headers: Optional[Dict[str, str]] = None) -> _Response:
    return _Response(text.encode(), status, _TEXT, headers)


class _StreamResponse:
    """A 200 streamed in chunked transfer encoding; its status line and
    headers go out with the first chunk (`prepare`)."""

    def __init__(self, request: _Request, headers: Dict[str, str]):
        self.request = request
        self.headers = dict(headers)
        self.prepared = False
        self.finished = False

    async def prepare(self) -> None:
        if self.prepared:
            return
        hdrs = list(self.headers.items())
        hdrs.append(("Transfer-Encoding", "chunked"))
        hdrs.append(("Date", email.utils.formatdate(usegmt=True)))
        if self.request.server:
            hdrs.append(("Server", self.request.server))
        self.prepared = True
        await self.request.conn.write(
            _status_line(self.request.version, 200) + _header_block(hdrs))

    async def write(self, data: bytes) -> None:
        await self.prepare()
        if not data:  # an empty chunk would end the body
            return
        await self.request.conn.write(
            f"{len(data):x}\r\n".encode() + data + b"\r\n")

    async def write_eof(self) -> None:
        await self.prepare()
        await self.request.conn.write(b"0\r\n\r\n")
        self.finished = True


async def _stop(task: "asyncio.Task") -> None:
    """Cancel a connection's watcher and wait until it has let go of the
    reader (a StreamReader takes one reader at a time)."""
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)


# connection-level outcomes a handler returns instead of a response
_CLOSED = object()   # the transport is gone (aborted, client left)

Dispatch = Callable[[_Request], Awaitable[Any]]


class HttpServer:
    """An HTTP/1.1 server on a thread and event loop of its own.
    `start()` spawns the thread; `wait_ready()` blocks until the socket
    is bound (a busy port is skipped, up to 20 ports on); `stop()`
    closes the listening socket and every open connection and joins
    the thread. `max_body` is read for each request."""

    def __init__(self, dispatch: Dispatch, host: str, port: int, *,
                 name: str, server: str, label: str,
                 max_body: Callable[[], int],
                 on_bound: Optional[Callable[[], None]] = None):
        self._dispatch = dispatch
        self._host = host
        self._port = port
        self._server = server
        self._label = label
        self._max_body = max_body
        self._on_bound = on_bound
        self.bound_port: Optional[int] = None
        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._shutdown = threading.Event()
        self._conns: set = set()
        self._thread = threading.Thread(target=self._serve_thread,
                                        daemon=True, name=name)

    def start(self) -> None:
        """Start serving. `dispatch` and `on_bound` may run from now on:
        the owner keeps the server where they find it first."""
        self._thread.start()

    def wait_ready(self, timeout: float, what: str) -> int:
        """The bound port; raises RuntimeError naming `what` if the
        server did not start within `timeout` seconds."""
        if not self._ready.wait(timeout=timeout) or self.bound_port is None:
            raise RuntimeError(f"{what} failed to start") \
                from self._start_error
        return self.bound_port

    def stop(self, timeout: float = 10.0) -> None:
        self._shutdown.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    async def _read_request(self, conn: _Conn) -> Optional[_Request]:
        """The next request on the connection; None at a clean EOF.
        Raises _BadRequest for what cannot be parsed or is too large."""
        line = await conn.readline()
        while line == b"":  # tolerate blank lines between requests
            line = await conn.readline()
        if line is None:
            return None
        parts = line.split()
        if len(parts) != 3 or not parts[2].startswith(b"HTTP/1."):
            raise _BadRequest(400, f"Invalid request line: {line[:100]!r}")
        method, target, version = (p.decode("latin-1") for p in parts)
        items: List[Tuple[str, str]] = []
        while True:
            h = await conn.readline()
            if h is None:
                raise _BadRequest(400, "incomplete request headers")
            if h == b"":
                break
            if len(items) >= _MAX_HEADERS or b":" not in h:
                raise _BadRequest(400, "Invalid request header")
            k, v = h.split(b":", 1)
            items.append((k.decode("latin-1").strip(),
                          v.decode("latin-1").strip()))
        headers = _Headers(items)
        path, _, query = target.partition("?")
        request = _Request(conn, method.upper(), path, version, headers,
                           b"", query, self._server)
        te = headers.get("Transfer-Encoding")
        if te:
            # a body is read by its Content-Length only
            raise _BadRequest(501, f"Transfer-Encoding {te!r} is not "
                                   f"supported")
        try:
            n = int(headers.get("Content-Length") or 0)
        except ValueError:
            raise _BadRequest(400, "Invalid Content-Length") from None
        if n < 0:
            raise _BadRequest(400, "Invalid Content-Length")
        limit = self._max_body()
        if n > limit:
            # aiohttp's text; refused before the body is read
            raise _BadRequest(
                413, f"Maximum request body size {limit} "
                     f"exceeded, actual body size {n}")
        request.body = await conn.readexactly(n) if n else b""
        return request

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        conn = _Conn(reader, writer)
        self._conns.add(conn)
        try:
            while not self._shutdown.is_set():
                try:
                    request = await self._read_request(conn)
                except _BadRequest as e:
                    resp = _text_response(e.text, status=e.status, headers={
                        "X-Request-Id": f"req-{uuid.uuid4().hex[:24]}"})
                    await conn.write(resp.encode("HTTP/1.1", close=True,
                                                 server=self._server))
                    break
                if request is None:
                    break
                keep = request.keep_alive
                try:
                    resp = await self._dispatch(request)
                except _CLIENT_GONE:
                    raise
                except Exception:  # noqa: BLE001 — a handler's bug: 500
                    _log.exception("%s: %s %s failed", self._label,
                                   request.method, request.path)
                    resp = _text_response(
                        "500 Internal Server Error\n\nServer got itself "
                        "in trouble", status=500)
                    keep = False
                finally:
                    conn.clear_on_gone()
                if resp is _CLOSED:
                    break
                if isinstance(resp, _StreamResponse):
                    if not (resp.finished and keep):
                        break
                    continue
                # every response carries X-Request-Id: the handler's id,
                # else a req- id
                if not any(k.lower() == "x-request-id" for k, _ in
                           list(resp.headers.items()) + resp.pairs):
                    resp.headers["X-Request-Id"] = \
                        request.req_id or f"req-{uuid.uuid4().hex[:24]}"
                await conn.write(resp.encode(
                    request.version,
                    close=not keep and request.version != "HTTP/1.0",
                    server=self._server))
                if not keep:
                    break
        except _CLIENT_GONE:
            pass
        finally:
            self._conns.discard(conn)
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — transport already gone
                pass

    def _serve_thread(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def run():
            port = self._port
            server = None
            for _attempt in range(20):  # skip ports already in use
                try:
                    server = await asyncio.start_server(
                        self._on_conn, self._host, port)
                    break
                except OSError:
                    if port == 0:  # an ephemeral bind cannot collide
                        raise
                    port += 1
            if server is None:
                raise RuntimeError(f"{self._label}: could not bind a port")
            try:
                if port == 0:
                    port = server.sockets[0].getsockname()[1]
                self.bound_port = port
                self._ready.set()
                if self._on_bound is not None:
                    self._on_bound()
                while not self._shutdown.is_set():
                    await asyncio.sleep(0.2)
            finally:
                # a server that stops, or fails, refuses new connections
                server.close()
            for conn in list(self._conns):
                conn.abort()
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            loop.run_until_complete(run())
        except BaseException as e:  # noqa: BLE001 — wait_ready raises it
            self._start_error = e
            self._ready.set()
        finally:
            loop.close()
