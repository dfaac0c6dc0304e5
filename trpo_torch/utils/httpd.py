"""Shared stdlib HTTP plumbing for the in-process endpoints (counterpart:
``trpo_tpu/utils/httpd.py``, copied: it imports only the standard
library).

The policy-inference front end (``serve/server.PolicyServer``) and, in
the reference, the introspection endpoint serve HTTP out of a
training/serving process. Both need the same non-negotiables, factored
here so the contracts stay in ONE place:

* **ThreadingHTTPServer on a daemon thread** — a hung client never
  blocks interpreter exit, and serving never runs on the training or
  batching thread.
* **Silenced ``log_message``/``handle_error``** — scrapes and dropped
  connections (``curl | head``, a scraper timing out mid-response) must
  not spray the console; a broken pipe in ``wfile.write`` is the
  CLIENT's problem.
* **``allow_reuse_address``** — a relaunched run must rebind the same
  port immediately (TIME_WAIT would otherwise hold it for minutes).
* **Port 0 = ephemeral** — the OS picks; the bound port is exposed as
  ``.port`` so callers can print/announce it.

Handlers are plain callables returning ``(status, content_type,
body_bytes)``: GET handlers take no arguments, POST handlers take the
raw request body. A handler raising is a bug in the handler, but it
must degrade to a 500 for THAT request — never kill the server thread
or traceback onto the console (same silence contract as above).

Dynamic paths (the serving tier's session protocol routes by id:
``POST /session/<id>/act``) use ``post_prefix``: ``{prefix:
fn(path, body)}`` — consulted only after the exact tables miss, longest
prefix wins, and the handler receives the FULL path so it can parse the
dynamic segment itself.

Request headers (trace propagation): handlers keep their
zero-argument / ``(body)`` signatures; a handler that needs the
incoming headers (the tracing layer reading ``X-Trace-Id``) calls
:func:`request_headers`, which returns the CURRENT request's header
mapping from a thread-local the dispatcher sets around every handler
invocation (handlers run on the per-connection handler thread, so the
thread-local is exact). Outside a handler it returns ``None``.

Two more pieces. (1) **Unix-domain-socket listeners**
(``uds_path=``): the same routes answered on an ``AF_UNIX`` socket
next to the TCP port — the router's same-host hop skips the TCP stack
(no Nagle, no delayed ACK, no conntrack) while cross-host hops stay
TCP. The UDS listener keeps the data-plane socket settings that ARE
meaningful off-TCP (backlog 128, non-inheritable/close-on-exec fds)
and drops the one that is not (``TCP_NODELAY`` — setting it on an
AF_UNIX socket raises). (2) :class:`AsyncBackgroundServer`: a
single-event-loop HTTP/1.1 server for the router's data plane —
connections are coroutines, not threads, so a thousand keep-alive
clients cost a thousand small state machines instead of a thousand
stacks + GIL handoffs. Exact-table sync handlers keep working (they
run on a small executor with the same :func:`request_headers`
contract); the hot paths register **async** handlers that run ON the
loop (``async fn(path, body, headers)``), where the router's
loop-owned connection pools live.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import http.server
import os
import socket
import socketserver
import threading
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "BackgroundHTTPServer",
    "AsyncBackgroundServer",
    "request_headers",
]

_tls = threading.local()


def request_headers():
    """The in-flight request's headers (``.get(name)``-able,
    case-insensitive) while called from inside an HTTP handler on this
    server; ``None`` anywhere else."""
    return getattr(_tls, "headers", None)

# handler return type: (status_code, content_type, body)
Response = Tuple[int, str, bytes]


UDS_PATH_MAX = 107


def check_uds_path(path: str) -> str:
    """``path`` if it fits ``sockaddr_un`` (107 bytes and a NUL), else a
    ``ValueError`` naming it: a path under a deep temporary directory with
    a replica suffix can pass the limit, and the hop must then fail
    loudly, never fall back to TCP."""
    if len(os.fsencode(path)) > UDS_PATH_MAX:
        raise ValueError(
            f"Unix socket path {path!r} is {len(os.fsencode(path))} bytes; "
            f"AF_UNIX takes at most {UDS_PATH_MAX} — choose a shorter "
            "--uds-path")
    return path


def _cleanup_uds(path: str) -> None:
    """Unlink a stale socket file so a relaunched run can rebind — the
    AF_UNIX equivalent of ``allow_reuse_address`` (binding over an
    existing path raises EADDRINUSE even with no listener alive)."""
    try:
        if os.path.exists(path):
            os.unlink(path)
    except OSError:
        pass


class BackgroundHTTPServer:
    """A stdlib ``ThreadingHTTPServer`` on a background daemon thread,
    routing by exact path.

    ``get``: ``{path: fn() -> (status, ctype, body)}``;
    ``post``: ``{path: fn(body_bytes) -> (status, ctype, body)}``.
    Unknown paths get a 404 carrying ``not_found`` (which should name
    the paths that DO exist — the introspection endpoint's
    "have /status and /metrics" idiom). ``max_body_bytes`` bounds POST
    bodies: an oversized request is refused with 413 before the read,
    so a hostile client cannot balloon the handler thread's memory.

    ``uds_path`` additionally binds the SAME routes on an AF_UNIX
    socket (its own acceptor thread; handlers are shared), exposed as
    ``.uds_path`` so a replica can advertise it for same-host dials.
    """

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        get: Optional[Dict[str, Callable[[], Response]]] = None,
        post: Optional[Dict[str, Callable[[bytes], Response]]] = None,
        post_prefix: Optional[
            Dict[str, Callable[[str, bytes], Response]]
        ] = None,
        not_found: str = "unknown path",
        thread_name: str = "httpd",
        max_body_bytes: int = 1 << 20,
        uds_path: Optional[str] = None,
    ):
        if uds_path:
            check_uds_path(uds_path)
        get_routes = dict(get or {})
        post_routes = dict(post or {})
        # longest prefix first, so "/session/" can coexist with a more
        # specific prefix without registration-order surprises
        prefix_routes = sorted(
            (post_prefix or {}).items(), key=lambda kv: -len(kv[0])
        )
        # which listener served each routed request: the
        # replica's /metrics proves same-host traffic actually moved
        # off TCP instead of silently falling back
        self.transport_requests_total = {"tcp": 0, "uds": 0}
        counter_lock = threading.Lock()

        def _respond(handler, status: int, ctype: str, body: bytes) -> None:
            handler.send_response(status)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)

        def _run(handler, fn, *args) -> None:
            with counter_lock:
                self.transport_requests_total[handler.via] += 1
            _tls.headers = handler.headers  # request_headers() scope
            try:
                status, ctype, body = fn(*args)
            except Exception as e:  # a handler bug degrades to a 500 for
                # THIS request; the server thread and console stay clean
                status, ctype = 500, "text/plain; charset=utf-8"
                body = f"internal error: {type(e).__name__}".encode()
            finally:
                _tls.headers = None
            _respond(handler, status, ctype, body)

        class _Handler(http.server.BaseHTTPRequestHandler):
            # HTTP/1.1: connections persist across requests (every
            # response here carries Content-Length, so framing is
            # sound). A data plane dies by per-request connection
            # setup — a fresh TCP handshake plus a fresh handler
            # THREAD per request (ThreadingHTTPServer spawns per
            # CONNECTION) costs more than a small model's inference;
            # keep-alive amortizes both across a client's whole run.
            protocol_version = "HTTP/1.1"
            via = "tcp"  # which listener family served this request
            # TCP_NODELAY: a small JSON response held back by Nagle
            # waiting on the peer's delayed ACK adds ~40 ms to a
            # millisecond-scale request; inference traffic is
            # latency-bound, never bandwidth-bound
            disable_nagle_algorithm = True

            def do_GET(handler):  # noqa: N805 — handler, not self
                path = handler.path.split("?", 1)[0]
                fn = get_routes.get(path)
                if fn is None:
                    handler.send_error(404, not_found)
                    return
                _run(handler, fn)

            def do_POST(handler):  # noqa: N805
                path = handler.path.split("?", 1)[0]
                fn = post_routes.get(path)
                args = ()
                if fn is None:
                    for prefix, pfn in prefix_routes:
                        if path.startswith(prefix):
                            fn, args = pfn, (path,)
                            break
                if fn is None:
                    handler.send_error(404, not_found)
                    return
                try:
                    length = int(handler.headers.get("Content-Length", 0))
                except ValueError:
                    length = -1
                if length < 0 or length > max_body_bytes:
                    handler.send_error(413, "request body too large")
                    return
                body = handler.rfile.read(length) if length else b""
                _run(handler, fn, *args, body)

            def log_message(handler, *args):  # noqa: N805
                pass  # requests must not spray the owning console

        class _UdsHandler(_Handler):
            via = "uds"
            # TCP_NODELAY does not exist on AF_UNIX — setting it
            # raises; Nagle never applied either, so nothing is lost
            disable_nagle_algorithm = False

            def address_string(handler):  # noqa: N805 — AF_UNIX peers
                return "uds"        # have no (host, port) to render

        class _Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            # a relaunched run must be able to rebind the same port
            # immediately (TIME_WAIT would otherwise hold it for minutes)
            allow_reuse_address = True
            # the stdlib default listen backlog is 5: a burst of
            # concurrent clients dialing at once overflows it and the
            # dropped SYNs retransmit after ~1 s — a whole second of
            # connect stall that reads as a p99 cliff. Size the backlog
            # for a data plane, not a debug endpoint.
            request_queue_size = 128

            def __init__(server, *args, **kw):  # noqa: N805
                super().__init__(*args, **kw)
                # live accepted sockets: keep-alive means a connection
                # outlives any one request, and close() must sever them
                # — a closed server still answering on old keep-alive
                # conns (with its components torn down) would look
                # ALIVE to a pooled client, where a real process death
                # looks like a dropped socket
                server._active = set()
                server._active_lock = threading.Lock()

            def process_request(server, request, client_address):  # noqa: N805
                with server._active_lock:
                    server._active.add(request)
                super().process_request(request, client_address)

            def shutdown_request(server, request):  # noqa: N805
                with server._active_lock:
                    server._active.discard(request)
                super().shutdown_request(request)

            def close_active(server) -> None:  # noqa: N805
                with server._active_lock:
                    conns = list(server._active)
                for sock in conns:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

            def handle_error(server, request, client_address):  # noqa: N805
                # a client dropping the connection mid-response raises in
                # wfile.write; the default handler tracebacks onto the
                # console — same silence contract as log_message above
                pass

        class _UdsServer(_Server):
            address_family = socket.AF_UNIX
            allow_reuse_address = False  # meaningless on AF_UNIX — the
            #                              stale path is unlinked instead

            def server_bind(server):  # noqa: N805
                # HTTPServer.server_bind assumes (host, port) — on
                # AF_UNIX the address is a PATH; bind at the TCPServer
                # layer and fill the name fields by hand. The listen fd
                # stays non-inheritable (close-on-exec): a launched
                # replica subprocess must not hold its parent's listener
                # open past exec (PEP 446 default, asserted here so a
                # future stdlib change fails loudly, not silently).
                socketserver.TCPServer.server_bind(server)
                assert not server.socket.get_inheritable()
                server.server_name = "localhost"
                server.server_port = 0

            def get_request(server):  # noqa: N805 — an AF_UNIX accept
                # returns '' as the peer address; BaseHTTPRequestHandler
                # indexes client_address[0] in log helpers, so shape it
                request, _ = server.socket.accept()
                return request, ("uds", 0)

        self._httpd = _Server((host, port), _Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=thread_name,
            daemon=True,
        )
        self._thread.start()

        self.uds_path: Optional[str] = None
        self._uds_httpd = None
        self._uds_thread = None
        if uds_path:
            _cleanup_uds(uds_path)
            self._uds_httpd = _UdsServer(uds_path, _UdsHandler)
            self.uds_path = uds_path
            self._uds_thread = threading.Thread(
                target=self._uds_httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name=f"{thread_name}-uds",
                daemon=True,
            )
            self._uds_thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        # sever surviving keep-alive connections: to a pooled client a
        # closed server must look exactly like a dead one (dropped
        # socket), never a live one answering with torn-down components
        httpd.close_active()
        httpd.server_close()
        self._thread.join(timeout=5.0)
        if self._uds_httpd is not None:
            self._uds_httpd.shutdown()
            self._uds_httpd.close_active()
            self._uds_httpd.server_close()
            self._uds_thread.join(timeout=5.0)
            if self.uds_path:
                _cleanup_uds(self.uds_path)


class _CIHeaders(dict):
    """Case-insensitive ``.get`` over lower-cased keys — the shape
    every trace/negotiation consumer already relies on (stdlib
    ``email.message.Message`` is case-insensitive too)."""

    def get(self, name, default=None):  # noqa: A003
        return super().get(name.lower(), default)


class AsyncBackgroundServer:
    """A single-event-loop HTTP/1.1 server on a daemon thread — the
    asyncio half of the serving data plane.

    Route tables match :class:`BackgroundHTTPServer` (``get``/``post``/
    ``post_prefix`` of SYNC handlers — they run on a bounded executor
    with the :func:`request_headers` thread-local set, so existing
    control-plane handlers port unchanged), plus ``async_post`` /
    ``async_post_prefix``: ``async fn(path, body, headers) -> (status,
    ctype, body)`` coroutines that run ON the loop — the hot path.
    The owning loop is exposed as ``.loop`` so the router can park its
    connection pools there.

    Listens on TCP (``port``, 0 = ephemeral) and optionally the same
    routes on an AF_UNIX path (``uds_path``) — both acceptors are
    plain asyncio servers with backlog 128; every response carries
    ``Content-Length``, connections are keep-alive by default and
    honor ``Connection: close``.
    """

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        get: Optional[Dict[str, Callable[[], Response]]] = None,
        post: Optional[Dict[str, Callable[[bytes], Response]]] = None,
        post_prefix: Optional[
            Dict[str, Callable[[str, bytes], Response]]
        ] = None,
        async_post: Optional[Dict[str, Callable]] = None,
        async_post_prefix: Optional[Dict[str, Callable]] = None,
        not_found: str = "unknown path",
        thread_name: str = "ahttpd",
        max_body_bytes: int = 1 << 20,
        uds_path: Optional[str] = None,
        executor_workers: int = 8,
    ):
        if uds_path:
            check_uds_path(uds_path)
        self._get = dict(get or {})
        self._post = dict(post or {})
        self._post_prefix = sorted(
            (post_prefix or {}).items(), key=lambda kv: -len(kv[0])
        )
        self._apost = dict(async_post or {})
        self._apost_prefix = sorted(
            (async_post_prefix or {}).items(), key=lambda kv: -len(kv[0])
        )
        self._not_found = not_found
        self._max_body = int(max_body_bytes)
        # loop-owned (incremented only from connection coroutines), so
        # no lock — same listener-family accounting as the threaded
        # server's counters
        self.transport_requests_total = {"tcp": 0, "uds": 0}
        self.host = host
        self.uds_path: Optional[str] = None
        self._want_uds = uds_path
        # sync (control-plane) handlers run here — bounded, so a stuck
        # handler can exhaust the executor but never the loop
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=executor_workers,
            thread_name_prefix=f"{thread_name}-h",
        )
        self.loop = asyncio.new_event_loop()
        self._servers: list = []
        started = threading.Event()
        boot_err: list = []

        async def _boot():
            try:
                srv = await asyncio.start_server(
                    self._serve_conn, host, port, backlog=128
                )
                self._servers.append(srv)
                self.port = int(srv.sockets[0].getsockname()[1])
                if uds_path:
                    _cleanup_uds(uds_path)
                    usrv = await asyncio.start_unix_server(
                        self._serve_conn, path=uds_path, backlog=128
                    )
                    # close-on-exec audit (PEP 446 default, pinned)
                    assert not usrv.sockets[0].get_inheritable()
                    self._servers.append(usrv)
                    self.uds_path = uds_path
            except Exception as e:  # surface bind errors to the caller
                boot_err.append(e)
            finally:
                started.set()

        loop = self.loop

        def _run_loop():
            asyncio.set_event_loop(loop)
            loop.create_task(_boot())
            loop.run_forever()
            # drain callbacks scheduled during shutdown, then close
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

        self._thread = threading.Thread(
            target=_run_loop, name=thread_name, daemon=True
        )
        self._thread.start()
        started.wait(timeout=30.0)
        if boot_err:
            self.close()
            raise boot_err[0]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- per-connection coroutine -----------------------------------------

    async def _serve_conn(self, reader, writer) -> None:
        sock = writer.get_extra_info("socket")
        via = (
            "uds"
            if sock is not None and sock.family == socket.AF_UNIX
            else "tcp"
        )
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, _version = (
                        line.decode("latin-1").rstrip("\r\n").split(" ", 2)
                    )
                except ValueError:
                    return  # unparseable request line: drop the conn
                headers = _CIHeaders()
                while True:
                    hline = await reader.readline()
                    if hline in (b"\r\n", b"\n", b""):
                        break
                    if len(headers) > 100:
                        return
                    name, _, value = (
                        hline.decode("latin-1").partition(":")
                    )
                    headers[name.strip().lower()] = value.strip()
                try:
                    length = int(headers.get("Content-Length") or 0)
                except ValueError:
                    length = -1
                if length < 0 or length > self._max_body:
                    await self._write_response(
                        writer, 413, "text/plain; charset=utf-8",
                        b"request body too large", close=True,
                    )
                    return
                body = (
                    await reader.readexactly(length) if length else b""
                )
                path = target.split("?", 1)[0]
                self.transport_requests_total[via] += 1
                status, ctype, out = await self._handle(
                    method, path, body, headers
                )
                close = (
                    (headers.get("Connection") or "").lower() == "close"
                )
                await self._write_response(
                    writer, status, ctype, out, close=close
                )
                if close:
                    return
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
        ):
            return  # a dropped client is the client's problem
        except Exception:
            return  # never let one connection's bug spray the console
        finally:
            try:
                writer.close()
            except Exception:
                pass

    _REASONS = {
        200: "OK", 400: "Bad Request", 404: "Not Found",
        409: "Conflict", 413: "Payload Too Large", 429: "Too Many "
        "Requests", 500: "Internal Server Error", 502: "Bad Gateway",
        503: "Service Unavailable", 504: "Gateway Timeout",
    }

    async def _write_response(
        self, writer, status: int, ctype: str, body: bytes,
        close: bool = False,
    ) -> None:
        reason = self._REASONS.get(status, "Unknown")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{'Connection: close' + chr(13) + chr(10) if close else ''}"
            "\r\n"
        ).encode("latin-1")
        writer.write(head + body)
        await writer.drain()

    async def _handle(self, method, path, body, headers):
        try:
            if method == "POST":
                afn = self._apost.get(path)
                if afn is None:
                    for prefix, pfn in self._apost_prefix:
                        if path.startswith(prefix):
                            afn = pfn
                            break
                if afn is not None:
                    try:
                        return await afn(path, body, headers)
                    except Exception as e:
                        return (
                            500, "text/plain; charset=utf-8",
                            f"internal error: {type(e).__name__}".encode(),
                        )
                fn = self._post.get(path)
                args = (body,)
                if fn is None:
                    for prefix, pfn in self._post_prefix:
                        if path.startswith(prefix):
                            fn, args = pfn, (path, body)
                            break
                if fn is not None:
                    return await self._run_sync(fn, args, headers)
            elif method == "GET":
                fn = self._get.get(path)
                if fn is not None:
                    return await self._run_sync(fn, (), headers)
            return (
                404, "text/plain; charset=utf-8",
                self._not_found.encode(),
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            return (
                500, "text/plain; charset=utf-8",
                f"internal error: {type(e).__name__}".encode(),
            )

    async def _run_sync(self, fn, args, headers):
        """A sync handler on the executor, with the
        :func:`request_headers` thread-local set for its duration —
        the exact contract the threaded server gives it."""

        def _call():
            _tls.headers = headers
            try:
                return fn(*args)
            except Exception as e:
                return (
                    500, "text/plain; charset=utf-8",
                    f"internal error: {type(e).__name__}".encode(),
                )
            finally:
                _tls.headers = None

        return await self.loop.run_in_executor(self._executor, _call)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        loop, self.loop = self.loop, None
        if loop is None:
            return

        def _stop():
            for srv in self._servers:
                srv.close()
            # cancel the per-connection coroutines so their finally
            # blocks close the sockets — same closed-looks-dead
            # contract as the threaded server's close_active
            for task in asyncio.all_tasks(loop):
                task.cancel()
            loop.call_soon(loop.stop)

        try:
            loop.call_soon_threadsafe(_stop)
        except RuntimeError:
            pass  # loop already gone
        self._thread.join(timeout=5.0)
        self._executor.shutdown(wait=False)
        if self.uds_path:
            _cleanup_uds(self.uds_path)
