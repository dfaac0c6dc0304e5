"""Routing front end: one ``POST /act`` contract over N replicas
(counterpart: ``trpo_tpu/serve/router.py``).

The client-facing half of the replicated control plane
(``serve/replicaset.py`` is the supervision half). One :class:`Router`
owns the public port and dispatches to whichever replicas are in
rotation:

* **Least-queue-depth dispatch** — the router is the only client of its
  replicas, so the truthful queue depth is its own in-flight counter per
  replica: pick the healthy replica with the fewest outstanding requests
  (ties break by id). Reloading replicas are used only when no healthy
  one exists.
* **One transparent retry** — a TRANSPORT-level failure reports the
  replica to the supervisor (immediate eviction) and retries the request
  ONCE on a different replica; ``/act`` is a pure function of the
  snapshot and session acts are seq-deduped, so the retry never applies
  anything twice. A 5xx answer from an un-pinned replica also retries
  once elsewhere, with the original answer passed through when no second
  replica exists. Client errors (400, 409, 404) pass through untouched.
* **503 backpressure only when ALL replicas are saturated** — each
  replica carries at most ``max_inflight`` router-outstanding requests;
  a request finding every in-rotation replica at its bound (or rotation
  empty) answers 503 with ``Retry-After``.
* **Overload robustness** — a token-bucket **retry budget** (past it the
  retry is skipped, never queued); **deadline-aware admission** (a
  request declaring a ``deadline_ms`` that the recent p99 already
  exceeds gets an immediate typed 503 ``deadline_unmeetable``); and the
  **shed order**: under sustained saturation stateless traffic stops
  being admitted a headroom of slots before the hard bound, so session
  traffic sheds last.
* **Session affinity and lossless failover** (recurrent policies) —
  ``POST /session`` mints the id here, registers it on the least-loaded
  replica and pins it; ``POST /session/<id>/act`` follows the pin,
  stamped with a per-session ``seq``. When the pinned replica dies, the
  next act resumes the session from the dead replica's carry journal
  (``"resumed": true``), fencing the old journal against a zombie
  writer, and only without a journal entry re-establishes it from a
  fresh carry (``"reestablished": true``). :meth:`migrate_session` moves
  a session off a draining replica for the autoscaler.
* **Canary routing** — while a
  :class:`~trpo_torch.serve.replicaset.CanaryController` has a replica
  on an unvalidated checkpoint, the router sends it ``canary_fraction``
  of stateless traffic (a deterministic stride) and of session creates,
  and books client-reported episode returns per replica for the reward
  gate.
* ``GET /healthz``, ``GET /status`` (JSON) and ``GET /metrics``
  (Prometheus ``trpo_router_*``) aggregate the whole set.

Two cores: ``core="async"`` (the default) runs the front end on one
event loop (:class:`~trpo_torch.utils.httpd.AsyncBackgroundServer`),
with ``/act`` and ``/session/<id>/act`` as coroutines, replica
connections in loop-owned keep-alive pools, and same-host hops dialed
over the replica's Unix socket; the blocking tail of a session failover
runs on the server's executor. ``core="thread"`` is the
thread-per-request front end (:class:`BackgroundHTTPServer`). Both run
the same control-plane code.

Telemetry, as in the reference: with a ``bus`` every routed request is
a ``router`` ``scope="request"`` event (ms, ok, retried, replica, and the
trace id when the trace is emitted), each session failover or drain a
``session`` event (``resumed``/``reestablished``/``drained``), each
client-booked episode a ``session`` ``episode`` event, and sheds
aggregated ``autoscale`` ``shed`` events (one per reason per second).
With a ``tracer`` (``obs.trace.Tracer``) each request's trace opens at
this public edge (the client's ``X-Trace-Id`` or a minted id,
head-sampled): a ``router.act`` / ``router.session_create`` /
``router.session_act`` root, a ``router.dispatch`` (``router.retry``)
span per replica hop whose id rides the hop's ``X-Trace-Parent`` header
(TCP or Unix socket), and on a session failover ``router.takeover`` and
``router.fence``. A retried, failed or taken-over request is always
traced, whatever the rate. With an ``injector``
(``resilience.FaultInjector``, which may also be armed later by setting
``router.injector``) each routed client request is the serving faults'
trigger point (:meth:`Router._chaos_tick`): it is counted under the
router's lock, so ``request=K`` is exact under concurrency, and fires the
request-clocked faults against the replica set, the carry-journal
directory, the transport and the request's own path and body; on the
async core it runs on the executor, off the event loop. A hook failure
never fails the request, and every chaos-fired request is traced. With a
``capture`` (``obs.capture.RequestCapture``) every answered act whose
trace is emitted is recorded for deterministic replay: the stamped body
(``seq`` travels in it) and the replica's raw answer, parsed on the
capture's writer thread, never on the request path (one append in
``_trace_done``, on both cores); ``/metrics`` adds ``trpo_capture_*``.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import math
import socket
import threading
import time
import urllib.parse
from collections import deque
from typing import Dict, Optional, Tuple

from trpo_torch.obs.trace import TRACE_HEADER, Tracer
from trpo_torch.serve import wire as _wire
from trpo_torch.utils.exposition import _esc, _fmt, _json_safe
from trpo_torch.utils.httpd import check_uds_path
from trpo_torch.utils.metrics import quantile_nearest_rank

__all__ = ["Router"]

_JSON = "application/json"


def _body(obj) -> bytes:
    return json.dumps(obj).encode()


class _Affinity:
    __slots__ = (
        "replica", "host", "last_used", "seq", "acts", "lock",
        "pending_resumed_steps", "ep_return", "ep_steps", "ep_t0",
    )

    def __init__(self, replica: str, now: float, host: str = "local"):
        self.replica = replica
        # the host the pinned replica journals UNDER, recorded at pin
        # time: a lease-evicted replica may relaunch on another host
        # under the same id, and a late act must still resume from (and
        # fence) the incarnation it was pinned to
        self.host = host
        self.last_used = now
        self.seq = 0   # per-session act sequence (the dedupe stamp)
        self.acts = 0  # acts the router saw succeed
        # serializes this session's acts against a drain migration
        self.lock = threading.Lock()
        # set by a completed drain migration: the NEXT act's response
        # carries `resumed: true` and the replayed step count
        self.pending_resumed_steps = None
        # client-reported realized return: per-act `reward` accumulates
        # here; `done: true` books the episode against the replica
        self.ep_return = 0.0
        self.ep_steps = 0
        # perf_counter when the episode's first act was stamped for
        # dispatch: every action its rewards judge was sent after it
        self.ep_t0 = None


class Router:
    """HTTP front end dispatching over a :class:`ReplicaSet`.

    ``replicaset`` must already be constructed (and usually
    ``start()``-ed); the router does not own its lifecycle — callers
    close the router first, then the set.
    """

    ENDPOINTS = (
        "/act", "/session", "/healthz", "/status", "/metrics",
    )

    # deadline admission judges only the last this-many seconds of
    # latency samples, so a storm's p99 never sheds a recovered set
    _ADMISSION_STALE_S = 10.0

    # how long after the last 503/shed the stateless headroom stays
    # armed — "sustained saturation" for the shed order
    _PRESSURE_WINDOW_S = 1.0

    def __init__(
        self,
        replicaset,
        port: int,
        host: str = "127.0.0.1",
        max_inflight: int = 64,
        act_timeout_s: float = 30.0,
        session_ttl_s: float = 300.0,
        max_sessions: int = 4096,
        bus=None,
        latency_window: int = 4096,
        journal_dir: Optional[str] = None,
        canary_fraction: float = 0.0,
        injector=None,
        min_latency_samples: int = 16,
        retry_budget: float = 8.0,
        retry_refill_per_sec: float = 4.0,
        tracer=None,
        core: str = "async",
        uds_path: Optional[str] = None,
        capture=None,
    ):
        if core not in ("async", "thread"):
            raise ValueError(
                f"core must be 'async' or 'thread', got {core!r}"
            )
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}"
            )
        if not 0.0 <= canary_fraction <= 1.0:
            raise ValueError(
                f"canary_fraction must be in [0, 1], got {canary_fraction}"
            )
        if min_latency_samples < 1:
            raise ValueError(
                f"min_latency_samples must be >= 1, got "
                f"{min_latency_samples}"
            )
        if retry_budget < 0 or retry_refill_per_sec < 0:
            raise ValueError(
                "retry_budget and retry_refill_per_sec must be >= 0, "
                f"got {retry_budget}/{retry_refill_per_sec}"
            )
        self.replicaset = replicaset
        # every router→replica exchange runs through the transport's
        # gate, so a partitioned host fails from here exactly as it does
        # from the supervisor. None (a test's fake set) = ungated.
        self.transport = getattr(replicaset, "transport", None)
        self.max_inflight = int(max_inflight)
        self.act_timeout_s = float(act_timeout_s)
        self.session_ttl_s = float(session_ttl_s)
        self.max_sessions = int(max_sessions)
        self.journal_dir = journal_dir
        self.canary_fraction = float(canary_fraction)
        self.min_latency_samples = int(min_latency_samples)

        self.routed_total = 0       # requests answered via a replica
        self.retried_total = 0      # transparent retries taken
        self.failed_total = 0       # requests failed after the retry
        self.backpressure_total = 0  # 503s for saturation/empty rotation
        self.retries_skipped_total = 0   # retry-budget exhaustion sheds
        self.shed_deadline_total = 0     # un-meetable-deadline 503s
        self.shed_stateless_total = 0    # stateless headroom refusals
        self.sessions_created_total = 0
        self.sessions_reestablished_total = 0  # failover, fresh carry
        self.sessions_resumed_total = 0        # failover, journaled carry
        self.sessions_drained_total = 0        # lossless drain migrations
        # retry token bucket: past the budget, retries are SKIPPED
        # (the request resolves as if no second attempt existed)
        self._retry_capacity = float(retry_budget)
        self._retry_tokens = float(retry_budget)
        self._retry_refill = float(retry_refill_per_sec)
        self._retry_stamp = time.monotonic()
        # shed order: under sustained saturation, STATELESS traffic
        # stops being admitted `_session_headroom` slots before the hard
        # bound. Tiny bounds keep headroom 0.
        self._session_headroom = (
            max(1, self.max_inflight // 8) if self.max_inflight >= 4
            else 0
        )
        self._last_pressure = 0.0   # monotonic stamp of the last 503/shed
        self.bus = bus
        self.tracer = tracer
        # request capture: the same sampling verdict as the tracer, so
        # capture and spans name the same traces. Caller-owned; None =
        # off. The notes park each in-flight request's raw fields until
        # _trace_done knows the final verdict.
        self.capture = capture
        self._capture_notes: Dict[int, dict] = {}
        self.injector = injector  # serving chaos (may be armed later)
        self._chaos_requests = 0   # routed requests seen while armed
        # shed events: counted per reason, emitted at most once a second
        self._shed_lock = threading.Lock()
        self._shed_counts: Dict[str, int] = {}
        self._shed_emitted: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._affinity: Dict[str, _Affinity] = {}
        self._lat_lock = threading.Lock()
        self._latencies_ms: deque = deque(maxlen=latency_window)
        # fresh-sample feed for the autoscaler, drained each control tick
        self._fresh_lats: deque = deque(maxlen=4096)
        # the admission check's TIME-expiring window of (monotonic t, ms)
        self._adm_lats: deque = deque(maxlen=4096)
        # per-replica rolling windows of (dispatch start, ms): the canary
        # gate compares the canary's p99 against the incumbents' over the
        # same period, counting only requests dispatched after its reset
        self._replica_lats: Dict[str, deque] = {}
        self._replica_cut = 0.0  # perf_counter of the last reset
        # per-replica completed-episode (first dispatch, return) pairs
        # (the reward gate's feed), counting only episodes begun after
        # its reset
        self._replica_eps: Dict[str, deque] = {}
        self._eps_cut = float("-inf")
        self.episodes_total = 0
        # recent stateless request bodies, mirrored by the canary
        # gate's action-parity sample (real traffic, not synthetic obs)
        self._recent_obs: deque = deque(maxlen=64)
        self._canary_clock = 0.0  # deterministic fraction accumulator
        # the SESSION-level stride: which /session creates pin to the
        # canary (whole episodes, the unit the reward gate judges)
        self._canary_session_clock = 0.0
        self._tls = threading.local()  # per-thread replica conn pool
        self.core = core
        # data-plane counters: what each dispatch rode
        self.dispatch_transport_total = {"tcp": 0, "uds": 0}
        self.wire_frames_total = {"json": 0, "binary": 0}
        self.wire_decode_errors_total = 0
        # the async core's loop-owned replica connection pools:
        # key (replica_id, ("tcp", netloc) | ("uds", path)) -> list of
        # idle (reader, writer) pairs. Touched ONLY on the loop.
        self._apool: Dict[tuple, list] = {}

        not_found = (
            "have POST /act, POST /session, POST /session/<id>/act, "
            "GET /healthz, GET /status, GET /metrics"
        )
        get = {
            "/healthz": self._healthz,
            "/status": self._status,
            "/metrics": self._metrics,
        }
        if core == "async":
            from trpo_torch.utils.httpd import AsyncBackgroundServer

            self._httpd = AsyncBackgroundServer(
                port,
                host=host,
                get=get,
                # session create is control-plane-rare: the sync path
                post={"/session": self._session_create},
                async_post={"/act": self._act_async},
                async_post_prefix={"/session/": self._session_act_async},
                not_found=not_found,
                thread_name="router-http",
                uds_path=uds_path,
            )
        else:
            from trpo_torch.utils.httpd import BackgroundHTTPServer

            self._httpd = BackgroundHTTPServer(
                port,
                host=host,
                get=get,
                post={
                    "/act": self._act,
                    "/session": self._session_create,
                },
                post_prefix={"/session/": self._session_act},
                not_found=not_found,
                thread_name="router-http",
                uds_path=uds_path,
            )
        self.host = host
        self.port = self._httpd.port
        self.uds_path = getattr(self._httpd, "uds_path", None)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- dispatch core -----------------------------------------------------

    def _pick(self, exclude=(), stateless: bool = True,
              want_canary: Optional[bool] = None) -> Optional[str]:
        """Least-inflight healthy replica id under ``max_inflight``, or
        None (saturated / empty rotation). Bumps the winner's inflight
        under the set's lock — the reservation IS the queue-depth
        signal.

        Canary-aware: while a replica is marked canary, STATELESS
        requests route to it on the deterministic ``canary_fraction``
        stride and everything else routes around it; a session create
        passes an explicit ``want_canary``. If the canary is the only
        viable candidate it still serves — degraded beats dropped.

        Shed order: under sustained saturation (a 503/shed within the
        last second), stateless requests stop being admitted
        ``_session_headroom`` slots before the hard bound.

        Replicas on SUSPECT hosts are avoided while any other candidate
        remains."""
        bound = self.max_inflight
        if self._headroom_active(stateless):
            bound = self.max_inflight - self._session_headroom
        rotation = self.replicaset.in_rotation()
        suspect = getattr(
            self.replicaset, "suspect_hosts", frozenset
        )()
        with self.replicaset.lock:
            candidates = [
                r for r in rotation
                if r.id not in exclude and r.inflight < bound
            ]
            if not candidates:
                return None
            if suspect:
                trusted = [
                    r for r in candidates
                    if getattr(r, "host", "local") not in suspect
                ]
                candidates = trusted or candidates
            canary = [
                r for r in candidates if getattr(r, "canary", False)
            ]
            incumbents = [
                r for r in candidates if not getattr(r, "canary", False)
            ]
            if canary and incumbents:
                take = (
                    want_canary
                    if want_canary is not None
                    else stateless and self._canary_take()
                )
                candidates = canary if take else incumbents
            best = min(candidates, key=lambda r: (r.inflight, r.id))
            best.inflight += 1
            return best.id

    def _canary_take(self) -> bool:
        """Deterministic error-accumulator over stateless requests: the
        canary receives EXACTLY ``canary_fraction`` of them in the long
        run for any fraction (a rounded stride would quantize 0.4 to
        1-in-2). Called under the set lock."""
        if self.canary_fraction <= 0.0:
            return False
        self._canary_clock += self.canary_fraction
        if self._canary_clock >= 1.0:
            self._canary_clock -= 1.0
            return True
        return False

    def _canary_session_take(self) -> bool:
        """The session-level twin of :meth:`_canary_take`: strides
        ``canary_fraction`` of session CREATES onto the canary, on its
        own accumulator, and only while a canary is in rotation (a
        stride burned with no canary would starve the reward window)."""
        if self.canary_fraction <= 0.0:
            return False
        rotation = self.replicaset.in_rotation()
        if not any(getattr(r, "canary", False) for r in rotation):
            return False
        with self._lock:
            self._canary_session_clock += self.canary_fraction
            if self._canary_session_clock >= 1.0:
                self._canary_session_clock -= 1.0
                return True
        return False

    def _release(self, replica_id: str) -> None:
        rec = self.replicaset.get(replica_id)
        if rec is None:
            return
        with self.replicaset.lock:
            rec.inflight = max(0, rec.inflight - 1)

    def _conn(self, replica_id: str, netloc: str):
        """A pooled keep-alive connection to the replica, one per
        (handler thread, replica, address): per-request connection setup
        costs more than a small model's inference, and a restarted
        replica (new port) misses the pool and dials fresh."""
        pool = getattr(self._tls, "conns", None)
        if pool is None:
            pool = self._tls.conns = {}
        key = (replica_id, netloc)
        conn = pool.get(key)
        if conn is None:
            # drop this thread's stale entries for the same replica, or
            # fds to dead addresses accumulate one per restart
            for old in [
                k for k in pool if k[0] == replica_id and k != key
            ]:
                stale = pool.pop(old)
                try:
                    stale.close()
                except Exception:
                    pass
            conn = http.client.HTTPConnection(
                netloc, timeout=self.act_timeout_s
            )
            # TCP_NODELAY on the outgoing half: http.client sends headers
            # and body as two segments, and Nagle holding the body for
            # the peer's delayed ACK adds ~40 ms to a hop
            conn.connect()
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
            pool[key] = conn
        return key, conn

    def _forward(self, replica_id: str, path: str, body: bytes,
                 fwd_headers: Optional[dict] = None):
        """POST ``body`` to the replica; ``(status, body, ctype)`` for
        HTTP-level answers (error statuses included); raises for
        transport-level failures. ``fwd_headers`` carries the client's
        negotiated ``Content-Type``/``Accept`` so a binary frame stays
        binary across the hop."""
        rec = self.replicaset.get(replica_id)
        url = rec.url if rec is not None else None
        if url is None:
            raise ConnectionError(f"replica {replica_id} has no URL")
        if self.transport is not None:
            # a partitioned host raises here, indistinguishable from a
            # dropped connection; a slow host pays its latency
            self.transport.gate(getattr(rec, "host", "local"))
        netloc = urllib.parse.urlsplit(url).netloc
        key, conn = self._conn(replica_id, netloc)
        headers = {"Content-Type": _JSON}
        if fwd_headers:
            headers.update(fwd_headers)
        with self._lock:
            self.dispatch_transport_total["tcp"] += 1
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            ctype = resp.getheader("Content-Type") or _JSON
            return resp.status, payload, ctype
        except Exception:
            # transport failure OR a stale pooled connection: drop it so
            # the retry (and every later request) dials fresh
            self._tls.conns.pop(key, None)
            try:
                conn.close()
            except Exception:
                pass
            raise

    # -- async dispatch core -----------------------------------------------
    #
    # With core="async" one event loop owns every replica connection,
    # replica hops are coroutines, and same-host replicas are dialed
    # over their AF_UNIX socket. The control-plane decisions (_pick,
    # _release, the retry budget, admission, affinity) are the same sync
    # code the thread core runs; the blocking failover tail runs on the
    # server's executor.

    def _dial_plan(self, rec) -> Tuple[str, str]:
        """``("uds", path)`` or ``("tcp", netloc)`` for one replica hop:
        UDS only when the replica advertises a socket path AND lives on
        this host. A socket path too long for ``sockaddr_un`` raises; it
        never falls back to TCP."""
        uds = getattr(rec, "uds_path", None)
        if uds and (
            self.transport is None
            or self.transport.same_host(getattr(rec, "host", "local"))
        ):
            return "uds", check_uds_path(uds)
        return "tcp", urllib.parse.urlsplit(rec.url).netloc

    # loop-owned pool helpers: touched ONLY from the loop thread

    def _apool_take(self, key):
        idle = self._apool.get(key)
        if idle:
            return idle.pop()
        # a restarted replica has a NEW address: drop its stale idle
        # conns, or fds to dead addresses accumulate one per restart
        rid = key[0]
        for old in [k for k in self._apool if k[0] == rid and k != key]:
            for pair in self._apool.pop(old):
                self._aclose_pair(pair)
        return None

    def _apool_put(self, key, pair) -> None:
        self._apool.setdefault(key, []).append(pair)

    def _apool_close_all(self) -> None:
        for idle in self._apool.values():
            for pair in idle:
                self._aclose_pair(pair)
        self._apool.clear()

    @staticmethod
    def _aclose_pair(pair) -> None:
        try:
            pair[1].close()
        except Exception:
            pass

    async def _adial(self, kind: str, addr: str):
        if kind == "uds":
            return await asyncio.open_unix_connection(addr)
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return reader, writer

    async def _aexchange(self, reader, writer, path: str, body: bytes,
                         headers: dict):
        """One HTTP/1.1 POST over an open stream pair:
        ``(status, payload, ctype, keep)``, ``keep`` False when the peer
        asked to close."""
        req = [f"POST {path} HTTP/1.1", "Host: local",
               f"Content-Length: {len(body)}"]
        req.extend(f"{k}: {v}" for k, v in headers.items())
        req.append("\r\n")
        writer.write("\r\n".join(req).encode("latin-1") + body)
        await writer.drain()
        line = await reader.readline()
        if not line:
            raise ConnectionError("connection closed before response")
        status = int(line.split(None, 2)[1])
        resp_headers = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            name, _, value = hline.decode("latin-1").partition(":")
            resp_headers[name.strip().lower()] = value.strip()
        n = int(resp_headers.get("content-length") or 0)
        payload = await reader.readexactly(n) if n else b""
        keep = resp_headers.get("connection", "").lower() != "close"
        ctype = resp_headers.get("content-type") or _JSON
        return status, payload, ctype, keep

    async def _aforward(self, replica_id: str, path: str, body: bytes,
                        fwd_headers: Optional[dict] = None, span=None):
        """The async mirror of :meth:`_forward`, with the UDS-vs-TCP
        dial plan. A pooled connection that fails is redialed ONCE (the
        replica closed its keep-alive side between requests — the replay
        is safe); a fresh socket's failure is a transport failure and
        raises. ``span`` (the hop's trace span) is stamped with the
        transport the dial plan chose."""
        rec = self.replicaset.get(replica_id)
        url = rec.url if rec is not None else None
        if url is None:
            raise ConnectionError(f"replica {replica_id} has no URL")
        if self.transport is not None:
            gate_ms = self.transport.gate_delay(
                getattr(rec, "host", "local")
            )
            if gate_ms:
                await asyncio.sleep(gate_ms / 1e3)
        kind, addr = self._dial_plan(rec)
        if span is not None:
            span.attrs["transport"] = kind
        headers = {"Content-Type": _JSON}
        if fwd_headers:
            headers.update(fwd_headers)
        key = (replica_id, (kind, addr))
        pair = self._apool_take(key)
        pooled = pair is not None
        try:
            if pair is None:
                pair = await asyncio.wait_for(
                    self._adial(kind, addr), self.act_timeout_s
                )
            out = await asyncio.wait_for(
                self._aexchange(pair[0], pair[1], path, body, headers),
                self.act_timeout_s,
            )
        except Exception:
            if pair is not None:
                self._aclose_pair(pair)
            if not pooled:
                raise
            pair = None
            try:
                pair = await asyncio.wait_for(
                    self._adial(kind, addr), self.act_timeout_s
                )
                out = await asyncio.wait_for(
                    self._aexchange(
                        pair[0], pair[1], path, body, headers
                    ),
                    self.act_timeout_s,
                )
            except Exception:
                if pair is not None:
                    self._aclose_pair(pair)
                raise
        status, payload, ctype, keep = out
        if keep:
            self._apool_put(key, pair)
        else:
            self._aclose_pair(pair)
        with self._lock:
            self.dispatch_transport_total[kind] += 1
        return status, payload, ctype

    def _book_latency(self, t0: float, rid: Optional[str]) -> None:
        """Account one answered request: the rolling, fresh and
        admission windows, and (when ``rid`` is given) the replica's."""
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.routed_total += 1
        with self._lat_lock:
            self._latencies_ms.append(ms)
            self._fresh_lats.append(ms)
            self._adm_lats.append((time.monotonic(), ms))
            if rid is not None:
                win = self._replica_lats.get(rid)
                if win is None:
                    win = self._replica_lats[rid] = deque(maxlen=512)
                win.append((t0, ms))
        return ms

    def _reserve_pinned(self, pinned: str) -> bool:
        """Reserve a slot on the pinned replica. Draining replicas still
        serve their PINNED sessions — that traffic is what the drain is
        migrating."""
        rec = self.replicaset.get(pinned)
        with self.replicaset.lock:
            ok = rec is not None and rec.state in (
                "healthy", "reloading", "draining")
            if ok:
                rec.inflight += 1
        return ok

    def _next_target(self, tried, stateless, want_canary, retrying):
        """The replica of a non-pinned attempt, reserved, or None. A
        retry takes a token from the budget only once a target exists —
        a set with no survivors burns failures, never phantom budget —
        and is counted only then."""
        rid = self._pick(exclude=tried, stateless=stateless,
                         want_canary=want_canary)
        if rid is None or not retrying:
            return rid
        if not self._take_retry_token():
            self._release(rid)
            return None
        with self._lock:
            self.retried_total += 1
        return rid

    async def _adispatch(self, path: str, body: bytes,
                         pinned: Optional[str] = None,
                         stateless: bool = True,
                         fwd_headers: Optional[dict] = None,
                         want_canary: Optional[bool] = None,
                         endpoint: str = "act", ctx=None, parent=None):
        """:meth:`_dispatch` on the loop: the same decisions, with the
        forward awaited and ``report_failure`` (which may tear down and
        relaunch a replica) on the executor."""
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        retried = False
        tried = []
        lost_rid = None
        first_5xx = None
        for attempt in (0, 1):
            if pinned is not None and attempt == 0:
                if not self._reserve_pinned(pinned):
                    return None, None, retried
                rid = pinned
            else:
                rid = self._next_target(
                    tried, stateless, want_canary,
                    lost_rid is not None or first_5xx is not None)
                if rid is None:
                    break
                retried = retried or attempt == 1
            tried.append(rid)
            hop, headers = self._hop(ctx, parent, rid, retried, endpoint,
                                     fwd_headers)
            try:
                status, payload, resp_ctype = await self._aforward(
                    rid, path, body, fwd_headers=headers, span=hop,
                )
            except Exception:
                if hop is not None:
                    ctx.force()
                    hop.end(error="transport")
                self._release(rid)
                await loop.run_in_executor(
                    self._httpd._executor,
                    self.replicaset.report_failure, rid,
                )
                lost_rid = rid
                if attempt == 0 and pinned is None:
                    continue
                break
            if hop is not None:
                hop.end(status=status)
            self._release(rid)
            if (
                status >= 500
                and attempt == 0
                and pinned is None
            ):
                if ctx is not None:
                    ctx.force()
                first_5xx = ((status, resp_ctype, payload), rid)
                continue
            self._emit_request(self._book_latency(t0, rid), True, retried,
                               rid, endpoint, ctx)
            return (status, resp_ctype, payload), rid, retried
        if first_5xx is not None:
            (status, ctype, payload), rid = first_5xx
            self._emit_request(self._book_latency(t0, None), True,
                               retried, rid, endpoint, ctx)
            return (status, ctype, payload), rid, retried
        return None, lost_rid, retried

    def _hop(self, ctx, parent, rid: str, retried: bool, endpoint: str,
             fwd_headers: Optional[dict]):
        """The span of one replica hop (``router.retry`` on the second
        attempt, which forces the trace) and the headers that carry it
        downstream; ``(None, fwd_headers)`` when the request is not
        traced."""
        if ctx is None:
            return None, fwd_headers
        if retried:
            ctx.force()  # a retried request always has a trace
        hop = ctx.span(
            "router.retry" if retried else "router.dispatch",
            parent=parent, replica=rid, host=self._host_of(rid),
            endpoint=endpoint,
            codec="binary" if _wire.is_binary_body(fwd_headers)
            else "json",
            transport="tcp",  # the async core's dial plan restamps it
        )
        return hop, {**(fwd_headers or {}), **Tracer.headers_for(ctx, hop)}

    def _emit_request(self, ms: float, ok: bool, retried: bool,
                      replica: Optional[str], endpoint: str,
                      ctx=None) -> None:
        if self.bus is None:
            return
        fields = {}
        if ctx is not None and ctx.emitting:
            # the request event names its trace exactly when the trace
            # is emitted
            fields["trace"] = ctx.trace_id
        try:
            self.bus.emit("router", scope="request", ms=ms, ok=ok,
                          retried=retried, replica=replica,
                          endpoint=endpoint, **fields)
        except Exception:
            pass

    # -- request tracing -----------------------------------------------------

    def _trace_edge(self, name: str, headers=None):
        """Open one request's trace at the public edge: the client's
        (valid) ``X-Trace-Id`` or a minted id, head-sampled, and its root
        span. ``(None, None)`` when tracing is off. ``headers``: the
        request's headers where the caller holds them (the async core);
        sync handlers read the thread-local."""
        if self.tracer is None:
            return None, None
        if headers is None:
            from trpo_torch.utils.httpd import request_headers

            headers = request_headers()
        tid = headers.get(TRACE_HEADER) if headers is not None else None
        ctx = self.tracer.begin(trace_id=tid)
        if self.injector is not None:
            ctx.force()  # every chaos-fired request has a trace
        return ctx, ctx.span(name)

    def _trace_done(self, ctx, root, status=None) -> None:
        """Close the root span and hand the spans to the writer. A 5xx
        (a replica's, passed through, included) forces the trace, except
        the typed 503s: a shed is a deliberate admission decision, and
        tracing every shed would flood the writer exactly under
        overload."""
        if ctx is None:
            return
        if status is not None and status >= 500 and status != 503:
            ctx.force()
        root.end(**({} if status is None else {"status": status}))
        if self.capture is not None:
            # after the forcing above: a late-forced trace (a passed-
            # through 5xx) is captured exactly when its spans emit
            with self._lock:
                note = self._capture_notes.pop(id(ctx), None)
            if note is not None:
                self.capture.record(
                    ctx, status=status if status is not None else 500,
                    **note)
        self.tracer.finish(ctx)

    def _capture_note(self, ctx, path: str, endpoint: str, body: bytes,
                      binary: bool, replica, result,
                      session: Optional[str] = None) -> None:
        """Park one answered request's raw capture fields (the body and
        the replica's answer, unparsed) until its ``_trace_done``. One
        dict assignment; a no-op when capture is off."""
        if self.capture is None or ctx is None:
            return
        note = dict(path=path, endpoint=endpoint, body=body, binary=binary,
                    session=session, replica=replica, response=result[2],
                    response_ctype=result[1])
        with self._lock:
            self._capture_notes[id(ctx)] = note

    def _traced(self, name: str, fn, *args, headers=None):
        """The handler trace wrapper: open the edge context, run the
        handler with ``(ctx, root)`` appended, close the root with the
        answered status."""
        ctx, root = self._trace_edge(name, headers)
        out = None
        try:
            out = fn(*args, ctx, root)
            return out
        finally:
            self._trace_done(ctx, root,
                             status=out[0] if out is not None else 500)

    async def _atraced(self, name: str, coro_fn, *args, headers=None):
        """:meth:`_traced` for a coroutine handler."""
        ctx, root = self._trace_edge(name, headers)
        out = None
        try:
            out = await coro_fn(*args, ctx, root)
            return out
        finally:
            self._trace_done(ctx, root,
                             status=out[0] if out is not None else 500)

    async def _act_async(self, path: str, body: bytes, headers):
        return await self._atraced("router.act", self._act_async_inner,
                                   body, headers, headers=headers)

    async def _act_async_inner(self, body: bytes, headers, ctx, root):
        fwd = self._codec_headers(headers)
        self._count_codec(fwd)
        if self.injector is not None:
            # a fault may kill a replica or start a storm: the executor,
            # never the event loop
            await asyncio.get_running_loop().run_in_executor(
                self._httpd._executor, self._chaos_tick, "/act", body)
        shed = self._admission_check(body, headers=headers, ctx=ctx)
        if shed is not None:
            return shed
        if not _wire.is_binary_body(headers):
            self._recent_obs.append(body)
        result, rid, retried = await self._adispatch(
            "/act", body, fwd_headers=fwd, ctx=ctx, parent=root,
        )
        if result is not None:
            self._capture_note(ctx, "/act", "act", body,
                               _wire.is_binary_body(headers), rid, result)
            return result
        return self._unrouted(rid, retried, stateless=True, ctx=ctx)

    async def _session_act_async(self, path: str, body: bytes, headers):
        return await self._atraced(
            "router.session_act", self._session_act_async_inner, path,
            body, headers, headers=headers)

    async def _session_act_async_inner(self, path: str, body: bytes,
                                       headers, ctx, root):
        fwd = self._codec_headers(headers)
        self._count_codec(fwd)
        if self.injector is not None:
            await asyncio.get_running_loop().run_in_executor(
                self._httpd._executor, self._chaos_tick, path, body)
        sid = self._session_id(path)
        if sid is None:
            return self._bad_session_path()
        while True:
            with self._lock:
                aff = self._affinity.get(sid)
            if aff is None:
                return self._unknown_session(sid)
            # the affinity lock is a THREADING lock shared with the sync
            # drain/migration machinery: poll it, never park an executor
            # worker (the failover tail needs those workers)
            while not aff.lock.acquire(blocking=False):
                await asyncio.sleep(0.001)
            try:
                with self._lock:
                    if self._affinity.get(sid) is not aff:
                        continue  # replaced/removed while we waited
                return await self._session_act_pinned_async(
                    sid, aff, body, fwd, ctx, root
                )
            finally:
                aff.lock.release()

    async def _session_act_pinned_async(self, sid: str, aff,
                                        body: bytes, fwd, ctx=None,
                                        root=None):
        body = self._stamp_seq(aff, body, fwd)
        result, rid, retried = await self._adispatch(
            f"/session/{sid}/act", body, pinned=aff.replica,
            fwd_headers=fwd, endpoint="session_act", ctx=ctx, parent=root,
        )
        # fast path: a clean non-404 answer with no pending drain
        # notification needs none of the failover tail
        if (
            result is not None
            and result[0] != 404
            and not (
                result[0] == 200
                and aff.pending_resumed_steps is not None
            )
        ):
            aff.last_used = time.monotonic()
            if result[0] == 200:
                with self._lock:
                    aff.acts += 1
                self._book_feedback(sid, aff, rid, body, fwd)
            self._capture_note(ctx, f"/session/{sid}/act", "session_act",
                               body, _wire.is_binary_body(fwd), aff.replica,
                               result, session=sid)
            return result
        # the anomaly tail (journal lookup, fence, sync re-dispatch)
        # blocks: run the shared sync code on the executor, aff.lock
        # still held by this coroutine
        return await asyncio.get_running_loop().run_in_executor(
            self._httpd._executor,
            lambda: self._session_act_finish(
                sid, aff, body, result, rid, retried, fwd_headers=fwd,
                ctx=ctx, root=root,
            ),
        )

    @staticmethod
    def _codec_headers(headers) -> Optional[dict]:
        """The client's payload-negotiation headers that must ride the
        replica hop: ``Content-Type`` for a binary frame, ``Accept``
        when declared. None = the pure-JSON default."""
        if headers is None:
            return None
        fwd = {}
        if _wire.is_binary_body(headers):
            fwd["Content-Type"] = _wire.WIRE_CONTENT_TYPE
        accept = headers.get("Accept")
        if accept is not None:
            fwd["Accept"] = accept
        return fwd or None

    def _dispatch(self, path: str, body: bytes,
                  pinned: Optional[str] = None, stateless: bool = True,
                  fwd_headers: Optional[dict] = None,
                  want_canary: Optional[bool] = None,
                  endpoint: str = "act", ctx=None, parent=None):
        """The routed request core: pick (or follow the pin), forward,
        retry ONCE on a transport failure or an un-pinned 5xx, account.
        Returns the upstream ``(status, ctype, body)`` (None = never
        answered), the replica that finally answered or was lost, and
        whether the retry was taken."""
        t0 = time.perf_counter()
        retried = False
        tried = []
        lost_rid = None  # a replica we reached and lost mid-request
        first_5xx = None  # a server-side error answer held as fallback
        for attempt in (0, 1):
            if pinned is not None and attempt == 0:
                if not self._reserve_pinned(pinned):
                    # the pin's replica left rotation: the session path
                    # re-establishes; plain /act never pins
                    return None, None, retried
                rid = pinned
            else:
                rid = self._next_target(
                    tried, stateless, want_canary,
                    lost_rid is not None or first_5xx is not None)
                if rid is None:
                    break
                retried = retried or attempt == 1
            tried.append(rid)
            hop, headers = self._hop(ctx, parent, rid, retried, endpoint,
                                     fwd_headers)
            try:
                status, payload, resp_ctype = self._forward(
                    rid, path, body, fwd_headers=headers,
                )
            except Exception:
                # transport failure: the replica died under us — tell
                # the supervisor (immediate eviction) and retry once
                if hop is not None:
                    ctx.force()  # reached-and-lost: an anomaly
                    hop.end(error="transport")
                self._release(rid)
                self.replicaset.report_failure(rid)
                lost_rid = rid
                if attempt == 0 and pinned is None:
                    continue
                break  # a held 5xx still passes through below
            if hop is not None:
                hop.end(status=status)
            self._release(rid)
            if (
                status >= 500
                and attempt == 0
                and pinned is None
            ):
                # a server-side error from an un-pinned replica is safe
                # to re-run once elsewhere; the answer is kept and passes
                # through verbatim if no second replica exists
                if ctx is not None:
                    ctx.force()
                first_5xx = ((status, resp_ctype, payload), rid)
                continue
            self._emit_request(self._book_latency(t0, rid), True, retried,
                               rid, endpoint, ctx)
            return (status, resp_ctype, payload), rid, retried
        if first_5xx is not None:
            (status, ctype, payload), rid = first_5xx
            self._emit_request(self._book_latency(t0, None), True,
                               retried, rid, endpoint, ctx)
            return (status, ctype, payload), rid, retried
        # no replica left to try: a reached-and-lost replica makes this a
        # FAILURE (lost_rid propagates); otherwise it is backpressure
        return None, lost_rid, retried

    # -- overload robustness -----------------------------------------------

    def _headroom_active(self, stateless: bool) -> bool:
        """THE shed-order predicate — one implementation for the bound
        ``_pick`` applies and the classification ``_unrouted`` reports."""
        return (
            stateless
            and self._session_headroom > 0
            and time.monotonic() - self._last_pressure
            < self._PRESSURE_WINDOW_S
        )

    def _take_retry_token(self) -> bool:
        """One token from the retry budget, or a counted shed. The bucket
        refills at ``retry_refill_per_sec`` up to its capacity."""
        with self._lock:
            now = time.monotonic()
            self._retry_tokens = min(
                self._retry_capacity,
                self._retry_tokens
                + (now - self._retry_stamp) * self._retry_refill,
            )
            self._retry_stamp = now
            if self._retry_tokens >= 1.0:
                self._retry_tokens -= 1.0
                return True
            self.retries_skipped_total += 1
        self._note_shed("retry_budget_exhausted")
        return False

    def _note_shed(self, reason: str) -> None:
        """Account one shed: stamp the pressure clock (the shed order's
        "sustained saturation" signal) and, with a bus, an aggregated
        ``autoscale`` ``shed`` event, at most one per reason per second,
        so a storm's thousands of sheds become a handful of counted
        records."""
        now = time.monotonic()
        self._last_pressure = now
        if self.bus is None:
            return
        with self._shed_lock:
            self._shed_counts[reason] = self._shed_counts.get(reason, 0) + 1
            if now - self._shed_emitted.get(reason, 0.0) < 1.0:
                return
            count = self._shed_counts.pop(reason)
            self._shed_emitted[reason] = now
        try:
            self.bus.emit("autoscale", event="shed", reason=reason,
                          count=count)
        except Exception:
            pass

    def _flush_shed_counts(self) -> None:
        """Emit what the per-reason throttle still holds (at close), so
        the log's shed counts match the counters."""
        if self.bus is None:
            return
        with self._shed_lock:
            pending, self._shed_counts = self._shed_counts, {}
        for reason, count in pending.items():
            try:
                self.bus.emit("autoscale", event="shed", reason=reason,
                              count=count)
            except Exception:
                pass

    def _admission_check(self, body: bytes, headers=None, ctx=None):
        """Deadline-aware admission: a request declaring a
        ``deadline_ms`` below the p99 of the last ``_ADMISSION_STALE_S``
        seconds (≥ ``min_latency_samples`` deep) gets an immediate typed
        503 instead of occupying a replica slot it is doomed to waste. A
        thin recent window admits. Returns the refusal, or None."""
        if b'"deadline_ms"' not in body:
            return None
        if _wire.is_binary_body(headers):
            try:
                payload = _wire.decode_frame(body)[0]
            except _wire.WireError:
                return None  # the replica's typed 400 owns bad frames
        else:
            try:
                payload = json.loads(body)
            except ValueError:
                return None  # the replica's 400 owns malformed bodies
        if not isinstance(payload, dict):
            return None
        deadline = payload.get("deadline_ms")
        if not isinstance(deadline, (int, float)) or isinstance(
            deadline, bool
        ):
            return None
        lats = self._recent_latencies()
        samples = len(lats)
        if samples < self.min_latency_samples:
            return None
        p99 = quantile_nearest_rank(lats, 0.99)
        if deadline >= p99:
            return None
        with self._lock:
            self.shed_deadline_total += 1
        self._note_shed("deadline_unmeetable")
        self._emit_request(0.0, False, False, None, "act", ctx)
        return 503, _JSON, _body(
            {
                "error": (
                    f"deadline_ms={deadline:g} is not meetable at the "
                    f"observed p99 ({p99:.1f} ms over {samples} "
                    "requests) — shed instead of wasting a slot"
                ),
                "code": "deadline_unmeetable",
                "p99_ms": p99,
            }
        )

    # -- handlers ----------------------------------------------------------

    def _chaos_tick(self, path: str, body: bytes) -> None:
        """One client request entered the router: the fault injector's
        trigger point, with the request's shape (an ``overload_storm``
        replays it). A hook failure never fails the request it rode in
        on."""
        if self.injector is None:
            return
        with self._lock:
            self._chaos_requests += 1
            idx = self._chaos_requests
        try:
            self.injector.on_serve_request(
                idx, replicaset=self.replicaset,
                journal_dir=self.journal_dir, router=self, path=path,
                body=body, transport=self.transport)
        except Exception:
            pass

    def _act(self, body: bytes):
        return self._traced("router.act", self._act_inner, body)

    def _act_inner(self, body: bytes, ctx, root):
        from trpo_torch.utils.httpd import request_headers

        headers = request_headers()
        fwd = self._codec_headers(headers)
        self._count_codec(fwd)
        self._chaos_tick("/act", body)
        shed = self._admission_check(body, headers=headers, ctx=ctx)
        if shed is not None:
            return shed
        # a small ring of real request bodies for the canary gate's
        # parity sample (JSON bodies only: it replays them as JSON)
        if not _wire.is_binary_body(headers):
            self._recent_obs.append(body)
        result, rid, retried = self._dispatch("/act", body,
                                              fwd_headers=fwd, ctx=ctx,
                                              parent=root)
        if result is not None:
            self._capture_note(ctx, "/act", "act", body,
                               _wire.is_binary_body(headers), rid, result)
            return result
        return self._unrouted(rid, retried, stateless=True, ctx=ctx)

    def _count_codec(self, fwd_headers: Optional[dict]) -> None:
        with self._lock:
            self.wire_frames_total[
                "binary"
                if _wire.is_binary_body(fwd_headers)
                else "json"
            ] += 1

    # -- the canary controller's probes ------------------------------------

    def recent_act_bodies(self, n: int = 8) -> list:
        """Up to ``n`` recent stateless request bodies (newest last)."""
        ring = list(self._recent_obs)
        return ring[-n:]

    def replica_latencies_ms(self, replica_id: str) -> list:
        with self._lat_lock:
            win = self._replica_lats.get(replica_id)
            cut = self._replica_cut
            return ([ms for t0, ms in win if t0 >= cut]
                    if win is not None else [])

    def reset_replica_latencies(self) -> None:
        """Start a fresh observation window (gate start): a request
        dispatched before it (in flight across the canary's reload, and
        possibly answered by the old snapshot) is never judged in it."""
        with self._lat_lock:
            self._replica_lats.clear()
            self._replica_cut = time.perf_counter()

    def replica_episode_returns(self, replica_id: str) -> list:
        """Completed-episode returns booked against one replica whose
        first act was dispatched after the last reset — the reward gate's
        window."""
        with self._lat_lock:
            win = self._replica_eps.get(replica_id)
            cut = self._eps_cut
            return ([r for t0, r in win if t0 >= cut]
                    if win is not None else [])

    def reset_replica_episodes(self) -> None:
        """Start a fresh realized-return window (gate start): an episode
        begun before it (some of its actions answered by the canary's
        previous step) is never judged in it."""
        with self._lat_lock:
            self._replica_eps.clear()
            self._eps_cut = time.perf_counter()

    def _unrouted(self, rid, retried: bool, stateless: bool = False,
                  endpoint: str = "act", ctx=None):
        """No replica answered: 502 when we reached-and-lost replicas,
        503 backpressure otherwise — typed ``shed_stateless`` when only
        the shed-order headroom refused it (a session request would
        still have been admitted)."""
        if rid is not None:
            if ctx is not None:
                ctx.force()  # a failed request always has a trace
            with self._lock:
                self.failed_total += 1
            self._emit_request(0.0, False, retried, rid, endpoint, ctx)
            return 502, _JSON, _body(
                {"error": "replica died mid-request and the retry "
                          "failed or had no replica to go to"}
            )
        headroom_shed = False
        if self._headroom_active(stateless):
            rotation = self.replicaset.in_rotation()
            with self.replicaset.lock:
                headroom_shed = any(
                    r.inflight < self.max_inflight for r in rotation
                )
        with self._lock:
            if headroom_shed:
                self.shed_stateless_total += 1
            else:
                self.backpressure_total += 1
        self._note_shed("stateless_headroom" if headroom_shed
                        else "backpressure")
        self._emit_request(0.0, False, retried, rid, endpoint, ctx)
        if headroom_shed:
            return 503, _JSON, _body(
                {
                    "error": (
                        "stateless traffic shed under sustained "
                        "saturation (session traffic sheds last) — "
                        "retry"
                    ),
                    "code": "shed_stateless",
                }
            )
        snap = self.replicaset.snapshot()
        saturated = snap["healthy"] > 0
        return 503, _JSON, _body(
            {
                "error": (
                    "all replicas saturated (backpressure) — retry"
                    if saturated
                    else "no replicas in rotation"
                ),
                "healthy": snap["healthy"],
                "replicas": snap["size"],
            }
        )

    # -- sessions ----------------------------------------------------------

    def _session_create(self, body: bytes):
        return self._traced("router.session_create",
                            self._session_create_inner, body)

    def _session_create_inner(self, body: bytes, ctx, root):
        if body:
            try:
                payload = json.loads(body)
            except ValueError as e:
                return 400, _JSON, _body(
                    {"error": f"body must be empty or a JSON object ({e})"}
                )
            if not isinstance(payload, dict):
                return 400, _JSON, _body(
                    {"error": "body must be empty or a JSON object"}
                )
            if payload.get("session_id") is not None:
                return 400, _JSON, _body(
                    {"error": "the router mints session ids — POST "
                              "an empty body"}
                )
        from trpo_torch.serve.session import mint_session_id

        # capacity check BEFORE the replica hop: a create the router is
        # going to refuse must not leak a replica-side session
        now = time.monotonic()
        with self._lock:
            self._expire_affinity_locked(now)
            if len(self._affinity) >= self.max_sessions:
                return 503, _JSON, _body(
                    {"error": "session table full — retry later"}
                )
        sid = mint_session_id()
        result, rid, _retried = self._dispatch(
            "/session", _body({"session_id": sid}), stateless=False,
            want_canary=self._canary_session_take() or None,
            endpoint="session", ctx=ctx, parent=root,
        )
        if result is None:
            return self._unrouted(rid, False, endpoint="session", ctx=ctx)
        status, ctype, payload = result
        if status != 200:
            return status, ctype, payload  # 409 wrong_protocol, 503, …
        with self._lock:
            self._affinity[sid] = _Affinity(
                rid, time.monotonic(), host=self._host_of(rid)
            )
            self.sessions_created_total += 1
        out = json.loads(payload)
        out["replica"] = rid
        return 200, _JSON, _body(out)

    def _expire_affinity_locked(self, now: float) -> None:
        # lazy TTL sweep of the affinity table (the replica-side store
        # is the authoritative TTL; this only bounds the table)
        if len(self._affinity) < self.max_sessions:
            return
        for sid, aff in list(self._affinity.items()):
            if now - aff.last_used > self.session_ttl_s:
                del self._affinity[sid]

    def _host_of(self, replica_id: str) -> str:
        return getattr(self.replicaset, "host_of", lambda _r: "local")(
            replica_id
        )

    def _journal_paths(self, replica_id: str,
                       pinned_host: Optional[str] = None):
        """The candidate journal files for one replica, in order: the
        pin-time host's namespaced name, the record's current host's,
        then the flat name."""
        from trpo_torch.serve.session import journal_path

        hosts = []
        if pinned_host is not None:
            hosts.append(pinned_host)
        hosts.append(self._host_of(replica_id))
        paths = []
        for host in hosts:
            p = journal_path(self.journal_dir, replica_id, host=host)
            if p not in paths:
                paths.append(p)
        legacy = journal_path(self.journal_dir, replica_id)
        if legacy not in paths:
            paths.append(legacy)
        return paths

    def _journal_lookup(self, replica_id: str, sid: str,
                        pinned_host: Optional[str] = None):
        """The newest journaled entry for one session from one replica's
        carry journal, read fresh from disk; None when durability is
        off, the file is missing, the entry is torn, or the session was
        never journaled."""
        if self.journal_dir is None:
            return None
        from trpo_torch.serve.session import read_carry_journal

        for path in self._journal_paths(replica_id, pinned_host):
            try:
                entry = read_carry_journal(path).get(sid)
            except Exception:
                entry = None
            if entry is not None:
                return entry
        return None

    def _fence_takeover(self, replica_id: str, sid: str,
                        pinned_host: Optional[str] = None) -> None:
        """Fence one session in the lost replica's journal: a
        partitioned-but-alive zombie incarnation of that replica must not
        journal the session again. Best-effort — seq-dedupe remains the
        client-visible exactly-once backstop."""
        if self.journal_dir is None:
            return
        from trpo_torch.serve.session import fence_session

        for path in self._journal_paths(replica_id, pinned_host):
            try:
                fence_session(path, sid)
            except Exception:
                pass

    def _reestablish(self, sid: str, aff, entry, strict: bool = False,
                     drain: bool = False, ctx=None, parent=None):
        """Re-create the session on a healthy replica — from the
        journaled ``entry`` when one exists (RESUME: carry, steps and
        dedupe state travel), from a fresh carry otherwise. Returns
        ``(ok, rid, resumed)``; on success the affinity is re-pinned (the
        seq counter is never reset).

        ``strict`` (the drain path): a refused journal entry FAILS
        instead of degrading to a fresh carry. ``drain`` books the move
        as a planned migration (``sessions_drained_total``)."""
        create = {"session_id": sid}
        resumed = entry is not None
        if resumed:
            create.update(
                carry=entry["carry"], steps=entry["steps"],
                seq=entry.get("seq"), last_action=entry.get("last_action"),
                last_step=entry.get("last_step"),
            )
        result, rid, _ = self._dispatch(
            "/session", _body(create), stateless=False,
            endpoint="session", ctx=ctx, parent=parent,
        )
        if result is None or result[0] != 200:
            if (
                resumed and not strict
                and result is not None and result[0] == 400
            ):
                # a journaled entry the new replica refuses degrades to
                # the fresh-carry path, never fails the client
                return self._reestablish(sid, aff, None, ctx=ctx,
                                         parent=parent)
            return (result, rid, resumed) if result is not None else (
                None, rid, resumed
            )
        with self._lock:
            aff.replica = rid
            aff.host = self._host_of(rid)  # the journal key moves too
            aff.last_used = time.monotonic()
            if drain:
                self.sessions_drained_total += 1
            elif resumed:
                self.sessions_resumed_total += 1
            else:
                self.sessions_reestablished_total += 1
        if self.bus is not None:
            try:
                if resumed:
                    self.bus.emit(
                        "session", session=sid,
                        event="drained" if drain else "resumed",
                        replica=rid, steps=int(entry["steps"]),
                        lag=max(0, aff.acts - int(entry["steps"])))
                else:
                    self.bus.emit("session", session=sid,
                                  event="reestablished", replica=rid)
            except Exception:
                pass
        return True, rid, resumed

    def restore_session(self, session_id: str, entry: dict) -> str:
        """Seed one session from a journal snapshot under its recorded
        id (``POST /session`` refuses client-supplied ids; this is the
        in-process door). The entry (the ``read_carry_journal`` shape:
        ``carry`` and ``steps``, optionally ``seq``/``last_action``/
        ``last_step``) goes through the same restore protocol a failover
        takeover uses, the affinity is pinned, and the seq counter
        continues from the snapshot. Returns the replica id; raises
        ``ValueError`` on a malformed entry or a duplicate session,
        ``RuntimeError`` when no replica accepted the restore."""
        entry = dict(entry)
        if "carry" not in entry or "steps" not in entry:
            raise ValueError(
                "entry needs 'carry' and 'steps' — a carry-journal "
                "snapshot (read_carry_journal shape)"
            )
        aff = _Affinity("", time.monotonic())
        with self._lock:
            if session_id in self._affinity:
                raise ValueError(
                    f"session {session_id!r} already exists on this "
                    "router"
                )
            self._affinity[session_id] = aff
        with aff.lock:
            ok, rid, _resumed = self._reestablish(session_id, aff, entry)
        if ok is not True:
            with self._lock:
                self._affinity.pop(session_id, None)
            detail = None
            if ok is not None:
                try:
                    detail = json.loads(ok[2]).get("error")
                except (ValueError, TypeError, IndexError):
                    detail = None
            raise RuntimeError(
                f"no replica accepted the restore of {session_id!r}"
                + (f": {detail}" if detail else "")
            )
        with self._lock:
            seq = entry.get("seq")
            aff.seq = (
                int(seq)
                if isinstance(seq, int) and not isinstance(seq, bool)
                else 0
            )
        return rid

    # -- the autoscaler's drain protocol -----------------------------------

    def sessions_pinned_to(self, replica_id: str) -> list:
        """Session ids whose affinity points at one replica — the
        drain's work list."""
        with self._lock:
            return [
                sid for sid, aff in self._affinity.items()
                if aff.replica == replica_id
            ]

    def _flush_replica_journal(
        self, replica_id: str, sid: Optional[str] = None
    ):
        """``POST /drain`` on the replica: the named session (or every
        live one) journaled NOW and the write-behind flushed. True
        (flushed), None (the replica does not know the session: no live
        state to move), or False (transport/flush failure)."""
        body = b"{}" if sid is None else _body({"session": sid})
        try:
            status, payload, _ = self._forward(
                replica_id, "/drain", body
            )
        except Exception:
            return False
        if status != 200:
            return False
        try:
            out = json.loads(payload)
        except ValueError:
            return False
        if not isinstance(out, dict):
            return False
        if out.get("ok"):
            return True
        if sid is not None and out.get("known") is False:
            return None
        return False

    def forget_drained_sessions(self, replica_id: str, sids) -> None:
        """Best-effort: the victim drops sessions the drain already
        resumed elsewhere (store removal + journal tombstones)."""
        try:
            self._forward(
                replica_id, "/drain", _body({"forget": list(sids)})
            )
        except Exception:
            pass

    def migrate_session(self, sid: str, from_replica: str):
        """Move ONE session off a draining replica, losslessly: under the
        session's affinity lock, flush the victim's journal, read the
        session's CURRENT entry, and resume it on a survivor. The next
        act's response says ``resumed: true``.

        True (moved), None (no longer pinned there), or False (could not
        move LOSSLESSLY — the drain must abort)."""
        with self._lock:
            aff = self._affinity.get(sid)
        if aff is None:
            return None
        with aff.lock:
            if aff.replica != from_replica:
                return None  # a concurrent failover already moved it
            if self.journal_dir is None:
                return False
            flushed = self._flush_replica_journal(from_replica, sid)
            if flushed is False:
                return False
            entry = self._journal_lookup(
                from_replica, sid, pinned_host=aff.host
            )
            if entry is None:
                if flushed is None:
                    # no live state on the victim AND nothing journaled:
                    # the session is dead — drop the stale pin
                    with self._lock:
                        self._affinity.pop(sid, None)
                    return None
                return False
            ok, rid, resumed = self._reestablish(
                sid, aff, entry, strict=True, drain=True
            )
            if ok is not True or not resumed:
                return False
            aff.pending_resumed_steps = int(entry["steps"])
            return True

    @staticmethod
    def _session_id(path: str) -> Optional[str]:
        parts = path.strip("/").split("/")
        if len(parts) != 3 or parts[0] != "session" or parts[2] != "act":
            return None
        return parts[1]

    @staticmethod
    def _bad_session_path():
        return 404, _JSON, _body(
            {"error": "unknown session path; have POST /session/<id>/act"}
        )

    @staticmethod
    def _unknown_session(sid: str):
        return 404, _JSON, _body(
            {
                "error": (
                    f"unknown session {sid!r} — mint one with "
                    "POST /session"
                ),
                "code": "session_unknown",
            }
        )

    def _session_act(self, path: str, body: bytes):
        return self._traced("router.session_act", self._session_act_inner,
                            path, body)

    def _session_act_inner(self, path: str, body: bytes, ctx, root):
        from trpo_torch.utils.httpd import request_headers

        fwd = self._codec_headers(request_headers())
        self._count_codec(fwd)
        self._chaos_tick(path, body)
        sid = self._session_id(path)
        if sid is None:
            return self._bad_session_path()
        # the session's affinity lock serializes this act against a
        # drain migration; after acquiring it, RE-validate the entry (a
        # drain that ran while we waited may have dropped the pin)
        while True:
            with self._lock:
                aff = self._affinity.get(sid)
            if aff is None:
                return self._unknown_session(sid)
            with aff.lock:
                with self._lock:
                    if self._affinity.get(sid) is not aff:
                        continue  # replaced/removed while we waited
                body = self._stamp_seq(aff, body, fwd)
                result, rid, retried = self._dispatch(
                    f"/session/{sid}/act", body, pinned=aff.replica,
                    fwd_headers=fwd, endpoint="session_act", ctx=ctx,
                    parent=root,
                )
                return self._session_act_finish(
                    sid, aff, body, result, rid, retried, fwd_headers=fwd,
                    ctx=ctx, root=root,
                )

    def _stamp_seq(self, aff, body: bytes, fwd_headers=None) -> bytes:
        """Stamp the per-session sequence number into the act body — the
        replica dedupes a replay of an applied seq. A binary frame is
        restamped (obs bytes untouched); an unparseable body forwards
        untouched and takes the replica's typed 400."""
        if _wire.is_binary_body(fwd_headers):
            with self._lock:
                aff.seq += 1
                seq = aff.seq
            try:
                return _wire.restamp(body, seq=seq)
            except _wire.WireError:
                with self._lock:
                    self.wire_decode_errors_total += 1
                return body
        try:
            payload = json.loads(body)
            if not isinstance(payload, dict):
                raise ValueError
            with self._lock:
                aff.seq += 1
                payload["seq"] = aff.seq
                if aff.ep_t0 is None:
                    aff.ep_t0 = time.perf_counter()
            return _body(payload)
        except ValueError:
            return body

    def _book_feedback(self, sid: str, aff, rid, body: bytes,
                       fwd_headers=None) -> None:
        """Realized-return feedback: clients may send a per-act
        ``reward`` and ``done`` in their JSON session-act bodies (the
        replica ignores them). Rewards accumulate on the affinity;
        ``done: true`` books the episode's return against the replica
        that answered it — the reward gate's windows. JSON only (the
        binary frame has no reward field)."""
        if rid is None or _wire.is_binary_body(fwd_headers):
            return
        try:
            payload = json.loads(body)
            if not isinstance(payload, dict):
                return
        except ValueError:
            return
        reward = payload.get("reward")
        done = payload.get("done")
        if reward is None and not done:
            return
        with self._lock:
            if isinstance(reward, (int, float)) and not isinstance(
                reward, bool
            ) and math.isfinite(reward):
                aff.ep_return += float(reward)
                aff.ep_steps += 1
            if done is not True:
                return
            ep_return, ep_steps = aff.ep_return, aff.ep_steps
            ep_t0 = aff.ep_t0 if aff.ep_t0 is not None else float("-inf")
            aff.ep_return, aff.ep_steps, aff.ep_t0 = 0.0, 0, None
        if ep_steps == 0:
            return  # a bare done with no rewarded step books nothing
        with self._lat_lock:
            win = self._replica_eps.get(rid)
            if win is None:
                win = self._replica_eps[rid] = deque(maxlen=512)
            win.append((ep_t0, ep_return))
        with self._lock:
            self.episodes_total += 1
        if self.bus is not None:
            try:
                self.bus.emit("session", session=sid, event="episode",
                              replica=rid, ep_return=ep_return,
                              ep_steps=ep_steps)
            except Exception:
                pass

    def _session_act_finish(self, sid: str, aff, body: bytes,
                            result, rid, retried, fwd_headers=None,
                            ctx=None, root=None):
        """Everything after the pinned dispatch returns: journal-backed
        failover, fence, re-dispatch and response decoration. Shared by
        the thread core (inline) and the async core (on the executor —
        it blocks on journals and sync re-dispatch)."""
        pinned = aff.replica
        resumed = reestablished = False
        entry = None
        lost_pin = result is None
        if not lost_pin and result[0] == 404:
            # the pinned replica restarted with an empty store (or
            # TTL-expired the session): a journaled carry still resumes
            # it — only a journal miss passes the 404 through
            try:
                unknown = (
                    json.loads(result[2]).get("code") == "session_unknown"
                )
            except ValueError:
                unknown = False
            if unknown:
                entry = self._journal_lookup(
                    pinned, sid, pinned_host=aff.host
                )
                lost_pin = entry is not None
        if lost_pin:
            # the pinned replica is gone: resume from its carry journal
            # when an entry exists, re-establish from a fresh carry
            # otherwise — never fail the client
            pinned_host = aff.host  # _reestablish re-points aff.host
            if entry is None:
                entry = self._journal_lookup(
                    pinned, sid, pinned_host=pinned_host
                )
            takeover = None
            if ctx is not None:
                # a failover is always traced, and its span names what
                # killed the pin (the replica's booked death reason)
                ctx.force()
                takeover = ctx.span(
                    "router.takeover", parent=root, from_replica=pinned,
                    from_host=pinned_host, journal_backed=entry is not None,
                    cause=self.replicaset.death_reason(pinned)
                    if hasattr(self.replicaset, "death_reason") else None)
            ok, rid, resumed = self._reestablish(sid, aff, entry, ctx=ctx,
                                                 parent=takeover)
            if takeover is not None:
                takeover.end(to_replica=rid if ok is True else None,
                             resumed=bool(resumed) and ok is True,
                             landed=ok is True)
            if ok is not True:
                # the takeover did NOT land: the session stays pinned
                # where it was, so its journal must NOT be fenced
                if ok is not None:
                    return ok  # the create's upstream error, verbatim
                return self._unrouted(rid, retried, endpoint="session_act",
                                      ctx=ctx)
            # the takeover landed elsewhere: fence the old incarnation
            # (keyed by the PIN-TIME host) so a zombie still holding the
            # session can never journal it again
            fence = (ctx.span("router.fence", parent=root, replica=pinned,
                              host=pinned_host, session=sid)
                     if ctx is not None else None)
            self._fence_takeover(pinned, sid, pinned_host=pinned_host)
            if fence is not None:
                fence.end()
            reestablished = not resumed
            result, rid, _ = self._dispatch(
                f"/session/{sid}/act", body, pinned=rid,
                fwd_headers=fwd_headers, endpoint="session_act", ctx=ctx,
                parent=root,
            )
            if result is None:
                return self._unrouted(rid, True, endpoint="session_act",
                                      ctx=ctx)
        status, ctype, payload = result
        aff.last_used = time.monotonic()
        if status == 200:
            with self._lock:
                aff.acts += 1
            self._book_feedback(sid, aff, rid, body, fwd_headers)
        # the STAMPED body (seq travels) and the replica's raw answer: the
        # failover decoration below touches neither the obs nor the action
        self._capture_note(ctx, f"/session/{sid}/act", "session_act", body,
                           _wire.is_binary_body(fwd_headers), rid, result,
                           session=sid)
        resumed_steps = int(entry["steps"]) if resumed else None
        if status == 200 and aff.pending_resumed_steps is not None:
            pending = aff.pending_resumed_steps
            aff.pending_resumed_steps = None  # consumed either way
            if not (resumed or reestablished):
                # a drain moved this session since its last act: tell
                # the client once (this act's own failover flags win)
                resumed = True
                resumed_steps = pending
        if status != 200 or not (resumed or reestablished):
            return status, ctype, payload
        # decorate the success with the failover outcome: a binary
        # response is restamped (action bytes untouched), JSON re-encoded
        base = (ctype or "").split(";", 1)[0].strip().lower()
        if base == _wire.WIRE_CONTENT_TYPE:
            if resumed:
                payload = _wire.restamp(
                    payload, resumed=True, resumed_steps=resumed_steps
                )
            else:
                payload = _wire.restamp(payload, reestablished=True)
            return status, ctype, payload
        out = json.loads(payload)
        if resumed:
            out["resumed"] = True
            out["resumed_steps"] = resumed_steps
        else:
            out["reestablished"] = True
        return status, _JSON, _body(out)

    # -- introspection -----------------------------------------------------

    def _healthz(self):
        snap = self.replicaset.snapshot()
        ok = snap["healthy"] > 0 or any(
            r["state"] == "reloading"
            for r in snap["replicas"].values()
        )
        return (200 if ok else 503), _JSON, _body(
            {"ok": ok, "healthy": snap["healthy"],
             "replicas": snap["size"]}
        )

    def _status(self):
        snap = self.replicaset.snapshot()
        with self._lock:
            counters = {
                "routed_total": self.routed_total,
                "retried_total": self.retried_total,
                "failed_total": self.failed_total,
                "backpressure_total": self.backpressure_total,
                "retries_skipped_total": self.retries_skipped_total,
                "shed_deadline_total": self.shed_deadline_total,
                "shed_stateless_total": self.shed_stateless_total,
                "sessions": len(self._affinity),
                "sessions_created_total": self.sessions_created_total,
                "sessions_reestablished_total":
                    self.sessions_reestablished_total,
                "sessions_resumed_total": self.sessions_resumed_total,
                "sessions_drained_total": self.sessions_drained_total,
                "episodes_total": self.episodes_total,
            }
        q, samples = self.latency_window((0.5, 0.99))
        rq, rsamples = self.latency_recent((0.5, 0.99))
        with self._lock:
            data_plane = {
                "core": self.core,
                "uds_path": self.uds_path,
                "wire_frames_total": dict(self.wire_frames_total),
                "dispatch_transport_total": dict(
                    self.dispatch_transport_total
                ),
                "wire_decode_errors_total":
                    self.wire_decode_errors_total,
            }
        return 200, _JSON, _body(_json_safe(
            {
                "replicas": snap["replicas"],
                "healthy": snap["healthy"],
                "size": snap["size"],
                "data_plane": data_plane,
                "counters": counters,
                "latency_ms": {str(k): v for k, v in q.items()},
                # always beside the quantiles: a 3-request "p99" is not
                # a measurement
                "latency_samples": samples,
                # the TIME-expiring view (last _ADMISSION_STALE_S s)
                "latency_recent_ms": {
                    str(k): v for k, v in rq.items()
                },
                "latency_recent_samples": rsamples,
            }
        ))

    def latency_quantiles_ms(self, qs=(0.5, 0.99)) -> dict:
        return self.latency_window(qs)[0]

    def latency_window(self, qs=(0.5, 0.99)):
        """``(quantiles, samples)`` over the rolling latency window;
        ``samples`` rides along so no consumer mistakes a 3-request
        "p99" for a measurement."""
        with self._lat_lock:
            lats = list(self._latencies_ms)
        if not lats:
            return {}, 0
        return {q: quantile_nearest_rank(lats, q) for q in qs}, len(lats)

    def _recent_latencies(self) -> list:
        """The latencies of the last ``_ADMISSION_STALE_S`` seconds."""
        horizon = time.monotonic() - self._ADMISSION_STALE_S
        with self._lat_lock:
            while self._adm_lats and self._adm_lats[0][0] < horizon:
                self._adm_lats.popleft()
            return [ms for _, ms in self._adm_lats]

    def latency_recent(self, qs=(0.5, 0.99)):
        """``(quantiles, samples)`` over the TIME-expiring admission
        window — the view ``_admission_check`` judges deadlines
        against; it decays by wall clock, not by displacement."""
        lats = self._recent_latencies()
        if not lats:
            return {}, 0
        return {q: quantile_nearest_rank(lats, q) for q in qs}, len(lats)

    def take_fresh_latencies(self) -> list:
        """Drain the latencies observed since the last call — the
        autoscaler's per-tick feed."""
        with self._lat_lock:
            fresh = list(self._fresh_lats)
            self._fresh_lats.clear()
        return fresh

    def _metrics(self):
        from trpo_torch.serve.replicaset import RECORD_STATES

        snap = self.replicaset.snapshot()
        lines = []

        def fam(name, mtype, help_, samples):
            rows = []
            for labels, value in samples:
                if isinstance(value, bool):
                    value = float(value)
                if not isinstance(value, (int, float)):
                    continue
                lbl = ",".join(
                    f'{k}="{_esc(v)}"' for k, v in labels.items()
                )
                rows.append(
                    f"{name}{{{lbl}}} {_fmt(float(value))}"
                    if lbl else f"{name} {_fmt(float(value))}"
                )
            if rows:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {mtype}")
                lines.extend(rows)

        replicas = snap["replicas"]
        fam(
            "trpo_router_replicas", "gauge",
            "replica-set size", [({}, snap["size"])],
        )
        fam(
            "trpo_router_replicas_healthy", "gauge",
            "replicas currently healthy", [({}, snap["healthy"])],
        )
        fam(
            "trpo_router_replica_state", "gauge",
            "replica rotation state (one-hot over record states)",
            [
                ({"replica": rid, "state": s},
                 1.0 if row["state"] == s else 0.0)
                for rid, row in sorted(replicas.items())
                for s in RECORD_STATES
            ],
        )
        fam(
            "trpo_router_replica_inflight", "gauge",
            "router-outstanding requests per replica",
            [
                ({"replica": rid}, row["inflight"])
                for rid, row in sorted(replicas.items())
            ],
        )
        fam(
            "trpo_router_replica_restarts", "counter",
            "relaunches consumed per replica (crash budget)",
            [
                ({"replica": rid}, row["restarts"])
                for rid, row in sorted(replicas.items())
            ],
        )
        fam(
            "trpo_router_replica_checkpoint_step", "gauge",
            "checkpoint step each replica currently serves",
            [
                ({"replica": rid}, row["loaded_step"])
                for rid, row in sorted(replicas.items())
                if row["loaded_step"] is not None
            ],
        )
        fam(
            "trpo_router_replica_canary", "gauge",
            "1 while the replica is canarying an unvalidated checkpoint",
            [
                ({"replica": rid}, 1.0 if row.get("canary") else 0.0)
                for rid, row in sorted(replicas.items())
            ],
        )
        with self._lock:
            counter_rows = [
                ("trpo_router_routed_total",
                 "requests answered via a replica", self.routed_total),
                ("trpo_router_retried_total",
                 "transparent one-shot transport retries",
                 self.retried_total),
                ("trpo_router_failed_total",
                 "requests failed after the retry", self.failed_total),
                ("trpo_router_backpressure_total",
                 "503s for saturation or empty rotation",
                 self.backpressure_total),
                ("trpo_router_retries_skipped_total",
                 "retries shed by the exhausted retry budget",
                 self.retries_skipped_total),
                ("trpo_router_shed_deadline_total",
                 "immediate 503s for requests whose deadline_ms the "
                 "observed p99 already exceeded",
                 self.shed_deadline_total),
                ("trpo_router_shed_stateless_total",
                 "stateless requests shed by the saturation headroom "
                 "(session traffic sheds last)",
                 self.shed_stateless_total),
                ("trpo_router_sessions_created_total",
                 "sessions minted through the router",
                 self.sessions_created_total),
                ("trpo_router_sessions_reestablished_total",
                 "sessions re-established after replica death "
                 "(fresh carry — no journal entry existed)",
                 self.sessions_reestablished_total),
                ("trpo_router_sessions_resumed_total",
                 "sessions resumed from a journaled carry after "
                 "replica death (lossless failover)",
                 self.sessions_resumed_total),
                ("trpo_router_sessions_drained_total",
                 "sessions moved losslessly off a draining replica "
                 "(elastic scale-in)",
                 self.sessions_drained_total),
                ("trpo_router_episodes_total",
                 "client-reported episodes booked against replicas "
                 "(the realized-return feed the reward gate judges)",
                 self.episodes_total),
            ]
            sessions_live = len(self._affinity)
        for name, help_, value in counter_rows:
            fam(name, "counter", help_, [({}, value)])
        fam(
            "trpo_router_sessions_active", "gauge",
            "sessions with live affinity", [({}, sessions_live)],
        )
        quantiles, lat_samples = self.latency_window((0.5, 0.99))
        fam(
            "trpo_router_latency_ms", "gauge",
            "routed-request latency quantiles over the recent window",
            [
                ({"quantile": str(q)}, v)
                for q, v in sorted(quantiles.items())
            ],
        )
        fam(
            "trpo_router_latency_window_samples", "gauge",
            "samples behind the latency quantiles (a 3-request p99 is "
            "not a measurement — consumers gate on this)",
            [({}, lat_samples)],
        )
        with self._lock:
            wire_rows = sorted(self.wire_frames_total.items())
            transport_rows = sorted(
                self.dispatch_transport_total.items()
            )
            decode_errors = self.wire_decode_errors_total
        fam(
            "trpo_router_wire_frames_total", "counter",
            "client requests by negotiated payload codec",
            [({"codec": c}, v) for c, v in wire_rows],
        )
        fam(
            "trpo_router_wire_decode_errors_total", "counter",
            "binary frames the router could not restamp (forwarded "
            "untouched for the replica's typed 400)",
            [({}, decode_errors)],
        )
        fam(
            "trpo_router_dispatch_transport_total", "counter",
            "replica hops by transport (same-host UDS vs TCP)",
            [({"transport": t}, v) for t, v in transport_rows],
        )
        if self.tracer is not None:
            # writer-backpressure drops are counted, never silent
            fam("trpo_trace_spans_total", "counter",
                "trace spans accepted for emission",
                [({}, self.tracer.spans_total)])
            fam("trpo_trace_sampled_total", "counter",
                "request traces emitted (head-sampled or forced)",
                [({}, self.tracer.sampled_total)])
            fam("trpo_trace_dropped_total", "counter",
                "trace spans dropped by writer backpressure",
                [({}, self.tracer.dropped_total)])
        if self.capture is not None:
            # dropped_total 0 certifies the capture log is complete
            fam("trpo_capture_requests_total", "counter",
                "requests captured for deterministic replay",
                [({}, self.capture.requests_total)])
            fam("trpo_capture_dropped_total", "counter",
                "capture records dropped by writer backpressure",
                [({}, self.capture.dropped_total)])
            fam("trpo_capture_bytes_total", "counter",
                "request payload bytes accepted for capture",
                [({}, self.capture.bytes_total)])
        body = ("\n".join(lines) + "\n").encode()
        return 200, "text/plain; version=0.0.4; charset=utf-8", body

    def close(self) -> None:
        self._flush_shed_counts()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            loop = getattr(httpd, "loop", None)
            if loop is not None and loop.is_running():
                # drain the loop-owned replica pools ON the loop before
                # stopping it

                async def _drain():
                    self._apool_close_all()

                try:
                    asyncio.run_coroutine_threadsafe(
                        _drain(), loop
                    ).result(timeout=2.0)
                except Exception:
                    pass
            httpd.close()
