"""Request-scoped tracing for the serving plane: spans on the event bus
(counterpart: ``trpo_tpu/obs/trace.py``, copied: it imports only the
standard library, and the port imports nothing of the reference package).

Aggregate windowed quantiles cannot say whether a slow request's time
went to queue admission, epoch coalescing under the deadline batcher, a
retried transport hop, a slow-network host, or a journal-backed
failover. This module is the attribution layer: every request through
the router (or a solo ``PolicyServer``) gets a 128-bit ``trace_id``
minted at the public edge (or accepted from a client's ``X-Trace-Id``
header), the id rides every router→replica HTTP hop as headers (so
``TemplateTransport`` multi-host hops carry it for free), and each stage
emits typed ``span`` records through the event bus — the JSONL stream
the reference's ``validate_events.py`` checks and ``analyze_run.py``
assembles.

Span model (single-record, end-stamped):

* One ``span`` event per finished span: ``trace`` (the 128-bit hex
  trace id), ``span`` (64-bit hex span id), optional ``parent``,
  ``name``, ``start`` (unix seconds), ``dur_ms`` (None ONLY for a span
  that was never terminated — the validator FAILS an unterminated
  root), free-form flat attrs (``replica``, ``host``, ``width``, …).
* ``remote: true`` marks a span whose parent was emitted by ANOTHER
  process (the id arrived in the ``X-Trace-Parent`` header): each
  process's log is self-consistent — ``validate_events.py`` FAILS an
  orphan (non-remote parent never emitted in the same file) without
  false-positives on cross-process edges, and the assembler joins the
  per-process logs back into one tree.
* The SHARED epoch span: every session act coalesced into one
  ``step_batch`` dispatch gets a per-trace copy of the dispatch span
  wearing the SAME ``span`` id (and width/rung attrs) — N traces
  pointing at one span id is what makes epoch-induced tail latency
  visible in the assembled view.

Sampling is HEAD-based and deterministic: the decision is a pure hash
of the trace id against ``sample_rate``, so the router and every
replica agree on one trace without coordination — and the router
additionally stamps the decision into the ``X-Trace-Sampled`` header
so a forced (anomaly) trace propagates too. Anomalies are ALWAYS
sampled regardless of rate: a retried, failed, resumed/re-established,
or chaos-fired request calls :meth:`TraceContext.force`, and the
buffered spans are emitted at finish — every anomaly has a trace.

Hot-path cost: spans buffer in their request's :class:`TraceContext`
(plain object appends); :meth:`Tracer.finish` moves an emitted
context's spans into a BOUNDED pending deque with one list-extend, and
a daemon writer drains them through ``bus.emit`` — the CarryJournal /
StatsDrain write-behind pattern. Writer backpressure DROPS spans (the
bound is a bound) and counts every drop in ``dropped_total`` — never
silent, exported as ``trpo_trace_dropped_total`` on /metrics.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = [
    "TRACE_HEADER",
    "PARENT_HEADER",
    "SAMPLED_HEADER",
    "Span",
    "TraceContext",
    "Tracer",
    "mint_trace_id",
    "mint_span_id",
    "valid_trace_id",
    "head_sampled",
]

# the propagation contract: the trace id a
# client may supply / read back, the parent span id of the hop, and the
# edge's sampling decision — plain headers, so every transport that
# carries HTTP (local, ssh-tunneled, k8s) carries traces for free
TRACE_HEADER = "X-Trace-Id"
PARENT_HEADER = "X-Trace-Parent"
SAMPLED_HEADER = "X-Trace-Sampled"


def mint_trace_id() -> str:
    """A fresh 128-bit trace id (32 hex chars) — minted at the public
    edge (router or solo server) unless the client supplied one."""
    return os.urandom(16).hex()


def mint_span_id() -> str:
    """A fresh 64-bit span id (16 hex chars)."""
    return os.urandom(8).hex()


_HEX = frozenset("0123456789abcdefABCDEF")


def valid_trace_id(tid) -> bool:
    """Accept a client-supplied trace id: hex DIGITS ONLY, 8–64 chars
    (``int(x, 16)`` would also take ``0x`` prefixes, signs,
    underscores and whitespace — none of which belong in a log key).
    Anything else is replaced by a minted id: a hostile/typoed header
    must not become an unjoinable key or a log-injection vector."""
    return (
        isinstance(tid, str)
        and 8 <= len(tid) <= 64
        and all(c in _HEX for c in tid)
    )


def head_sampled(trace_id: str, rate: float) -> bool:
    """The head-based sampling decision as a pure function of the trace
    id: every process hashing the same id reaches the same verdict with
    no coordination (client-supplied ids are hashed, not trusted to be
    uniform)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    digest = hashlib.sha256(trace_id.encode()).digest()
    return int.from_bytes(digest[:8], "big") < rate * 2.0**64


class Span:
    """One in-flight span: started now, ended (at most) once. The
    record is built at :meth:`end` and buffered on the owning context —
    never written on the request path."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "start", "_p0",
        "dur_ms", "remote", "attrs", "_ctx",
    )

    def __init__(
        self,
        ctx: "TraceContext",
        name: str,
        parent_id: Optional[str] = None,
        remote: bool = False,
        span_id: Optional[str] = None,
        **attrs,
    ):
        self.trace_id = ctx.trace_id
        self.span_id = span_id or mint_span_id()
        self.parent_id = parent_id
        self.name = name
        self.start = time.time()
        self._p0 = time.perf_counter()
        self.dur_ms: Optional[float] = None
        self.remote = bool(remote)
        self.attrs = attrs
        self._ctx = ctx

    def end(self, **attrs) -> "Span":
        """Terminate the span (idempotent — the first end wins) and
        buffer its record on the context."""
        if self.dur_ms is not None:
            return self
        self.dur_ms = (time.perf_counter() - self._p0) * 1e3
        if attrs:
            self.attrs.update(attrs)
        self._ctx._add(self._record())
        return self

    def _record(self) -> dict:
        rec = {
            "trace": self.trace_id,
            "span": self.span_id,
            "name": self.name,
            "start": self.start,
            "dur_ms": self.dur_ms,
        }
        if self.parent_id is not None:
            rec["parent"] = self.parent_id
        if self.remote:
            rec["remote"] = True
        rec.update(self.attrs)
        return rec


class TraceContext:
    """One request's trace state: the id, the sampling verdict, and the
    span buffer. Spans from any thread touching the request (handler,
    epoch dispatcher, journal hook) append under one small lock; the
    whole buffer is emitted — or dropped — exactly once at
    :meth:`Tracer.finish`."""

    __slots__ = ("trace_id", "sampled", "forced", "_spans", "_lock")

    def __init__(self, trace_id: str, sampled: bool):
        self.trace_id = trace_id
        self.sampled = bool(sampled)
        self.forced = False
        self._spans: list = []
        self._lock = threading.Lock()

    def span(
        self,
        name: str,
        parent: Optional["Span"] = None,
        parent_id: Optional[str] = None,
        remote: bool = False,
        span_id: Optional[str] = None,
        **attrs,
    ) -> Span:
        """Start a child span (``parent`` wins over ``parent_id``)."""
        if parent is not None:
            parent_id = parent.span_id
        return Span(
            self, name, parent_id=parent_id, remote=remote,
            span_id=span_id, **attrs,
        )

    def record(
        self,
        name: str,
        start: float,
        dur_ms: float,
        parent_id: Optional[str] = None,
        span_id: Optional[str] = None,
        remote: bool = False,
        **attrs,
    ) -> str:
        """Buffer an already-measured span retroactively (the epoch
        batcher times its queue-wait and dispatch windows itself, then
        books them per participating trace — passing the SAME
        ``span_id`` for every coalesced trace's dispatch copy is what
        makes the shared epoch span). Returns the span id."""
        sid = span_id or mint_span_id()
        rec = {
            "trace": self.trace_id,
            "span": sid,
            "name": name,
            "start": start,
            "dur_ms": dur_ms,
        }
        if parent_id is not None:
            rec["parent"] = parent_id
        if remote:
            rec["remote"] = True
        rec.update(attrs)
        self._add(rec)
        return sid

    def force(self) -> None:
        """Mark this trace an ANOMALY (retried / failed / resumed /
        chaos-fired): its spans are emitted regardless of the head
        sampling verdict — every anomaly has a trace."""
        self.forced = True

    @property
    def emitting(self) -> bool:
        return self.sampled or self.forced

    def _add(self, rec: dict) -> None:
        with self._lock:
            self._spans.append(rec)

    def _take(self) -> list:
        with self._lock:
            spans, self._spans = self._spans, []
        return spans


class Tracer:
    """Request-trace fan-in for one process: mints/joins contexts,
    owns the sampling rate, and drains emitted spans to the event bus
    on a daemon writer (write-behind — the act path never touches the
    bus).

    ``process`` (e.g. ``"router"`` or the replica name) and ``host``
    stamp every span this process emits, so the assembler can tell
    which side of a hop each record came from without guessing."""

    def __init__(
        self,
        bus,
        sample_rate: float = 0.0,
        process: Optional[str] = None,
        host: Optional[str] = None,
        max_pending: int = 4096,
        poll_interval: float = 0.2,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}"
            )
        if max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}"
            )
        self.bus = bus
        self.sample_rate = float(sample_rate)
        self.process = process
        self.host = host
        self.max_pending = int(max_pending)
        self._poll = float(poll_interval)
        # counters (read by the /metrics handlers): spans_total counts
        # spans accepted into the pending buffer, sampled_total counts
        # emitted TRACES (contexts), dropped_total counts spans the
        # bounded buffer refused — backpressure is visible, not silent
        self.spans_total = 0
        self.sampled_total = 0
        self.dropped_total = 0
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._wake = threading.Event()
        self._stop = False
        self._writer = threading.Thread(
            target=self._loop, name="trace-writer", daemon=True
        )
        self._writer.start()

    # -- context lifecycle -------------------------------------------------

    def begin(
        self, trace_id: Optional[str] = None, sampled: Optional[bool] = None
    ) -> TraceContext:
        """The public-edge entry: accept a (valid) client-supplied
        trace id or mint one; head-sample unless the caller already
        knows the verdict (a propagated ``X-Trace-Sampled`` header)."""
        if trace_id is None or not valid_trace_id(trace_id):
            trace_id = mint_trace_id()
        if sampled is None:
            sampled = head_sampled(trace_id, self.sample_rate)
        return TraceContext(trace_id, sampled)

    def join(self, headers) -> Optional[TraceContext]:
        """The replica-side entry: join the trace the incoming hop
        carries, or — when no trace header arrived — act as the public
        edge (a solo server IS the edge). ALWAYS returns a context: an
        unsampled one still buffers (a couple of cheap allocs per
        request), because a replica-side anomaly — a 500, an engine
        failure — must be able to ``force()`` its spans out even when
        the edge's head sample said no; the anomalies-always-trace
        policy holds on BOTH sides of the hop. ``headers`` is any
        ``.get(name)``-able mapping (``http.server`` headers, a plain
        dict, or None)."""
        tid = headers.get(TRACE_HEADER) if headers is not None else None
        if tid is not None and valid_trace_id(tid):
            sampled = (
                headers.get(SAMPLED_HEADER) == "1"
                or head_sampled(tid, self.sample_rate)
            )
            return TraceContext(tid, sampled)
        # no propagated trace: this process is the edge (direct client)
        return self.begin(trace_id=tid)

    def parent_from(self, headers) -> Optional[str]:
        """The propagated parent span id of the incoming hop."""
        pid = headers.get(PARENT_HEADER) if headers is not None else None
        return pid if isinstance(pid, str) and pid else None

    @staticmethod
    def headers_for(ctx: TraceContext, parent: Optional[Span]) -> Dict[str, str]:
        """The headers one outgoing hop carries: trace id, the hop
        span's id as the downstream parent, and the CURRENT sampling
        verdict (a trace forced mid-flight propagates as sampled, so
        the retry/takeover leg's replica spans exist too)."""
        headers = {TRACE_HEADER: ctx.trace_id}
        if parent is not None:
            headers[PARENT_HEADER] = parent.span_id
        if ctx.emitting:
            headers[SAMPLED_HEADER] = "1"
        return headers

    # -- emission ----------------------------------------------------------

    def finish(self, ctx: Optional[TraceContext]) -> bool:
        """The request is over: emit the context's buffered spans when
        the trace is sampled/forced, drop them otherwise. Returns
        whether the trace was emitted (callers stamp ``trace`` onto
        their request event exactly when it was).

        Backpressure drops WHOLE contexts, never span tails: a partial
        trace would manufacture validator failures (the root span ends
        last, so a tail-drop preferentially orphans its children).
        FORCED (anomaly) contexts overshoot the bound instead of
        dropping — they are rare, their request events already named
        the trace, and the validator's retry/takeover contracts depend
        on their spans existing; the overshoot is bounded by one
        request's span count."""
        if ctx is None:
            return False
        spans = ctx._take()
        if not spans or not ctx.emitting:
            return False
        stamp = {}
        if self.process is not None:
            stamp["process"] = self.process
        if self.host is not None:
            stamp["host"] = self.host
        with self._lock:
            if self._stop:
                return False
            if (
                not ctx.forced
                and len(self._pending) + len(spans) > self.max_pending
            ):
                self.dropped_total += len(spans)
                return False
            for rec in spans:
                if stamp:
                    rec = {**rec, **stamp}
                self._pending.append(rec)
            self.spans_total += len(spans)
            self.sampled_total += 1
        self._wake.set()
        return True

    def _loop(self) -> None:
        while True:
            with self._lock:
                pending, self._pending = self._pending, deque()
                stop = self._stop
            if pending:
                try:
                    # ONE bus-lock hold + one sink write for the whole
                    # drain: per-span emit (write+flush each, under the
                    # lock every dispatcher thread shares) was the
                    # measurable hot-path cost on the serving bench
                    self.bus.emit_batch("span", pending)
                except Exception:
                    # a closed bus (teardown race) or a sink error must
                    # never kill the writer — but the loss is COUNTED:
                    # dropped_total=0 must mean genuinely lossless
                    # (spans_total stays "accepted for emission";
                    # written = spans_total - dropped_total)
                    with self._lock:
                        self.dropped_total += len(pending)
            if stop:
                return
            self._wake.wait(timeout=self._poll)
            self._wake.clear()

    def drain(self, timeout: float = 5.0) -> None:
        """Block until the pending buffer is empty (tests, teardown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    return
            self._wake.set()
            time.sleep(0.01)

    def close(self) -> None:
        """Flush and stop the writer (the bus is the caller's — closed
        after, like every other bus consumer)."""
        with self._lock:
            self._stop = True
        self._wake.set()
        self._writer.join(timeout=5.0)
