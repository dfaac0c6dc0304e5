"""Host/replica transport: the seam that crosses the machine boundary
(counterpart: ``trpo_tpu/serve/transport.py``, whose design this copies).

A failed ``/healthz`` poll means a replica is dead only when router and
replica share a fate domain. Across hosts a host can PARTITION while its
replica processes stay healthy, a launch can land while its ``run.json``
never becomes readable, and a slow network stretches every exchange. The
transport makes those failure modes explicit:

* :class:`LocalExecTransport` — the default: ONE implicit host
  (``"local"``), launches through the caller's ``launcher(replica_id)``.
  With no gate armed, ``gate()`` is a no-op.
* :class:`TemplateTransport` — N named hosts behind the
  ``cfg.serve_replica_cmd`` launch template
  (:func:`~trpo_torch.serve.replicaset.render_launch_argv`, which
  substitutes ``{host}`` alongside ``{port}``/``{checkpoint}``/
  ``{replica}``). Placement is round-robin over hosts, skipping hosts
  the caller marks *suspect*. ``{replica}`` renders as the
  HOST-NAMESPACED replica name (``<host>--<rid>``) so two hosts minting
  the same replica id never share a carry-journal file.
* **Gated exchanges** — :meth:`gate` runs before every router→replica
  and supervisor→replica exchange: a partitioned host raises
  :class:`TransportPartitioned` (blackholed both ways), a slow host
  sleeps the set per-exchange latency first. The replica process itself
  is untouched: detection comes from lease expiry
  (``serve/replicaset.py``). The gates (``partition``, ``heal``,
  ``slow``, ``lose_descriptors``) are the transport's own methods; the
  fault injector that arms them from a fault grammar is ROADMAP.md
  Queue 1 item 18.4.
* **Bounded descriptor discovery** — a transport-launched replica is
  discovered through its ``run.json`` with bounded retries under
  exponential backoff and a per-attempt time budget; a descriptor that
  never lands RAISES out of ``discover()``, which the supervisor books
  as a loud launch failure (crash budget → ``failed``).
* **Gated kill** — a partitioned host's replica cannot be signalled:
  :meth:`_TransportHandle.kill` skips while the partition holds, leaving
  a partitioned-but-alive zombie behind — the writer the carry journal's
  fencing refuses. ``close()`` is ungated and reaps every process the
  transport launched.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "TransportPartitioned",
    "LocalExecTransport",
    "TemplateTransport",
]

LOCAL_HOST = "local"


class TransportPartitioned(ConnectionError):
    """The transport to this host is blackholed (both ways)."""


class _ChaosGates:
    """The per-host gate state every transport shares: partitions
    (blackhole until a monotonic deadline), injected per-exchange
    latency, and lost-descriptor marks. Thread-safe — a caller may arm
    these from any thread while the supervisor and the router's handler
    threads consult them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._partitioned_until: Dict[str, float] = {}
        self._latency_ms: Dict[str, float] = {}
        self._lost_descriptors: set = set()

    # -- the gates -----------------------------------------------------------

    def partition(self, host: str, seconds: float) -> None:
        """Blackhole every exchange with ``host`` for ``seconds`` —
        the replica processes there stay alive and keep running."""
        with self._lock:
            self._partitioned_until[host] = time.monotonic() + float(
                seconds
            )

    def heal(self, host: str) -> None:
        with self._lock:
            self._partitioned_until.pop(host, None)

    def slow(self, host: str, ms: float) -> None:
        """Add ``ms`` of latency to every exchange with ``host``."""
        with self._lock:
            if ms <= 0:
                self._latency_ms.pop(host, None)
            else:
                self._latency_ms[host] = float(ms)

    def lose_descriptors(self, host: str) -> None:
        """From now on, launches on ``host`` land but their run.json
        never becomes readable — the bounded discovery budget must
        fail the launch loudly."""
        with self._lock:
            self._lost_descriptors.add(host)

    # -- the exchange gate -------------------------------------------------

    def partitioned(self, host: str) -> bool:
        with self._lock:
            until = self._partitioned_until.get(host)
            if until is None:
                return False
            if time.monotonic() >= until:
                del self._partitioned_until[host]
                return False
            return True

    def descriptors_lost(self, host: str) -> bool:
        with self._lock:
            return host in self._lost_descriptors

    def gate_delay(self, host: str) -> float:
        """The non-blocking half of :meth:`gate` (the asyncio router
        must not ``time.sleep`` on its event loop):
        raise :class:`TransportPartitioned` while a partition holds,
        otherwise return the injected latency in ms the CALLER must
        pay (``await asyncio.sleep`` on the loop, ``time.sleep`` in
        :meth:`gate`) — 0.0 with no gate armed."""
        if self.partitioned(host):
            raise TransportPartitioned(
                f"transport to host {host!r} is partitioned"
            )
        with self._lock:
            lat = self._latency_ms.get(host)
        return float(lat) if lat else 0.0

    def gate(self, host: str) -> float:
        """Model one exchange with ``host``: raise
        :class:`TransportPartitioned` while a partition holds, pay the
        injected latency otherwise. No gate armed = no-op. Returns the
        latency PAID in ms (0.0 normally)."""
        lat = self.gate_delay(host)
        if lat:
            time.sleep(lat / 1e3)
        return lat

    def same_host(self, host: str) -> bool:
        """Does ``host`` share this process's machine? The router's
        UDS dial predicate: same-host replica hops may ride
        an AF_UNIX socket; cross-host hops stay TCP. Only the implicit
        local host qualifies — a :class:`TemplateTransport`'s NAMED
        hosts are remote by definition (even a test faking them
        in-process models a cross-host topology, and must keep paying
        the TCP/gate semantics it exists to exercise)."""
        return host == LOCAL_HOST


class LocalExecTransport(_ChaosGates):
    """The local launcher behind the transport interface: one implicit
    host, ``launcher(replica_id)`` launches. The default every
    :class:`~trpo_torch.serve.replicaset.ReplicaSet` wraps its launcher
    in; with no gate armed it adds nothing to a launch or an exchange."""

    def __init__(self, launcher: Callable[[str], object]):
        super().__init__()
        if launcher is None:
            raise ValueError(
                "LocalExecTransport needs a launcher(replica_id) callable"
            )
        self._launcher = launcher
        self.hosts: Tuple[str, ...] = (LOCAL_HOST,)

    def place(self, avoid=()) -> str:
        return LOCAL_HOST

    def launch(self, host: str, replica_id: str):
        """The caller's launcher owns everything. Handles are NOT wrapped —
        ``kill()``/``alive()``/``discover()`` keep their exact local
        semantics (a local process can always be signalled)."""
        return self._launcher(replica_id)

    def replica_name(self, host: str, replica_id: str) -> str:
        return replica_id

    def close(self) -> None:
        pass


class _TransportHandle:
    """A transport-launched replica handle: wraps the inner handle
    (``SubprocessReplica`` or a test-supplied in-process stand-in) with
    the host gate on ``alive``/``kill``/``discover`` and the bounded
    descriptor-discovery budget.

    Discovery contract: each :meth:`discover` call from the supervisor
    tick is at most ONE attempt (so a slow transport never wedges the
    tick); attempts are paced by exponential backoff and each is held
    to ``attempt_timeout``; once ``max_attempts`` are spent with no
    descriptor, discover RAISES — the supervisor books the launch as
    failed-loudly (never a phantom ``starting`` record)."""

    def __init__(
        self,
        transport,
        host: str,
        inner,
        max_attempts: int = 30,
        backoff: float = 0.25,
        backoff_cap: float = 2.0,
        attempt_timeout: float = 2.0,
    ):
        self.transport = transport
        self.host = host
        self.inner = inner
        self.max_attempts = int(max_attempts)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.attempt_timeout = float(attempt_timeout)
        self._attempts = 0
        self._next_attempt = 0.0
        self._started = time.monotonic()
        # an in-process stand-in knows its URL immediately; a
        # subprocess child is discovered through its descriptor
        self.url: Optional[str] = getattr(inner, "url", None)

    def discover(self) -> Optional[str]:
        if self.url is not None:
            return self.url
        now = time.monotonic()
        if now < self._next_attempt:
            return None  # backoff pacing: not this tick
        self._attempts += 1
        self._next_attempt = now + min(
            self.backoff * (2 ** (self._attempts - 1)), self.backoff_cap
        )
        url = None
        try:
            self.transport.gate(self.host)
            if self.transport.descriptors_lost(self.host):
                raise TransportPartitioned(
                    f"descriptor on host {self.host!r} unreadable"
                )
            t0 = time.monotonic()
            url = getattr(self.inner, "discover", lambda: None)()
            if time.monotonic() - t0 > self.attempt_timeout:
                # a real remote fetch that overran its per-attempt
                # budget does not count as a success even if it
                # eventually returned — the NEXT attempt re-reads
                url = None
        except TransportPartitioned:
            url = None
        if url is not None:
            self.url = url
            return url
        if self._attempts >= self.max_attempts:
            raise LookupError(
                f"descriptor discovery exhausted {self.max_attempts} "
                f"attempts over "
                f"{time.monotonic() - self._started:.1f}s on host "
                f"{self.host!r} — the launch landed but run.json never "
                "became readable"
            )
        return None

    def alive(self) -> bool:
        """While the host is partitioned, liveness is UNKNOWABLE — and
        an unknowable replica must be treated as alive so the LEASE
        (not a misread local poll) owns the eviction decision."""
        if self.transport.partitioned(self.host):
            return True
        return self.inner.alive()

    def kill(self) -> None:
        """Best-effort: a partitioned host's replica cannot be
        signalled — the kill is SKIPPED (the process lives on as a
        zombie; the journal fence is what defuses its writes). The
        transport reaps it at close()."""
        if self.transport.partitioned(self.host):
            return
        self.inner.kill()

    def close(self) -> None:
        # teardown is ungated: the test/smoke harness owns both ends
        self.inner.close()

    def __getattr__(self, name):
        # e.g. `.server` of an in-process replica, `.proc` of a child
        return getattr(self.inner, name)


class TemplateTransport(_ChaosGates):
    """N named hosts behind the ``serve_replica_cmd`` launch template.

    ``launch_fn(host, replica_id, replica_name)`` overrides the
    subprocess launch (tests build in-process replicas per "host" to
    exercise partitions without process spawns); the default renders
    the template — ``{host}`` substituted alongside ``{port}``/
    ``{checkpoint}``/``{replica}`` (``{replica}`` = the host-namespaced
    name) — and spawns a
    :class:`~trpo_torch.serve.replicaset.SubprocessReplica` discovered
    through its run.json over the gated, bounded discovery path."""

    def __init__(
        self,
        template: Optional[str],
        hosts,
        checkpoint: Optional[str] = None,
        replica_root: Optional[str] = None,
        launch_fn: Optional[Callable] = None,
        discover_attempts: int = 30,
        discover_backoff: float = 0.25,
        discover_backoff_cap: float = 2.0,
        attempt_timeout: float = 2.0,
    ):
        super().__init__()
        hosts = tuple(str(h) for h in hosts)
        if not hosts or any(not h for h in hosts):
            raise ValueError(
                f"hosts must be a non-empty list of names, got {hosts!r}"
            )
        if len(set(hosts)) != len(hosts):
            raise ValueError(f"duplicate host names in {hosts!r}")
        if launch_fn is None and not (template and template.strip()):
            raise ValueError(
                "TemplateTransport needs a serve_replica_cmd template "
                "(or an explicit launch_fn)"
            )
        self.template = template
        self.hosts = hosts
        self.checkpoint = checkpoint
        self.replica_root = replica_root
        self._launch_fn = launch_fn
        self.discover_attempts = int(discover_attempts)
        self.discover_backoff = float(discover_backoff)
        self.discover_backoff_cap = float(discover_backoff_cap)
        self.attempt_timeout = float(attempt_timeout)
        self._rr = 0
        self._launched: List[object] = []  # every inner handle, for reap

    def replica_name(self, host: str, replica_id: str) -> str:
        """The host-namespaced replica name — the key both halves of
        the carry-journal protocol share
        (``journal_path(dir, rid, host=host)`` ==
        ``journal_path(dir, replica_name)``), so replica-id reuse
        across hosts can never collide on a journal file."""
        return f"{host}--{replica_id}"

    def place(self, avoid=()) -> str:
        """Round-robin placement over the host list, skipping hosts in
        ``avoid`` (the caller's suspect set). When every host is
        avoided, fall back to plain round-robin — degraded placement
        beats refusing to launch replacement capacity at all."""
        avoid = set(avoid)
        candidates = [h for h in self.hosts if h not in avoid] or list(
            self.hosts
        )
        with self._lock:  # supervisor relaunch + autoscaler scale-out
            #               place concurrently; an unlocked cursor
            #               would double-place on one host
            host = candidates[self._rr % len(candidates)]
            self._rr += 1
        return host

    def launch(self, host: str, replica_id: str) -> _TransportHandle:
        name = self.replica_name(host, replica_id)
        if self._launch_fn is not None:
            inner = self._launch_fn(host, replica_id, name)
        else:
            from trpo_torch.serve.replicaset import (
                SubprocessReplica,
                render_launch_argv,
            )

            root = self.replica_root or os.path.join(
                str(self.checkpoint or "."), "replicas"
            )
            inner = SubprocessReplica(
                [],
                os.path.join(root, name),
                command=render_launch_argv(
                    self.template,
                    port=0,
                    checkpoint=self.checkpoint,
                    replica=name,
                    host=host,
                ),
            )
        with self._lock:
            self._launched.append(inner)
        return _TransportHandle(
            self,
            host,
            inner,
            max_attempts=self.discover_attempts,
            backoff=self.discover_backoff,
            backoff_cap=self.discover_backoff_cap,
            attempt_timeout=self.attempt_timeout,
        )

    def close(self) -> None:
        """Reap every process this transport ever launched — including
        zombies a partition left unsignalled (their gated kill was
        skipped; teardown is local to the harness and ungated)."""
        with self._lock:
            launched, self._launched = self._launched, []
        for inner in launched:
            try:
                # close() is graceful (terminate, then kill on timeout)
                # and idempotent for already-closed handles — a zombie
                # child's event log must not be torn by a raw SIGKILL
                inner.close()
            except Exception:
                pass
