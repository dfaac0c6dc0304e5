"""Replica manager: N serving replicas, supervised, restartable
(counterpart: ``trpo_tpu/serve/replicaset.py``).

* A **replica** is one complete serving stack answering ``POST /act``
  (or the session protocol) on its own ephemeral port. Two launchers:

  - :class:`InProcessReplica` — engine + batcher + ``PolicyServer``
    built in this process by a caller-supplied factory. The N engines
    share one interpreter and, on a card, one CUDA context.
  - :class:`SubprocessReplica` — a ``python -m trpo_torch.serve`` child
    process, discovered through its ``run.json`` descriptor (the child
    writes the bound URL atomically; the supervisor polls the file and
    never parses stdout). Each child has its own interpreter and its own
    CUDA context.

* The **supervisor thread** polls every replica's ``GET /healthz`` on
  ``health_interval``. A replica answering ``reloading=true`` leaves
  rotation while its hot reload is in flight and returns when it lands.
  A replica that stops answering is ``evicted`` (out of rotation at
  once) and relaunched after an exponential backoff, burning its
  ``max_restarts`` crash budget; past the budget it is ``failed`` for
  good and the SET keeps serving on the survivors. The router reports a
  death it observed mid-request (:meth:`ReplicaSet.report_failure`), so
  eviction does not wait for the next poll.

**Multi-host liveness.** Every replica is placed on a HOST through a
transport (``serve/transport.py``; ``LocalExecTransport`` by default).
With ``lease_ttl`` armed, each replica holds an epoch-numbered LEASE
renewed by every answered ``/healthz``, and lease EXPIRY, not a failed
poll, evicts; the relaunch is placed on a host not marked suspect.
Transport errors first mark the host *suspect*: its replicas are held
out of new placement while the lease decides.

:class:`CanaryController` turns a new checkpoint into a gated
deployment over the set (see its docstring).

With a ``bus`` (``obs.events.EventBus``) every transition is an event, as
in the reference: replica lifecycle and host health as ``router``
records, leases as ``lease`` records, each canary transition as a
``canary`` record (a rejection also as ``health:canary_rejected``). The
state of record beside them is :meth:`ReplicaSet.snapshot` (with each
record's ``last_death_reason``) and the controller's counters and
``last_reason``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional


__all__ = [
    "RECORD_STATES",
    "InProcessReplica",
    "SubprocessReplica",
    "render_launch_argv",
    "ReplicaSet",
    "CanaryController",
]

# the states a ReplicaRecord takes (the rotation view; died/restarted/
# drained are transitions, not states). `draining` is the lossless scale-in window: the replica is
# out of stateless rotation and takes no new sessions, but pinned
# session traffic still reaches it while the autoscaler resumes its
# sessions onto survivors from the carry journal.
RECORD_STATES = (
    "starting", "healthy", "reloading", "draining", "evicted", "failed",
)

# the directory that holds the trpo_torch package: a child replica runs
# there so `python -m trpo_torch.serve` imports this checkout
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def render_launch_argv(
    template: str, port, checkpoint, replica: Optional[str] = None,
    host: Optional[str] = None,
) -> List[str]:
    """Render ``cfg.serve_replica_cmd`` into a launch argv: the template
    is shell-split (POSIX rules) and every ``{port}``/``{checkpoint}``
    (and, when given, ``{replica}``/``{host}``) placeholder substituted
    — the seam that lets scale-out target a non-local launcher (ssh
    wrapper, kubectl run, …) while the default stays the local
    ``python -m trpo_torch.serve`` child. ``{host}`` is what a multi-host
    template (``--hosts``, ``serve/transport.TemplateTransport``)
    wires into its ssh/kubectl target. The rendered argv is what
    :class:`SubprocessReplica` takes as ``command``; ``python -m
    trpo_torch.serve --replica-cmd`` wires it as the replica launcher."""
    import shlex

    if not template or not template.strip():
        raise ValueError("serve_replica_cmd template is empty")
    out = []
    for arg in shlex.split(template):
        arg = arg.replace("{port}", str(port)).replace(
            "{checkpoint}", str(checkpoint)
        )
        if replica is not None:
            arg = arg.replace("{replica}", replica)
        if host is not None:
            arg = arg.replace("{host}", host)
        out.append(arg)
    return out


class InProcessReplica:
    """One in-process serving stack, built by ``factory()`` →
    ``(server, closers)`` where ``server`` is the ``PolicyServer`` and
    ``closers`` the extra resources (batcher, checkpointer) to close
    after it, in order."""

    def __init__(self, factory: Callable):
        self._factory = factory
        self.server, self._closers = factory()
        self.url = self.server.url
        # same-host data plane: advertise the replica's Unix
        # socket so the router's _dial_plan can skip TCP entirely
        self.uds_path = getattr(self.server, "uds_path", None)
        self._killed = False

    def alive(self) -> bool:
        return not self._killed

    def kill(self) -> None:
        """Abrupt death (chaos/testing): drop the HTTP socket NOW —
        in-flight and later connections fail like a crashed process's
        would — and tear down the rest quietly. Pending carry-journal
        entries are DROPPED (``abrupt=True``), exactly as a real crash
        would lose the write-behind window; only explicitly drained
        snapshots survive, keeping injected kills honest about
        durability."""
        self._killed = True
        try:
            self.server.close(abrupt=True)
        except Exception:
            pass
        for c in self._closers:
            try:
                c.close()
            except Exception:
                pass

    def close(self) -> None:
        if self._killed:
            return
        self._killed = True
        self.server.close()
        for c in self._closers:
            try:
                c.close()
            except Exception:
                pass


class SubprocessReplica:
    """One ``python -m trpo_torch.serve`` child, discovered via its
    run.json.

    ``argv`` is the full serve argument list EXCLUDING
    ``--run-descriptor`` (appended here, pointing into
    ``replica_dir``); ``--port 0`` should be in it so replicas never
    collide. ``url`` is ``None`` until the descriptor appears — the
    supervisor keeps the replica in ``starting`` and polls.

    ``command`` (the :func:`render_launch_argv` seam) REPLACES the
    default ``[python, -m, trpo_torch.serve] + argv`` launch with a
    rendered ``cfg.serve_replica_cmd`` template, so scale-out can
    target a non-local launcher (the wrapped command must still end up
    running a server that writes the descriptor this supervisor
    discovers). ``--run-descriptor`` is appended either way. The child
    runs from the package's parent directory, so ``-m trpo_torch.serve``
    resolves whatever the caller's working directory."""

    def __init__(
        self,
        argv: List[str],
        replica_dir: str,
        command: Optional[List[str]] = None,
    ):
        os.makedirs(replica_dir, exist_ok=True)
        self.descriptor_path = os.path.join(replica_dir, "run.json")
        # a stale descriptor from a previous attempt must not be
        # "discovered" as the new replica's URL
        try:
            os.remove(self.descriptor_path)
        except OSError:
            pass
        self.log_path = os.path.join(replica_dir, "serve.log")
        self._log = open(self.log_path, "a")
        self.proc = subprocess.Popen(
            self._build_command(argv, command)
            + ["--run-descriptor", self.descriptor_path],
            stdout=self._log,
            stderr=subprocess.STDOUT,
            cwd=_PACKAGE_ROOT,
        )
        self.url: Optional[str] = None
        self.uds_path: Optional[str] = None

    @staticmethod
    def _build_command(
        argv: List[str], command: Optional[List[str]]
    ) -> List[str]:
        """The launch argv before the descriptor flag: the rendered
        ``serve_replica_cmd`` when one is set, else the local
        ``python -m trpo_torch.serve`` child."""
        if command is not None:
            return list(command)
        return [sys.executable, "-m", "trpo_torch.serve"] + list(argv)

    def discover(self) -> Optional[str]:
        """The bound URL from run.json (atomic write by the child,
        poll-don't-parse by the parent); None while the child is still
        importing torch, loading its checkpoint or binding its port."""
        if self.url is not None:
            return self.url
        from trpo_torch.utils.exposition import read_descriptor

        desc = read_descriptor(self.descriptor_path)
        if desc and desc.get("url"):
            self.url = desc["url"]
            # the child advertises its Unix socket (if it bound one) in
            # the same atomically-written descriptor, so the parent
            # never sees a URL without its UDS sibling
            self.uds_path = desc.get("uds_path")
        return self.url

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        try:
            self.proc.kill()
            self.proc.wait(timeout=10)
        except Exception:
            pass
        self._log.close()

    def close(self) -> None:
        try:
            self.proc.terminate()
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()
        self._log.close()


class ReplicaRecord:
    """One replica's scheduling view (state in ``RECORD_STATES``) plus
    the counters the router and /metrics read. ``inflight`` is
    maintained by the ROUTER under the set's lock — the replica itself
    never sees it."""

    def __init__(self, replica_id: str):
        self.id = replica_id
        self.handle = None
        self.url: Optional[str] = None
        self.uds_path: Optional[str] = None  # same-host UDS
        self.state = "starting"
        self.inflight = 0
        self.restarts = 0          # relaunches consumed (crash budget)
        self.health_fails = 0      # consecutive failed health polls
        self.not_before = 0.0      # monotonic gate for backoff relaunch
        self.started_at = 0.0
        self.loaded_step: Optional[int] = None
        self.sessions = 0
        self.canary = False        # wearing an unvalidated checkpoint
        #                            (set by CanaryController; the
        #                            router routes a fraction of
        #                            stateless traffic here and keeps
        #                            sessions away)
        # multi-host liveness
        self.host = "local"        # transport placement
        # the reason the LAST death/eviction was booked with
        self.last_death_reason: Optional[str] = None
        self.lease_epoch = 0       # grants this incarnation + earlier ones
        self.lease_expires: Optional[float] = None  # monotonic; None =
        #                            no live lease (never granted, or
        #                            consumed by expiry/relaunch)
        self.lease_renewed_emit = 0.0  # throttle for `renewed` events

    def row(self) -> dict:
        return {
            "state": self.state,
            "url": self.url,
            "inflight": self.inflight,
            "restarts": self.restarts,
            "loaded_step": self.loaded_step,
            "sessions": self.sessions,
            "canary": self.canary,
            "host": self.host,
            "lease_epoch": self.lease_epoch,
            "last_death_reason": self.last_death_reason,
        }


class ReplicaSet:
    """Launch, supervise, and restart N serving replicas.

    ``launcher(replica_id)`` builds one replica handle
    (:class:`InProcessReplica` / :class:`SubprocessReplica`); it is
    called again — with the same id — for every restart. Thread-safe:
    the router reads rotation state and bumps inflight under
    ``self.lock``; the supervisor mutates lifecycle state under the
    same lock. ``bus`` (an ``obs.events.EventBus``) receives the
    lifecycle, host and lease records.
    """

    def __init__(
        self,
        launcher: Optional[Callable[[str], object]],
        n_replicas: int,
        health_interval: float = 0.5,
        health_timeout: float = 2.0,
        health_fail_threshold: int = 2,
        max_restarts: int = 3,
        backoff: float = 0.5,
        backoff_cap: float = 30.0,
        start_timeout: float = 120.0,
        bus=None,
        transport=None,
        lease_ttl: Optional[float] = None,
        suspect_after: int = 2,
        suspect_decay_s: float = 30.0,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if health_interval <= 0:
            raise ValueError(
                f"health_interval must be > 0, got {health_interval}"
            )
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}"
            )
        if backoff < 0 or backoff_cap < backoff:
            raise ValueError(
                f"need 0 <= backoff <= backoff_cap, got "
                f"{backoff}/{backoff_cap}"
            )
        if lease_ttl is not None and lease_ttl <= health_interval:
            raise ValueError(
                "lease_ttl must exceed health_interval (a lease shorter "
                "than the renewal cadence expires between polls), got "
                f"ttl={lease_ttl} interval={health_interval}"
            )
        if suspect_after < 1:
            raise ValueError(
                f"suspect_after must be >= 1, got {suspect_after}"
            )
        if suspect_decay_s <= 0:
            raise ValueError(
                f"suspect_decay_s must be > 0, got {suspect_decay_s}"
            )
        self.bus = bus
        if transport is None:
            from trpo_torch.serve.transport import LocalExecTransport

            transport = LocalExecTransport(launcher)
        # no `self.launcher`: every launch goes through the transport
        # (LocalExecTransport wraps the callable) — keeping a direct
        # handle around would invite a path that bypasses placement
        # and the chaos gates
        self.transport = transport
        self.lease_ttl = None if lease_ttl is None else float(lease_ttl)
        self.suspect_after = int(suspect_after)
        self.suspect_decay_s = float(suspect_decay_s)
        self.health_interval = float(health_interval)
        self.health_timeout = float(health_timeout)
        self.health_fail_threshold = int(health_fail_threshold)
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.start_timeout = float(start_timeout)
        # host health (the degradation ladder's suspect rung): tracked
        # only when the topology can benefit — lease armed or a real
        # multi-host transport.
        # `_suspect` maps host -> suspected-at (monotonic): a host all
        # of whose replicas relaunched elsewhere gets no more probes,
        # so suspicion DECAYS after `suspect_decay_s` (circuit-breaker
        # half-open: the next launch there either works or re-strikes)
        self._host_fails: Dict[str, int] = {}
        self._suspect: Dict[str, float] = {}
        self.lock = threading.Lock()
        self.replicas: Dict[str, ReplicaRecord] = {
            f"r{i}": ReplicaRecord(f"r{i}") for i in range(n_replicas)
        }
        # ids are NEVER reused: a drained-away r1 followed by a
        # scale-out mints r<next>, so carry-journal files from
        # different incarnations can't collide
        self._next_idx = n_replicas
        self.lease_expiries_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        for rec in self.replicas.values():
            self._launch(rec)

    # -- lifecycle ---------------------------------------------------------

    def _launch(self, rec: ReplicaRecord) -> None:
        rec.state = "starting"
        rec.health_fails = 0
        rec.lease_expires = None  # a fresh incarnation earns its lease
        #                           on its first answered healthz
        # stamped BEFORE the (slow — AOT compile) launch: a tick
        # racing add_replica must never read a zero start time and
        # declare the replica start_timeout-expired
        rec.started_at = time.monotonic()
        # place AWAY from suspect hosts: replacement capacity must land
        # where the network works (the single-host default always
        # places "local")
        rec.host = self.transport.place(avoid=self.suspect_hosts())
        rec.handle = self.transport.launch(rec.host, rec.id)
        rec.url = getattr(rec.handle, "url", None)
        rec.uds_path = getattr(rec.handle, "uds_path", None)
        self._emit(rec.id, "started", attempt=rec.restarts + 1)

    def _emit(self, replica_id: str, state: str, **extra) -> None:
        """One ``router`` ``scope="replica"`` lifecycle record (a
        multi-host record names its host); a closed bus never breaks
        supervision."""
        if self.bus is None:
            return
        rec = self.replicas.get(replica_id)
        if rec is not None and rec.host != "local" and "host" not in extra:
            extra["host"] = rec.host
        try:
            self.bus.emit("router", scope="replica", replica=replica_id,
                          state=state, **extra)
        except Exception:
            pass

    def _emit_host(self, host: str, state: str) -> None:
        if self.bus is None:
            return
        try:
            self.bus.emit("router", scope="host", host=host, state=state)
        except Exception:
            pass

    def _emit_lease(self, rec: ReplicaRecord, event: str, **extra) -> None:
        if self.bus is None:
            return
        fields = {"replica": rec.id, "event": event,
                  "epoch": rec.lease_epoch}
        if rec.host != "local":
            fields["host"] = rec.host
        try:
            self.bus.emit("lease", **{**fields, **extra})
        except Exception:
            pass

    def start(self) -> None:
        """Run the supervisor thread (the constructor already launched
        the replicas; tests that drive ticks by hand skip this)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="replica-supervisor", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.health_interval):
            try:
                self.tick()
            except Exception:  # pragma: no cover — must never die
                pass

    # -- host health + leases ----------------------------------------------

    def _hosts_tracked(self) -> bool:
        """Host suspect accounting is armed only when it can matter —
        leases on, or a genuinely multi-host transport."""
        return self.lease_ttl is not None or len(
            getattr(self.transport, "hosts", ("local",))
        ) > 1

    def suspect_hosts(self) -> frozenset:
        """Currently-suspect hosts, with decay: a host whose replicas
        all relaunched elsewhere gets no more health exchanges, so
        nothing could ever clear it — after ``suspect_decay_s`` the
        suspicion lapses (half-open) and placement may try the host
        again; a still-bad host immediately re-strikes its way back."""
        now = time.monotonic()
        with self.lock:
            lapsed = [
                h for h, t0 in self._suspect.items()
                if now - t0 >= self.suspect_decay_s
            ]
            for h in lapsed:
                del self._suspect[h]
                self._host_fails.pop(h, None)
            return frozenset(self._suspect)

    def host_of(self, replica_id: str) -> str:
        rec = self.replicas.get(replica_id)
        return rec.host if rec is not None else "local"

    def death_reason(self, replica_id: str) -> Optional[str]:
        """The reason the replica's last death/eviction was booked with:
        "lease expired …" during a partition, a transport failure, a
        crash."""
        rec = self.replicas.get(replica_id)
        return rec.last_death_reason if rec is not None else None

    def note_transport_failure(self, host: str) -> None:
        """One failed exchange with ``host`` (healthz poll, routed
        forward): a strike toward *suspect*. Suspect hosts' replicas
        are held out of NEW session placement (``Router._pick``) and
        avoided by launch placement; the LEASE still owns eviction."""
        if not self._hosts_tracked():
            return
        with self.lock:
            fails = self._host_fails.get(host, 0) + 1
            self._host_fails[host] = fails
            newly = (fails >= self.suspect_after
                     and host not in self._suspect)
            if fails >= self.suspect_after:
                # (re)stamp: continued strikes keep the decay window
                # open — only a strike-free decay period clears it
                self._suspect[host] = time.monotonic()
        if newly:
            self._emit_host(host, "suspect")

    def _note_transport_ok(self, host: str) -> None:
        if not self._hosts_tracked():
            return
        with self.lock:
            self._host_fails.pop(host, None)
            healed = self._suspect.pop(host, None) is not None
        if healed:
            self._emit_host(host, "healthy")

    def _renew_lease(self, rec: ReplicaRecord) -> None:
        """An answered healthz exchange IS the renewal: the lease
        measures transport-level reachability, not snapshot readiness.
        The first answer of an incarnation GRANTS a new epoch."""
        if self.lease_ttl is None:
            return
        now = time.monotonic()
        with self.lock:
            granted = rec.lease_expires is None
            if granted:
                rec.lease_epoch += 1
                rec.lease_renewed_emit = now
            rec.lease_expires = now + self.lease_ttl
        if granted:
            self._emit_lease(rec, "granted", ttl=self.lease_ttl)
        elif now - rec.lease_renewed_emit >= self.lease_ttl / 2.0:
            rec.lease_renewed_emit = now
            self._emit_lease(rec, "renewed")

    def _lease_expired(self, rec: ReplicaRecord) -> bool:
        with self.lock:
            return (
                rec.lease_expires is not None
                and time.monotonic() >= rec.lease_expires
            )

    def _expire_lease(self, rec: ReplicaRecord, detail: str) -> None:
        """Lease expiry → the normal died/evicted path, exactly once
        (the expires cell is consumed under the lock) even when the
        supervisor tick and a router ``report_failure`` race to observe
        it."""
        with self.lock:
            if rec.state in ("evicted", "failed"):
                return
            if rec.lease_expires is None:
                return
            if time.monotonic() < rec.lease_expires:
                return
            rec.lease_expires = None  # consumed: one expiry per grant
            self.lease_expiries_total += 1
        self._emit_lease(rec, "expired", ttl=self.lease_ttl)
        self._mark_died(
            rec,
            reason=(
                f"lease expired (epoch {rec.lease_epoch}, "
                f"ttl {self.lease_ttl:g}s; {detail})"
            ),
        )

    # -- supervision -------------------------------------------------------

    def _healthz(
        self, url: str, host: Optional[str] = None
    ) -> Optional[dict]:
        try:
            if host is not None:
                # the transport gate models the network leg of the
                # exchange: a partitioned host raises (= the poll never
                # arrives), a slow host pays its injected latency
                self.transport.gate(host)
            with urllib.request.urlopen(
                url + "/healthz", timeout=self.health_timeout
            ) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            # an HTTP answer IS liveness: a 503 (no checkpoint yet)
            # replica is starting, not dead
            try:
                return json.loads(e.read())
            except Exception:
                return {"ok": False}
        except Exception:
            return None

    def tick(self) -> None:
        """One supervision pass over every replica (called by the
        supervisor thread; callable directly for deterministic tests)."""
        now = time.monotonic()
        with self.lock:  # the set resizes under scale-out/drain now
            recs = list(self.replicas.values())
        for rec in recs:
            with self.lock:
                state = rec.state
                handle, url = rec.handle, rec.url
            if handle is None:
                # add_replica published the record but its (slow: AOT
                # compile) launch has not assigned the handle yet —
                # still launching, nothing to poll or kill
                continue
            if state == "failed":
                continue
            if state == "evicted":
                if now >= rec.not_before:
                    self._relaunch(rec)
                continue
            if url is None:  # subprocess still binding: discover
                try:
                    url = getattr(handle, "discover", lambda: None)()
                except Exception as e:
                    # the transport's bounded discovery budget is spent:
                    # the launch failed LOUDLY (crash budget, relaunch on
                    # a healthier host) — never a phantom `starting`
                    # record wedging the supervisor
                    self._mark_died(
                        rec, reason=f"descriptor discovery failed: {e}"
                    )
                    continue
                if url is not None:
                    with self.lock:
                        rec.url = url
                        rec.uds_path = getattr(handle, "uds_path", None)
                elif (
                    not handle.alive()
                    or now - rec.started_at > self.start_timeout
                ):
                    self._mark_died(rec, reason="never became reachable")
                continue
            health = self._healthz(url, host=rec.host)
            if health is None:
                alive = handle.alive() if handle is not None else False
                rec.health_fails += 1
                self.note_transport_failure(rec.host)
                if not alive:
                    # the process is PROVABLY gone (a local handle, or
                    # an unpartitioned transport watching it): no lease
                    # can save a corpse
                    self._mark_died(rec, reason="process exited")
                elif self.lease_ttl is not None:
                    # lease-armed: a failed poll merely stops renewal —
                    # a partitioned host's replicas are alive, just
                    # unreachable; only EXPIRY evicts, and only once
                    # the failure is PERSISTENT (threshold consecutive
                    # failed polls): a slow-network tick that starved
                    # another host's renewal past its TTL must not turn
                    # one transient blip there into an instant
                    # eviction. A replica that never earned a lease is
                    # bounded by start_timeout.
                    if (
                        rec.health_fails >= self.health_fail_threshold
                        and self._lease_expired(rec)
                    ):
                        self._expire_lease(
                            rec,
                            f"{rec.health_fails} failed health polls",
                        )
                    elif (
                        rec.lease_expires is None
                        and now - rec.started_at > self.start_timeout
                    ):
                        self._mark_died(
                            rec,
                            reason="no lease within start_timeout",
                        )
                elif rec.health_fails >= self.health_fail_threshold:
                    self._mark_died(
                        rec,
                        reason=f"{rec.health_fails} failed health polls",
                    )
                continue
            rec.health_fails = 0
            self._note_transport_ok(rec.host)
            self._renew_lease(rec)
            rec.loaded_step = health.get("step")
            rec.sessions = int(health.get("sessions") or 0)
            if not health.get("ok"):
                # answering but no snapshot yet: keep out of rotation
                # without burning the crash budget (a replica waiting
                # for its first checkpoint is starting, not dying)
                continue
            new_state = (
                "reloading" if health.get("reloading") else "healthy"
            )
            with self.lock:
                # guard the flip: the unlocked healthz poll above takes
                # up to health_timeout, during which the router may have
                # observed a death (report_failure -> evicted/failed) —
                # a stale "it answered me" must never resurrect a dead
                # replica or cancel its scheduled relaunch
                changed = (
                    rec.state in ("starting", "healthy", "reloading")
                    and rec.state != new_state
                )
                if changed:
                    rec.state = new_state
            if changed:
                self._emit(rec.id, new_state)

    def _mark_died(self, rec: ReplicaRecord, reason: str) -> None:
        """died → evicted (out of rotation NOW) → backoff relaunch, or
        ``failed`` once the crash budget is burned."""
        with self.lock:
            if rec.state in ("evicted", "failed"):
                return  # already resolved (e.g. router reported first)
            rec.state = "evicted"
            rec.last_death_reason = reason
        self._emit(rec.id, "died", reason=reason)
        try:
            rec.handle.kill()  # reap a half-dead process/socket
        except Exception:
            pass
        if rec.restarts >= self.max_restarts:
            with self.lock:
                rec.state = "failed"
                rec.last_death_reason = (
                    f"{reason}; crash budget exhausted "
                    f"({self.max_restarts})")
            self._emit(rec.id, "evicted", reason=reason)
            self._emit(rec.id, "failed", reason=(
                f"crash budget exhausted ({self.max_restarts})"))
            return
        delay = min(self.backoff * (2 ** rec.restarts), self.backoff_cap)
        rec.not_before = time.monotonic() + delay
        self._emit(rec.id, "evicted", reason=reason, backoff_s=delay)

    def _relaunch(self, rec: ReplicaRecord) -> None:
        """Backoff elapsed: burn one crash-budget unit and relaunch.
        Only the state flip holds the lock — the launch itself (process
        spawn / AOT compile) must not stall the router's pick()."""
        with self.lock:
            if rec.state != "evicted":
                return
            rec.restarts += 1
            rec.state = "starting"
            rec.url = None
            rec.uds_path = None
            rec.lease_expires = None
        self._emit(rec.id, "restarted", attempt=rec.restarts + 1)
        try:
            # placement re-decides per relaunch: a replica lease-evicted
            # off a partitioned host comes back on a host the transport
            # can still reach (replacement capacity on healthy hosts)
            host = self.transport.place(avoid=self.suspect_hosts())
            handle = self.transport.launch(host, rec.id)
        except Exception:
            # a failed relaunch burns the budget exactly like a death:
            # a persistently-unlaunchable replica (port exhaustion, bad
            # argv) must reach `failed`, not loop restarted/evicted
            # forever
            if rec.restarts >= self.max_restarts:
                with self.lock:
                    rec.state = "failed"
                    rec.last_death_reason = (
                        "crash budget exhausted "
                        f"({self.max_restarts}) — relaunch raised")
                self._emit(rec.id, "failed",
                           reason=rec.last_death_reason)
                return
            with self.lock:
                rec.state = "evicted"
                rec.not_before = time.monotonic() + min(
                    self.backoff * (2 ** rec.restarts), self.backoff_cap
                )
            return
        with self.lock:
            rec.handle = handle
            rec.host = host
            rec.url = getattr(handle, "url", None)
            rec.uds_path = getattr(handle, "uds_path", None)
            rec.health_fails = 0
            rec.started_at = time.monotonic()

    def report_failure(self, replica_id: str) -> None:
        """The router observed a transport-level failure mid-request:
        evict NOW instead of waiting for the next poll tick (the router
        already retried the request elsewhere).

        Lease-armed sets instead treat it as a transport STRIKE: across
        a host boundary the failure says nothing about the replica
        process (a partition looks identical to a crash from here), so
        the host is marked toward suspect and the supervisor's lease
        machinery owns the eviction — one mid-request blip against a
        coincidentally-stale lease (a slow tick can starve renewals)
        must never evict on its own; the next tick (≤ health_interval
        away) expires it if the failure is persistent."""
        rec = self.replicas.get(replica_id)
        if rec is None:
            return
        with self.lock:
            if rec.state in ("evicted", "failed", "starting"):
                return
        self.note_transport_failure(rec.host)
        if self.lease_ttl is not None:
            return
        self._mark_died(rec, reason="router observed transport failure")

    # -- elastic scale (serve/autoscaler.py drives these) ------------------

    def add_replica(self) -> str:
        """Scale-out: mint a NEW replica id (never reused) and launch it
        through the same launcher seam every restart uses. The replica
        comes up ``starting`` and enters rotation only once its
        ``/healthz`` answers ok — warmed exactly like a restart. A
        launcher that RAISES leaves no phantom record behind (a
        handle-less ``starting`` corpse would hold the autoscaler's
        warming gate forever) — the error propagates to the caller,
        which retries on a later breach window."""
        with self.lock:
            rid = f"r{self._next_idx}"
            self._next_idx += 1
            rec = self.replicas[rid] = ReplicaRecord(rid)
        try:
            self._launch(rec)
        except Exception:
            with self.lock:
                self.replicas.pop(rid, None)
                rec.state = "failed"  # defuse stale tick iterations
            raise
        return rid

    def begin_drain(self, replica_id: str) -> bool:
        """Scale-in step 1: take a HEALTHY, non-canary replica out of
        stateless rotation (state ``draining`` — pinned session traffic
        still reaches it while its sessions migrate). False when the
        replica is not in a drainable state."""
        rec = self.replicas.get(replica_id)
        if rec is None:
            return False
        with self.lock:
            if rec.state != "healthy" or rec.canary:
                return False
            rec.state = "draining"
        self._emit(replica_id, "draining")
        return True

    def abort_drain(self, replica_id: str) -> None:
        """A drain that stalled (timeout, un-migratable session) goes
        BACK to rotation — aborting must never drop sessions. No-op if
        the replica left ``draining`` some other way (died mid-drain:
        the normal evict/restart path owns it)."""
        rec = self.replicas.get(replica_id)
        if rec is None:
            return
        with self.lock:
            if rec.state != "draining":
                return
            rec.state = "healthy"
        self._emit(replica_id, "healthy")

    def finish_drain(self, replica_id: str) -> bool:
        """Scale-in terminal: remove a session-empty draining replica
        from the set and close its handle. False if it is no longer
        draining (died mid-drain and was evicted)."""
        with self.lock:
            rec = self.replicas.get(replica_id)
            if rec is None or rec.state != "draining":
                return False
            del self.replicas[replica_id]
            # defuse a stale supervisor iteration still holding this
            # record: `failed` is skipped by tick() and _mark_died, so
            # a removed replica can never be "relaunched" into a leak
            rec.state = "failed"
        self._emit(replica_id, "drained")
        if rec.handle is not None:
            try:
                rec.handle.close()
            except Exception:
                pass
        return True

    def active_size(self) -> int:
        """Replicas that count against the autoscaler's bounds: every
        record except permanently-failed ones (a starting or draining
        replica is capacity in flight, not a reason to launch more)."""
        with self.lock:
            return sum(
                1 for r in self.replicas.values() if r.state != "failed"
            )

    # -- the router's view -------------------------------------------------

    def in_rotation(self) -> List[ReplicaRecord]:
        """Replicas the router may dispatch to, preference-ordered:
        healthy first; reloading replicas only when NO healthy one
        exists (the snapshot swap is atomic, so serving through a
        reload is degraded, not wrong)."""
        with self.lock:
            healthy = [
                r for r in self.replicas.values() if r.state == "healthy"
            ]
            if healthy:
                return healthy
            return [
                r for r in self.replicas.values()
                if r.state == "reloading"
            ]

    def get(self, replica_id: str) -> Optional[ReplicaRecord]:
        return self.replicas.get(replica_id)

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "replicas": {
                    rid: rec.row()
                    for rid, rec in sorted(self.replicas.items())
                },
                "healthy": sum(
                    1 for r in self.replicas.values()
                    if r.state == "healthy"
                ),
                "size": len(self.replicas),
            }

    def wait_healthy(
        self, n: Optional[int] = None, timeout: float = 120.0
    ) -> bool:
        """Block until ``n`` (default: all non-failed) replicas are
        healthy — startup convenience for the CLI and the smokes."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                healthy = sum(
                    1 for r in self.replicas.values()
                    if r.state == "healthy"
                )
                want = n if n is not None else sum(
                    1 for r in self.replicas.values()
                    if r.state != "failed"
                )
            if want and healthy >= want:
                return True
            self.tick() if self._thread is None else time.sleep(0.05)
        return False

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for rec in self.replicas.values():
            if rec.handle is not None:
                try:
                    rec.handle.close()
                except Exception:
                    pass
        # reap transport-launched leftovers: a partition's gated kill
        # leaves a live zombie behind by design — teardown must not
        try:
            self.transport.close()
        except Exception:
            pass


class CanaryController:
    """Gated checkpoint deployment over a :class:`ReplicaSet`.

    A plain hot swap promotes every new checkpoint to 100% of traffic
    with no gate — an unvalidated save takes the whole set down with
    it. This controller turns the swap into a deployment: the replicas
    run MANAGED reload (``PolicyServer(managed_reload=True)`` — their
    watchers never auto-swap past the first load), and every new step
    from ``latest_step_fn`` walks the canary lifecycle:

    1. **started** — pick one healthy replica (fewest sessions, so
       pinned recurrent sessions stay off the unvalidated checkpoint),
       mark it canary (the router starts striding ``canary_fraction``
       of stateless traffic onto it), and ``POST /reload {"step": N}``.
    2. **gate** — wait until the canary has answered
       ``window_requests`` routed requests, then judge:
       (a) *windowed p99*: the canary's p99 over the gate window must
       be within ``p99_budget_pct`` of the pooled incumbents' p99 over
       the SAME window; (b) *realized return* (armed by
       ``reward_window_episodes`` > 0): the router strides
       ``canary_fraction`` of session CREATES onto the canary, clients
       report per-act ``reward``/``done`` and the router books each
       completed episode's return against its replica — the canary's
       mean return over ``reward_window_episodes`` episodes must stay
       within ``reward_budget`` of the pooled incumbents' (both sides
       under a ``reward_min_episodes`` floor, so a 1-episode fluke
       never convicts or acquits). The failure class p99 and parity
       CANNOT see — a checkpoint that is fast, finite, and worse at
       the task — dies here; (c) *action parity*: recent REAL request
       bodies are mirrored to the canary and an incumbent — every
       canary action must be finite, and (when ``parity_tol`` is set)
       within it of the incumbent's mean absolute difference. A wedged
       checkpoint — loads fine, answers garbage — dies here. In a
       session-only plane (recurrent policies) there are no stateless
       bodies to mirror: when the reward gate is armed and has judged,
       parity stands down instead of starving the gate forever.
    3. **promoted** — a clean gate reloads the step onto every other
       replica (serially; each one's ``reloading`` window takes it out
       of rotation, so no request is ever dropped), updates the
       incumbent step, and clears the canary mark.
    4. **rolled_back** — a failed gate swaps the canary's PREVIOUS
       in-memory snapshot back (``{"rollback": true}`` — instant, no
       disk, one-shot). JUDGED
       failures (p99 over budget, parity, a save that will not load)
       blacklist the step so it is never re-canaried; TRANSIENT ones
       (canary died mid-gate, gate window starved) retry on a later
       tick. A canary that DIES mid-gate resolves to rolled_back: its
       relaunch loads the incumbent step (the launcher reads
       ``incumbent["step"]``), and the set stays healthy.

    Every gate resolves to ``promoted`` or ``rolled_back``:
    ``promoted_total``/``rolled_back_total`` count them, ``last_step``,
    ``last_decision`` and ``last_reason`` name the latest, and
    ``last_decision_s`` is how long its gate took from the reload
    command to the terminal, and ``last_p99_ms`` holds the canary's and
    the pooled incumbents' p99 that its p99 gate compared (None when
    the gate did not reach that comparison). With ``bus`` each
    transition is also a ``canary`` event, and a rejection a
    ``health:canary_rejected`` finding.
    """

    def __init__(
        self,
        replicaset: ReplicaSet,
        router,
        latest_step_fn: Callable[[], Optional[int]],
        incumbent: Optional[dict] = None,
        window_requests: int = 24,
        p99_budget_pct: float = 50.0,
        parity_samples: int = 4,
        parity_tol: Optional[float] = None,
        gate_timeout_s: float = 120.0,
        poll_interval: float = 1.0,
        reload_timeout_s: float = 120.0,
        bus=None,
        reward_window_episodes: int = 0,
        reward_min_episodes: Optional[int] = None,
        reward_budget: float = 0.0,
    ):
        if window_requests < 1:
            raise ValueError(
                f"window_requests must be >= 1, got {window_requests}"
            )
        if p99_budget_pct < 0:
            raise ValueError(
                f"p99_budget_pct must be >= 0, got {p99_budget_pct}"
            )
        if reward_window_episodes < 0:
            raise ValueError(
                f"reward_window_episodes must be >= 0, got "
                f"{reward_window_episodes}"
            )
        if reward_min_episodes is not None and reward_min_episodes < 1:
            raise ValueError(
                f"reward_min_episodes must be >= 1, got "
                f"{reward_min_episodes}"
            )
        if reward_budget < 0:
            raise ValueError(
                f"reward_budget must be >= 0, got {reward_budget}"
            )
        self.bus = bus
        self.replicaset = replicaset
        self.router = router
        self.latest_step_fn = latest_step_fn
        # the shared mutable incumbent cell: the replica LAUNCHER reads
        # incumbent["step"] so a relaunch mid-gate loads the validated
        # step, never the one under test
        self.incumbent = incumbent if incumbent is not None else {
            "step": None
        }
        self.window_requests = int(window_requests)
        self.p99_budget_pct = float(p99_budget_pct)
        self.parity_samples = int(parity_samples)
        self.parity_tol = parity_tol
        self.gate_timeout_s = float(gate_timeout_s)
        self.poll_interval = float(poll_interval)
        self.reload_timeout_s = float(reload_timeout_s)
        # the realized-return gate: 0 episodes = disarmed (the p99 +
        # parity gate alone); the floor defaults to the window so both
        # sides judge over full windows
        self.reward_window_episodes = int(reward_window_episodes)
        self.reward_min_episodes = (
            int(reward_min_episodes)
            if reward_min_episodes is not None
            else max(1, self.reward_window_episodes)
        )
        self.reward_budget = float(reward_budget)
        self.promoted_total = 0
        self.rolled_back_total = 0
        self.promotion_reload_failures_total = 0
        self.last_step: Optional[int] = None
        self.last_decision: Optional[str] = None  # promoted/rolled_back
        self.last_reason: Optional[str] = None
        self.last_decision_s: Optional[float] = None
        self.last_p99_ms: Optional[tuple] = None  # (canary, incumbents)
        self._rejected_steps: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def incumbent_step(self) -> Optional[int]:
        return self.incumbent["step"]

    # -- plumbing ----------------------------------------------------------

    def _post(self, url: Optional[str], path: str, payload: dict,
              timeout: Optional[float] = None):
        """POST to a replica's control/data route; ``(status, parsed)``
        or ``(None, None)`` on transport failure (including a replica
        mid-relaunch with no bound URL yet)."""
        try:
            req = urllib.request.Request(
                url + path,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(
                req, timeout=timeout or self.reload_timeout_s
            ) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:
                return e.code, None
        except Exception:
            return None, None

    def _replica_alive(self, rec: ReplicaRecord) -> bool:
        with self.replicaset.lock:
            return rec.state in ("starting", "healthy", "reloading")

    def _canary_lost(self, rec: ReplicaRecord, restarts0: int) -> bool:
        """The canary no longer wears the step under test: it died, or
        it died AND the supervisor already relaunched it (the relaunch
        reads ``incumbent["step"]``, so a bumped restart counter means
        the unvalidated snapshot is gone even though the record reads
        healthy again)."""
        with self.replicaset.lock:
            return (
                rec.state not in ("starting", "healthy", "reloading")
                or rec.restarts != restarts0
            )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="canary-controller", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.tick()
            except Exception:  # pragma: no cover — must never die
                pass

    def tick(self) -> None:
        """One control pass: adopt/gate the newest complete checkpoint.
        Synchronous — a gate runs to its terminal inside this call
        (tests drive it directly; the thread just repeats it)."""
        try:
            step = self.latest_step_fn()
        except Exception:
            return
        if step is None:
            return
        if self.incumbent["step"] is None:
            # first adoption: take what the replicas ACTUALLY serve
            # (their ungated first load), not blindly the latest step —
            # a save landing between their first load and this first
            # tick must go through the gate like any other
            with self.replicaset.lock:
                served = [
                    r.loaded_step
                    for r in self.replicaset.replicas.values()
                    if r.loaded_step is not None
                ]
            self.incumbent["step"] = max(served) if served else step
            return
        if step == self.incumbent["step"] or step in self._rejected_steps:
            self._reconcile()
            return
        self._run_gate(step)

    def _reconcile(self) -> None:
        """Converge stragglers onto the incumbent: a replica that
        relaunched mid-promotion (launcher read the pre-promotion
        cell) or whose promotion reload failed transiently would
        otherwise serve a mixed step forever — managed replicas never
        follow latest on their own."""
        incumbent = self.incumbent["step"]
        if incumbent is None:
            return
        with self.replicaset.lock:
            lagging = [
                (r.id, r.url) for r in self.replicaset.replicas.values()
                if (
                    r.state == "healthy"
                    and not r.canary
                    and r.loaded_step is not None
                    and r.loaded_step != incumbent
                )
            ]
        for rid, url in lagging:
            self._post(url, "/reload", {"step": incumbent})

    # -- the gate ----------------------------------------------------------

    def _pick_canary(self) -> Optional[ReplicaRecord]:
        with self.replicaset.lock:
            healthy = [
                r for r in self.replicaset.replicas.values()
                if r.state == "healthy"
            ]
            if len(healthy) < 2:
                # a 1-replica "canary" is just an ungated swap with
                # extra steps; wait for the set to heal
                return None
            return min(healthy, key=lambda r: (r.sessions, r.id))

    def _run_gate(self, step: int) -> None:
        rec = self._pick_canary()
        if rec is None:
            return  # retry next tick
        with self.replicaset.lock:
            rec.canary = True
        self._emit("started", step, rec.id)
        t0 = time.monotonic()
        self.last_p99_ms = None
        try:
            ok, reason = self._deploy_and_judge(rec, step)
        except Exception as e:
            # a gate bug must still resolve the canary: a gate left
            # open would keep a replica marked canary forever
            ok, reason = False, f"gate error: {type(e).__name__}: {e}"
        if ok:
            self._promote(rec, step)
        else:
            self._rollback(rec, step, reason)
        self.last_decision_s = time.monotonic() - t0

    # gate failures that say nothing about the CHECKPOINT: the canary
    # died under it, traffic lulled and the window starved, or no
    # mirrored body produced a usable parity verdict. These roll back
    # but do NOT blacklist the step — the next tick retries; a judged
    # failure (p99, parity, a save that will not load) does.
    _TRANSIENT_REASONS = (
        "canary died mid-gate",
        "gate window starved",
        "no usable parity sample",
        "reward window starved",
        "no usable reward baseline",
    )

    def _deploy_and_judge(self, rec: ReplicaRecord, step: int):
        with self.replicaset.lock:
            restarts0 = rec.restarts
        # 1. command the canary onto the new step (synchronous reload)
        status, out = self._post(rec.url, "/reload", {"step": step})
        if status != 200 or not (out or {}).get("ok"):
            return False, (
                f"canary reload to step {step} failed "
                f"(status={status}, {out})"
            )
        # 2. observe a fresh window of routed traffic (and, when the
        # reward gate is armed, a fresh window of completed episodes)
        self.router.reset_replica_latencies()
        if self.reward_window_episodes > 0:
            self.router.reset_replica_episodes()
        deadline = time.monotonic() + self.gate_timeout_s
        while True:
            if self._canary_lost(rec, restarts0):
                return False, "canary died mid-gate"
            canary_lats = self.router.replica_latencies_ms(rec.id)
            if len(canary_lats) >= self.window_requests:
                break
            if time.monotonic() >= deadline:
                return False, (
                    f"gate window starved: {len(canary_lats)}/"
                    f"{self.window_requests} canary requests within "
                    f"{self.gate_timeout_s:g}s"
                )
            time.sleep(0.02)
        # 3a. windowed p99 vs the pooled incumbents over the same window
        from trpo_torch.utils.metrics import quantile_nearest_rank

        incumbent_lats: list = []
        with self.replicaset.lock:
            others = [
                r.id for r in self.replicaset.replicas.values()
                if r.id != rec.id
            ]
        for rid in others:
            incumbent_lats.extend(self.router.replica_latencies_ms(rid))
        if incumbent_lats:
            c99 = quantile_nearest_rank(canary_lats, 0.99)
            i99 = quantile_nearest_rank(incumbent_lats, 0.99)
            self.last_p99_ms = (c99, i99)
            budget = i99 * (1.0 + self.p99_budget_pct / 100.0)
            if c99 > budget:
                return False, (
                    f"canary p99 {c99:.1f}ms over budget "
                    f"{budget:.1f}ms (incumbent p99 {i99:.1f}ms + "
                    f"{self.p99_budget_pct:g}%)"
                )
        # 3b. realized return vs the pooled incumbents (armed gate only)
        if self.reward_window_episodes > 0:
            ok, reason = self._judge_reward(rec, others, restarts0)
            if not ok:
                return False, reason
            if not self.router.recent_act_bodies(1):
                # session-only plane (recurrent policies): there are no
                # stateless bodies to mirror, and mirroring a mid-episode
                # body at a blank canary carry would judge noise. The
                # realized-return gate already judged BEHAVIOR over whole
                # episodes — parity stands down instead of starving.
                return True, None
        # 3c. action parity on mirrored REAL traffic
        return self._judge_parity(rec, others)

    def _judge_reward(self, rec: ReplicaRecord, others, restarts0) -> tuple:
        """Judge the canary's windowed realized return against the
        pooled incumbents'. Episode returns are booked by the router
        from client-reported per-act ``reward`` / ``done`` fields; the
        session router strides ``canary_fraction`` of session CREATES
        onto the canary, so both sides accumulate episodes from live
        traffic. A thin canary window is a starved (transient) gate; a
        thin INCUMBENT baseline is equally unusable — ``min_episodes``
        floors both sides so one lucky episode never decides. The only
        judged failure is the one no other gate can see: the canary's
        mean return falling more than ``reward_budget`` below the
        incumbents'."""
        deadline = time.monotonic() + self.gate_timeout_s
        while True:
            if self._canary_lost(rec, restarts0):
                return False, "canary died mid-gate"
            canary_eps = self.router.replica_episode_returns(rec.id)
            if len(canary_eps) >= self.reward_window_episodes:
                break
            if time.monotonic() >= deadline:
                return False, (
                    f"reward window starved: {len(canary_eps)}/"
                    f"{self.reward_window_episodes} canary episodes "
                    f"within {self.gate_timeout_s:g}s"
                )
            time.sleep(0.02)
        incumbent_eps: list = []
        for rid in others:
            incumbent_eps.extend(self.router.replica_episode_returns(rid))
        floor = max(1, self.reward_min_episodes)
        if len(incumbent_eps) < floor:
            return False, (
                f"no usable reward baseline: {len(incumbent_eps)}/"
                f"{floor} incumbent episodes"
            )
        c_mean = sum(canary_eps) / len(canary_eps)
        i_mean = sum(incumbent_eps) / len(incumbent_eps)
        if c_mean < i_mean - self.reward_budget:
            return False, (
                f"canary realized return {c_mean:.4f} under incumbent "
                f"{i_mean:.4f} by more than budget "
                f"{self.reward_budget:g} "
                f"({len(canary_eps)} canary vs {len(incumbent_eps)} "
                "incumbent episodes)"
            )
        return True, None

    def _judge_parity(self, rec: ReplicaRecord, others) -> tuple:
        """Mirror recent REAL request bodies to the canary (and an
        incumbent referee). Client bodies are untrusted: a body BOTH
        replicas refuse is the client's problem and judges nothing —
        only a body the incumbent answers and the canary refuses (or
        answers nonfinite / out-of-tolerance) convicts the canary.
        Zero usable samples is a TRANSIENT outcome (retry next tick),
        never a vacuous pass."""
        import numpy as np

        bodies = self.router.recent_act_bodies(self.parity_samples)
        incumbent_url = None
        with self.replicaset.lock:
            for rid in others:
                other = self.replicaset.replicas.get(rid)
                if other is not None and other.state == "healthy":
                    incumbent_url = other.url
                    break
        usable = 0
        diffs = []
        for body in bodies:
            try:
                payload = json.loads(body)
            except ValueError:
                continue  # unparseable client body: judges nothing
            c_status, c_out = self._post(
                rec.url, "/act", payload, timeout=30.0
            )
            if c_status != 200 or not isinstance(c_out, dict):
                if incumbent_url is None:
                    continue  # no referee: cannot attribute the refusal
                i_status, i_out = self._post(
                    incumbent_url, "/act", payload, timeout=30.0
                )
                if i_status != 200:
                    continue  # BOTH refuse: a bad client body, skip it
                return False, (
                    f"canary refused a mirrored request "
                    f"(status={c_status}) the incumbent answered"
                )
            c_act = np.asarray(c_out.get("action"), dtype=np.float64)
            if not np.all(np.isfinite(c_act)):
                return False, (
                    "canary answered nonfinite actions on mirrored "
                    "traffic (wedged checkpoint)"
                )
            usable += 1
            if incumbent_url is not None and self.parity_tol is not None:
                i_status, i_out = self._post(
                    incumbent_url, "/act", payload, timeout=30.0
                )
                if i_status == 200 and isinstance(i_out, dict):
                    i_act = np.asarray(
                        i_out.get("action"), dtype=np.float64
                    )
                    if i_act.shape == c_act.shape:
                        diffs.append(
                            float(np.mean(np.abs(c_act - i_act)))
                        )
        if usable == 0:
            # the gate window proved traffic flows, but none of the
            # sampled bodies produced a usable verdict: hold the line
            # (transient — not blacklisted) rather than promote blind
            return False, "no usable parity sample in mirrored traffic"
        if diffs and self.parity_tol is not None:
            mean_diff = sum(diffs) / len(diffs)
            if mean_diff > self.parity_tol:
                return False, (
                    f"action parity {mean_diff:.4f} over tolerance "
                    f"{self.parity_tol:g} vs the incumbent on mirrored "
                    "obs"
                )
        return True, None

    def _promote(self, rec: ReplicaRecord, step: int) -> None:
        # publish the new incumbent BEFORE the reload sweep: a replica
        # relaunching while the sweep runs reads this cell through the
        # launcher closure — updating it afterwards would let the
        # relaunch come up pinned to the OLD step with nothing to
        # converge it until the next promotion (the _reconcile pass
        # also sweeps any such straggler on later ticks)
        self.incumbent["step"] = step
        with self.replicaset.lock:
            others = [
                r for r in self.replicaset.replicas.values()
                if r.id != rec.id and r.state in ("healthy", "reloading")
            ]
        for other in others:
            # serial: each replica's reloading window takes it out of
            # rotation while the survivors keep serving — zero drops
            status, out = self._post(other.url, "/reload", {"step": step})
            if status != 200 or not (out or {}).get("ok"):
                # it keeps serving its step; the reconcile pass on a
                # later tick converges it
                self.promotion_reload_failures_total += 1
                self._emit_health(
                    "canary_promotion_partial",
                    f"promotion reload to step {step} failed on "
                    f"{other.id} (status={status}) — it keeps serving "
                    f"step {other.loaded_step}; the reconcile pass on "
                    "a later tick will converge it")
        with self.replicaset.lock:
            rec.canary = False
        self.promoted_total += 1
        self.last_step, self.last_decision = step, "promoted"
        self.last_reason = None
        self._emit("promoted", step, rec.id)

    def _rollback(self, rec: ReplicaRecord, step: int, reason: str) -> None:
        if self._replica_alive(rec) and rec.url:
            health = self.replicaset._healthz(rec.url) or {}
            if health.get("step") == step:
                # the canary actually serves the step under test:
                # instant in-memory rollback (explicit incumbent load
                # as the fallback when the one-shot history is spent)
                status, out = self._post(
                    rec.url, "/reload", {"rollback": True}
                )
                if status != 200:
                    incumbent = self.incumbent["step"]
                    if incumbent is not None:
                        self._post(
                            rec.url, "/reload", {"step": incumbent}
                        )
            else:
                # the reload never swapped (failed restore): a rollback
                # would revert PAST the incumbent and waste the one-shot
                # history — instead unpin the target back to the
                # incumbent so the replica's watcher stops retrying the
                # rejected step
                incumbent = self.incumbent["step"]
                if incumbent is not None:
                    self._post(rec.url, "/reload", {"step": incumbent})
        # a DEAD canary needs no reload: its relaunch reads
        # incumbent["step"] from the launcher closure
        with self.replicaset.lock:
            rec.canary = False
        if not any(
            (reason or "").startswith(t) for t in self._TRANSIENT_REASONS
        ):
            self._rejected_steps.add(step)
        self.rolled_back_total += 1
        self.last_step, self.last_decision = step, "rolled_back"
        self.last_reason = reason
        self._emit("rolled_back", step, rec.id, reason=reason)
        self._emit_health(
            "canary_rejected",
            f"canary gate rejected checkpoint step {step} on {rec.id}: "
            f"{reason}", data={"step": step, "replica": rec.id})

    def _emit(self, event: str, step: int, replica: str, **extra) -> None:
        if self.bus is None:
            return
        try:
            self.bus.emit("canary", step=step, event=event,
                          replica=replica, **extra)
        except Exception:  # a closed bus never breaks the gate
            pass

    def _emit_health(self, check: str, message: str, **extra) -> None:
        if self.bus is None:
            return
        try:
            self.bus.emit("health", check=check, level="warn",
                          message=message, **extra)
        except Exception:
            pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
