"""Deterministic fault injection (counterpart:
``trpo_tpu/resilience/inject.py``): every failure mode the resilience and
serving layers handle, injectable on demand from a typed spec string, so
chaos runs are reproducible and their recovery paths test-pinned.

Env level (clocked by the supervised pool's host steps,
``resilience/supervisor.py``):

* ``kill_worker@step=K:worker=W``  — SIGKILL a ``gymproc:`` worker just
  before the K-th host env step (its pipe closes; supervision restarts
  it).
* ``hang_worker@step=K:worker=W``  — SIGSTOP it instead: alive but
  silent, caught by ``env_step_timeout``.
* ``delay_step@step=K:seconds=S``  — sleep S seconds before the K-th host
  step (a latency spike nothing should break on).

Update level (clocked by ``learn``'s absolute iterations):

* ``nan_update@iter=N``            — replace every floating-point leaf of
  the policy parameters with NaN just before iteration N runs, so the
  update's nonfinite guard trips and ``recover_on_nan="restore"`` has
  something to recover from.
* ``sigterm@iter=N``               — SIGTERM this process just before
  iteration N runs: drain → final checkpoint → requeue exit code.

Serving plane (clocked by the router's routed client requests, or by the
checkpoint step at the reload seam):

* ``kill_replica@request=K:replica=R`` — kill replica ``rR`` just before
  the K-th routed request (the supervisor evicts and relaunches it; a
  pinned session resumes from its carry journal).
* ``stall_replica@request=K:replica=R:seconds=S`` — wedge ``rR``'s act
  path for S seconds while its health checks answer: detection must come
  from the request path (the router's timeout, eviction, retry).
* ``wedge_reload@step=N`` — replace the params of checkpoint step N with
  NaN as a replica loads it: the save restores cleanly but answers
  garbage, the failure the canary gate exists to catch.
* ``drop_carry_journal@request=K:replica=R`` — delete ``rR``'s carry
  journal: the next failover must notice and fall back loudly to a fresh
  carry (``session`` ``reestablished``).
* ``overload_storm@request=K:rps=R:seconds=S`` — from the K-th request,
  replay the triggering request's shape at R requests/s for S seconds (a
  session act seeds storm-owned sessions, so no real carry is touched):
  the autoscaler or the admission layers must react.
* ``slow_replica@request=K:replica=R:ms=M`` — every act on ``rR`` pays M
  more ms from then on; health checks stay fast.
* ``flap_replica@request=K:replica=R:times=T`` — kill ``rR``, wait for its
  supervised relaunch, kill it again: T kills in all.
* ``partition_host@request=K:host=H:seconds=S`` — blackhole the transport
  to host H both ways for S seconds (``serve/transport.py``); the replica
  processes stay up, so detection must come from lease expiry.
* ``slow_network@request=K:host=H:ms=M`` — M more ms on every exchange
  with host H.
* ``lost_descriptor@request=K:host=H`` — launches on H land but their
  ``run.json`` never becomes readable: discovery must fail loudly.

Train → serve boundary (clocked by the published serving step; their
caller, the promotion controller, is ROADMAP.md Queue 1 item 18.6):

* ``corrupt_checkpoint@step=N`` — truncate every payload file of the
  published step N to half, after its completion marker landed.
* ``regress_checkpoint@step=N`` — scale the policy's floating-point
  leaves by 8 as step N publishes: finite, loads cleanly, behaves worse.
* ``kill_promoter@step=N`` — raise :class:`PromoterKilled` right after
  step N publishes, before the gate drives.

Specs are ``;``-separated and each fires EXACTLY ONCE, so a recovery that
re-runs the target iteration re-runs it clean (what lets a restored run
continue bit for bit). Every firing is a ``fault_injected`` event on the
bus, so each can be matched to the detection or recovery record it must
cause (the reference's ``scripts/validate_events.py`` reads the port's
logs).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Optional, Tuple

__all__ = [
    "FaultSpec", "FaultInjector", "parse_fault_specs", "PromoterKilled",
]


class PromoterKilled(RuntimeError):
    """Raised by a ``kill_promoter`` spec mid-promotion — the simulated
    controller crash. The promotion journal/markers already persisted;
    a restarted controller converges from them."""

# fault kind -> (trigger key, level); level discriminates which hook
# site fires it: "env" = on_env_step (host env steps), "update" =
# before_iteration (training iterations), "serve" = on_serve_request /
# on_checkpoint_load (the serving plane's request clock / reload seam)
_KINDS = {
    "kill_worker": ("step", "env"),
    "hang_worker": ("step", "env"),
    "delay_step": ("step", "env"),
    "nan_update": ("iter", "update"),
    "sigterm": ("iter", "update"),
    "kill_replica": ("request", "serve"),
    "stall_replica": ("request", "serve"),
    "wedge_reload": ("step", "serve"),
    "drop_carry_journal": ("request", "serve"),
    "overload_storm": ("request", "serve"),
    "slow_replica": ("request", "serve"),
    "flap_replica": ("request", "serve"),
    "partition_host": ("request", "serve"),
    "slow_network": ("request", "serve"),
    "lost_descriptor": ("request", "serve"),
    "corrupt_checkpoint": ("step", "serve"),
    "regress_checkpoint": ("step", "serve"),
    "kill_promoter": ("step", "serve"),
}

# serve-level faults clocked by a checkpoint STEP rather than the
# router's request counter — on_serve_request must never consume these
_STEP_SERVE_KINDS = (
    "wedge_reload", "corrupt_checkpoint", "regress_checkpoint",
    "kill_promoter",
)

# faults that target a HOST (the multi-host transport) rather than a
# replica — host= is required for these
_HOST_KINDS = ("partition_host", "slow_network", "lost_descriptor")


def _nan_like(x):
    if hasattr(x, "new_full"):  # a torch tensor
        return x.new_full(x.shape, float("nan"))
    import numpy as np

    return np.full_like(x, np.nan)


def _map_floating(tree, fn):
    """``tree`` with ``fn`` applied to every floating-point leaf (torch
    tensors and numpy arrays; other leaves are kept). Builds new leaves:
    the caller's tensors are never written."""
    import numpy as np

    from trpo_torch.ops.flat import tree_map

    def leaf(x):
        if hasattr(x, "is_floating_point"):
            return fn(x) if x.is_floating_point() else x
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype,
                                                       np.floating):
            return fn(x)
        return x

    return tree_map(leaf, tree)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault: what (``kind``), when (``at`` — a 1-based
    host env step for env-level faults, a 1-based absolute training
    iteration for update-level ones, a 1-based routed client request
    for serving-level ones, a checkpoint step for ``wedge_reload``),
    and the kind-specific parameters."""

    kind: str
    at: int
    worker: int = 0
    seconds: float = 0.25
    replica: int = 0
    rps: float = 10.0     # overload_storm: synthetic request rate
    ms: float = 100.0     # slow_replica/slow_network: latency injection
    times: int = 2        # flap_replica: total kills
    host: str = ""        # partition_host/slow_network/lost_descriptor

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {sorted(_KINDS)}"
            )
        if self.kind in _HOST_KINDS and not self.host:
            raise ValueError(
                f"{self.kind}: needs host=NAME (the transport host to "
                "target)"
            )
        if self.at < 1:
            raise ValueError(
                f"{self.kind}: trigger point must be >= 1, got {self.at}"
            )
        if self.worker < 0:
            raise ValueError(f"{self.kind}: worker must be >= 0")
        if self.seconds < 0:
            raise ValueError(f"{self.kind}: seconds must be >= 0")
        if self.replica < 0:
            raise ValueError(f"{self.kind}: replica must be >= 0")
        if self.rps <= 0:
            raise ValueError(f"{self.kind}: rps must be > 0")
        if self.ms < 0:
            raise ValueError(f"{self.kind}: ms must be >= 0")
        if self.times < 1:
            raise ValueError(f"{self.kind}: times must be >= 1")

    @property
    def env_level(self) -> bool:
        return _KINDS[self.kind][1] == "env"

    @property
    def serve_level(self) -> bool:
        return _KINDS[self.kind][1] == "serve"

    @property
    def replica_id(self) -> str:
        """The serving replica this fault targets, in the replica set's
        naming convention (``r<N>``)."""
        return f"r{self.replica}"

    def __str__(self) -> str:
        key = _KINDS[self.kind][0]
        extra = ""
        if self.kind in ("kill_worker", "hang_worker"):
            extra = f":worker={self.worker}"
        elif self.kind == "delay_step":
            extra = f":seconds={self.seconds:g}"
        elif self.kind in ("kill_replica", "drop_carry_journal"):
            extra = f":replica={self.replica}"
        elif self.kind == "stall_replica":
            extra = f":replica={self.replica}:seconds={self.seconds:g}"
        elif self.kind == "overload_storm":
            extra = f":rps={self.rps:g}:seconds={self.seconds:g}"
        elif self.kind == "slow_replica":
            extra = f":replica={self.replica}:ms={self.ms:g}"
        elif self.kind == "flap_replica":
            extra = f":replica={self.replica}:times={self.times}"
        elif self.kind == "partition_host":
            extra = f":host={self.host}:seconds={self.seconds:g}"
        elif self.kind == "slow_network":
            extra = f":host={self.host}:ms={self.ms:g}"
        elif self.kind == "lost_descriptor":
            extra = f":host={self.host}"
        return f"{self.kind}@{key}={self.at}{extra}"


def parse_fault_specs(spec: str) -> Tuple[FaultSpec, ...]:
    """Parse a ``;``-separated fault-spec string (grammar above). Raises
    ``ValueError`` with the offending fragment on any mistake — a chaos
    run with a silently dropped fault would "pass" by testing nothing."""
    out = []
    for frag in spec.split(";"):
        frag = frag.strip()
        if not frag:
            continue
        if "@" not in frag:
            raise ValueError(
                f"fault spec {frag!r}: expected kind@key=value[:key=value]"
            )
        kind, _, rest = frag.partition("@")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"fault spec {frag!r}: unknown kind {kind!r} "
                f"(have {sorted(_KINDS)})"
            )
        trigger_key = _KINDS[kind][0]
        fields = {}
        for pair in rest.split(":"):
            key, eq, value = pair.partition("=")
            key = key.strip()
            if not eq:
                raise ValueError(
                    f"fault spec {frag!r}: expected key=value, got {pair!r}"
                )
            fields[key] = value.strip()
        if trigger_key not in fields:
            trigger_name = {
                "step": (
                    "checkpoint step" if kind in _STEP_SERVE_KINDS
                    else "host env step"
                ),
                "iter": "iteration",
                "request": "routed client request",
            }[trigger_key]
            raise ValueError(
                f"fault spec {frag!r}: {kind} needs {trigger_key}=N "
                f"({trigger_name})"
            )
        try:
            at = int(fields.pop(trigger_key))
            worker = int(fields.pop("worker", 0))
            seconds = float(fields.pop("seconds", 0.25))
            replica = int(fields.pop("replica", 0))
            rps = float(fields.pop("rps", 10.0))
            ms = float(fields.pop("ms", 100.0))
            times = int(fields.pop("times", 2))
            host = str(fields.pop("host", ""))
        except ValueError as e:
            raise ValueError(f"fault spec {frag!r}: {e}") from None
        if fields:
            raise ValueError(
                f"fault spec {frag!r}: unknown keys {sorted(fields)}"
            )
        try:
            out.append(FaultSpec(kind=kind, at=at, worker=worker,
                                 seconds=seconds, replica=replica,
                                 rps=rps, ms=ms, times=times, host=host))
        except ValueError as e:
            raise ValueError(f"fault spec {frag!r}: {e}") from None
    if not out:
        raise ValueError(f"fault spec {spec!r} contains no faults")
    return tuple(out)


class FaultInjector:
    """Fires :class:`FaultSpec` s at their trigger points.

    Two hook sites, matching the two fault levels:

    * :meth:`on_env_step` — called by the supervised env wrapper
      (``resilience/supervisor.py``) with the running host-step count and
      the RAW ``ProcVecEnv`` (whose worker processes the kill/hang specs
      signal).
    * :meth:`before_iteration` — called by both training drivers with the
      absolute 1-based iteration about to run (and, for fused device
      chunks, the chunk ``span``); returns the — possibly NaN-poisoned —
      TrainState to use.

    Each spec fires once (see module docstring); every firing emits a
    ``fault_injected`` event when a bus is attached.
    """

    def __init__(self, specs, bus=None):
        self.specs = tuple(specs)
        self.bus = bus
        self._fired: set = set()
        # serving hooks run on concurrent HTTP handler threads (the
        # training hooks are single-threaded); the check-and-mark must
        # be atomic or one fault could fire twice
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str, bus=None) -> "FaultInjector":
        return cls(parse_fault_specs(spec), bus=bus)

    @property
    def all_fired(self) -> bool:
        return len(self._fired) == len(self.specs)

    @property
    def unfired(self) -> Tuple[str, ...]:
        """Spec strings that never fired — a completed chaos run with
        any of these tested nothing and should say so loudly."""
        return tuple(
            str(s) for i, s in enumerate(self.specs) if i not in self._fired
        )

    def _emit(self, spec: FaultSpec, **data) -> None:
        if self.bus is not None:
            self.bus.emit(
                "fault_injected", fault=spec.kind, at=spec.at,
                spec=str(spec), **data,
            )

    # -- env level ---------------------------------------------------------

    def on_env_step(self, step_idx: int, env) -> None:
        """Fire env-level faults due at host step ``step_idx`` (1-based,
        counted by the supervised wrapper). ``env`` is the raw
        ``ProcVecEnv``; kill/hang specs signal its worker processes
        directly — exactly what a crashed/hung simulator looks like from
        the parent."""
        for i, s in enumerate(self.specs):
            if i in self._fired or not s.env_level or s.at != step_idx:
                continue
            if s.kind == "delay_step":
                self._fired.add(i)
                time.sleep(s.seconds)
                self._emit(s, seconds=s.seconds)
                continue
            procs = getattr(env, "_procs", None)
            if procs is None or s.worker >= len(procs):
                raise ValueError(
                    f"fault {s}: env has no worker {s.worker} to target"
                )
            proc = procs[s.worker]
            if proc is None:
                # already degraded to in-process: nothing to signal.
                # NOT marked fired — the end-of-run unfired warning must
                # report the spec instead of the run passing silently
                continue
            self._fired.add(i)
            sig = (
                signal.SIGKILL
                if s.kind == "kill_worker"
                else signal.SIGSTOP
            )
            os.kill(proc.pid, sig)
            self._emit(s, worker=s.worker, pid=proc.pid)

    # -- update level ------------------------------------------------------

    def before_iteration(self, iteration: int, state, span: int = 1):
        """Fire update-level faults due inside iterations
        ``[iteration, iteration + span)`` (``span`` > 1 = a fused device
        chunk: the fault lands at the chunk boundary, the finest
        granularity the one-program design exposes). Returns the state —
        with every floating-point policy-parameter leaf NaN-poisoned when
        a ``nan_update`` fired."""
        for i, s in enumerate(self.specs):
            if (
                i in self._fired
                or _KINDS[s.kind][1] != "update"
                or not iteration <= s.at < iteration + span
            ):
                continue
            self._fired.add(i)
            if s.kind == "sigterm":
                self._emit(s, pid=os.getpid())
                os.kill(os.getpid(), signal.SIGTERM)
            elif s.kind == "nan_update":
                state = state._replace(policy_params=_map_floating(
                    state.policy_params, _nan_like))
                self._emit(s, iteration=s.at)
        return state

    # -- serving plane ------------------------------------------------------

    def on_serve_request(
        self, request_idx: int, replicaset=None, journal_dir=None,
        router=None, path=None, body=None, transport=None,
    ) -> None:
        """Fire request-clocked serving faults due at the
        ``request_idx``-th routed client request (1-based, counted by
        the router). ``replicaset`` is the live
        :class:`~trpo_torch.serve.replicaset.ReplicaSet` whose replica
        the kill/stall/slow/flap specs target; ``journal_dir`` is
        where ``drop_carry_journal`` finds its victim file; ``router``
        + the triggering request's ``path``/``body`` are what an
        ``overload_storm`` replays realistic traffic through;
        ``transport`` is the host/replica transport
        (``serve/transport.py``) the partition grammar blackholes/
        slows — the fault lands on the NETWORK model, never on the
        replica processes themselves."""
        due = []
        with self._lock:
            for i, s in enumerate(self.specs):
                if (
                    i in self._fired
                    or not s.serve_level
                    or s.kind in _STEP_SERVE_KINDS
                    or s.at != request_idx
                ):
                    continue
                self._fired.add(i)
                due.append((i, s))
        first_error = None
        for i, s in due:
            try:
                self._fire_serve_fault(
                    s, replicaset, journal_dir,
                    router=router, path=path, body=body,
                    transport=transport,
                )
            except Exception as e:
                # a fault that could not execute (bad replica index,
                # wrong launcher family) must end the run UNFIRED —
                # the end-of-run warning names it instead of the run
                # passing as if the chaos had been exercised. The
                # OTHER due faults still execute (one bad spec must
                # not silently un-exercise its siblings); the first
                # error re-raises afterwards.
                with self._lock:
                    self._fired.discard(i)
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error

    def _fire_serve_fault(self, s, replicaset, journal_dir,
                          router=None, path=None, body=None,
                          transport=None) -> None:
        # emit BEFORE executing: concurrent request threads may detect
        # the failure (report_failure -> died/evicted records) within
        # microseconds of the kill, and the validator's matched-by-
        # detection rule requires the detection AFTER the injection
        if s.kind in _HOST_KINDS:
            self._fire_host_fault(s, transport)
        elif s.kind == "kill_replica":
            rec = (
                replicaset.replicas.get(s.replica_id)
                if replicaset is not None else None
            )
            if rec is None or rec.handle is None:
                raise ValueError(
                    f"fault {s}: no replica {s.replica_id} to kill"
                )
            self._emit(s, replica=s.replica_id)
            rec.handle.kill()
        elif s.kind == "overload_storm":
            self._start_storm(s, router, path, body)
        elif s.kind == "slow_replica":
            rec = (
                replicaset.replicas.get(s.replica_id)
                if replicaset is not None else None
            )
            server = getattr(
                rec.handle if rec is not None else None, "server", None
            )
            if server is None or not hasattr(server, "slow"):
                raise ValueError(
                    f"fault {s}: no in-process replica {s.replica_id} "
                    "to slow (subprocess replicas have no latency seam)"
                )
            self._emit(s, replica=s.replica_id, ms=s.ms)
            server.slow(s.ms)
        elif s.kind == "flap_replica":
            self._start_flap(s, replicaset)
        elif s.kind == "stall_replica":
            rec = (
                replicaset.replicas.get(s.replica_id)
                if replicaset is not None else None
            )
            if rec is None or rec.handle is None:
                raise ValueError(
                    f"fault {s}: no replica {s.replica_id} to stall"
                )
            self._emit(s, replica=s.replica_id, seconds=s.seconds)
            self._stall_replica(rec.handle, s.seconds)
        elif s.kind == "drop_carry_journal":
            if journal_dir is None:
                raise ValueError(
                    f"fault {s}: no carry-journal directory to "
                    "target (router has journal_dir=None)"
                )
            from trpo_torch.serve.session import journal_path

            self._emit(s, replica=s.replica_id)
            try:
                os.remove(journal_path(journal_dir, s.replica_id))
            except OSError:
                pass  # never journaled anything yet: same outcome —
                #       the failover finds nothing and says so

    def _fire_host_fault(self, s, transport) -> None:
        """The partition grammar: every fault lands on the
        TRANSPORT's network model — the replica processes stay exactly
        as healthy as they were, which is the whole point (detection
        must come from lease expiry / bounded discovery / latency
        metrics, never from the injector doing the supervisor's job)."""
        if transport is None:
            raise ValueError(
                f"fault {s}: needs the host transport hook "
                "(transport=None — is the router running over a "
                "serve/transport.py transport?)"
            )
        hosts = getattr(transport, "hosts", ())
        if s.host not in hosts:
            raise ValueError(
                f"fault {s}: transport has no host {s.host!r} "
                f"(have {list(hosts)})"
            )
        if s.kind == "partition_host":
            self._emit(s, host=s.host, seconds=s.seconds)
            transport.partition(s.host, s.seconds)
        elif s.kind == "slow_network":
            self._emit(s, host=s.host, ms=s.ms)
            transport.slow(s.host, s.ms)
        elif s.kind == "lost_descriptor":
            self._emit(s, host=s.host)
            transport.lose_descriptors(s.host)

    def _start_storm(self, s, router, path, body) -> None:
        """Launch the overload-storm generator: background workers
        replaying REALISTIC traffic at the router at ``s.rps`` for
        ``s.seconds``. A stateless trigger replays its own body; a
        session-act trigger seeds STORM-OWNED sessions (a flood of new
        users) so no real session's carry is ever perturbed. Worker
        errors are swallowed — the storm's 503 sheds ARE the expected
        response; what must react is the autoscaler/admission layer,
        and the validator checks exactly that."""
        if router is None:
            raise ValueError(
                f"fault {s}: overload_storm needs the router hook "
                "(router=None)"
            )
        session_mode = bool(path) and path.startswith("/session/")
        if session_mode:
            import json as _json

            try:
                obs = _json.loads(body)["obs"]
            except Exception:
                raise ValueError(
                    f"fault {s}: triggering session act carried no "
                    "replayable obs"
                )
            payload = _json.dumps({"obs": obs}).encode()
        else:
            if not body:
                raise ValueError(
                    f"fault {s}: triggering request has no body to "
                    "replay"
                )
            payload = bytes(body)
        self._emit(s, rps=s.rps, seconds=s.seconds)
        # enough workers that the target rate survives per-request
        # latency (a worker is synchronous: at most 1 outstanding, so
        # concurrency == workers under saturation); each paces itself
        # at rps/workers
        workers = max(1, min(16, int(s.rps // 5) or 1))
        for w in range(workers):
            t = threading.Thread(
                target=self._storm_worker,
                args=(router.url, session_mode, payload,
                      s.rps / workers, s.seconds),
                name=f"overload-storm-{w}",
                daemon=True,
            )
            t.start()

    @staticmethod
    def _storm_worker(url, session_mode, payload, rps, seconds) -> None:
        import json as _json
        import urllib.request

        def post(path, data):
            req = urllib.request.Request(
                url + path, data=data,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10.0) as r:
                return _json.loads(r.read())

        target = "/act"
        if session_mode:
            target = None  # minted below, retried while the set sheds
        end = time.monotonic() + seconds
        interval = 1.0 / rps
        next_t = time.monotonic()
        while time.monotonic() < end:
            try:
                if session_mode and target is None:
                    out = post("/session", b"")
                    target = f"/session/{out['session']}/act"
                else:
                    post(target, payload)
            except Exception:
                pass  # sheds/backpressure are the system WORKING
            next_t += interval
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.monotonic()  # overloaded: don't burst

    def _start_flap(self, s, replicaset) -> None:
        """Kill the target, wait for its supervised restart to go
        healthy, kill it again — ``s.times`` kills total, off-thread
        (the restarts take backoff-scale wall time)."""
        rec = (
            replicaset.replicas.get(s.replica_id)
            if replicaset is not None else None
        )
        if rec is None or rec.handle is None:
            raise ValueError(
                f"fault {s}: no replica {s.replica_id} to flap"
            )
        self._emit(s, replica=s.replica_id, times=s.times)
        with replicaset.lock:
            restarts0 = rec.restarts

        def run():
            for k in range(s.times):
                deadline = time.monotonic() + 120.0
                while time.monotonic() < deadline:
                    with replicaset.lock:
                        state, handle = rec.state, rec.handle
                        restarts = rec.restarts
                    # kill k+1 waits for the k-th RELAUNCH to land (the
                    # restart counter, not just "healthy" — the record
                    # can still read healthy for a poll tick after the
                    # previous kill, and a second shot into the same
                    # corpse would flap nothing)
                    if (
                        state == "healthy"
                        and handle is not None
                        and restarts >= restarts0 + k
                    ):
                        break
                    time.sleep(0.05)
                else:
                    return  # never came back: the flap ends here
                try:
                    handle.kill()
                except Exception:
                    return

        t = threading.Thread(
            target=run, name="flap-replica", daemon=True
        )
        t.start()

    @staticmethod
    def _stall_replica(handle, seconds: float) -> None:
        """Wedge one replica's act path: in-process replicas stall the
        PolicyServer's handlers (health checks keep answering — the
        honest wedged-device shape); subprocess replicas get
        SIGSTOP + a timed SIGCONT."""
        server = getattr(handle, "server", None)
        if server is not None and hasattr(server, "stall"):
            server.stall(seconds)
            return
        proc = getattr(handle, "proc", None)
        if proc is not None:
            os.kill(proc.pid, signal.SIGSTOP)
            timer = threading.Timer(
                seconds, lambda: os.kill(proc.pid, signal.SIGCONT)
            )
            timer.daemon = True
            timer.start()
            return
        raise ValueError(
            "stall_replica: replica handle exposes neither an "
            "in-process server nor a subprocess to signal"
        )

    def on_checkpoint_load(self, step: int, params):
        """Fire ``wedge_reload`` specs due at checkpoint ``step``:
        returns the params with every floating-point leaf NaN-poisoned
        (the checkpoint "loads but answers garbage" — the canary gate's
        target failure class); untouched params otherwise. Called by
        the serving reload path with the freshly restored snapshot —
        the FIRST replica to load the step (the canary, under gated
        deployment) is the one that wears it."""
        due = None
        with self._lock:
            for i, s in enumerate(self.specs):
                if (
                    i in self._fired
                    or s.kind != "wedge_reload"
                    or s.at != step
                ):
                    continue
                self._fired.add(i)
                due = s
                break
        if due is None:
            return params
        params = _map_floating(params, _nan_like)
        self._emit(due, step=step)
        return params

    # -- train→serve boundary -----------------------------------------------

    def _take_step_fault(self, kind: str, step: int):
        """Atomically claim the one unfired ``kind`` spec due at
        checkpoint ``step`` (the on_checkpoint_load discipline)."""
        with self._lock:
            for i, s in enumerate(self.specs):
                if i in self._fired or s.kind != kind or s.at != step:
                    continue
                self._fired.add(i)
                return i, s
        return None, None

    def on_checkpoint_publish(self, step: int, state):
        """Fire ``regress_checkpoint`` specs due at serving step
        ``step``: returns the TrainState with every floating-point
        policy leaf scaled deep into tanh saturation — finite, loads
        cleanly, passes p99 and finite-parity, behaves degenerately at
        the task. Called by the promotion controller with the restored
        winner state just before it saves into the serving directory."""
        _, due = self._take_step_fault("regress_checkpoint", step)
        if due is None:
            return state
        state = state._replace(policy_params=_map_floating(
            state.policy_params, lambda x: x * 8.0))
        self._emit(due, step=step)
        return state

    def on_checkpoint_published(self, step: int, step_dir: str) -> None:
        """Fire ``corrupt_checkpoint`` specs due at serving step
        ``step``: truncate every payload file under the just-published
        ``step_dir`` to half its size, AFTER the completion marker
        landed — the torn-flush shape the marker protocol cannot see.
        The canary's restore must fail loudly and the gate must
        reject."""
        i, due = self._take_step_fault("corrupt_checkpoint", step)
        if due is None:
            return
        torn = 0
        for root, _dirs, files in os.walk(step_dir):
            for name in files:
                path = os.path.join(root, name)
                try:
                    size = os.path.getsize(path)
                    if size > 0:
                        os.truncate(path, size // 2)
                        torn += 1
                except OSError:
                    continue
        if torn == 0:
            # nothing to tear = the fault could not execute; end the
            # run UNFIRED so the loud-completion warning names it
            with self._lock:
                self._fired.discard(i)
            raise ValueError(
                f"fault {due}: published step dir {step_dir!r} has no "
                "payload files to corrupt"
            )
        self._emit(due, step=step, files=torn)

    def on_promotion(self, step: int) -> None:
        """Fire ``kill_promoter`` specs due at serving step ``step``:
        raises :class:`PromoterKilled` — the controller "dies" after
        publishing and before the gate drives. The journal/markers are
        already durable; a restarted controller must converge."""
        _, due = self._take_step_fault("kill_promoter", step)
        if due is None:
            return
        self._emit(due, step=step)
        raise PromoterKilled(
            f"kill_promoter: promotion controller killed at serving "
            f"step {step} (mid-promotion, after publish)"
        )
