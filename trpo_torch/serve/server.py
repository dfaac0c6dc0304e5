"""HTTP front end of the serving tier: ``POST /act``, the session protocol
and hot reload (counterpart: ``trpo_tpu/serve/server.py``).

A :class:`PolicyServer` owns these routes on a
:class:`~trpo_torch.utils.httpd.BackgroundHTTPServer` (TCP, plus an
``AF_UNIX`` listener with ``uds_path``):

* ``POST /act`` — ``{"obs": [...]}`` in, ``{"action": ..., "step": N}``
  out (feedforward engines). The handler thread submits to the
  micro-batcher and blocks on its future. Malformed JSON or a wrong obs
  shape is a 400, serving before any checkpoint loaded a 503, an engine
  failure a 500, a timed-out inference a 504, each scoped to its request.
* ``POST /session`` + ``POST /session/<id>/act`` — the recurrent
  protocol: mint a session (server-side carry in a bounded TTL
  :class:`~trpo_torch.serve.session.SessionStore`), then step it by id
  through the server's own
  :class:`~trpo_torch.serve.batcher.SessionBatcher`. An unknown or
  expired session is a typed 404 (``code="session_unknown"``). An
  optional ``seq`` makes an act idempotent.
* A wrong-protocol call (``/act`` on a recurrent engine, a session call
  on a feedforward one) is a typed 409 naming the right endpoint
  (``code="wrong_protocol"``).
* ``GET /healthz`` — liveness, the loaded step, the model family, the
  live session count and ``reloading``.
* ``GET /metrics`` — Prometheus ``trpo_serve_*`` families.
* ``POST /reload`` — managed replicas only: ``{"step": N}`` loads one
  marker-complete step, ``{"rollback": true}`` swaps the previous
  in-memory snapshot back.
* ``POST /drain`` — journal every live session (or one, or forget some)
  for a lossless scale-in.

Act bodies and answers are JSON, or the binary frames of
:mod:`trpo_torch.serve.wire` when the request says so
(``Content-Type``/``Accept``); a malformed frame is a typed 400
(``code="bad_frame"``).

Hot reload: a background watcher polls the port's
``Checkpointer.latest_step()`` every ``poll_interval`` seconds (marker
gated: a torn save is never offered) and restores a new step with
``prune=False`` (the directory may be a live trainer's). The engine's
load captures the new snapshot's graphs on the watcher's thread and
swaps it in, so in-flight requests finish on the old params and nothing
is dropped. A failed restore is printed and retried at the next poll;
the endpoint keeps serving the last good snapshot.

Telemetry: with a ``bus`` a reload (or a failed one) is a ``health``
event, and the session store, journal and batchers emit theirs on it.
With a ``tracer`` (``obs.trace.Tracer``) every act, session create and
session act is a ``replica.*`` span, joined to the trace its hop carried
(``X-Trace-Id``/``X-Trace-Parent``/``X-Trace-Sampled``) or opened here
for a direct client, with the batcher's ``batch.queue_wait`` and engine
spans under it; ``/metrics`` adds ``trpo_trace_*``. With an ``injector``
(``resilience.FaultInjector``) every restored step passes through its
``on_checkpoint_load`` before the engine loads it, so a
``wedge_reload@step=N`` spec replaces step N's params with NaN on the
first replica to load it (the canary, under a gated deployment); the
engine copies them into the new snapshot it captures its graphs over.
With a ``capture`` (``obs.capture.RequestCapture``) every act whose trace
is emitted is recorded for deterministic replay: its raw body, the
answered action and the step of the snapshot the batch ran on (read from
the dispatched snapshot, never from the server's current step, so a
window that spans a reload replays on the right weights); ``/metrics``
adds ``trpo_capture_*``.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Dict, Optional

import numpy as np

from trpo_torch.serve import wire as _wire
from trpo_torch.utils.httpd import BackgroundHTTPServer, request_headers

__all__ = ["PolicyServer"]

_JSON = "application/json"
_WIRE = _wire.WIRE_CONTENT_TYPE
_PROMETHEUS = "text/plain; version=0.0.4; charset=utf-8"
_NOT_LOADED = {"error": "no policy loaded yet (no complete checkpoint)"}


def _json_body(obj) -> bytes:
    return json.dumps(obj).encode()


def _reply(status: int, obj):
    return status, _JSON, _json_body(obj)


def _finite_or_none(v: float):
    return v if math.isfinite(v) else None


class PolicyServer:
    """Serve a policy over HTTP, hot-reloading from a checkpoint dir.

    ``snapshot_fn`` maps a restored ``TrainState`` to the engine's
    ``(policy_params, obs_norm)`` (default: those two fields).
    ``checkpointer``/``template`` may be None for an engine loaded by
    hand (no hot reload).

    ``engine`` is an :class:`~trpo_torch.serve.engine.InferenceEngine`
    (``batcher`` required: ``/act`` active) or a
    :class:`~trpo_torch.serve.session.RecurrentServeEngine` (``batcher``
    None: the server owns a SessionBatcher with ``session_deadline_ms``).

    ``managed_reload=True`` stops the watcher from following every new
    checkpoint: the first load takes ``initial_step`` (or the latest, on
    a cold directory) and later steps land only through ``POST /reload``.
    ``carry_journal_dir`` attaches a
    :class:`~trpo_torch.serve.session.CarryJournal` at ``journal_path(dir,
    replica_name)`` (recurrent engines), synced every
    ``carry_sync_every`` applied steps.
    """

    ENDPOINTS = (
        "/act", "/session", "/healthz", "/metrics", "/reload", "/drain",
    )

    def __init__(
        self,
        engine,
        batcher,
        port: int,
        host: str = "127.0.0.1",
        checkpointer=None,
        template=None,
        snapshot_fn: Optional[Callable] = None,
        poll_interval: float = 1.0,
        bus=None,
        act_timeout_s: float = 30.0,
        session_ttl_s: float = 300.0,
        max_sessions: int = 1024,
        replica_name: Optional[str] = None,
        carry_journal_dir: Optional[str] = None,
        carry_sync_every: int = 1,
        managed_reload: bool = False,
        initial_step: Optional[int] = None,
        injector=None,
        session_deadline_ms: float = 3.0,
        session_adaptive_deadline: bool = True,
        tracer=None,
        uds_path: Optional[str] = None,
        capture=None,
    ):
        if (checkpointer is None) != (template is None):
            raise ValueError(
                "checkpointer and template come together: the watcher "
                "restores INTO the template (agent.init_state())"
            )
        if poll_interval <= 0:
            raise ValueError(
                f"poll_interval must be > 0, got {poll_interval}")
        self.is_recurrent = bool(getattr(engine, "is_recurrent", False))
        if self.is_recurrent and batcher is not None:
            raise ValueError(
                "a recurrent engine takes no micro-batcher: the server "
                "owns its own SessionBatcher for the carry-threading "
                "epoch dispatch (pass batcher=None)"
            )
        if not self.is_recurrent and batcher is None:
            raise ValueError(
                "a feedforward engine needs a MicroBatcher on /act")
        self.engine = engine
        self.batcher = batcher
        self.bus = bus
        self.tracer = tracer
        # request capture: this replica's own record of the emitted acts
        # it answered. Caller-owned like the tracer; None = off. The notes
        # park each in-flight act's capture fields until _traced knows
        # the trace's final verdict.
        self.capture = capture
        self._capture_notes: Dict[int, dict] = {}
        self.injector = injector  # chaos: the reload seam (wedge_reload)
        self.checkpointer = checkpointer
        self.template = template
        self.snapshot_fn = snapshot_fn or (
            lambda state: (state.policy_params, state.obs_norm))
        self.poll_interval = float(poll_interval)
        self.act_timeout_s = float(act_timeout_s)
        self.reloads_total = 0
        self.reload_failures_total = 0
        self.last_reload_ms: Optional[float] = None
        self.session_acts_total = 0
        self.session_act_errors_total = 0
        self.replica_name = replica_name
        self.managed_reload = bool(managed_reload)
        # managed mode: the ONLY step this replica may serve; None =
        # adopt whatever first checkpoint appears (cold directory)
        self._target_step: Optional[int] = (
            int(initial_step)
            if managed_reload and initial_step is not None else None)
        # act-plane frames per codec, and typed decode refusals
        self.wire_frames_total = {"json": 0, "binary": 0}
        self.wire_decode_errors_total = 0
        self._counter_lock = threading.Lock()
        self._reload_lock = threading.Lock()  # watcher vs POST /reload
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._reloading = False  # True while a restore+load is in flight
        self._stall_until = 0.0  # chaos: acts sleep past this deadline
        self._slow_ms = 0.0      # chaos: persistent per-act latency
        self.sessions = None
        self.session_batcher = None
        if self.is_recurrent:
            from trpo_torch.serve.batcher import SessionBatcher
            from trpo_torch.serve.session import (
                CarryJournal,
                SessionStore,
                journal_path,
            )

            journal = None
            if carry_journal_dir is not None:
                journal = CarryJournal(
                    journal_path(carry_journal_dir, replica_name or "solo"),
                    replica=replica_name or "solo", bus=bus,
                )
            self.sessions = SessionStore(
                ttl_s=session_ttl_s,
                max_sessions=max_sessions,
                bus=bus,
                replica=replica_name,
                journal=journal,
                sync_every=carry_sync_every,
            )
            self.session_batcher = SessionBatcher(
                engine,
                deadline_ms=session_deadline_ms,
                adaptive_deadline=session_adaptive_deadline,
                bus=bus,
            )

        if checkpointer is not None:
            # synchronous first load: no needless 503 window when a
            # checkpoint already exists
            self._maybe_reload()
            self._watcher = threading.Thread(
                target=self._watch, name="serve-reload-watcher", daemon=True)
            self._watcher.start()

        self._httpd = BackgroundHTTPServer(
            port,
            host=host,
            get={"/healthz": self._healthz, "/metrics": self._metrics},
            post={
                "/act": self._act,
                "/session": self._session_create,
                "/reload": self._reload_cmd,
                "/drain": self._drain_cmd,
            },
            post_prefix={"/session/": self._session_act},
            not_found=(
                "have POST /act, POST /session, POST /session/<id>/act, "
                "POST /reload, GET /healthz, GET /metrics"
            ),
            thread_name="serve-http",
            uds_path=uds_path,
        )
        self.host = host
        self.port = self._httpd.port
        self.uds_path = self._httpd.uds_path

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- hot reload --------------------------------------------------------

    def _maybe_reload(self) -> None:
        with self._reload_lock:
            self._maybe_reload_locked()

    def _maybe_reload_locked(self) -> None:
        if self.managed_reload and self._target_step is not None:
            step = self._target_step
        else:
            step = self.checkpointer.latest_step()
        if step is None or step == self.engine.loaded_step:
            return
        t0 = time.perf_counter()
        try:
            self._reloading = True
            # prune=False: a save the live trainer is writing looks torn
            # to a reader, and must not be deleted by one
            state = self.checkpointer.restore(self.template, step,
                                              prune=False)
            params, obs_norm = self.snapshot_fn(state)
            if not self.engine.with_obs_norm:
                obs_norm = None
            if self.injector is not None:
                # the checkpoint restored cleanly; a wedge_reload spec
                # makes it answer garbage, what the canary gate must catch
                params = self.injector.on_checkpoint_load(step, params)
            self.engine.load(params, obs_norm, step=step)
        except Exception as e:  # keep serving the last good snapshot
            self.reload_failures_total += 1
            msg = (f"serve: checkpoint step {step} failed to load "
                   f"({type(e).__name__}: {e}) — "
                   + (f"still serving step {self.engine.loaded_step}"
                      if self.engine.ready
                      else "nothing loaded yet (serving 503; do the model "
                      "flags match the training run?)"))
            print(msg, file=sys.stderr, flush=True)
            self._emit_health("serve_reload_failed", "warn", msg, step)
            return
        finally:
            self._reloading = False
        self.last_reload_ms = (time.perf_counter() - t0) * 1e3
        if self.managed_reload and self._target_step is None:
            # a managed replica on a cold directory adopts its FIRST
            # checkpoint; every later step comes through POST /reload
            self._target_step = step
        self.reloads_total += 1
        self._emit_health("serve_reload", "info",
                          f"hot-reloaded policy snapshot from step {step}",
                          step)

    def _emit_health(self, check: str, level: str, message: str,
                     step: int) -> None:
        if self.bus is not None:
            self.bus.emit("health", check=check, level=level,
                          message=message, data={"step": step})

    # -- request tracing -----------------------------------------------------

    def _traced(self, name: str, fn, *args):
        """The handler trace wrapper (the router has its twin): join the
        request's trace — the propagated one, whose parent span lives in
        the router's log (``remote``), or as the public edge for a direct
        client — open the handler span, run the handler with ``(ctx,
        span)`` appended, force the trace on a replica-side failure (a
        crash, or a 5xx other than the typed 503), close with the
        status."""
        if self.tracer is None:
            return fn(*args, None, None)
        headers = request_headers()
        ctx = self.tracer.join(headers)
        parent = self.tracer.parent_from(headers)
        span = ctx.span(name, parent_id=parent, remote=parent is not None)
        out = None
        try:
            out = fn(*args, ctx, span)
            return out
        finally:
            status = out[0] if out is not None else 500
            if out is None or (status >= 500 and status != 503):
                ctx.force()
            span.end(status=status)
            if self.capture is not None:
                # after the forcing above: capture and span emission
                # agree on the final verdict
                with self._counter_lock:
                    note = self._capture_notes.pop(id(ctx), None)
                if note is not None:
                    self.capture.record(ctx, status=status, **note)
            self.tracer.finish(ctx)

    def _capture_note(self, ctx, path: str, endpoint: str, body: bytes,
                      step, action, session: Optional[str] = None) -> None:
        """Park one answered act's capture fields until its trace closes;
        a no-op when capture is off."""
        if self.capture is None or ctx is None:
            return
        note = dict(path=path, endpoint=endpoint, body=body,
                    binary=_wire.is_binary_body(request_headers()),
                    session=session, replica=self.replica_name, step=step,
                    action=np.asarray(action).tolist())
        with self._counter_lock:
            self._capture_notes[id(ctx)] = note

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self._maybe_reload()
            except Exception as e:  # the watcher must outlive a bad poll
                print(f"serve: checkpoint poll failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr,
                      flush=True)

    def _reload_cmd(self, body: bytes):
        """``POST /reload`` on a managed replica (unmanaged ones refuse
        with a typed 409: their watcher owns the snapshot)."""
        if not self.managed_reload:
            return _reply(409, {
                "error": (
                    "this replica follows latest_step() on its own "
                    "watcher — run it with managed_reload=True to "
                    "command reloads"
                ),
                "code": "unmanaged",
            })
        try:
            payload = json.loads(body) if body else {}
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            return _reply(400, {"error": f'body must be {{"step": N}} or '
                                         f'{{"rollback": true}} ({e})'})
        if payload.get("rollback"):
            with self._reload_lock:
                try:
                    step = self.engine.rollback()
                except RuntimeError as e:
                    return _reply(409, {"error": str(e),
                                        "code": "no_previous_snapshot"})
                self._target_step = step
            return _reply(200, {"ok": True, "step": step,
                                "rolled_back": True})
        step = payload.get("step")
        if not isinstance(step, int) or isinstance(step, bool):
            return _reply(400, {"error": 'body must carry an integer '
                                         '"step" (or "rollback": true)'})
        if self.checkpointer is None:
            return _reply(409, {"error": "no checkpoint directory attached "
                                         "— nothing to reload from",
                                "code": "no_checkpointer"})
        with self._reload_lock:
            self._target_step = step
            self._maybe_reload_locked()  # synchronous: a definitive answer
            loaded = self.engine.loaded_step
        ok = loaded == step
        return _reply(200 if ok else 500, {"ok": ok, "step": loaded})

    def _drain_cmd(self, body: bytes):
        """``POST /drain``: an empty body journals EVERY live session and
        blocks until flushed; ``{"session": sid}`` just one;
        ``{"forget": [sids]}`` removes sessions resumed elsewhere.
        Feedforward replicas answer trivially."""
        if self.sessions is None:
            return _reply(200, {"ok": True, "sessions": 0})
        try:
            payload = json.loads(body) if body else {}
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            forget = payload.get("forget")
            if forget is not None and (
                    not isinstance(forget, list)
                    or not all(isinstance(s, str) for s in forget)):
                raise ValueError('"forget" must be a list of session ids')
            one = payload.get("session")
            if one is not None and not isinstance(one, str):
                raise ValueError('"session" must be a session id')
        except ValueError as e:
            return _reply(400, {"error": f'body must be empty, '
                                         f'{{"session": sid}} or '
                                         f'{{"forget": [...]}} ({e})'})
        if forget is not None:
            removed = sum(1 for sid in forget if self.sessions.remove(sid))
            return _reply(200, {"ok": True, "forgotten": removed,
                                "sessions": len(self.sessions)})
        if one is not None:
            flushed = self.sessions.sync_one(one)
            known = self.sessions.get(one) is not None
            return _reply(200, {"ok": flushed, "known": known,
                                "sessions": len(self.sessions)})
        flushed = self.sessions.sync_all()
        return _reply(200, {"ok": flushed, "sessions": len(self.sessions)})

    # -- latency seams -----------------------------------------------------

    def slow(self, ms: float) -> None:
        """Every act from now on pays an extra ``ms`` (a degraded device;
        health checks answer at full speed)."""
        self._slow_ms = float(ms)

    def stall(self, seconds: float) -> None:
        """Every act sleeps until ``seconds`` from now have passed (a
        wedged device; health checks still answer)."""
        self._stall_until = time.monotonic() + float(seconds)

    def _maybe_stall(self) -> None:
        if self._slow_ms > 0:
            time.sleep(self._slow_ms / 1e3)
        delay = self._stall_until - time.monotonic()
        if delay > 0:
            time.sleep(delay)

    # -- handlers ----------------------------------------------------------

    def _negotiate(self, body: bytes):
        """``(payload, reply_binary, err)``: a wire-frame body decoded into
        the JSON path's payload shape (``payload`` None for a JSON body),
        the answer's codec from ``Accept``, and a ready typed 400 for a
        malformed frame."""
        headers = request_headers()
        binary = _wire.is_binary_body(headers)
        reply_binary = _wire.wants_binary(headers)
        with self._counter_lock:
            self.wire_frames_total["binary" if binary else "json"] += 1
        if not binary:
            return None, reply_binary, None
        try:
            scalars, arrays = _wire.decode_frame(body)
        except _wire.WireError as e:
            with self._counter_lock:
                self.wire_decode_errors_total += 1
            return None, reply_binary, _reply(400, {
                "error": f"bad wire frame: {e.detail}", "code": e.code})
        payload = dict(scalars)
        payload.update(arrays)
        return payload, reply_binary, None

    def _parse_obs(self, body: bytes, with_seq: bool):
        """``(obs, seq, reply_binary, err)`` of an act body."""
        payload, reply_binary, err = self._negotiate(body)
        if err is not None:
            return None, None, reply_binary, err
        seq = None
        try:
            if payload is None:
                payload = json.loads(body)
            obs = np.asarray(payload["obs"], self.engine.obs_dtype)
            if with_seq:
                seq = payload.get("seq")
                if seq is not None and (not isinstance(seq, int)
                                        or isinstance(seq, bool)):
                    raise ValueError("seq must be an integer")
        except (ValueError, KeyError, TypeError) as e:
            return None, None, reply_binary, _reply(
                400, {"error": f'body must be {{"obs": [...]}} ({e})'})
        if obs.shape != self.engine.obs_shape:
            return None, None, reply_binary, _reply(400, {
                "error": (f"obs shape {list(obs.shape)} != expected "
                          f"{list(self.engine.obs_shape)}")})
        return obs, seq, reply_binary, None

    @staticmethod
    def _answer(meta: dict, action, reply_binary: bool):
        action = np.asarray(action)
        if reply_binary:
            return 200, _WIRE, _wire.encode_frame(meta, {"action": action})
        return _reply(200, dict(meta, action=action.tolist()))

    def _act(self, body: bytes):
        return self._traced("replica.act", self._act_inner, body)

    def _act_inner(self, body: bytes, ctx, span):
        self._maybe_stall()
        if self.is_recurrent:
            return _reply(409, {
                "error": (
                    "this endpoint serves a RECURRENT policy: the "
                    "stateless /act plane cannot thread its carry — "
                    "mint a session with POST /session, then "
                    "POST /session/<id>/act"
                ),
                "code": "wrong_protocol",
                "endpoint": "/session",
            })
        if not self.engine.ready:
            return _reply(503, _NOT_LOADED)
        obs, _, reply_binary, err = self._parse_obs(body, with_seq=False)
        if err is not None:
            return err
        try:
            # submit inside the try: a batcher racing its own teardown
            # answers a scoped JSON 500
            future = self.batcher.submit(
                obs, trace=(ctx, span.span_id) if ctx is not None else None)
            action, step = future.result(timeout=self.act_timeout_s)
        except _FutureTimeout:
            return _reply(504, {
                "error": f"inference exceeded {self.act_timeout_s}s"})
        except Exception as e:  # an engine failure, scoped to this request
            return _reply(500, {
                "error": f"inference failed: {type(e).__name__}"})
        # `step` is the snapshot the batch ran on, captured in the engine
        self._capture_note(ctx, "/act", "act", body, step, action)
        return self._answer({"step": step}, action, reply_binary)

    # -- session protocol --------------------------------------------------

    @staticmethod
    def _wrong_protocol_feedforward():
        return _reply(409, {
            "error": (
                "this endpoint serves a FEEDFORWARD policy: there is no "
                "carry to thread — use the stateless POST /act"
            ),
            "code": "wrong_protocol",
            "endpoint": "/act",
        })

    def _session_restore(self, body: bytes):
        """``(session_id, restore)`` of a ``POST /session`` body: an
        optional id (the router owns ids for affinity) and, to resume a
        journaled session, ``carry``/``steps``/``seq``/``last_action``/
        ``last_step``. Raises ``ValueError`` on a malformed body."""
        if not body:
            return None, {}
        payload = json.loads(body)
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        session_id = payload.get("session_id")
        if session_id is not None and not isinstance(session_id, str):
            raise ValueError("session_id must be a string")
        if payload.get("carry") is None:
            return session_id, {}
        carry = np.asarray(payload["carry"], np.float32)
        if carry.shape != (self.engine.state_size,):
            raise ValueError(
                f"carry must have {self.engine.state_size} elements, got "
                f"shape {list(carry.shape)}")
        steps = payload.get("steps")
        if not isinstance(steps, int) or isinstance(steps, bool) \
                or steps < 0:
            raise ValueError('a restored carry needs its integer "steps" '
                             'count')
        # validated here: an int() failing inside SessionStore.create
        # would answer an unscoped 500 after its LRU eviction
        for key in ("seq", "last_step"):
            v = payload.get(key)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool)):
                raise ValueError(f"{key} must be an integer")
        last_action = payload.get("last_action")
        if last_action is not None:
            last_action = np.asarray(last_action)
            if last_action.dtype == object:
                raise ValueError("last_action must be numeric")
        return session_id, {"carry": carry, "steps": steps,
                            "seq": payload.get("seq"),
                            "last_action": last_action,
                            "last_step": payload.get("last_step")}

    def _session_create(self, body: bytes):
        return self._traced("replica.session_create",
                            self._session_create_inner, body)

    def _session_create_inner(self, body: bytes, ctx, span):
        """Mint a session (a fresh zero carry), or resume a journaled
        one."""
        if not self.is_recurrent:
            return self._wrong_protocol_feedforward()
        if not self.engine.ready:
            return _reply(503, _NOT_LOADED)
        try:
            session_id, restore = self._session_restore(body)
        except (ValueError, TypeError) as e:
            return _reply(400, {"error": f"body must be empty or JSON ({e})"})
        carry = restore.pop("carry", None)
        sid = self.sessions.create(
            carry if carry is not None else self.engine.initial_carry(),
            session_id=session_id, **restore)
        out = {"session": sid, "step": self.engine.loaded_step}
        if carry is not None:
            out["resumed_steps"] = restore["steps"]
        return _reply(200, out)

    def _session_act(self, path: str, body: bytes):
        return self._traced("replica.session_act", self._session_act_inner,
                            path, body)

    def _session_act_inner(self, path: str, body: bytes, ctx, span):
        """``POST /session/<id>/act``: advance one session's carry by one
        observation, under the session's lock (different sessions share
        the batcher's epochs). A replay of the last applied ``seq``
        answers the STORED action without stepping the carry again."""
        if not self.is_recurrent:
            return self._wrong_protocol_feedforward()
        self._maybe_stall()
        parts = path.strip("/").split("/")
        if len(parts) != 3 or parts[0] != "session" or parts[2] != "act":
            return _reply(404, {"error": "unknown session path; have POST "
                                         "/session/<id>/act"})
        sid = parts[1]
        if not self.engine.ready:
            return _reply(503, _NOT_LOADED)
        sess = self.sessions.get(sid)
        if sess is None:
            return _reply(404, {
                "error": (f"unknown or expired session {sid!r} — mint a "
                          "new one with POST /session"),
                "code": "session_unknown",
            })
        obs, seq, reply_binary, err = self._parse_obs(body, with_seq=True)
        if err is not None:
            return err
        try:
            with sess.lock:
                if (seq is not None and sess.last_seq == seq
                        and sess.last_action is not None):
                    # replayed seq: already applied (exactly once)
                    self.sessions.deduped_total += 1
                    sess.last_used = time.monotonic()
                    self._capture_note(ctx, path, "session_act", body,
                                       sess.last_step, sess.last_action,
                                       session=sid)
                    return self._answer(
                        {"step": sess.last_step, "session": sid,
                         "session_steps": sess.steps, "deduped": True},
                        sess.last_action, reply_binary)
                # the timeout bounds both the queue admission (a wedged
                # engine backs the queue up) and the epoch's result
                future = self.session_batcher.submit(
                    sid, sess.carry, obs, timeout=self.act_timeout_s,
                    trace=(ctx, span.span_id) if ctx is not None else None)
                action, carry_new, step = future.result(
                    timeout=self.act_timeout_s)
                sess.carry = carry_new
                if seq is not None:
                    sess.last_seq = seq
                sess.last_action = np.asarray(action)
                sess.last_step = step
                self.sessions.touch_steps(sess)
                self.sessions.journal_step(
                    sid, sess,
                    trace=(ctx, span.span_id) if ctx is not None else None)
        except _FutureTimeout:
            # the epoch never came back: the carry was NOT advanced, so a
            # retry is safe
            with self._counter_lock:
                self.session_act_errors_total += 1
            return _reply(504, {
                "error": f"inference exceeded {self.act_timeout_s}s"})
        except Exception as e:  # an engine failure, scoped to this request
            with self._counter_lock:
                self.session_act_errors_total += 1
            return _reply(500, {
                "error": f"inference failed: {type(e).__name__}"})
        with self._counter_lock:
            self.session_acts_total += 1
        self._capture_note(ctx, path, "session_act", body, step, action,
                           session=sid)
        return self._answer({"step": step, "session": sid,
                             "session_steps": sess.steps},
                            action, reply_binary)

    def _healthz(self):
        ok = self.engine.ready
        return (200 if ok else 503), _JSON, _json_body({
            "ok": ok,
            "step": self.engine.loaded_step,
            "requests_total": (self.batcher.requests_total
                               if self.batcher is not None
                               else self.session_acts_total),
            "reloads_total": self.reloads_total,
            "reloading": self._reloading,
            "recurrent": self.is_recurrent,
            "managed": self.managed_reload,
            "sessions": len(self.sessions) if self.sessions is not None
            else 0,
        })

    # -- /metrics ----------------------------------------------------------

    def _metrics(self):
        lines = []

        def fam(name, mtype, help_, samples):
            rows = [f"{name}{labels} {value}"
                    for labels, value in samples if value is not None]
            if rows:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {mtype}")
                lines.extend(rows)

        def one(name, mtype, help_, value):
            fam(name, mtype, help_, [("", value)])

        def quantiles(name, help_, q):
            fam(name, "gauge", help_,
                [(f'{{quantile="{qq}"}}', _finite_or_none(v))
                 for qq, v in sorted(q.items())])

        def shapes(help_):
            # dict() snapshot: a first dispatch at a new rung inserts a
            # key while the scrape iterates
            fam("trpo_serve_batch_shape_total", "counter", help_,
                [(f'{{shape="{rung}"}}', count) for rung, count in
                 sorted(dict(self.engine.shape_counts).items())])

        if self.batcher is None:  # recurrent: the session data plane
            s, sb = self.sessions, self.session_batcher
            one("trpo_serve_session_acts_total", "counter",
                "session act requests served", self.session_acts_total)
            one("trpo_serve_session_act_errors_total", "counter",
                "session act requests failed by engine errors",
                self.session_act_errors_total)
            one("trpo_serve_sessions_active", "gauge",
                "live sessions in the bounded store", len(s))
            one("trpo_serve_sessions_created_total", "counter",
                "sessions minted", s.created_total)
            one("trpo_serve_sessions_expired_total", "counter",
                "sessions TTL-expired", s.expired_total)
            one("trpo_serve_sessions_evicted_total", "counter",
                "sessions LRU-evicted at capacity", s.evicted_total)
            one("trpo_serve_sessions_resumed_total", "counter",
                "sessions restored from a journaled carry",
                s.resumed_total)
            one("trpo_serve_session_acts_deduped_total", "counter",
                "acts answered from the seq-dedupe cache (replayed "
                "retries that must not double-step)", s.deduped_total)
            one("trpo_serve_session_queue_depth", "gauge",
                "session acts waiting in the epoch batcher",
                sb.queue_depth)
            one("trpo_serve_session_epochs_total", "counter",
                "gather/scatter epochs dispatched", sb.epochs_total)
            one("trpo_serve_session_epoch_width", "gauge",
                "sessions gathered into the most recent epoch",
                sb.epoch_width_last)
            one("trpo_serve_session_epoch_width_mean", "gauge",
                "mean sessions per dispatched epoch", sb.epoch_width_mean)
            one("trpo_serve_session_epoch_holdbacks_total", "counter",
                "same-session entries deferred to a later epoch (one "
                "sid never rides twice in one dispatch)",
                sb.holdbacks_total)
            shapes("epoch dispatches per padded session-batch rung")
            quantiles("trpo_serve_session_latency_ms",
                      "per-act latency quantiles over the recent (bounded) "
                      "window", sb.latency_quantiles_ms((0.5, 0.99)))
        else:
            b = self.batcher
            one("trpo_serve_requests_total", "counter",
                "act requests accepted", b.requests_total)
            one("trpo_serve_batches_total", "counter",
                "micro-batches dispatched", b.batches_total)
            one("trpo_serve_request_errors_total", "counter",
                "requests failed by engine errors", b.errors_total)
            one("trpo_serve_queue_depth", "gauge",
                "requests waiting in the micro-batcher", b.queue_depth)
            one("trpo_serve_queue_high_water", "gauge",
                "max queue depth observed", b.queue_high_water)
            shapes("dispatches per padded batch rung")
            quantiles("trpo_serve_latency_ms",
                      "per-request latency quantiles over the recent window",
                      b.latency_quantiles_ms((0.5, 0.99)))
            ema = getattr(b, "dispatch_cost_ema_ms", None)
            if ema is not None:
                one("trpo_serve_dispatch_cost_ema_ms", "gauge",
                    "EMA of observed per-dispatch engine cost (the "
                    "adaptive-deadline signal)", _finite_or_none(ema))
        one("trpo_serve_checkpoint_step", "gauge",
            "checkpoint step currently served", self.engine.loaded_step)
        one("trpo_serve_reloads_total", "counter", "hot reloads applied",
            self.reloads_total)
        with self._counter_lock:
            frames = dict(self.wire_frames_total)
            decode_errors = self.wire_decode_errors_total
        fam("trpo_serve_wire_frames_total", "counter",
            "act-plane requests by wire codec",
            [(f'{{codec="{c}"}}', n) for c, n in sorted(frames.items())])
        one("trpo_serve_wire_decode_errors_total", "counter",
            "binary frames refused as malformed (typed 400 bad_frame)",
            decode_errors)
        fam("trpo_serve_transport_requests_total", "counter",
            "requests served by listener family (tcp vs same-host uds)",
            [(f'{{transport="{t}"}}', n) for t, n in sorted(dict(
                self._httpd.transport_requests_total).items())])
        if self.tracer is not None:
            # writer-backpressure drops are counted, never silent
            one("trpo_trace_spans_total", "counter",
                "trace spans accepted for emission",
                self.tracer.spans_total)
            one("trpo_trace_sampled_total", "counter",
                "request traces emitted (head-sampled or forced)",
                self.tracer.sampled_total)
            one("trpo_trace_dropped_total", "counter",
                "trace spans dropped by writer backpressure",
                self.tracer.dropped_total)
        if self.capture is not None:
            # the tracer contract again: dropped_total 0 certifies a
            # complete capture log
            one("trpo_capture_requests_total", "counter",
                "requests captured for deterministic replay",
                self.capture.requests_total)
            one("trpo_capture_dropped_total", "counter",
                "capture records dropped by writer backpressure",
                self.capture.dropped_total)
            one("trpo_capture_bytes_total", "counter",
                "request payload bytes accepted for capture",
                self.capture.bytes_total)
        return 200, _PROMETHEUS, ("\n".join(lines) + "\n").encode()

    # -- teardown ----------------------------------------------------------

    def close(self, abrupt: bool = False) -> None:
        """Stop the watcher and the HTTP server (the micro-batcher belongs
        to the caller). ``abrupt=True`` drops pending carry-journal
        entries, as a crash would."""
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5.0)
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.close()
        if self.session_batcher is not None:
            # after the front end: accepted epochs still resolve
            self.session_batcher.close()
        if self.sessions is not None:
            self.sessions.close(flush=not abrupt)
