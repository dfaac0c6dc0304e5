"""Request capture for deterministic replay
(counterpart: ``trpo_tpu/obs/capture.py``).

The serving plane journals every carry, fences every write, and traces
every sampled request — a *recording* of production that, before this
module, nothing could play back. :class:`RequestCapture` closes the
recording half of that loop: for every request whose trace is emitted
(the SAME head-sampling verdict the tracer uses — capture and spans
agree with no coordination, and anomaly-forced traces are always
captured), it records the request's replayable inputs on the event bus
as typed ``capture`` records:

* ``trace`` / ``order`` — the trace id and this process's arrival
  order among captured requests (the causal replay order within a
  session is the stamped ``seq``; ``order`` totally orders the
  cross-session interleave).
* ``path`` / ``endpoint`` / ``session`` / ``seq`` — where the request
  went; ``seq`` is the router's dedupe stamp, extracted from the
  stamped body (JSON or wire frame) on the writer thread.
* ``payload`` — the observation, re-encoded as a base64'd binary wire
  frame (``serve/wire.py`` — the codec IS the serializer, so replay
  round-trips the obs bytes bit-exact regardless of whether the client
  spoke JSON or wire).
* ``step`` — the checkpoint step loaded on the answering replica: the
  shadow set must serve the same params for the bit-exact oracle to
  hold.
* ``action`` — the answered action (when the response parsed): the
  recorded side of the replay diff.

Hot-path contract (the span-writer pattern, verbatim): the
request path does ONE bounded-deque append of raw bytes — body/response
parsing, wire re-encoding, and base64 all happen on the daemon writer
thread, which drains through ``bus.emit_batch``. Backpressure drops
WHOLE records and counts every one in ``dropped_total`` (exported as
``trpo_capture_dropped_total`` — never silent); anomaly-forced records
overshoot the bound instead of dropping, exactly like forced traces.
"""

from __future__ import annotations

import base64
import binascii
import json
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

__all__ = [
    "RequestCapture",
    "capture_records",
    "decode_payload",
    "encode_obs_payload",
]


def encode_obs_payload(obs: np.ndarray, seq: Optional[int] = None) -> str:
    """One observation as a base64'd wire frame — the capture record's
    ``payload`` field. The wire codec is the serializer:
    little-endian raw array bytes, so decode → re-encode → decode is
    bit-exact."""
    from trpo_torch.serve import wire as _wire

    scalars = {} if seq is None else {"seq": int(seq)}
    frame = _wire.encode_frame(scalars, {"obs": np.asarray(obs)})
    return base64.b64encode(frame).decode("ascii")


def decode_payload(record: dict):
    """``(scalars, obs)`` back out of one capture record's ``payload``
    (None when the record carries no payload — the writer could not
    parse the request body; the bundle builder reports those as
    non-replayable instead of guessing)."""
    payload = record.get("payload")
    if not isinstance(payload, str) or not payload:
        return None
    from trpo_torch.serve import wire as _wire

    try:
        scalars, arrays = _wire.decode_frame(
            base64.b64decode(payload.encode("ascii"))
        )
    except (_wire.WireError, binascii.Error, ValueError):
        return None
    obs = arrays.get("obs")
    if obs is None:
        return None
    return scalars, np.asarray(obs)


def capture_records(records) -> list:
    """The ``capture`` records out of a loaded event stream, in arrival
    order (``order`` within each capturing process; processes
    interleave by record time)."""
    caps = [r for r in records if r.get("kind") == "capture"]
    caps.sort(key=lambda r: (r.get("t", 0), r.get("order", 0)))
    return caps


class RequestCapture:
    """Write-behind request recorder for one process (router or
    replica) — the :class:`~trpo_torch.obs.trace.Tracer` pattern applied
    to request inputs.

    ``record()`` is called at request end with the raw body/response
    bytes; it checks the trace's emitting verdict, does one bounded
    append, and returns. The daemon writer parses, wire-encodes, and
    emits batched ``capture`` records through the bus. ``process`` /
    ``host`` stamp every record, so a multi-process incident window
    assembles the same way traces do."""

    def __init__(
        self,
        bus,
        process: Optional[str] = None,
        host: Optional[str] = None,
        max_pending: int = 1024,
        poll_interval: float = 0.2,
    ):
        if max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}"
            )
        self.bus = bus
        self.process = process
        self.host = host
        self.max_pending = int(max_pending)
        self._poll = float(poll_interval)
        # counters (exported by the /metrics handlers): requests_total
        # counts records accepted into the pending buffer, bytes_total
        # the request-payload bytes they carried, dropped_total the
        # records writer backpressure refused — drops are visible,
        # never silent (the tracer contract)
        self.requests_total = 0
        self.dropped_total = 0
        self.bytes_total = 0
        self._order = 0
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._wake = threading.Event()
        self._stop = False
        self._writer = threading.Thread(
            target=self._loop, name="capture-writer", daemon=True
        )
        self._writer.start()

    # -- producer side (the request path) ----------------------------------

    def record(
        self,
        ctx,
        path: str,
        endpoint: str,
        body: bytes,
        status: int,
        binary: bool = False,
        session: Optional[str] = None,
        replica: Optional[str] = None,
        step: Optional[int] = None,
        action=None,
        response: Optional[bytes] = None,
        response_ctype: Optional[str] = None,
    ) -> bool:
        """Capture one finished request iff its trace is emitting —
        the deterministic head-sampling verdict (plus anomaly forcing)
        is shared with the tracer, so capture and spans name exactly
        the same set of traces. One deque append on the request path;
        everything heavy runs on the writer. Returns whether the
        record was accepted (False = not sampled, or counted drop)."""
        if ctx is None or not ctx.emitting:
            return False
        item = {
            "trace": ctx.trace_id,
            "path": path,
            "endpoint": endpoint,
            "body": body,
            "binary": bool(binary),
            "status": int(status),
            "session": session,
            "replica": replica,
            "step": step,
            "action": action,
            "response": response,
            "response_ctype": response_ctype,
            "forced": bool(ctx.forced),
            "t": time.time(),
        }
        with self._lock:
            if self._stop:
                return False
            if not ctx.forced and len(self._pending) + 1 > self.max_pending:
                # backpressure drops whole records, counted — forced
                # (anomaly) requests overshoot instead: an incident's
                # inputs are exactly what replay exists for
                self.dropped_total += 1
                return False
            item["order"] = self._order
            self._order += 1
            self._pending.append(item)
            self.requests_total += 1
            self.bytes_total += len(body) if body is not None else 0
        self._wake.set()
        return True

    # -- writer side --------------------------------------------------------

    def _encode(self, item: dict) -> dict:
        """One pending item → one ``capture`` record (writer thread:
        body parse, wire re-encode, base64, response-action
        extraction). A body the writer cannot parse still yields a
        record — without ``payload``, so the miss is loud downstream
        (the bundle builder reports the trace non-replayable)."""
        rec = {
            "trace": item["trace"],
            "order": item["order"],
            "path": item["path"],
            "endpoint": item["endpoint"],
            "status": item["status"],
            "t": item["t"],
        }
        for key in ("session", "replica"):
            if item.get(key) is not None:
                rec[key] = item[key]
        if item.get("forced"):
            rec["forced"] = True
        obs, seq = self._parse_body(item["body"], item["binary"])
        if seq is not None:
            rec["seq"] = seq
        if obs is not None:
            try:
                rec["payload"] = encode_obs_payload(obs, seq=seq)
            except Exception:
                pass
        # the answered action and the checkpoint step it ran on: given
        # directly by a replica-side caller, or parsed out of the raw
        # response the router-side caller handed over
        action, step = item.get("action"), item.get("step")
        if item.get("response") is not None and (
            action is None or step is None
        ):
            r_action, r_step = self._parse_response(
                item["response"], item.get("response_ctype")
            )
            action = r_action if action is None else action
            step = r_step if step is None else step
        if isinstance(step, int) and not isinstance(step, bool):
            rec["step"] = step
        if action is not None:
            try:
                rec["action"] = np.asarray(action, np.float64).tolist()
            except (TypeError, ValueError):
                pass
        return rec

    @staticmethod
    def _parse_body(body, binary: bool):
        """``(obs, seq)`` out of one stamped act body (None, None when
        unparseable — the record is emitted payload-less)."""
        if body is None:
            return None, None
        from trpo_torch.serve import wire as _wire

        if binary:
            try:
                scalars, arrays = _wire.decode_frame(body)
            except _wire.WireError:
                return None, None
            obs = arrays.get("obs")
            seq = scalars.get("seq")
            return (
                np.array(obs) if obs is not None else None,
                int(seq) if isinstance(seq, int) else None,
            )
        try:
            payload = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return None, None
        if not isinstance(payload, dict):
            return None, None
        obs = payload.get("obs")
        if obs is None:
            return None, None
        try:
            obs = np.asarray(obs, np.float32)
        except (TypeError, ValueError):
            return None, None
        seq = payload.get("seq")
        return obs, int(seq) if isinstance(seq, int) else None

    @staticmethod
    def _parse_response(response: bytes, ctype: Optional[str]):
        """``(action, step)`` out of one response body (JSON or wire
        frame) — the recorded side of the replay diff plus the
        checkpoint step the act actually ran on."""
        from trpo_torch.serve import wire as _wire

        base = (ctype or "").split(";", 1)[0].strip().lower()
        if base == _wire.WIRE_CONTENT_TYPE:
            try:
                scalars, arrays = _wire.decode_frame(response)
            except _wire.WireError:
                return None, None
            act = arrays.get("action")
            return (
                np.array(act) if act is not None else None,
                scalars.get("step"),
            )
        try:
            out = json.loads(response)
        except (ValueError, UnicodeDecodeError):
            return None, None
        if not isinstance(out, dict):
            return None, None
        return out.get("action"), out.get("step")

    def _loop(self) -> None:
        while True:
            with self._lock:
                pending, self._pending = self._pending, deque()
                stop = self._stop
            if pending:
                stamp = {}
                if self.process is not None:
                    stamp["process"] = self.process
                if self.host is not None:
                    stamp["host"] = self.host
                try:
                    records = [
                        {**self._encode(item), **stamp}
                        for item in pending
                    ]
                    # one bus-lock hold + one sink write per drain —
                    # the batched-emit lesson the tracer's writer
                    # already paid for on the serving bench
                    self.bus.emit_batch("capture", records)
                except Exception:
                    # a closed bus (teardown race) or a sink error
                    # must never kill the writer — but the loss is
                    # COUNTED: dropped_total=0 means genuinely
                    # lossless
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
