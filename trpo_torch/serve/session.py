"""Session protocol for serving recurrent policies: the carry is state
(counterpart: ``trpo_tpu/serve/session.py``).

The stateless ``/act`` plane (``serve/engine.py``) refuses recurrent
policies: a GRU/LSTM policy's action depends on a hidden carry integrated
over the client's whole episode, and HTTP requests don't carry it. This
module makes that a protocol of its own:

* :class:`RecurrentServeEngine` — the eval-mode ``policy.step`` (mode,
  no generator) over ``(carry, obs)`` → ``(action, new_carry)``, one
  program per rung of a batch ladder (one CUDA graph per rung on a card,
  eager on the CPU): :meth:`step_batch` advances N independent sessions
  in ONE ``(N, carry)``/``(N, obs)`` dispatch, padded up to the nearest
  rung with zero rows whose outputs are sliced off. The snapshot contract
  is the feedforward engine's (``serve/engine.py``): the snapshot is
  ``(params, obs_norm, step, graphs)``, captured anew at each load off
  the request path and swapped as one reference. The action head is
  recomputed per row, as the exact batch-1 head ``act`` runs, as the
  reference does, so the head is never the op that makes a row's action
  depend on its epoch's width; whether the cell's wider products are
  width-independent is a property of the device's matmul kernels,
  measured in ``tests/test_torch_session_serve.py`` and ``chip_smoke.py``
  ``[serve]``.
* :class:`SessionStore` — a bounded, thread-safe map ``session id →
  carry`` with TTL eviction (a sweep thread and lazy access checks both
  enforce it) and LRU capacity eviction.
* :class:`CarryJournal` — a write-behind, per-replica journal of session
  carries: the act path puts the carry into a latest-wins pending map (one
  dict assignment, never a disk write) and a writer thread appends JSON
  lines, compacting the file to the latest entry per session once it
  outgrows the live set. Readers (:func:`read_carry_journal`) skip a torn
  or corrupt line: an entry torn by ``kill -9`` mid-write reads as
  absent. A carry is the flat ``(state_size,)`` f32 of both packages
  (``[h]`` for the GRU, ``[h | c]`` for the LSTM), so a journal written
  by one package reads in the other.
* Write fencing: the router appends a session id to the journal's fence
  sidecar (:func:`fence_session`) when it takes the session over, and the
  writer re-reads the fence before every flush and refuses writes for a
  fenced session until an explicit :meth:`SessionStore.create` on this
  replica reclaims it. Journal files are keyed by (host, replica)
  (:func:`journal_path`).

With a ``bus`` (``obs.events.EventBus``) the store emits ``session``
events (``created``, ``expired``, ``evicted``) and the journal one
``lease`` ``fenced_write_refused`` event per fenced session, as the
reference's do; a closed bus never breaks the data plane.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from trpo_torch.serve.engine import LadderEngine, torch_dtype
from trpo_torch.utils.metrics import repair_jsonl_tail
from trpo_torch.utils.normalize import normalize

__all__ = [
    "RecurrentServeEngine",
    "SimulatedCostSessionEngine",
    "SessionStore",
    "CarryJournal",
    "read_carry_journal",
    "journal_path",
    "fence_path",
    "fence_session",
    "read_fences",
    "mint_session_id",
]


def mint_session_id() -> str:
    """An opaque session id (hex uuid4)."""
    return uuid.uuid4().hex


def _emit_quietly(bus, kind: str, **fields) -> None:
    """Emit on ``bus`` (if any); a closed bus never breaks the data
    plane."""
    if bus is None:
        return
    try:
        bus.emit(kind, **fields)
    except Exception:
        pass


class RecurrentServeEngine(LadderEngine):
    """Eval-mode ``step`` over a swappable params snapshot, one program per
    rung of a session ladder.

    ``with_obs_norm`` folds ``normalize(stats, obs)`` in front of the
    torso as the training act path does; clients send RAW observations.
    ``is_recurrent`` is the protocol discriminator the HTTP front end
    reads: engines with it serve ``/session``, engines without serve
    ``/act``.

    Carries may come as numpy arrays (fresh sessions, journal resumes,
    direct callers) or as tensors on the engine's device (the session
    batcher's device-resident carries): then padding happens on the
    device and the new carries come back there, and no carry byte crosses
    to the host on the act path.
    """

    is_recurrent = True

    def __init__(
        self,
        policy,
        obs_shape: Tuple[int, ...],
        with_obs_norm: bool = False,
        obs_dtype=np.float32,
        batch_shapes: Tuple[int, ...] = (1,),
        device="cuda",
    ):
        if not hasattr(policy, "step") or not hasattr(
                policy, "initial_state"):
            raise ValueError(
                "RecurrentServeEngine needs a recurrent policy "
                "(step/initial_state) — serve a feedforward policy "
                "through the stateless InferenceEngine instead"
            )
        super().__init__(batch_shapes, with_obs_norm, obs_dtype, device)
        self.policy = policy
        self.obs_shape = tuple(obs_shape)
        self.state_size = int(policy.state_size)
        self.steps_total = 0

    def _input_specs(self, rung: int) -> list:
        return [((rung, self.state_size), torch.float32),
                ((rung,) + self.obs_shape, torch_dtype(self.obs_dtype))]

    def _program(self, params, obs_norm):
        policy, with_norm = self.policy, self.with_obs_norm
        head = policy.head

        def step(carry, obs):
            if with_norm:
                obs = normalize(obs_norm, obs)
            carry_new, _ = policy.step(params, carry, obs)
            # the head recomputed per row as the (1, H) product the
            # batch-1 act path runs, so no row's action depends on the
            # width of the head's product; the batched head above is
            # discarded
            rows = [policy.dist.mode(head(params, carry_new[i:i + 1]))
                    for i in range(carry_new.shape[0])]
            action = torch.cat(rows)
            if action.dtype == torch.int64:
                action = action.to(torch.int32)
            return action, carry_new

        return step

    def initial_carry(self) -> np.ndarray:
        """A fresh session's carry: zeros, ``(state_size,)`` float32."""
        return np.zeros((self.state_size,), np.float32)

    def _as_carries(self, carries):
        """``(carries, on_device)``: device tensors stay on the device (f32),
        anything else becomes a host f32 array."""
        if isinstance(carries, torch.Tensor) and \
                carries.device == self.device and self.device.type == "cuda":
            return carries.float(), True
        if isinstance(carries, torch.Tensor):
            carries = carries.detach().cpu().numpy()
        return np.asarray(carries, np.float32), False

    def step(self, carry, obs, return_step: bool = False):
        """Advance ONE session: ``(carry (S,), obs (*obs_shape))`` →
        ``(action, new_carry)``, or ``(action, new_carry, step)`` with the
        checkpoint step of the snapshot THIS call used. A batch-1 view of
        :meth:`step_batch`: both run the same programs."""
        carry, _ = self._as_carries(carry)
        if tuple(carry.shape) != (self.state_size,):
            raise ValueError(
                f"carry must have shape ({self.state_size},), "
                f"got {tuple(carry.shape)}"
            )
        obs = np.asarray(obs, self.obs_dtype)
        if obs.shape != self.obs_shape:
            raise ValueError(
                f"obs must have shape {self.obs_shape}, got {obs.shape}"
            )
        action, carry_new, ck_step = self.step_batch(
            carry[None], obs[None], return_step=True)
        out = (action[0], carry_new[0])
        return out + (ck_step,) if return_step else out

    def step_batch(self, carries, obs, return_step: bool = False):
        """Advance N independent sessions in ONE dispatch: ``(carries (n,
        S), obs (n, *obs_shape))`` → ``(actions, new_carries)``, or
        ``(..., step)`` with the snapshot's checkpoint step. Pads up to the
        nearest rung with zero rows and slices them off (row i of every
        output is a function of row i of the inputs alone: a GRU/LSTM step
        couples no rows); over-sized epochs chunk at the top rung. Actions
        come back as numpy; new carries follow the input's residency."""
        snap = self._current()
        carries, on_device = self._as_carries(carries)
        obs = np.asarray(obs, self.obs_dtype)
        if carries.ndim != 2 or carries.shape[1] != self.state_size:
            raise ValueError(
                f"carries must be (n, {self.state_size}), "
                f"got shape {tuple(carries.shape)}"
            )
        if obs.ndim != 1 + len(self.obs_shape) or (
                obs.shape[1:] != self.obs_shape):
            raise ValueError(
                f"obs must be (n, {', '.join(map(str, self.obs_shape))}), "
                f"got shape {obs.shape}"
            )
        if carries.shape[0] != obs.shape[0]:
            raise ValueError(
                f"carries and obs disagree on the session count: "
                f"{carries.shape[0]} vs {obs.shape[0]}"
            )
        n = obs.shape[0]
        if n < 1:
            raise ValueError("step_batch needs at least one session row")
        act_outs, carry_outs = [], []
        for i in range(0, n, self.max_batch):
            c_chunk = carries[i:i + self.max_batch]
            o_chunk = obs[i:i + self.max_batch]
            action, carry_new = self._run(
                snap, [c_chunk, o_chunk], o_chunk.shape[0],
                [False, on_device])
            act_outs.append(action)
            carry_outs.append(carry_new)
        with self._lock:
            self.steps_total += n
        actions = (act_outs[0] if len(act_outs) == 1
                   else np.concatenate(act_outs))
        if len(carry_outs) == 1:
            new_carries = carry_outs[0]
        elif on_device:
            new_carries = torch.cat(carry_outs)
        else:
            new_carries = np.concatenate(carry_outs)
        if not on_device:
            new_carries = np.asarray(new_carries, np.float32)
        out = (actions, new_carries)
        return out + (snap.step,) if return_step else out


class SimulatedCostSessionEngine:
    """A session-engine wrapper charging a fixed per-DISPATCH cost behind
    a serial lock: the device runs one step program at a time whether it
    advances 1 session or 64, so N serialized batch-1 steps cost N ×
    ``cost_ms`` and one ``(N, carry)`` epoch about 1 ×. For measuring the
    epoch control plane against that capacity model; production paths
    never use it."""

    def __init__(self, engine, cost_ms: float):
        if cost_ms < 0:
            raise ValueError(f"cost_ms must be >= 0, got {cost_ms}")
        self._engine = engine
        self.cost_ms = float(cost_ms)
        self._dispatch_lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _charge(self):
        if self.cost_ms > 0:
            time.sleep(self.cost_ms / 1e3)

    def step(self, carry, obs, return_step: bool = False):
        with self._dispatch_lock:
            self._charge()
            return self._engine.step(carry, obs, return_step=return_step)

    def step_batch(self, carries, obs, return_step: bool = False):
        with self._dispatch_lock:
            self._charge()
            return self._engine.step_batch(carries, obs,
                                           return_step=return_step)


class _Session:
    __slots__ = (
        "carry", "created", "last_used", "steps", "lock",
        "last_seq", "last_action", "last_step",
    )

    def __init__(self, carry, now: float):
        self.carry = carry
        self.created = now
        self.last_used = now
        self.steps = 0
        self.lock = threading.Lock()  # serializes steps WITHIN a session
        # retry idempotency: a replayed seq returns the STORED action
        # instead of stepping the carry again
        self.last_seq: Optional[int] = None
        self.last_action: Optional[np.ndarray] = None
        self.last_step: Optional[int] = None


# a tombstone in the journal's pending map / file: the session was
# evicted or expired — a post-crash reader must not resurrect it
_DROPPED = object()


def journal_path(journal_dir: str, replica_id: str,
                 host: Optional[str] = None) -> str:
    """The journal file of a replica: ``<dir>/<replica>.carry.jsonl``, or
    ``<dir>/<host>--<replica>.carry.jsonl`` with ``host`` (None, "" and
    "local" keep the flat name), so two hosts minting the same replica id
    never share a file."""
    if host and host != "local":
        replica_id = f"{host}--{replica_id}"
    return os.path.join(journal_dir, f"{replica_id}.carry.jsonl")


def fence_path(path: str) -> str:
    """The journal's fence sidecar: one JSON line per fenced session."""
    return path + ".fence"


def fence_session(path: str, session_id: str) -> None:
    """Fence one session in the journal at ``path``: a holder of that
    journal that has not since re-created the session must refuse to
    journal it (only the router appends here, so a plain append is
    safe)."""
    with open(fence_path(path), "a") as f:
        f.write(json.dumps({"session": session_id, "t": time.time()})
                + "\n")
        f.flush()


def _load_fence_lines(path: str):
    """``({session_id: last 1-based fence-line index}, total_lines)``; a
    torn or corrupt line still counts a line (indices stay stable) but
    fences nothing."""
    fenced: Dict[str, int] = {}
    total = 0
    try:
        f = open(fence_path(path), "rb")
    except OSError:
        return fenced, 0
    with f:
        for line in f:
            total += 1
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            sid = rec.get("session") if isinstance(rec, dict) else None
            if isinstance(sid, str) and sid:
                fenced[sid] = total
    return fenced, total


def read_fences(path: str) -> set:
    """The fenced session ids of the journal at ``path``."""
    return set(_load_fence_lines(path)[0])


def read_carry_journal(path: str) -> Dict[str, dict]:
    """``{session_id: entry}`` of a carry journal: the latest entry per
    session wins, tombstones (``{"drop": true}``) remove, and any
    unparseable line is SKIPPED (a torn entry reads as absent). A missing
    file is an empty journal."""
    entries: Dict[str, dict] = {}
    try:
        f = open(path, "rb")
    except OSError:
        return entries
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            sid = rec.get("session")
            if not isinstance(sid, str) or not sid:
                continue
            if rec.get("drop"):
                entries.pop(sid, None)
                continue
            if not isinstance(rec.get("carry"), list) or not isinstance(
                    rec.get("steps"), int):
                continue
            entries[sid] = rec
    return entries


class CarryJournal:
    """Write-behind, bounded, self-compacting session-carry journal.

    :meth:`record` is one latest-wins dict assignment under a small lock.
    A daemon writer swaps the pending map out and appends one JSON line
    per dirty session, flushing each batch. Once the file's line count
    outgrows ``compact_factor`` × the live sessions (at least
    ``min_compact``), it is rewritten to one entry per session
    (write-then-rename). A previous incarnation's torn final line is
    truncated on open.
    """

    def __init__(
        self,
        path: str,
        compact_factor: int = 4,
        min_compact: int = 256,
        poll_interval: float = 0.5,
        bus=None,
        replica: Optional[str] = None,
    ):
        self.bus = bus
        self.path = path
        self.replica = replica
        self._fence_emitted: set = set()
        # sid -> last fence-line index; sid -> the fence-line watermark at
        # reclaim time (a reclaim lifts the fences that existed then; a
        # later fence re-fences)
        self._fenced: Dict[str, int] = {}
        self._reclaimed: Dict[str, int] = {}
        self._fence_lines = 0
        self._fence_size = -1
        self.fenced_writes_total = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        repair_jsonl_tail(path)
        # a restarted replica inherits its previous incarnation's entries
        self._latest: Dict[str, dict] = read_carry_journal(path)
        # the ACTUAL line count, so the compaction bound holds across
        # restart loops
        try:
            with open(path, "rb") as f:
                self._lines = sum(1 for _ in f)
        except OSError:
            self._lines = 0
        self.compact_factor = int(compact_factor)
        self.min_compact = int(min_compact)
        self._poll = float(poll_interval)
        self._pending: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self.records_total = 0
        self.writes_total = 0
        self.compactions_total = 0
        self._f = open(path, "a")
        self._refresh_fences()
        self._writer = threading.Thread(
            target=self._loop, name="carry-journal-writer", daemon=True)
        self._writer.start()

    # -- producer side (the act path) --------------------------------------

    def record(self, entry: dict) -> None:
        """Queue one session snapshot (``entry`` carries ``session``; the
        caller passes a fully copied entry). Latest wins per session;
        never blocks on IO."""
        sid = entry["session"]
        with self._lock:
            if self._stop:
                return
            self._pending[sid] = entry
            self.records_total += 1
            self._idle.clear()
        self._wake.set()

    def forget(self, session_id: str) -> None:
        """Tombstone an evicted/expired session."""
        with self._lock:
            if self._stop:
                return
            self._pending[session_id] = _DROPPED
            self._idle.clear()
        self._wake.set()

    def lookup(self, session_id: str) -> Optional[dict]:
        """The newest entry of one session (pending beats flushed; a
        pending tombstone reads as absent)."""
        with self._lock:
            hit = self._pending.get(session_id)
            if hit is _DROPPED:
                return None
            if hit is not None:
                return dict(hit)
            hit = self._latest.get(session_id)
            return dict(hit) if hit is not None else None

    # -- write fencing -----------------------------------------------------

    def reclaim(self, session_id: str) -> None:
        """An explicit (re-)create of this session on THIS replica lifts
        the fences on disk right now (refreshed first); a fence appended
        later fences again."""
        self._refresh_fences()
        with self._lock:
            self._reclaimed[session_id] = self._fence_lines

    def fenced(self, session_id: str) -> bool:
        with self._lock:
            idx = self._fenced.get(session_id)
            if idx is None:
                return False
            return idx > self._reclaimed.get(session_id, 0)

    def _refresh_fences(self) -> None:
        """Size-gated re-read of the fence sidecar (on open and before
        every write batch: the fence holds across processes)."""
        try:
            size = os.stat(fence_path(self.path)).st_size
        except OSError:
            size = 0
        if size == self._fence_size:
            return
        fenced, total = _load_fence_lines(self.path)
        with self._lock:
            self._fenced = fenced
            self._fence_lines = total
            self._fence_size = size

    # -- writer side ---------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._lock:
                pending, self._pending = self._pending, {}
                stop = self._stop
                if not pending:
                    # idle is set UNDER the lock record() clears it under,
                    # so drain() never sees idle with an entry unflushed
                    self._idle.set()
            if pending:
                try:
                    self._write_batch(pending)
                except Exception:  # a full disk or a bad entry degrades
                    # the journal, never the act path; the writer goes on
                    traceback.print_exc()
                continue
            if stop:
                return
            self._wake.wait(timeout=self._poll)
            self._wake.clear()

    @staticmethod
    def _jsonable(entry: dict) -> dict:
        """Array fields ride the entry by reference (the act path never
        converts); they become JSON here, on the writer thread. A device
        carry pays its host transfer here too, at journal cadence."""
        def conv(v):
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().numpy().tolist()
            if isinstance(v, np.ndarray):
                return v.tolist()
            return v
        return {k: conv(v) for k, v in entry.items()}

    def _write_batch(self, pending: Dict[str, object]) -> None:
        # honor the fence BEFORE touching the file
        self._refresh_fences()
        for sid in [s for s in pending if self.fenced(s)]:
            pending.pop(sid)
            self.fenced_writes_total += 1
            if sid not in self._fence_emitted:
                self._fence_emitted.add(sid)
                _emit_quietly(self.bus, "lease",
                              event="fenced_write_refused", session=sid,
                              replica=self.replica or "unknown")
        if not pending:
            return
        for sid, entry in pending.items():
            if entry is _DROPPED:
                self._f.write(json.dumps({"session": sid, "drop": True})
                              + "\n")
                self._latest.pop(sid, None)
            else:
                entry = self._jsonable(entry)
                self._f.write(json.dumps(entry) + "\n")
                self._latest[sid] = entry
            self._lines += 1
            self.writes_total += 1
        self._f.flush()
        if self._lines > max(self.min_compact,
                             self.compact_factor * len(self._latest)):
            self._compact()

    def _compact(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for entry in self._latest.values():
                f.write(json.dumps(entry) + "\n")
        os.replace(tmp, self.path)  # atomic: a reader sees old or new
        self._f.close()
        self._f = open(self.path, "a")
        self._lines = len(self._latest)
        self.compactions_total += 1

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every pending record is on disk (tests and graceful
        shutdown; never the act path)."""
        self._wake.set()
        return self._idle.wait(timeout)

    def _shutdown(self, keep_pending: bool) -> None:
        with self._lock:
            self._stop = True
            if not keep_pending:
                self._pending.clear()
        self._wake.set()
        self._writer.join(timeout=5.0)
        self._f.close()

    def close(self) -> None:
        """Flush what is pending, then stop the writer."""
        self._shutdown(keep_pending=True)

    def abandon(self) -> None:
        """Crash-style teardown: DROP the pending entries, as ``kill -9``
        would."""
        self._shutdown(keep_pending=False)


class SessionStore:
    """Bounded ``session id → carry`` map with TTL + LRU eviction.

    ``ttl_s`` bounds idle lifetime (lazily on access and by a background
    sweep); ``max_sessions`` bounds the map (at capacity the longest-idle
    session is evicted). A vanished session's next act gets a typed
    ``session_unknown`` from the front end. Steps of one session are
    serialized by its lock; different sessions never contend.
    """

    def __init__(
        self,
        ttl_s: float = 300.0,
        max_sessions: int = 1024,
        bus=None,
        replica: Optional[str] = None,
        sweep_interval: Optional[float] = None,
        journal: Optional[CarryJournal] = None,
        sync_every: int = 1,
    ):
        self.bus = bus
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        if max_sessions < 1:
            raise ValueError(
                f"max_sessions must be >= 1, got {max_sessions}")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.ttl_s = float(ttl_s)
        self.max_sessions = int(max_sessions)
        self.replica = replica
        self.journal = journal  # owned: closed with the store
        self.sync_every = int(sync_every)
        self.created_total = 0
        self.expired_total = 0
        self.evicted_total = 0
        self.resumed_total = 0   # sessions created FROM a journaled carry
        self.deduped_total = 0   # acts answered from the seq-dedupe cache
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, _Session]" = OrderedDict()
        self._stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep_loop, name="session-ttl-sweeper",
            daemon=True,
            args=(sweep_interval if sweep_interval is not None
                  else max(self.ttl_s / 4.0, 0.05),),
        )
        self._sweeper.start()

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def create(self, initial_carry, session_id: Optional[str] = None,
               steps: int = 0, seq: Optional[int] = None,
               last_action=None, last_step: Optional[int] = None) -> str:
        """Register a session (minting an id unless the caller supplies
        one). Re-creating an EXISTING id resets its carry (the router's
        re-establish; a direct client's explicit restart).
        ``steps``/``seq``/``last_action``/``last_step`` restore a
        journaled session with its step count and seq-dedupe state."""
        sid = session_id or mint_session_id()
        now = time.monotonic()
        evicted = None
        with self._lock:
            if sid not in self._sessions and (
                    len(self._sessions) >= self.max_sessions):
                evicted, _ = self._sessions.popitem(last=False)  # LRU
                self.evicted_total += 1
            carry = (initial_carry if isinstance(initial_carry, torch.Tensor)
                     else np.asarray(initial_carry, np.float32))
            sess = _Session(carry, now)
            sess.steps = int(steps)
            if seq is not None:
                sess.last_seq = int(seq)
            if last_action is not None:
                sess.last_action = np.asarray(last_action)
            if last_step is not None:
                sess.last_step = int(last_step)
            self._sessions[sid] = sess
            self._sessions.move_to_end(sid)
            self.created_total += 1
            if steps:
                self.resumed_total += 1
        if evicted is not None:
            self._forget_journal(evicted)
            self._emit("evicted", evicted)
        self._emit("created", sid)
        if self.journal is not None:
            # an explicit create makes THIS replica the session's journal
            # owner again: lift any fence a previous takeover left
            self.journal.reclaim(sid)
        if steps and self.journal is not None:
            # journal the restored state now: a second failover before the
            # next act must still find it
            with sess.lock:
                self.journal_session(sid, sess)
        elif (self.journal is not None
              and self.journal.lookup(sid) is not None):
            # a fresh (re-)create of a journaled id is a restart: tombstone
            # the stale entry
            self.journal.forget(sid)
        return sid

    def journal_session(self, sid: str, sess: _Session) -> None:
        """Snapshot one session into the journal (under its lock). Arrays
        go in by reference: the act path replaces ``sess.carry`` and
        ``last_action`` wholesale, never in place."""
        if self.journal is None:
            return
        entry = {"session": sid, "steps": int(sess.steps),
                 "carry": sess.carry, "t": time.time()}
        if sess.last_seq is not None:
            entry["seq"] = int(sess.last_seq)
        if sess.last_action is not None:
            entry["last_action"] = sess.last_action
        if sess.last_step is not None:
            entry["last_step"] = int(sess.last_step)
        self.journal.record(entry)

    def journal_step(self, sid: str, sess: _Session, trace=None) -> None:
        """After an act: snapshot every ``sync_every`` applied steps.
        ``trace`` (the act's ``(TraceContext, parent span id)``) books a
        ``journal.sync`` span, only when the cadence snapshots; it times
        the enqueue (the write happens on the journal's writer)."""
        if self.journal is None or sess.steps % self.sync_every != 0:
            return
        t_wall, t0 = time.time(), time.perf_counter()
        self.journal_session(sid, sess)
        if trace is not None:
            ctx, parent_id = trace
            ctx.record("journal.sync", start=t_wall,
                       dur_ms=(time.perf_counter() - t0) * 1e3,
                       parent_id=parent_id, steps=int(sess.steps))

    def _forget_journal(self, sid: str) -> None:
        if self.journal is not None:
            self.journal.forget(sid)

    def sync_one(self, session_id: str, timeout: float = 10.0) -> bool:
        """Journal ONE session now and block until flushed. False: unknown
        session, journal off, or the flush did not land."""
        if self.journal is None:
            return False
        with self._lock:
            sess = self._sessions.get(session_id)
        if sess is None:
            return False
        with sess.lock:
            self.journal_session(session_id, sess)
        return self.journal.drain(timeout)

    def sync_all(self, timeout: float = 10.0) -> bool:
        """Journal EVERY live session now (each under its lock) and block
        until flushed, so a reader of the file sees current carries."""
        if self.journal is None:
            return False
        with self._lock:
            live = list(self._sessions.items())
        for sid, sess in live:
            with sess.lock:
                self.journal_session(sid, sess)
        return self.journal.drain(timeout)

    def remove(self, session_id: str) -> bool:
        """Drop a session the caller resumed elsewhere, tombstoning its
        journal entry."""
        with self._lock:
            sess = self._sessions.pop(session_id, None)
        if sess is None:
            return False
        self._forget_journal(session_id)
        return True

    def get(self, session_id: str) -> Optional[_Session]:
        """The live session, refreshed to most-recently-used, or None
        (unknown, or found expired just now and dropped)."""
        now = time.monotonic()
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None:
                return None
            expired = now - sess.last_used > self.ttl_s
            if expired:
                del self._sessions[session_id]
                self.expired_total += 1
            else:
                sess.last_used = now
                self._sessions.move_to_end(session_id)
        if expired:
            self._forget_journal(session_id)
            self._emit("expired", session_id)
            return None
        return sess

    def touch_steps(self, sess: _Session) -> None:
        sess.steps += 1
        sess.last_used = time.monotonic()

    def _sweep_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            now = time.monotonic()
            expired = []
            with self._lock:
                for sid, sess in list(self._sessions.items()):
                    if now - sess.last_used > self.ttl_s:
                        del self._sessions[sid]
                        self.expired_total += 1
                        expired.append(sid)
            for sid in expired:
                self._forget_journal(sid)
                self._emit("expired", sid)

    def _emit(self, event: str, session_id: str) -> None:
        fields = {"session": session_id, "event": event}
        if self.replica:
            fields["replica"] = self.replica
        _emit_quietly(self.bus, "session", **fields)

    def close(self, flush: bool = True) -> None:
        """``flush=False`` drops pending journal entries, as a crash
        would."""
        self._stop.set()
        self._sweeper.join(timeout=5.0)
        if self.journal is not None:
            if flush:
                self.journal.close()
            else:
                self.journal.abandon()
