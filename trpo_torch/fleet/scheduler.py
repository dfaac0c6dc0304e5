"""The elastic fleet orchestrator: N runs, bounded slots, auto-requeue
(counterpart: ``trpo_tpu/fleet/scheduler.py``).

A single run is *survivable* (preemption-safe shutdown, exit 75 =
requeue, marker-gated checkpoints) and *observable* (/status, /metrics,
``analyze_run --compare``). This module composes them into a host-side
control plane that launches each :class:`~trpo_torch.fleet.spec.
MemberSpec` as a ``python -m trpo_torch.train`` subprocess with its own
checkpoint dir, event log, ephemeral status port, and ``run.json``
descriptor, and drives the lifecycle state machine in
:mod:`trpo_torch.fleet.events`:

* **exit 0** → ``finished``;
* **exit == requeue_exit_code (75)** → ``preempted``: the member is
  requeued with exponential backoff and relaunched ``--resume`` from
  the marker-gated ``Checkpointer.latest_step()`` (``step_<n>/`` with
  its ``step_<n>.complete`` marker), with ``--iterations`` rewritten to
  the *remaining* budget — a preempted member loses ZERO completed
  iterations (its event log's iteration sequence stays gapless across
  the requeue);
* **any other nonzero exit** → a crash, charged against the member's
  ``max_restarts`` budget; past it the member is ``failed`` — the
  member, never the fleet;
* at the end, the selection hook scores every finished member (the
  same episode-weighted mean return as ``population.member_scores``,
  optionally pooled with served realized-return ``feedback`` from the
  promotion controller) and marks the bottom-k ``culled``, and the
  fleet gate runs ``obs/analyze.compare_runs`` per clean finished
  member against the reference member under the 0/1/2 exit contract;
* with ``spec.pbt_rounds`` > 0, each round's culled members respawn
  from the winner's checkpoint (*exploit* — ``shutil.copytree`` of the
  marker-gated dir, resume from its newest complete step) with
  perturbed hyperparameters (*explore* — redrawn ``seed``, ``lam`` and
  ``cg_damping`` scaled ``×(1±pbt_perturb)``; Jaderberg et al. 2017),
  booked as ``fleet`` ``respawned`` events, and the fleet drives
  another round; respawn segments are gate-``skipped`` (their
  wall-clock metrics measure the explore budget, not a full run).

While members run, the scheduler scrapes each live member's ``/status``
(discovered via its descriptor, never via console parsing) into one
fleet snapshot, served from a fleet-level ``/status`` + ``/metrics``
endpoint (:class:`~trpo_torch.fleet.scrape.FleetStatusServer`). Every
lifecycle transition is emitted as a typed ``fleet`` event on the run
bus; ``python -m trpo_torch.scripts.validate_events`` fails a log where
a ``preempted`` member was never resolved to ``requeued``/``failed``.

The orchestrator adds NO behavior inside members beyond the descriptor
file: members are stock ``python -m trpo_torch.train`` invocations. A
member runs on the card unless the base args say ``--device cpu``; the
orchestrator itself touches no device.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from trpo_torch.fleet.events import TERMINAL_STATES, emit_fleet
from trpo_torch.fleet.scrape import (
    FleetStatusServer,
    descriptor_path,
    read_descriptor,
    scrape_member,
)
from trpo_torch.fleet.spec import (
    FleetSpec,
    MemberSpec,
    member_cli_args,
    member_total_iterations,
)

__all__ = ["FleetScheduler", "MemberRecord", "default_member_argv",
           "score_event_records"]

_SNAPSHOT_SCHEMA = "trpo-tpu-fleet"  # the reference's, so its readers parse it


def default_member_argv(
    spec: FleetSpec, member: MemberSpec, ctx: Dict[str, Any]
) -> List[str]:
    """The stock launch command: ``python -m trpo_torch.train`` + base
    args + member overrides + the per-member io wiring (checkpoint dir,
    event log, ephemeral status port, descriptor). A requeue appends
    ``--resume`` and rewrites ``--iterations`` to the remaining budget
    (argparse last-wins, so the append cleanly overrides the base)."""
    argv = [sys.executable, "-m", "trpo_torch.train"]
    argv += list(spec.base_args)
    argv += member_cli_args(member)
    argv += [
        "--checkpoint-dir", ctx["checkpoint_dir"],
        "--metrics-jsonl", ctx["events_path"],
        "--status-port", "0",
        "--run-descriptor", ctx["descriptor_path"],
    ]
    if ctx.get("resume_step") is not None:
        argv.append("--resume")
        if ctx.get("remaining_iterations") is not None:
            argv += ["--iterations", str(ctx["remaining_iterations"])]
    return argv


def _score_totals(records: List[dict]) -> "tuple":
    """``(weighted_return_sum, episode_weight_sum)`` over a member's
    iteration records — the raw totals, so callers can POOL additional
    weighted evidence (the served realized-return feedback of the
    promotion controller) before dividing."""
    import math

    total_w = 0.0
    total_r = 0.0
    for rec in records:
        if rec.get("kind") != "iteration":
            continue
        stats = rec.get("stats") or {}
        r = stats.get("mean_episode_reward")
        if not isinstance(r, (int, float)) or isinstance(r, bool):
            continue
        if math.isnan(float(r)):
            continue
        w = stats.get("episodes_in_batch")
        w = float(w) if isinstance(w, (int, float)) and w > 0 else 1.0
        total_r += float(r) * w
        total_w += w
    return total_r, total_w


def score_event_records(records: List[dict]) -> float:
    """A member's final score from its event log: episode-weighted mean
    return over every iteration record — the same semantics as
    ``population.Population.member_scores`` (NaN batches contribute
    nothing; a member that never finished an episode scores ``-inf``),
    read from JSONL instead of a device stats pytree."""
    total_r, total_w = _score_totals(records)
    return total_r / total_w if total_w > 0 else float("-inf")


class MemberRecord:
    """The scheduler's mutable view of one member."""

    __slots__ = (
        "spec", "state", "attempt", "requeues", "failures", "proc",
        "not_before", "resume_step", "exit_code", "member_dir",
        "checkpoint_dir", "events_path", "console_path",
        "descriptor_file", "descriptor", "live", "score",
        "run_s", "seg_t0", "total_override", "respawned",
    )

    def __init__(self, spec: MemberSpec, member_dir: str):
        self.spec = spec
        self.state = "pending"
        self.attempt = 0          # launches so far (1-based once running)
        self.requeues = 0         # preemption requeues
        self.failures = 0         # crash exits
        self.proc: Optional[subprocess.Popen] = None
        self.not_before = 0.0     # monotonic clock gate for relaunch
        self.resume_step: Optional[int] = None
        self.exit_code: Optional[int] = None
        self.member_dir = member_dir
        self.checkpoint_dir = os.path.join(member_dir, "ck")
        self.events_path = os.path.join(member_dir, "events.jsonl")
        self.console_path = os.path.join(member_dir, "console.log")
        self.descriptor_file = descriptor_path(member_dir)
        self.descriptor: Optional[dict] = None
        self.live: Optional[dict] = None
        self.score: Optional[float] = None
        self.run_s = 0.0          # summed wall time of running segments
        self.seg_t0: Optional[float] = None
        # PBT respawn bookkeeping: an explicit total for the
        # respawned segment (resume step + explore budget — the spec's
        # stated total no longer applies), and the respawned mark that
        # keeps the compare-gate honest (a respawn SEGMENT's wall-clock
        # metrics measure the resume, not the member)
        self.total_override: Optional[int] = None
        self.respawned = False

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def row(self) -> dict:
        return {
            "state": self.state,
            "attempt": self.attempt,
            "requeues": self.requeues,
            "failures": self.failures,
            "exit_code": self.exit_code,
            "resume_step": self.resume_step,
            "pid": self.proc.pid if self.proc is not None else None,
            "live": dict(self.live) if self.live else None,
            "score": self.score,
            "respawned": self.respawned,
            "events_jsonl": self.events_path,
        }


class FleetScheduler:
    """Schedule a :class:`FleetSpec` over ``spec.max_workers`` local
    slots until every member reaches a terminal state.

    ``bus`` (optional ``obs.EventBus``) carries the typed ``fleet``
    lifecycle events. ``status_port`` (optional; 0 = ephemeral) serves
    the live fleet ``/status`` + ``/metrics``. ``launcher`` and
    ``latest_step_fn`` are test seams: the former is a
    ``(member, ctx) -> argv`` callable (the default wraps
    :func:`default_member_argv` over this spec), the latter reads a
    member's newest complete checkpoint step (default: the marker-gated
    ``Checkpointer.latest_step`` on the member's checkpoint dir, which
    never selects a ``step_<n>/`` without its marker).
    ``selection`` maps ``{member_id: score}`` to the ids to cull
    (default: bottom ``spec.cull_bottom_k`` finished members).
    """

    def __init__(
        self,
        spec: FleetSpec,
        fleet_dir: str,
        bus=None,
        status_port: Optional[int] = None,
        launcher: Optional[Callable[..., List[str]]] = None,
        latest_step_fn: Optional[Callable[[str], Optional[int]]] = None,
        selection: Optional[Callable[[Dict[str, float]], List[str]]] = None,
        subprocess_env: Optional[Dict[str, str]] = None,
        feedback: Optional[Dict[str, "tuple"]] = None,
    ):
        self.spec = spec
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.bus = bus
        self._launcher = launcher or (
            lambda member, ctx: default_member_argv(spec, member, ctx)
        )
        self._latest_step_fn = latest_step_fn or self._checkpoint_latest
        self._selection = selection
        self._env = dict(subprocess_env) if subprocess_env else None
        # served realized-return feedback: {member: (mean,
        # episodes)} from fleet.promote.feedback_scores — pooled into
        # member_final_scores episode-weighted, so served reality and
        # training batches carry exactly their episode counts' worth
        self._feedback = dict(feedback) if feedback else {}
        # members import trpo_torch via `python -m trpo_torch.train`:
        # run them from the repo root regardless of the orchestrator's cwd
        import trpo_torch

        self._cwd = os.path.dirname(
            os.path.dirname(os.path.abspath(trpo_torch.__file__))
        )
        self._started_t = time.time()
        self._started_m = time.monotonic()
        self._finished = False
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.members: Dict[str, MemberRecord] = {}
        for m in spec.members:
            mdir = os.path.join(self.fleet_dir, m.member_id)
            os.makedirs(mdir, exist_ok=True)
            self.members[m.member_id] = MemberRecord(m, mdir)
        # reference-swapped snapshot: the HTTP handlers read the
        # attribute once and serialize outside any lock (the same
        # contract as obs/server.StatusSink)
        self.snapshot: dict = self._build_snapshot()
        self.status_server: Optional[FleetStatusServer] = None
        if status_port is not None:
            self.status_server = FleetStatusServer(
                lambda: self.snapshot, status_port
            )

    # -- snapshot ----------------------------------------------------------

    def _build_snapshot(self) -> dict:
        rows = {mid: rec.row() for mid, rec in self.members.items()}
        counts: Dict[str, int] = {}
        for rec in self.members.values():
            counts[rec.state] = counts.get(rec.state, 0) + 1
        return {
            "schema": _SNAPSHOT_SCHEMA,
            "started_t": self._started_t,
            "updated_t": time.time(),
            "fleet_dir": self.fleet_dir,
            "max_workers": self.spec.max_workers,
            "members": rows,
            "state_counts": counts,
            "finished": self._finished,
        }

    def _refresh(self) -> None:
        self.snapshot = self._build_snapshot()

    # -- launch / exit handling -------------------------------------------

    @staticmethod
    def _checkpoint_latest(checkpoint_dir: str) -> Optional[int]:
        """Marker-gated newest complete step — a torn save (the
        preemption grace window running out mid-write: a ``step_<n>/``
        without its ``step_<n>.complete``) never becomes a resume
        point."""
        if not os.path.isdir(checkpoint_dir):
            return None
        try:
            from trpo_torch.utils.checkpoint import Checkpointer

            return Checkpointer(checkpoint_dir).latest_step()
        except Exception:
            return None

    def _total_from_manifest(self, rec: MemberRecord) -> Optional[int]:
        """The member's iteration budget read back from its FIRST
        ``run_manifest`` (the config the member actually ran with).
        Only the first segment's manifest is the TOTAL — a resumed
        segment's manifest carries the rewritten remainder — so the
        scan stops at the first manifest. None when the log doesn't
        exist yet or carries no usable config."""
        import json

        try:
            with open(rec.events_path) as f:
                for line in f:
                    try:
                        r = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(r, dict):
                        continue
                    if r.get("kind") != "run_manifest":
                        continue
                    cfg = r.get("config") or {}
                    for n in (r.get("n_iterations"),
                              cfg.get("n_iterations")):
                        if isinstance(n, int) and not isinstance(n, bool):
                            return n
                    return None
        except OSError:
            return None
        return None

    def _remaining_iterations(self, rec: MemberRecord) -> Optional[int]:
        # spec-stated total first; else the budget the member itself
        # recorded in its first run_manifest — without it a relaunch
        # would run the FULL default budget on top of the restored
        # counter (the documented resume semantics) and overshoot
        total = rec.total_override
        if total is None:
            total = member_total_iterations(self.spec, rec.spec)
        if total is None:
            total = self._total_from_manifest(rec)
        if total is None or rec.resume_step is None:
            return None
        return max(total - int(rec.resume_step), 0)

    def _launch(self, rec: MemberRecord) -> None:
        rec.attempt += 1
        rec.descriptor = None
        rec.live = None
        # a stale descriptor from the previous attempt must never feed
        # the scraper a dead pid/port
        try:
            os.remove(rec.descriptor_file)
        except OSError:
            pass
        ctx = {
            "attempt": rec.attempt,
            "member_dir": rec.member_dir,
            "checkpoint_dir": rec.checkpoint_dir,
            "events_path": rec.events_path,
            "descriptor_path": rec.descriptor_file,
            "resume_step": rec.resume_step,
            "remaining_iterations": self._remaining_iterations(rec),
        }
        argv = self._launcher(rec.spec, ctx)
        with open(rec.console_path, "ab") as console:
            rec.proc = subprocess.Popen(
                argv,
                stdout=console,
                stderr=subprocess.STDOUT,
                env=self._env,
                cwd=self._cwd,
            )
        rec.state = "running"
        rec.seg_t0 = time.monotonic()
        emit_fleet(
            self.bus, rec.spec.member_id, "launched", rec.attempt,
            resume_step=rec.resume_step,
        )

    def _backoff(self, n: int) -> float:
        base = self.spec.requeue_backoff
        return min(base * (2 ** max(n - 1, 0)), self.spec.backoff_cap)

    def _queue_relaunch(self, rec: MemberRecord, reason: str,
                        exit_code: int, n: int) -> None:
        rec.state = "pending"
        rec.not_before = time.monotonic() + self._backoff(n)
        emit_fleet(
            self.bus, rec.spec.member_id, "requeued", rec.attempt,
            reason=reason, exit_code=exit_code,
            resume_step=rec.resume_step,
        )

    def _on_exit(self, rec: MemberRecord, code: int) -> None:
        # rec.live keeps the LAST scrape across the exit — the final
        # fleet view still shows what the member was doing
        rec.proc = None
        rec.exit_code = code
        if rec.seg_t0 is not None:
            rec.run_s += time.monotonic() - rec.seg_t0
            rec.seg_t0 = None
        mid = rec.spec.member_id
        if code == 0:
            rec.state = "finished"
            emit_fleet(self.bus, mid, "finished", rec.attempt)
            return
        rec.resume_step = self._latest_step_fn(rec.checkpoint_dir)
        remaining = self._remaining_iterations(rec)
        if code == self.spec.requeue_exit_code:
            emit_fleet(
                self.bus, mid, "preempted", rec.attempt, exit_code=code
            )
            if remaining == 0:
                # preempted AFTER the final save: nothing left to run —
                # the member is complete, a relaunch would only redo
                # iterations. No requeue is counted: `requeues` must
                # stay monotone (it is exported as a Prometheus
                # counter) and the gate skips requeued members, while
                # this one's single segment is clean
                rec.state = "finished"
                emit_fleet(
                    self.bus, mid, "finished", rec.attempt,
                    reason="complete_at_preemption",
                    resume_step=rec.resume_step,
                )
            elif rec.requeues >= self.spec.max_requeues:
                # budget checked BEFORE counting, so the reported
                # requeues never exceeds the requeues that happened
                rec.state = "failed"
                emit_fleet(
                    self.bus, mid, "failed", rec.attempt, exit_code=code,
                    reason="requeue budget exhausted",
                )
            else:
                rec.requeues += 1
                self._queue_relaunch(rec, "preempted", code, rec.requeues)
        else:
            # a crash IS a crash — `failures` counts crash exits, so it
            # increments unconditionally (unlike requeues, which counts
            # scheduler actions)
            rec.failures += 1
            if rec.failures > self.spec.max_restarts:
                rec.state = "failed"
                emit_fleet(
                    self.bus, mid, "failed", rec.attempt, exit_code=code,
                    reason="crash budget exhausted",
                )
            elif remaining == 0:
                # a CRASH with nothing left to run (teardown crash after
                # the final save): the checkpointed work is intact but
                # the nonzero exit must not be laundered into a clean
                # finish — and a relaunch would only redo the budget
                rec.state = "failed"
                emit_fleet(
                    self.bus, mid, "failed", rec.attempt, exit_code=code,
                    reason="crashed after completing its iteration "
                    "budget",
                    resume_step=rec.resume_step,
                )
            else:
                self._queue_relaunch(rec, "crash", code, rec.failures)

    # -- scraping ----------------------------------------------------------

    def _scrape_running(self) -> None:
        for rec in self.members.values():
            if rec.state != "running":
                continue
            if rec.descriptor is None:
                rec.descriptor = read_descriptor(rec.descriptor_file)
            if rec.descriptor is not None:
                live = scrape_member(rec.descriptor)
                if live is not None:
                    rec.live = live

    # -- the scheduling loop ----------------------------------------------

    def _runnable(self) -> List[MemberRecord]:
        now = time.monotonic()
        return [
            rec for rec in self.members.values()
            if rec.state == "pending" and rec.not_before <= now
        ]

    def _running(self) -> List[MemberRecord]:
        return [r for r in self.members.values() if r.state == "running"]

    def run(
        self,
        timeout: Optional[float] = None,
        pbt_rounds: Optional[int] = None,
    ) -> dict:
        """Drive the fleet to completion; returns the result dict
        (member rows, scores, culled ids, gate verdicts + ``exit_code``
        under the 0/1/2 contract).

        With ``pbt_rounds`` > 0 (default: ``spec.pbt_rounds``), each
        round's culled members respawn from the winner's checkpoint
        with perturbed hyperparameters (exploit/explore — Jaderberg et
        al. 2017) and the fleet drives again; the ``timeout`` budget
        spans ALL rounds."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        self._drive_loop(deadline)
        result = self._finalize()
        rounds = self.spec.pbt_rounds if pbt_rounds is None else pbt_rounds
        for _ in range(max(rounds, 0)):
            if deadline is not None and time.monotonic() > deadline:
                break
            if not self._pbt_respawn(result):
                break
            self._drive_loop(deadline)
            result = self._finalize()
        return result

    def _drive_loop(self, deadline: Optional[float]) -> None:
        """The scheduling loop proper: launch/reap/scrape until every
        member is terminal (or the deadline aborts the stragglers)."""
        next_scrape = time.monotonic()
        try:
            while True:
                changed = False
                # fill free slots (in spec order — the reference member
                # is first and starts first)
                for rec in self._runnable():
                    if len(self._running()) >= self.spec.max_workers:
                        break
                    self._launch(rec)
                    changed = True
                # reap exits
                for rec in self._running():
                    code = rec.proc.poll()
                    if code is not None:
                        self._on_exit(rec, code)
                        changed = True
                now = time.monotonic()
                if now >= next_scrape:
                    self._scrape_running()
                    next_scrape = now + self.spec.scrape_interval
                    changed = True
                if changed:
                    self._refresh()
                if all(r.terminal for r in self.members.values()):
                    break
                if deadline is not None and now > deadline:
                    self._abort_running("fleet timeout")
                    break
                time.sleep(self.spec.poll_interval)
        except BaseException:
            self._abort_running("scheduler aborted")
            raise

    def _abort_running(self, reason: str) -> None:
        for rec in self.members.values():
            if rec.proc is None:
                continue
            try:
                rec.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        t_end = time.monotonic() + 15.0
        for rec in self.members.values():
            if rec.proc is None:
                continue
            try:
                rec.proc.wait(timeout=max(t_end - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                rec.proc.kill()
                rec.proc.wait(timeout=5.0)
            rec.exit_code = rec.proc.returncode
            rec.proc = None
            if rec.seg_t0 is not None:
                rec.run_s += time.monotonic() - rec.seg_t0
                rec.seg_t0 = None
        # EVERY non-terminal member fails here — including pending ones
        # that never launched or sat in requeue backoff: an aborted
        # fleet must not report skipped-but-clean for work it never ran
        for rec in self.members.values():
            if not rec.terminal:
                rec.state = "failed"
                emit_fleet(
                    self.bus, rec.spec.member_id, "failed", rec.attempt,
                    exit_code=rec.exit_code, reason=reason,
                )
        self._refresh()

    # -- selection + gate --------------------------------------------------

    def _load_member_records(self, rec: MemberRecord) -> Optional[list]:
        from trpo_torch.obs.analyze import load_events

        try:
            records = load_events(rec.events_path)
        except OSError:
            return None
        return records or None

    def _terminal_records(self) -> Dict[str, Optional[list]]:
        """One parse per finished/culled member's event log, shared by
        scoring and the gate (a real fleet's logs hold thousands of
        records each — don't read them twice back-to-back)."""
        return {
            mid: self._load_member_records(rec)
            for mid, rec in self.members.items()
            if rec.state in ("finished", "culled")
        }

    def member_final_scores(
        self, records_map: Optional[Dict[str, Optional[list]]] = None
    ) -> Dict[str, float]:
        """Final score per *finished* member (episode-weighted mean
        return from its event log — ``population.member_scores``
        semantics)."""
        if records_map is None:
            records_map = self._terminal_records()
        scores: Dict[str, float] = {}
        for mid, records in records_map.items():
            if records is None:
                continue
            total_r, total_w = _score_totals(records)
            fb = self._feedback.get(mid)
            if fb:
                # served reality pools in episode-weighted:
                # a feedback mean over n served episodes carries exactly
                # n episodes' worth against the training batches
                mean, n = fb
                if (
                    isinstance(mean, (int, float))
                    and isinstance(n, (int, float))
                    and n > 0
                ):
                    total_r += float(mean) * float(n)
                    total_w += float(n)
            self.members[mid].score = (
                total_r / total_w if total_w > 0 else float("-inf")
            )
            scores[mid] = self.members[mid].score
        return scores

    def _cull(self, scores: Dict[str, float]) -> List[str]:
        if self._selection is not None:
            culled = [m for m in self._selection(dict(scores))
                      if m in scores]
        elif self.spec.cull_bottom_k > 0 and scores:
            k = min(self.spec.cull_bottom_k, max(len(scores) - 1, 0))
            culled = sorted(scores, key=lambda m: scores[m])[:k]
        else:
            culled = []
        for mid in culled:
            rec = self.members[mid]
            rec.state = "culled"
            emit_fleet(
                self.bus, mid, "culled", rec.attempt, score=rec.score,
                reason="selection bottom-k",
            )
        return culled

    # -- PBT exploit/explore ----------------------------------------------

    def _pbt_respawn(self, result: dict) -> List[str]:
        """Respawn this round's culled members from the winner's
        checkpoint with perturbed hyperparameters — the PBT
        exploit/explore step (Jaderberg et al. 2017). Returns the
        respawned member ids (empty = nothing to respawn: no cull, no
        finite winner, or no winner checkpoint — the PBT loop stops).

        *Exploit*: the culled member's checkpoint dir is replaced by a
        copy of the winner's (``step_<n>/`` directories and their
        ``.complete`` markers), and the member resumes from the copy's
        newest complete step. *Explore*: its
        ``seed`` is redrawn and its ``lam`` (GAE-λ) / ``cg_damping``
        overrides are multiplicatively perturbed by ``×(1±
        spec.pbt_perturb)`` — deterministically per (member, attempt),
        so a rerun respawns identically. The member's event log is
        rotated aside (``events.gen<N>.jsonl``) so next round's scoring
        reflects only the post-respawn segment."""
        import math
        import random
        import shutil

        scores = result.get("scores") or {}
        culled = [
            mid for mid in result.get("culled") or []
            if self.members[mid].state == "culled"
        ]
        eligible = {
            mid: s for mid, s in scores.items()
            if mid not in culled
            and self.members[mid].state == "finished"
            and isinstance(s, (int, float)) and math.isfinite(s)
        }
        if not culled or not eligible:
            return []
        winner = max(eligible, key=lambda m: (eligible[m], m))
        win_rec = self.members[winner]
        win_step = self._latest_step_fn(win_rec.checkpoint_dir)
        if win_step is None:
            return []
        respawned = []
        for mid in culled:
            rec = self.members[mid]
            # exploit: inherit the winner's weights wholesale
            if os.path.isdir(rec.checkpoint_dir):
                shutil.rmtree(rec.checkpoint_dir)
            shutil.copytree(win_rec.checkpoint_dir, rec.checkpoint_dir)
            # explore: perturb — deterministic per (member, attempt)
            rng = random.Random(f"{mid}:{rec.attempt}")
            factor = (
                1.0 - self.spec.pbt_perturb
                if rng.random() < 0.5
                else 1.0 + self.spec.pbt_perturb
            )
            ov = rec.spec.overrides_dict
            ov["seed"] = rng.randrange(2 ** 31)
            if "lam" in ov:
                # perturb λ through its distance from 1 (its natural
                # scale near the ceiling) and keep it a valid GAE(λ)
                lam = float(ov["lam"])
                ov["lam"] = round(
                    min(max(1.0 - (1.0 - lam) * factor, 0.0), 1.0), 6
                )
            if "cg_damping" in ov:
                ov["cg_damping"] = round(
                    float(ov["cg_damping"]) * factor, 8
                )
            rec.spec = MemberSpec(mid, tuple(ov.items()))
            # next round's score must reflect the post-respawn segment
            # only: rotate the log aside (the new segment starts with
            # its own run_manifest, keeping rotated files valid too)
            try:
                os.replace(
                    rec.events_path,
                    os.path.join(
                        rec.member_dir,
                        f"events.gen{rec.attempt}.jsonl",
                    ),
                )
            except OSError:
                pass
            rec.state = "pending"
            rec.not_before = 0.0
            rec.exit_code = None
            rec.score = None
            rec.resume_step = int(win_step)
            rec.respawned = True
            total = member_total_iterations(self.spec, rec.spec)
            explore_budget = self.spec.pbt_iterations
            if explore_budget is None:
                explore_budget = max(
                    (total or 0) - int(win_step), 1
                )
            rec.total_override = int(win_step) + int(explore_budget)
            emit_fleet(
                self.bus, mid, "respawned", rec.attempt,
                reason=(
                    f"pbt exploit {winner}@{win_step} explore "
                    f"x{factor:g}"
                ),
                resume_step=int(win_step),
            )
            respawned.append(mid)
        self._finished = False
        self._refresh()
        return respawned

    def run_gate(
        self, records_map: Optional[Dict[str, Optional[list]]] = None
    ) -> dict:
        """The fleet-level perf/health gate: ``compare_runs`` per clean
        finished member against the reference member, under the analyze
        CLI's exit contract — **0** clean, **1** regressed, **2**
        reference/member log unreadable. Members that were requeued are
        reported ``skipped`` instead of judged: their wall-clock metrics
        (timesteps/s spans the scheduler downtime) measure the
        preemption, not the member."""
        from trpo_torch.obs.analyze import compare_runs, summarize_run

        if records_map is None:
            records_map = self._terminal_records()
        ref_id = self.spec.reference_id
        ref_rec = self.members[ref_id]
        gate: dict = {"reference": ref_id, "members": {}, "exit_code": 0}
        if ref_rec.state not in ("finished", "culled"):
            # no baseline to gate against — the member failure itself is
            # already the fleet verdict (exit 1 via `failed`), so the
            # gate reports skipped rather than claiming unreadable logs
            gate["reason"] = (
                f"reference member {ref_id!r} did not finish "
                f"({ref_rec.state}); gate skipped"
            )
            for mid in self.members:
                if mid != ref_id:
                    gate["members"][mid] = {
                        "verdict": "skipped", "reason": "no reference",
                    }
            return gate
        if ref_rec.respawned:
            # a respawned reference's current log is an explore SEGMENT
            # resumed from someone else's checkpoint — no clean baseline
            gate["reason"] = (
                f"reference member {ref_id!r} was PBT-respawned — its "
                "log is a resume segment, not a clean baseline; gate "
                "skipped"
            )
            for mid in self.members:
                if mid != ref_id:
                    gate["members"][mid] = {
                        "verdict": "skipped",
                        "reason": "reference not clean",
                    }
            return gate
        if ref_rec.requeues > 0 or ref_rec.failures > 0:
            # a requeued reference's wall-clock metrics span scheduler
            # downtime — comparing against that depressed baseline
            # would wave real regressions through; same skip rule the
            # non-reference members get below
            gate["reason"] = (
                f"reference member {ref_id!r} was requeued "
                f"x{ref_rec.requeues} / crashed x{ref_rec.failures} — "
                "no clean baseline; gate skipped"
            )
            for mid in self.members:
                if mid != ref_id:
                    gate["members"][mid] = {
                        "verdict": "skipped",
                        "reason": "reference not clean",
                    }
            return gate
        ref_records = records_map.get(ref_id)
        if ref_records is None:
            gate["exit_code"] = 2
            gate["reason"] = (
                f"reference member {ref_id!r} finished but its event "
                "log is unreadable"
            )
            return gate
        ref_summary = summarize_run(ref_records)
        for mid, rec in self.members.items():
            if mid == ref_id:
                continue
            if rec.state not in ("finished", "culled"):
                gate["members"][mid] = {
                    "verdict": "skipped", "reason": rec.state,
                }
                continue
            if rec.requeues > 0 or rec.failures > 0:
                gate["members"][mid] = {
                    "verdict": "skipped",
                    "reason": f"requeued x{rec.requeues}, "
                    f"crashed x{rec.failures} — wall-clock metrics "
                    "measure the preemption, not the member",
                }
                continue
            if rec.respawned:
                gate["members"][mid] = {
                    "verdict": "skipped",
                    "reason": "pbt respawn segment — resumed from the "
                    "winner's checkpoint mid-run; its metrics measure "
                    "the explore budget, not a full member run",
                }
                continue
            records = records_map.get(mid)
            if records is None:
                gate["members"][mid] = {
                    "verdict": "unreadable", "reason": "no event records",
                }
                gate["exit_code"] = 2
                continue
            cmp = compare_runs(
                ref_summary,
                summarize_run(records),
                threshold_pct=self.spec.gate_threshold_pct,
                min_ms=self.spec.gate_min_ms,
            )
            gate["members"][mid] = {
                "verdict": "regressed" if cmp["regressed"] else "ok",
                "comparison": cmp,
            }
            if cmp["regressed"] and gate["exit_code"] == 0:
                gate["exit_code"] = 1
        return gate

    def _finalize(self) -> dict:
        records_map = self._terminal_records()
        scores = self.member_final_scores(records_map)
        culled = self._cull(scores)
        gate = self.run_gate(records_map)
        self._finished = True
        self._refresh()
        failed = sorted(
            mid for mid, rec in self.members.items()
            if rec.state == "failed"
        )
        exit_code = gate["exit_code"]
        if failed and exit_code == 0:
            exit_code = 1
        # fleet-level bench row: fleet wall time vs the sum of member
        # run segments (the parallel speedup), as a `phase` record so
        # it rides the same compare_runs machinery as every other
        # timing row
        fleet_wall_s = time.monotonic() - self._started_m
        members_wall_s = sum(
            rec.run_s for rec in self.members.values()
        )
        bench = {
            "fleet_wall_ms": fleet_wall_s * 1e3,
            "members_wall_ms": members_wall_s * 1e3,
            "parallel_speedup": (
                members_wall_s / fleet_wall_s if fleet_wall_s > 0 else None
            ),
            "max_workers": self.spec.max_workers,
        }
        if self.bus is not None:
            try:
                self.bus.emit(
                    "phase", name="fleet/wall", ms=fleet_wall_s * 1e3,
                    members_ms=members_wall_s * 1e3,
                    max_workers=self.spec.max_workers,
                    members=len(self.members),
                )
            except Exception:
                pass
        return {
            "members": {
                mid: rec.row() for mid, rec in self.members.items()
            },
            "scores": scores,
            "culled": culled,
            "failed": failed,
            "respawned": sorted(
                mid for mid, rec in self.members.items() if rec.respawned
            ),
            "gate": gate,
            "bench": bench,
            "exit_code": exit_code,
        }

    def close(self) -> None:
        self._abort_running("scheduler closed")
        if self.status_server is not None:
            self.status_server.close()
            self.status_server = None
