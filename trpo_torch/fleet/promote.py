"""The train→serve promotion controller (counterpart:
``trpo_tpu/fleet/promote.py``).

The fleet trains portfolios, checkpoints land atomically behind
completion markers, and the serving set hot-reloads through a gated
canary with instant rollback. This module connects them: a trained
winner reaches serving, and served outcomes reach training.

* :func:`pick_winner` reads a finished fleet's result dict (scores +
  the compare-gate verdicts) and names the member whose checkpoint
  deserves traffic — gate-regressed, culled, and failed members are
  never candidates, however well they scored;
* :class:`PromotionController` drives that member's marker-gated
  checkpoint into the serving directory and through the
  :class:`~trpo_torch.serve.replicaset.CanaryController` gate (p99 +
  realized return + parity), emitting a typed ``promote`` event at
  every transition::

      candidate ──publish──▶ canary ──gate──▶ promoted
                                       ├────▶ rejected     (judged)
                                       └────▶ rolled_back  (unresolved)

* :meth:`PromotionController.feedback` pools the episode returns the
  router booked from live traffic and emits them as a ``promote``
  ``feedback`` record; :func:`feedback_scores` reads those records
  back so the NEXT fleet round's scoring blends served reality into
  training-time scores (the flywheel's return edge).

Crash safety is the design center. A promotion is journaled
(``promote_journal.json`` next to the serving checkpoints, written
atomically) through three phases — ``publishing`` → ``published`` →
terminal — and every phase is *re-entrant*: a controller that dies
mid-promotion (the ``kill_promoter@step=N`` chaos spec raises exactly
there, after publish and before the gate) is restarted, re-reads the
journal plus the serving directory's completion markers
(``step_<n>.complete``), and converges — a terminal entry is returned
from cache (never re-published, never re-gated: the no-double-promote
guarantee), a ``publishing`` entry re-publishes the SAME serving step
(pruning any torn half-save first), a ``published`` entry skips
straight to the gate. The serving step itself is chosen monotonically
above both the incumbent and the directory's newest step, so a
rejected (blacklisted) step is never reused.

``python -m trpo_torch.scripts.validate_events`` closes the loop
contract: a ``candidate`` with no later same-step terminal fails
validation — a stranded promotion is a broken controller, not an
acceptable state.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "PromotionController",
    "pick_winner",
    "feedback_scores",
]

#: journal filename, colocated with the serving checkpoints so the
#: markers and the journal live (and survive) together
JOURNAL_NAME = "promote_journal.json"

_TERMINAL_OUTCOMES = ("promoted", "rejected", "rolled_back")


def pick_winner(result: dict) -> Optional[str]:
    """The fleet member whose checkpoint deserves promotion, from a
    :meth:`FleetScheduler.run` result dict — or ``None`` when no member
    qualifies.

    Eligibility goes through the existing compare-gate, not around it:
    a member is a candidate only if it finished with a finite score,
    was not culled or failed, and the fleet gate did not judge it
    ``regressed``/``unreadable`` (``ok`` and ``skipped`` both pass —
    ``skipped`` means the gate had no clean baseline, which is not a
    verdict against the member). Highest score wins; ties break on
    member id for determinism."""
    scores = result.get("scores") or {}
    out = set(result.get("culled") or []) | set(result.get("failed") or [])
    gate_members = (result.get("gate") or {}).get("members") or {}
    best: Optional[Tuple[float, str]] = None
    for mid, score in scores.items():
        if mid in out:
            continue
        if not isinstance(score, (int, float)) or not math.isfinite(score):
            continue
        verdict = (gate_members.get(mid) or {}).get("verdict")
        if verdict in ("regressed", "unreadable"):
            continue
        key = (float(score), mid)
        # ties break toward the LOWER member id: max() on (score, id)
        # would prefer the higher id, so compare explicitly
        if best is None or key[0] > best[0] or (
            key[0] == best[0] and key[1] < best[1]
        ):
            best = key
    return best[1] if best else None


def feedback_scores(records: List[dict]) -> Dict[str, Tuple[float, int]]:
    """Served realized-return feedback per member, read back from
    ``promote``/``feedback`` event records: ``{member: (mean_return,
    episodes)}``, episode-weighted across multiple feedback records for
    the same member. The fleet's next scoring round blends these with
    training-time episode scores (see
    ``FleetScheduler(..., feedback=...)``)."""
    totals: Dict[str, List[float]] = {}
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "promote":
            continue
        if rec.get("event") != "feedback":
            continue
        member = rec.get("member")
        n = rec.get("episodes")
        mean = rec.get("mean_return")
        if not isinstance(member, str) or not member:
            continue
        if not isinstance(n, int) or isinstance(n, bool) or n <= 0:
            continue
        if (
            not isinstance(mean, (int, float))
            or isinstance(mean, bool)
            or not math.isfinite(mean)
        ):
            continue
        acc = totals.setdefault(member, [0.0, 0.0])
        acc[0] += float(mean) * n
        acc[1] += n
    return {
        m: (acc[0] / acc[1], int(acc[1]))
        for m, acc in totals.items()
        if acc[1] > 0
    }


class PromotionController:
    """Drive one fleet member's checkpoint into serving, through the
    canary gate, crash-safely.

    ``serve_checkpoint_dir`` is the directory the serving tier watches
    (the canary's ``latest_step_fn`` reads it); ``template`` is a
    TrainState template for :meth:`Checkpointer.restore` (the agent's
    ``init_state()``, on the serving device); ``canary`` is
    the live :class:`CanaryController` over the serving
    :class:`ReplicaSet`. ``injector`` (optional
    :class:`~trpo_torch.resilience.inject.FaultInjector`) is the chaos
    seam — ``regress_checkpoint`` rewrites the state between restore
    and save, ``corrupt_checkpoint`` tears the published files after
    the marker lands, ``kill_promoter`` raises between publish and
    gate. ``drive_canary=False`` for a deployment where the canary's
    own background thread ticks (the controller then only observes);
    the default drives ``canary.tick()`` itself, which is what tests
    and the flywheel smoke use.

    ``checkpointer_factory`` is a test seam: ``(directory) ->
    Checkpointer``-shaped object.
    """

    def __init__(
        self,
        serve_checkpoint_dir: str,
        template,
        canary,
        *,
        bus=None,
        injector=None,
        gate_timeout_s: float = 120.0,
        poll_interval: float = 0.05,
        drive_canary: bool = True,
        checkpointer_factory: Optional[Callable[[str], object]] = None,
    ):
        self.serve_checkpoint_dir = os.path.abspath(serve_checkpoint_dir)
        self.template = template
        self.canary = canary
        self.bus = bus
        self.injector = injector
        self.gate_timeout_s = float(gate_timeout_s)
        self.poll_interval = float(poll_interval)
        self.drive_canary = bool(drive_canary)
        if checkpointer_factory is None:
            def checkpointer_factory(directory):
                from trpo_torch.utils.checkpoint import Checkpointer

                return Checkpointer(directory)
        self._ck_factory = checkpointer_factory
        self.journal_path = os.path.join(
            self.serve_checkpoint_dir, JOURNAL_NAME
        )

    # -- journal -----------------------------------------------------------

    def _read_journal(self) -> dict:
        try:
            with open(self.journal_path) as f:
                j = json.load(f)
            if isinstance(j, dict) and isinstance(j.get("entries"), dict):
                return j
        except (OSError, ValueError):
            pass
        return {"entries": {}}

    def _write_journal(self, journal: dict) -> None:
        # atomic: a crash mid-write must leave either the previous
        # journal or the new one, never a truncated half — the whole
        # restart-converges story rests on this file being readable
        os.makedirs(self.serve_checkpoint_dir, exist_ok=True)
        tmp = self.journal_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(journal, f, indent=2, sort_keys=True)
        os.replace(tmp, self.journal_path)

    def _save_entry(self, key: str, entry: dict) -> None:
        journal = self._read_journal()
        journal["entries"][key] = entry
        self._write_journal(journal)

    # -- events ------------------------------------------------------------

    def _emit(self, event: str, member: str, step: int, **extra) -> None:
        if self.bus is None:
            return
        try:
            self.bus.emit(
                "promote", member=member, event=event, step=int(step),
                **extra,
            )
        except Exception:
            pass

    # -- the promotion -----------------------------------------------------

    def _next_serve_step(self) -> int:
        """Strictly above everything the serving side has ever seen:
        the incumbent, the directory's newest COMPLETE step, and any
        step the journal ever assigned (a rejected/blacklisted step
        must never be reassigned to a different candidate)."""
        floor = 0
        incumbent = self.canary.incumbent.get("step")
        if isinstance(incumbent, int):
            floor = max(floor, incumbent)
        latest = self._ck_factory(self.serve_checkpoint_dir).latest_step()
        if isinstance(latest, int):
            floor = max(floor, latest)
        for entry in self._read_journal()["entries"].values():
            s = entry.get("serve_step")
            if isinstance(s, int):
                floor = max(floor, s)
        return floor + 1

    def promote(
        self,
        member: str,
        member_checkpoint_dir: str,
        src_step: Optional[int] = None,
        timeout_s: Optional[float] = None,
    ) -> dict:
        """Promote ``member``'s newest complete checkpoint (or an
        explicit ``src_step``) into serving; blocks until the canary
        gate resolves. Returns ``{"member", "src_step", "serve_step",
        "outcome", "reason"}`` with ``outcome`` one of ``promoted`` /
        ``rejected`` (judged — the step is blacklisted) /
        ``rolled_back`` (the gate never resolved within the deadline).

        Re-entrant per ``(member, src_step)``: a repeat call after a
        crash converges on the journal + markers — a terminal entry
        returns from cache without touching the serving plane."""
        src_ck = self._ck_factory(member_checkpoint_dir)
        if src_step is None:
            src_step = src_ck.latest_step()
        if src_step is None:
            raise FileNotFoundError(
                f"member {member!r} has no complete checkpoint in "
                f"{member_checkpoint_dir}"
            )
        key = f"{member}@{int(src_step)}"
        entry = self._read_journal()["entries"].get(key)
        if entry and entry.get("outcome") in _TERMINAL_OUTCOMES:
            # the no-double-promote guarantee: a resolved promotion
            # is FINAL for this (member, src_step) — a restarted
            # controller reports it, it does not redo it
            return dict(entry)
        if entry:
            serve_step = int(entry["serve_step"])
        else:
            serve_step = self._next_serve_step()
            entry = {
                "member": member,
                "src_step": int(src_step),
                "serve_step": serve_step,
                "phase": "publishing",
                "outcome": None,
                "reason": None,
            }
            self._emit(
                "candidate", member, serve_step, src_step=int(src_step)
            )
            self._save_entry(key, entry)
        if not self._published(serve_step):
            self._publish(src_ck, int(src_step), serve_step, member)
        if entry.get("phase") != "published":
            entry["phase"] = "published"
            self._save_entry(key, entry)
        # the kill_promoter seam: after the publish is durable, before
        # the gate drives — exactly where a stranded canary would be
        # worst. The raise propagates; the journal converges a restart.
        if self.injector is not None:
            self.injector.on_promotion(serve_step)
        self._emit("canary", member, serve_step, src_step=int(src_step))
        outcome, reason = self._drive_gate(serve_step, timeout_s)
        entry["phase"] = "terminal"
        entry["outcome"] = outcome
        entry["reason"] = reason
        self._save_entry(key, entry)
        extra = {"src_step": int(src_step)}
        if reason:
            extra["reason"] = reason
        self._emit(outcome, member, serve_step, **extra)
        return dict(entry)

    def _published(self, serve_step: int) -> bool:
        """Re-read the serving directory's completion markers — the
        durable truth a restarted controller converges on. A marker
        present means the publish finished (a step's marker lands
        strictly after its directory is in place); anything less gets
        re-published."""
        dst = self._ck_factory(self.serve_checkpoint_dir)
        return serve_step in set(dst._complete_steps())

    def _publish(self, src_ck, src_step: int, serve_step: int,
                 member: str) -> None:
        state = src_ck.restore(self.template, step=src_step, prune=False)
        if self.injector is not None:
            # regress_checkpoint: the state is rewritten HERE — it will
            # save cleanly, load cleanly, and only behave worse
            state = self.injector.on_checkpoint_publish(serve_step, state)
        dst = self._ck_factory(self.serve_checkpoint_dir)
        # a previous attempt at this serve_step may have torn mid-save:
        # prune the incomplete remains first (marker-gated: a COMPLETE
        # step never reaches here — _published() short-circuits)
        dst.prune_incomplete()
        dst.save(serve_step, state)
        if self.injector is not None:
            # corrupt_checkpoint: tears the files of the step directory
            # (step_<n>/) AFTER the marker landed — the shape the marker
            # protocol cannot see, which only the canary's failed reload
            # catches
            self.injector.on_checkpoint_published(
                serve_step, dst._step_dir(serve_step))

    def _drive_gate(
        self, serve_step: int, timeout_s: Optional[float]
    ) -> Tuple[str, Optional[str]]:
        deadline = time.monotonic() + (
            self.gate_timeout_s if timeout_s is None else float(timeout_s)
        )
        canary = self.canary
        while True:
            if canary.incumbent.get("step") == serve_step:
                return "promoted", None
            if serve_step in canary._rejected_steps:
                return "rejected", (
                    f"canary gate rejected serving step {serve_step} "
                    "(judged; step blacklisted)"
                )
            if time.monotonic() >= deadline:
                return "rolled_back", (
                    f"canary gate did not resolve serving step "
                    f"{serve_step} within its deadline"
                )
            if self.drive_canary:
                # synchronous: one tick runs a full gate to its
                # terminal (CanaryController.tick's documented contract)
                canary.tick()
            time.sleep(self.poll_interval)

    # -- the return edge ---------------------------------------------------

    def feedback(self, member: str, step: int) -> dict:
        """Pool every episode return the router has booked across the
        serving set and book it against ``member`` as a ``promote``
        ``feedback`` record — the realized-return edge the next fleet
        round's scoring blends in via :func:`feedback_scores`."""
        router = self.canary.router
        with self.canary.replicaset.lock:
            rids = list(self.canary.replicaset.replicas.keys())
        eps: List[float] = []
        for rid in rids:
            eps.extend(router.replica_episode_returns(rid))
        mean = (sum(eps) / len(eps)) if eps else None
        extra = {"episodes": len(eps)}
        if mean is not None and math.isfinite(mean):
            extra["mean_return"] = float(mean)
        self._emit("feedback", member, int(step), **extra)
        return {"member": member, "step": int(step), **extra}
