"""Health monitor: watch the iteration stream for known failure
signatures and surface them as ``health`` events (counterpart:
``trpo_tpu/obs/health.py``, copied: the same rules, thresholds and
finding names, so one alerting setup reads both packages' logs).

Rules: NaN entropy (the abort the reference also takes), a nonfinite
guard trip inside the update, KL-rollback streaks, explained-variance
collapse, every rise of the solver ladder's fallback counter
(``health:solve_fallback``) and its pin (``health:solve_pinned``), the
async driver's stats drain reaching its bound, and — with
``--memory-accounting`` — live device bytes growing monotonically across
a steady-state window (``health:memory_leak``, fed by
``obs/memory.MemoryMonitor``). Findings go through the event bus, so the
pluggable sinks (console, JSONL, callback, status endpoint) all see one
schema.

Warnings are transition-gated: a streak emits when it CROSSES the
threshold, not once per iteration while it persists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["HealthConfig", "HealthMonitor"]


@dataclasses.dataclass
class HealthConfig:
    rollback_streak: int = 3       # consecutive KL rollbacks → warn
    ev_collapse: float = -0.5      # explained variance below this → warn
    ev_warmup_iterations: int = 10  # EV is legitimately garbage early on
    memory_leak_window: int = 8    # consecutive iterations of strictly
    #                                growing live bytes → warn (a steady-
    #                                state training loop reuses its
    #                                buffers; sustained monotone growth
    #                                means something retains a reference
    #                                per iteration)
    memory_leak_min_growth: int = 1 << 20  # total growth over the window
    #                                must exceed this (bytes) — jitter in
    #                                small host-side arrays is not a leak
    memory_leak_warmup: int = 2    # first iterations allocate legitimately
    #                                (kernel builds, carry buffers):
    #                                skipped


class HealthMonitor:
    """Evaluate health rules against each iteration's host stats.

    ``observe_iteration`` returns the findings it emitted (empty list =
    healthy), so callers without a bus can still branch on them."""

    def __init__(self, bus=None, config: Optional[HealthConfig] = None):
        self.bus = bus
        self.cfg = config or HealthConfig()
        self._rollback_streak = 0
        self._streak_reported = False
        self._ev_reported = False
        self._drain_reported = False
        self._prev_fallbacks: Optional[int] = None  # solve-ladder counter
        self._pinned_reported = False
        self._mem_samples: list = []   # live-bytes window (leak rule)
        self._mem_seen = 0
        self._leak_reported = False
        self.findings: list = []

    def _emit(self, check: str, level: str, message: str,
              iteration: Optional[int] = None, **data) -> dict:
        finding = {"check": check, "level": level, "message": message}
        if iteration is not None:
            finding["iteration"] = iteration
        if data:
            finding["data"] = data
        self.findings.append(finding)
        if self.bus is not None:
            self.bus.emit("health", **finding)
        return finding

    def observe_iteration(self, iteration: int, stats: dict) -> list:
        out = []
        ent = stats.get("entropy")
        if ent is not None and ent != ent:  # NaN
            out.append(self._emit(
                "nan_entropy", "error",
                "policy entropy is NaN — the NaN abort will fire",
                iteration,
            ))
        if stats.get("nan_guard"):
            out.append(self._emit(
                "nan_guard", "error",
                "nonfinite gradient/surrogate/entropy inside the update",
                iteration,
            ))
        if stats.get("kl_rolled_back"):
            self._rollback_streak += 1
            if (
                self._rollback_streak >= self.cfg.rollback_streak
                and not self._streak_reported
            ):
                self._streak_reported = True
                out.append(self._emit(
                    "kl_rollback_streak", "warn",
                    f"{self._rollback_streak} consecutive KL rollbacks — "
                    "the quadratic step model is miscalibrated (consider "
                    "linesearch_kl_cap / adaptive_damping)",
                    iteration,
                    streak=self._rollback_streak,
                ))
        else:
            self._rollback_streak = 0
            self._streak_reported = False
        # solver precision ladder: every rise of the
        # run-cumulative fallback counter is one audit that failed its
        # cosine floor — emitted per rise (fallbacks are at most one per
        # solve_audit_every updates, never a flood), and
        # validate_events.py REQUIRES the pairing, so the emission here
        # is part of the event-log contract, not just advice
        fb = stats.get("fallbacks")
        if fb is not None:
            # baseline 0, not None: the run-cumulative counter starts at
            # 0 by construction (trpo.init_ladder), so a fallback on the
            # VERY FIRST update (the audit always fires at step 0) must
            # report too. A resumed run's first row re-reports the
            # pre-resume total once — informative, and it keeps the
            # validator's pairing rule satisfiable on resumed logs.
            prev = (
                0 if self._prev_fallbacks is None else self._prev_fallbacks
            )
            if fb > prev:
                out.append(self._emit(
                    "solve_fallback", "warn",
                    "solve audit cosine fell below the floor — the "
                    "update used the f32/full-batch solution "
                    f"(fallbacks total {fb})",
                    iteration,
                    fallbacks=fb,
                    solve_cosine=stats.get("solve_cosine"),
                ))
            self._prev_fallbacks = fb
        if stats.get("solve_pinned") and not self._pinned_reported:
            self._pinned_reported = True
            out.append(self._emit(
                "solve_pinned", "error",
                "persistent solve-audit failures — the precision ladder "
                "is pinned at the f32/full-batch solve for the rest of "
                "the run (check fvp_dtype/fvp_subsample against this "
                "problem's conditioning)",
                iteration,
                fallbacks=stats.get("fallbacks"),
            ))
        ev = stats.get("vf_explained_variance")
        if (
            ev is not None
            and ev == ev  # EV is NaN when Var(y)=0 — not a collapse
            and iteration > self.cfg.ev_warmup_iterations
        ):
            if ev < self.cfg.ev_collapse and not self._ev_reported:
                self._ev_reported = True
                out.append(self._emit(
                    "ev_collapse", "warn",
                    f"critic explained variance collapsed to {ev:.3g} — "
                    "advantage estimates are worse than a zero baseline",
                    iteration,
                    explained_variance=ev,
                ))
            elif ev >= self.cfg.ev_collapse:
                self._ev_reported = False  # recovered: re-arm the check
        return out

    def observe_memory(self, iteration: int, live_bytes: int) -> list:
        """The steady-state leak rule (fed by ``obs/memory.MemoryMonitor``
        once per iteration): live device bytes growing STRICTLY at every
        step of a ``memory_leak_window``-long window, by at least
        ``memory_leak_min_growth`` in total, after the warmup iterations
        → one ``health:memory_leak`` error for the run. An EQUAL sample
        is skipped, not treated as a plateau: a fused k-iteration chunk
        drains k rows at one host instant, so its k identical samples
        are one observation — resetting on them would make the window
        structurally unfillable on the fused driver. A SHRINK resets
        the window: freed memory is not a leak."""
        out = []
        self._mem_seen += 1
        if self._mem_seen <= self.cfg.memory_leak_warmup:
            return out
        w = self._mem_samples
        if w and live_bytes == w[-1]:
            return out
        if w and live_bytes < w[-1]:
            self._mem_samples = [live_bytes]
            return out
        w.append(live_bytes)
        if len(w) > self.cfg.memory_leak_window:
            del w[0]
        if (
            not self._leak_reported
            and len(w) == self.cfg.memory_leak_window
            and w[-1] - w[0] >= self.cfg.memory_leak_min_growth
        ):
            self._leak_reported = True
            grown = w[-1] - w[0]
            out.append(self._emit(
                "memory_leak", "error",
                f"live device bytes grew monotonically for "
                f"{len(w)} consecutive iterations "
                f"(+{grown} bytes, ~{grown // max(1, len(w) - 1)} "
                "bytes/iteration) — something retains a buffer per "
                "iteration (an unbounded snapshot window, a stats row "
                "kept alive, a host list of device arrays)",
                iteration,
                live_bytes=live_bytes, window=len(w), growth_bytes=grown,
            ))
        return out

    def observe_drain(self, depth: int, high_water: int,
                      maxsize: int) -> list:
        """Async-driver gauge hook: called once per iteration with the
        StatsDrain queue's depth/high-water/bound (host ints — no device
        sync). Warns on the HIGH-WATER gauge reaching the bound — the
        instantaneous depth races the drain thread's pops (a blocked
        submit can have drained below the bound by the time this polls),
        while high-water latches the event deterministically. Reported
        once per run (high-water never recedes)."""
        out = []
        if maxsize and high_water >= maxsize and not self._drain_reported:
            self._drain_reported = True
            out.append(self._emit(
                "stats_drain_backpressure", "warn",
                f"stats drain queue hit its bound "
                f"({high_water}/{maxsize}) — the per-iteration stats "
                "fetch is slower than the iteration; stop conditions lag "
                "by the full bound",
                depth=depth, high_water=high_water, maxsize=maxsize,
            ))
        return out
