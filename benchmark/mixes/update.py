"""The unit of work ``update``: on-policy chained TRPO policy updates,
driven by a mix's parameters (``mixes/<mix>.json`` with ``"unit":
"update"``). A mix that needs another unit of work (a whole training
iteration, say) names another file here.

Set-up draws, from the seed, on the device: the policy's weights (the
family's ``draw_params``) and a pool of ``batch_pool`` batches, each with
its own observations, actions drawn from the drawn policy (the family's
``draw_batch``) and a standardized N(0, 1) advantage vector, unit row
weights. The window chains updates in segments of ``restart_every``: a
segment starts from the drawn weights, and its update ``j`` takes batch
``j mod batch_pool``. So every update is at most ``restart_every - 1``
steps from the policy that drew its actions, the work of an update does
not depend on how many updates ran before it, and the segment's first
updates are the output check's. Each update computes ``old_dist`` with
the program's policy forward on the current parameters, so it starts
where a training iteration's does (ratio 1, KL 0), then calls the
program's update with the preconditioner and ladder state threaded
through as ``agent.learn`` threads them.

Mix parameters:

* ``ladder``: ``null`` passes no ladder (the unaudited cheap solve); an
  object passes ``trpo.init_ladder(cfg)`` with those fields set (``{}``:
  audits on the configuration's cadence; ``{"pinned": true,
  "pinned_host": true}``: the state of a run after its third failed
  audit, the full-batch f32 solve);
* ``batch_pool``: batches drawn at set-up;
* ``restart_every``: the length of a segment of chained updates;
* ``check_updates``: the segment's first updates, run in set-up, that
  the output check follows with the reference;
* ``check_stress``: planted batches the check then runs through the same
  call (``"backtrack"``, ``"rollback"``: the family's ``stress_batch``),
  so that it compares the line search's backtracking and the KL
  rollback; a kind the family cannot plant is left out;
* ``warmup_updates``: further updates in set-up;
* ``trace_seconds``: how long a ``--trace 1`` run traces further
  updates with the profiler (whole updates, at least one).
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark import check


def n_rows(config) -> int:
    return int(config["n_envs"]) * int(config["steps_per_env"])


def subsample_rows(n: int, fraction: Optional[float]) -> int:
    """How many rows the configuration's curvature subsample keeps (the
    rule ``reference/trpo.keep_rows`` states)."""
    from benchmark.spec import load_module

    return len(load_module("reference", "trpo").keep_rows(n, fraction))


def _standardized(gen, device, rows):
    adv = torch.randn(rows, generator=gen, device=device)
    return (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)


class Workload:
    """The inputs of one run and the program's state as the window drives
    it. ``fault`` plants a broken update under the timed path (a test
    lever): ``"unchanged"`` returns the parameters it was given,
    ``"half_batch"`` updates on the first half of each batch's rows."""

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None,
                 config: Optional[dict] = None):
        self.cell = cell
        self.config = cell.config if config is None else config
        self.mix = cell.mix
        self.family = cell.family
        self.device = torch.device(device)
        self.fault = fault
        self.rows = n_rows(self.config)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self.params0 = self.family.draw_params(self.config, gen, self.device)
        self.batches = []
        for _ in range(int(self.mix["batch_pool"])):
            obs, actions = self.family.draw_batch(
                self.config, gen, self.device, self.rows, self.params0)
            self.batches.append(
                (obs, actions, _standardized(gen, self.device, self.rows)))
        self.stress = []
        for kind in self.mix.get("check_stress", []):
            planted = self.family.stress_batch(
                kind, self.config, gen, self.device, self.rows, self.params0)
            if planted is not None:
                obs, actions, old = planted
                self.stress.append((obs, actions, _standardized(
                    gen, self.device, self.rows), old))
        self.weight = torch.ones(self.rows, device=self.device)
        self.pinned = bool((self.mix.get("ladder") or {}).get("pinned"))
        self.sub_rows = subsample_rows(
            self.rows, self.config["trpo"].get("fvp_subsample"))
        self.fvp_rows = self.rows if self.pinned else self.sub_rows
        self.restart_every = int(self.mix["restart_every"])
        self.n_updates = 0
        self.pos = 0

    # -- the program ---------------------------------------------------
    def build_program(self) -> None:
        from trpo_torch.config import get_preset
        from trpo_torch.ops.precond import init_gaussian_head_precond
        from trpo_torch.trpo import TRPOBatch, init_ladder, make_trpo_update

        c = self.config
        self.family.prepare_program(c)
        self.cfg = get_preset(c["preset"]).replace(
            policy_hidden=tuple(c["hidden"]),
            policy_activation=c["activation"], **c["trpo"])
        self.policy = self.family.program_policy(c)
        self.update = make_trpo_update(self.policy, self.cfg)
        self._batch = TRPOBatch
        self.params = self.family.to_program(
            {k: v.clone() for k, v in self.params0.items()})
        self.precond = (init_gaussian_head_precond(self.params)
                        if self.cfg.cg_precondition == "head_block" else None)
        self.ladder = None
        if self.mix.get("ladder") is not None:
            lad = init_ladder(self.cfg, self.device)
            fields = {}
            for k, v in self.mix["ladder"].items():
                old = getattr(lad, k)
                fields[k] = (torch.as_tensor(v, dtype=old.dtype,
                                             device=self.device)
                             if torch.is_tensor(old) else v)
            self.ladder = lad._replace(**fields)

    def restart(self) -> None:
        """Start a segment: the drawn weights again, batch 0 next."""
        self.params = self.family.to_program(
            {k: v.clone() for k, v in self.params0.items()})
        self.pos = 0

    def _call_update(self, params, batch):
        if self.fault == "unchanged":
            _, stats = self.update(params, batch, None, self.precond,
                                   self.ladder)
            return params, stats
        if self.fault == "half_batch":
            half = batch.weight.shape[0] // 2
            batch = self._batch(*(None if f is None else
                                  (f[:half] if torch.is_tensor(f) else
                                   {k: v[:half] for k, v in f.items()})
                                  for f in batch))
        return self.update(params, batch, None, self.precond, self.ladder)

    def step(self, feed: Optional[tuple] = None):
        """One update: ``old_dist`` by the program's forward (or the
        planted ``feed``'s own), then the program's update. Returns
        ``(stats, refreshed)``."""
        if feed is None:
            if self.pos == self.restart_every:
                self.restart()
            obs, actions, adv = self.batches[self.pos % len(self.batches)]
            old = None
            self.pos += 1
        else:
            obs, actions, adv, old = feed
        refreshed = self.precond is not None and (
            self.precond.age % max(int(self.cfg.precond_refresh_every), 1)
            == 0)
        with torch.autograd.profiler.record_function("bench.old_dist"):
            if old is None:
                with torch.no_grad():
                    old = self.policy.apply(self.params, obs)
        with torch.autograd.profiler.record_function("bench.update"):
            batch = self._batch(obs, actions, adv, old, self.weight)
            self.params, stats = self._call_update(self.params, batch)
        if stats.precond_next is not None:
            self.precond = stats.precond_next
        if stats.ladder_next is not None:
            self.ladder = stats.ladder_next
        self.n_updates += 1
        return stats, refreshed

    # -- the output check ----------------------------------------------
    def check_batches(self) -> list:
        """The check's updates in order, as the reference takes them: the
        segment's first ``check_updates`` batches, then the planted ones."""
        n = int(self.mix["check_updates"])
        return ([self.batches[t % len(self.batches)] for t in range(n)]
                + self.stress)

    def check_program(self) -> dict:
        """Run the check's updates through the window's own call, from the
        drawn weights; the program's readings. The window then starts a
        segment afresh."""
        self.restart()
        stats = [self.step()[0] for _ in range(int(self.mix["check_updates"]))]
        stats += [self.step(feed)[0] for feed in self.stress]
        out = check.program_readings(stats, self.params_named())
        self.restart()
        return out

    def params_named(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.family.from_program(self.params).items()}

    def drop_program(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("params", "precond", "ladder", "update", "policy"):
            setattr(self, name, None)

    # -- what the window's updates did, for the metric readers ---------
    @staticmethod
    def keep(stats, refreshed) -> tuple:
        """The counters of one update that the readers need. Only these
        scalars are kept: a whole ``TRPOStats`` holds views of
        parameter-sized buffers, and keeping one an update would grow
        the peak memory with the window's length."""
        return (stats.cg_iterations,
                -1 if stats.cg_iterations_cheap is None
                else stats.cg_iterations_cheap,
                stats.solve_audited, stats.linesearch_trials,
                stats.nan_guard, stats.rolled_back,
                False if stats.solve_pinned is None else stats.solve_pinned,
                refreshed)

    def records(self, kept: list) -> list:
        """One dict per :meth:`keep` tuple, read back in one transfer: the
        CG iterations of each solve that ran and its rows (a pinned
        update solves on every row, an unpinned one on the subsample and,
        where audited, again on every row), the line-search trials, the
        NaN guard, the rollback."""
        if not kept:
            return []
        table = torch.stack([torch.stack([
            torch.as_tensor(v, device=self.device).float().reshape(())
            for v in k[:7]]) for k in kept]).cpu().tolist()
        out = []
        for (cg, cheap, audited, trials, nan, rolled, pinned), k in zip(
                table, kept):
            if pinned:
                solves = [(self.rows, int(cg))]
            else:
                solves = [(self.sub_rows, int(cheap if cheap >= 0 else cg))]
                if audited:
                    solves.append((self.rows, int(cg)))
            out.append({"solves": solves, "cg_iterations": int(cg),
                        "cg_iterations_cheap": int(cheap),
                        "audited": bool(audited),
                        "linesearch_trials": int(trials),
                        "nan_guard": bool(nan), "rolled_back": bool(rolled),
                        "refreshed": bool(k[7])})
        return out
