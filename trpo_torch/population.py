"""Population training: N seeds of one agent trained in lockstep
(counterpart: ``trpo_tpu/population.py``).

Every member runs the agent's own iteration (rollout → GAE through K2 →
the TRPO update, its CG matvec through K1 → critic fit) from its own
``TrainState``; a population iteration steps each member once, one after
another. The reference ``vmap``s its fused device iteration over the
member axis instead, and forces the XLA Gauss-Newton operator there
because its Pallas FVP kernel does not compose with ``vmap``. The port's
iteration reads the host inside the update (the CG's early exit, the line
search's acceptance, the audit's pin flag) and cannot be traced under
``torch.func.vmap``; stepped one after another, member *i* is bitwise
equal to a solo run of seed *i* on one device, and every member's update
launches the same kernels as a solo run. Nothing is shared between members
but the agent's immutable parts: each K1 operator and its buffers are
built per update.

The members' states stay a list (``member_state(i)``): a ``TrainState``
holds a ``torch.Generator``, which has no member axis. The stats of
:meth:`Population.run_iteration` are stacked on a leading member axis,
those of :meth:`Population.run_iterations` on ``(member, n)``.

``lam`` gives each member its own GAE-λ: the hyperparameter axis of a
sweep.

``Population(agent, seeds, mesh=m, axis="data")`` splits the member axis
over the ranks of ``m``'s ``axis`` (one process per rank, ``parallel/``),
as the reference shards its stacked state: rank r steps members
``[r·K, (r+1)·K)`` of ``K = N/D``, and every stat is all-gathered, so
:meth:`member_scores`, :meth:`best_member` and a caller's selection read
the whole population on every rank. Members on a mesh take the
Gauss-Newton operator, the reference's rule for population members
(``trpo_tpu/population.py``); a member's update is its own, with no
collective, so member *i* is bitwise a solo ``fvp_mode="ggn"`` run of seed
*i*, and the meshless population of the same agent when the operator is
the GGN there too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from trpo_torch.agent import TRPOAgent, TrainState
from trpo_torch.ops.allreduce import all_gather_cat

__all__ = ["Population"]


class Population:
    """N seeds of ``agent`` trained in lockstep."""

    def __init__(self, agent: TRPOAgent, seeds: Sequence[int], mesh=None,
                 axis: str = "data", lam: Optional[Sequence[float]] = None):
        if not agent.is_device_env:
            raise ValueError(
                "Population needs a device env (a host simulator is one "
                "shared adapter whose envs the members cannot share)"
            )
        if agent.mesh is not None:
            raise ValueError(
                "pass a meshless agent; the population axis is the thing "
                "being sharded (mesh=... here)"
            )
        if agent.cfg.train_overlap:
            raise ValueError(
                "Population cannot drive the overlapped training "
                "pipeline (train_overlap): members step the serial "
                "iteration in lockstep, and the overlap is a host-side "
                "driver of its own — train population members with "
                "train_overlap=0"
            )
        if len(seeds) == 0:
            raise ValueError("population needs at least one seed")
        if lam is not None and len(lam) != len(seeds):
            raise ValueError(
                f"lam must be parallel to seeds: {len(lam)} λ values for "
                f"{len(seeds)} members"
            )
        if mesh is not None and len(seeds) % mesh.shape[axis] != 0:
            raise ValueError(
                f"population size {len(seeds)} must divide evenly over the "
                f"{axis}={mesh.shape[axis]} mesh axis"
            )
        self.seeds = tuple(int(s) for s in seeds)
        self.mesh = mesh
        self._group = None
        self._members = range(len(self.seeds))
        if mesh is not None:
            import copy

            from trpo_torch.trpo import make_trpo_update

            # a shallow clone with the GGN update: the caller's agent keeps
            # its own (possibly fused) one
            agent = copy.copy(agent)
            agent.trpo_update = make_trpo_update(agent.policy, agent.cfg,
                                                 allow_fused=False)
            k = len(self.seeds) // mesh.shape[axis]
            r = mesh.coordinate(axis)
            self._members = range(r * k, (r + 1) * k)
            self._group = mesh.group(axis)
        self.agent = agent
        # Python floats, as cfg.lam: a member whose λ equals cfg.lam runs
        # the plain iteration bit for bit
        self.lam = None if lam is None else tuple(float(x) for x in lam)
        # this rank's members (every member without a mesh)
        self.states = {i: agent.init_state(self.seeds[i])
                       for i in self._members}

    @property
    def size(self) -> int:
        return len(self.seeds)

    def run_iteration(self) -> dict:
        """Advance every member one training iteration; returns the stats
        with a leading member axis (every member's, on every rank)."""
        rows = []
        for i in self._members:
            lam = None if self.lam is None else self.lam[i]
            self.states[i], stats = self.agent.run_iteration(self.states[i],
                                                             lam=lam)
            rows.append(stats)
        stacked = _stack(rows, self.agent.device)
        if self._group is None:
            return stacked
        return {k: all_gather_cat(v, self._group) for k, v in stacked.items()}

    def run(self, n_iterations: int) -> list:
        """``n_iterations`` lockstep iterations; a list of per-iteration
        stats, each with a leading member axis."""
        return [self.run_iteration() for _ in range(n_iterations)]

    def run_iterations(self, n: int) -> dict:
        """``n`` lockstep iterations; the stats with leading axes
        ``(member, n)``."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        steps = self.run(n)
        return {k: torch.stack([s[k] for s in steps], dim=1)
                for k in steps[0]}

    def member_state(self, i: int) -> TrainState:
        """One member's ``TrainState`` (e.g. the selection winner); on a
        mesh, one of this rank's members."""
        if i not in self.states:
            raise ValueError(
                f"member {i} is stepped by another rank (this rank holds "
                f"members {list(self._members)})")
        return self.states[i]

    def member_scores(self, stats) -> torch.Tensor:
        """Per-member episode-weighted mean return: a batch with no
        finished episode (NaN) contributes nothing, and a member that
        finished none scores lowest: the least finite f32, where the
        reference's ``nan_to_num`` maps its ``-inf``. Takes per-iteration
        stats (leading member axis) or ``run_iterations``' ``(member, n)``
        stats, where each member is scored over every episode it
        completed, as the agent's ``reward_running``."""
        r = torch.as_tensor(stats["mean_episode_reward"]).float()
        if "episodes_in_batch" in stats:
            c = torch.as_tensor(stats["episodes_in_batch"],
                                device=r.device).float()
        else:  # partial stats: weight each finite batch equally
            c = torch.where(torch.isnan(r), 0.0, 1.0)
        if r.ndim > 1:
            c = torch.where(torch.isnan(r), 0.0, c)
            total = c.sum(dim=1)
            score = (torch.nan_to_num(r) * c).sum(dim=1) / torch.clamp(
                total, min=1.0)
            r = torch.where(total > 0, score, -torch.inf)
        return torch.nan_to_num(r, nan=torch.finfo(r.dtype).min)

    def best_member(self, stats) -> int:
        """Index of the member with the highest :meth:`member_scores`."""
        return int(torch.argmax(self.member_scores(stats)))


def _stack(rows: list, device) -> dict:
    """Per-member stats dicts stacked along a leading member axis."""
    return {k: torch.stack([torch.as_tensor(r[k], device=device)
                            for r in rows])
            for k in rows[0]}
