"""``TRPOAgent`` — training on a device env (counterpart:
``trpo_tpu/agent.py``, the device-env feedforward path and its serial
``learn`` loop).

An iteration is: on-device rollout (``rollout.device_rollout``, in
time-chunks with ``cfg.rollout_chunk``) → GAE over
the critic's values (``ops/returns.gae_from_next_values``, through the
reverse-scan kernel) → the TRPO update (``trpo.make_trpo_update``, whose
CG matvec is the fused FVP kernel) → the critic fit (``vf.py``) → the
stats dict, with the keys of the reference's ``_vf_stats_phase``. The
damping λ (``cfg.adaptive_damping``) and the solver ladder's state ride
``TrainState.cg_damping`` and ``TrainState.ladder`` from update to update.

The policy family follows the config, as in the reference: a recurrent
policy with ``cfg.policy_gru`` (GRU or LSTM, ``cfg.policy_cell``), a
mixture of experts with ``cfg.policy_experts`` (the two exclude each
other), the conv torso for ``(H, W, C)`` pixels, else the MLP. A
recurrent policy's state rides the rollout carry, its update replays the
window as a ``SeqObs``, and its critic reads ``[obs, state]``. A conv
policy sets cuDNN to f32, deterministic convolutions
(``models.conv.exact_convolutions``). Pixels reach the critic as their raw
0-255 values cast to the compute dtype, as in the reference.

With ``cfg.normalize_obs`` the rollout's policy normalizes its inputs with
``TrainState.obs_norm`` as of the start of the iteration; the update and
the critic replay the trajectory's observations normalized with the same
statistics, through the raw policy (so the update still reaches the fused
FVP kernel), and the raw observations are folded into the statistics for
the next iteration.

``learn`` is the reference's serial training loop: chunks of
``cfg.fuse_iterations`` iterations (``run_iterations``), the chunk's stats
brought to the host in one transfer, a JSONL row per iteration
(``utils/metrics.StatsLogger``), the stop rules, a checkpoint every
``cfg.checkpoint_every`` iterations, the preemption exit and the NaN
recovery (``resilience``). The reference's overlapped and host-async
loops, its telemetry and its fault injector are not ported (ROADMAP.md
Queue 1 items 13, 15 and 18).

The agent runs on ``cuda`` unless the caller passes ``device="cpu"`` (as
the tests do). With no device given and no CUDA available it raises; it
never carries on quietly on the CPU.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from trpo_torch import envs as envs_lib
from trpo_torch.config import TRPOConfig, check_ported
from trpo_torch.envs.episode_stats import RunningEpisodeMean
from trpo_torch.models.conv import exact_convolutions
from trpo_torch.models.moe import make_moe_policy
from trpo_torch.models.policy import make_policy, spec_from_env
from trpo_torch.models.recurrent import SeqObs, make_recurrent_policy
from trpo_torch.ops.flat import tree_map
from trpo_torch.ops.precond import init_gaussian_head_precond
from trpo_torch.ops.returns import gae_from_next_values
from trpo_torch.rollout import Trajectory, device_rollout, init_env_states
from trpo_torch.trpo import (
    TRPOBatch,
    init_ladder,
    ladder_stateful,
    make_trpo_update,
    standardize_advantages,
)
from trpo_torch.resilience import Preempted, PreemptionGuard, RecoveryPolicy
from trpo_torch.utils.metrics import StatsLogger, explained_variance
from trpo_torch.utils.normalize import init_stats, normalize, update_stats
from trpo_torch.utils.timers import PhaseTimer
from trpo_torch.vf import VFState, create_value_function

__all__ = ["TRPOAgent", "TrainState", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The explicit device, else ``cuda``; raises when none is given and
    CUDA is unavailable."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "trpo_torch runs on CUDA and none is available; pass "
            "device='cpu' (or --device cpu) to run the plain versions of "
            "the kernels on the CPU"
        )
    return torch.device("cuda")


class TrainState(NamedTuple):
    """Everything that evolves across iterations."""
    policy_params: Any
    vf_state: VFState
    env_carry: Any                 # (states, obs, episode_return, length),
    #                                and (h, prev_done) for a recurrent
    #                                policy
    rng: torch.Generator           # rollout noise, on the agent's device
    iteration: int
    total_episodes: torch.Tensor   # int64 scalar on the device
    total_timesteps: int
    precond: Any = None            # ops.precond.PrecondState or None
    cg_damping: Any = None         # f32 device scalar with adaptive_damping
    ladder: Any = None             # trpo.LadderState when the ladder is on
    obs_norm: Any = None           # utils.normalize.RunningStats with
    #                                cfg.normalize_obs


def _to(tree, device):
    """``tree`` with its tensors moved to ``device``."""
    return tree_map(
        lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree
    )


class TRPOAgent:
    """TRPO on one device. ``env`` is an env name (see
    ``trpo_torch.envs.make``) or a constructed env."""

    def __init__(self, env, config: Optional[TRPOConfig] = None,
                 device=None):
        cfg = config or TRPOConfig()
        check_ported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_envs = cfg.resolved_n_envs()
        if isinstance(env, str):
            env = envs_lib.make(env, max_episode_steps=cfg.max_pathlength,
                                device=self.device)
        self.env = env
        self.obs_shape, action_spec = spec_from_env(env)
        compute_dtype = getattr(torch, cfg.compute_dtype)
        family = dict(hidden=tuple(cfg.policy_hidden),
                      activation=cfg.policy_activation,
                      init_log_std=cfg.init_log_std,
                      compute_dtype=compute_dtype)
        if cfg.policy_gru is not None:
            if cfg.policy_experts is not None:
                raise ValueError(
                    "policy_gru and policy_experts are mutually exclusive "
                    "(no recurrent-MoE model family)"
                )
            self.policy = make_recurrent_policy(
                self.obs_shape, action_spec, gru_size=cfg.policy_gru,
                cell=cfg.policy_cell, **family)
        elif cfg.policy_experts is not None:
            self.policy = make_moe_policy(
                self.obs_shape, action_spec,
                n_experts=cfg.policy_experts, **family)
        else:
            self.policy = make_policy(self.obs_shape, action_spec,
                                      **family)
            if len(self.obs_shape) == 3:
                exact_convolutions()
        self.is_recurrent = cfg.policy_gru is not None
        vf_dim = int(math.prod(self.obs_shape))
        if self.is_recurrent:
            # the POMDP critic: [obs, state] features (state_size: H for
            # the GRU, 2H for the LSTM's packed [h | c])
            vf_dim += self.policy.state_size
        self.vf = create_value_function(
            vf_dim,
            hidden=tuple(cfg.vf_hidden),
            activation=cfg.vf_activation,
            learning_rate=cfg.vf_learning_rate,
            train_steps=cfg.vf_train_steps,
            compute_dtype=compute_dtype,
        )
        self.trpo_update = make_trpo_update(self.policy, cfg)
        self._precond_stateful = (
            cfg.cg_precondition == "head_block"
            and cfg.precond_refresh_every > 1
        )
        self._ladder_stateful = ladder_stateful(cfg)
        # steps per env per iteration, so T·N ≥ batch_timesteps
        self.n_steps = max(1, -(-cfg.batch_timesteps // self.n_envs))

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Params from CPU generators seeded by ``seed`` (the same weights
        on every device); rollout noise from a generator on the device."""
        seed = self.cfg.seed if seed is None else seed
        g_policy = torch.Generator().manual_seed(seed)
        g_vf = torch.Generator().manual_seed(seed + 1)
        rng = torch.Generator(device=self.device).manual_seed(seed + 2)
        policy_params = _to(self.policy.init(g_policy), self.device)
        return TrainState(
            policy_params=policy_params,
            vf_state=_to(self.vf.init(g_vf), self.device),
            env_carry=init_env_states(self.env, self.n_envs, rng,
                                      policy=self.policy),
            rng=rng,
            iteration=0,
            total_episodes=torch.zeros((), dtype=torch.int64,
                                       device=self.device),
            total_timesteps=0,
            precond=init_gaussian_head_precond(policy_params)
            if self._precond_stateful else None,
            cg_damping=torch.full((), float(self.cfg.cg_damping),
                                  device=self.device)
            if self.cfg.adaptive_damping else None,
            ladder=init_ladder(self.cfg, self.device)
            if self._ladder_stateful else None,
            obs_norm=init_stats(self.obs_shape, self.device)
            if self.cfg.normalize_obs else None,
        )

    def _normed_policy(self, stats):
        """The policy with ``stats``-normalization in front of it (the
        policy itself when ``stats`` is None), for the rollout. It drops
        ``mlp_spec``: the fused FVP kernel reads raw inputs, so this
        wrapper must never pass for a plain MLP. The update runs the raw
        policy on normalized data instead."""
        if stats is None:
            return self.policy
        pol = self.policy
        if self.is_recurrent:
            # the rollout calls .step; .apply is wrapped too, so the
            # wrapped policy stays one over raw observations
            return pol._replace(
                step=lambda p, h, o: pol.step(p, h, normalize(stats, o)),
                apply=lambda p, seq: pol.apply(
                    p, seq._replace(obs=normalize(stats, seq.obs))),
            )
        return pol._replace(
            apply=lambda p, o: pol.apply(p, normalize(stats, o)),
            apply_cast=lambda p, o, dt: pol.apply_cast(
                p, normalize(stats, o), dt),
            mlp_spec=None,
        )

    def _vf_features(self, traj: Trajectory):
        """Critic inputs ``(current, next)``, flattened to ``(T·N, F)``:
        the observations, and for a recurrent policy the state it held
        when seeing them (``policy_h`` / ``policy_h_next``) beside them."""
        T, N = traj.rewards.shape
        flat = lambda x: x.reshape(T * N, -1)  # noqa: E731
        if not self.is_recurrent:
            return flat(traj.obs), flat(traj.next_obs)
        join = lambda o, h: torch.cat([flat(o), flat(h)], dim=-1)  # noqa
        return (join(traj.obs, traj.policy_h),
                join(traj.next_obs, traj.policy_h_next))

    def _advantages(self, vf_state: VFState, traj: Trajectory):
        T, N = traj.rewards.shape
        vf_in, vf_next_in = self._vf_features(traj)
        with torch.no_grad():
            values = self.vf.predict(vf_state, vf_in).reshape(T, N)
            next_values = self.vf.predict(vf_state, vf_next_in).reshape(T, N)
        adv, vtarg = gae_from_next_values(
            traj.rewards, values, next_values, traj.terminated, traj.done,
            self.cfg.gamma, self.cfg.lam,
        )
        return adv, vtarg, values

    def _policy_phase(self, train_state: TrainState, traj: Trajectory):
        """Advantages → TRPO policy update → episode scalars. Returns the
        state advanced in everything but ``vf_state``, and the pack the
        critic phase consumes."""
        cfg = self.cfg
        T, N = traj.rewards.shape
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])  # noqa: E731

        new_obs_norm = stats = train_state.obs_norm
        if stats is not None:
            # the statistics the rollout used, so the replayed
            # distributions match old_dist; the raw observations are
            # folded in afterwards, for the next iteration
            new_obs_norm = update_stats(stats, flat(traj.obs))
            traj = traj._replace(obs=normalize(stats, traj.obs),
                                 next_obs=normalize(stats, traj.next_obs))

        adv, vtarg, values = self._advantages(train_state.vf_state, traj)
        weight = torch.ones(T * N, device=adv.device)
        adv_flat = flat(adv)
        if cfg.standardize_advantages:
            adv_flat = standardize_advantages(adv_flat, weight)
        vf_in, _ = self._vf_features(traj)
        if self.is_recurrent:
            # the window keeps its (T, N) axes: the policy replays it
            # from the rollout's resets and entry state
            batch = TRPOBatch(
                obs=SeqObs(traj.obs, traj.reset, traj.policy_h0),
                actions=traj.actions,
                advantages=adv_flat.reshape(T, N),
                old_dist=traj.old_dist,
                weight=weight.reshape(T, N),
            )
        else:
            batch = TRPOBatch(
                obs=flat(traj.obs),
                actions=flat(traj.actions),
                advantages=adv_flat,
                old_dist=tree_map(flat, traj.old_dist),
                weight=weight,
            )
        new_policy_params, trpo_stats = self.trpo_update(
            train_state.policy_params, batch, train_state.cg_damping,
            train_state.precond, train_state.ladder,
        )

        done_f = traj.done.float()
        n_episodes = traj.done.sum()
        ep_denom = torch.clamp(n_episodes, min=1)
        no_eps = n_episodes == 0
        nan = torch.full((), float("nan"), device=adv.device)
        mean_ep_reward = torch.where(
            no_eps, nan, torch.sum(traj.episode_return * done_f) / ep_denom
        )
        mean_ep_length = torch.where(
            no_eps, nan,
            torch.sum(traj.episode_length.float() * done_f) / ep_denom,
        )
        new_state = train_state._replace(
            policy_params=new_policy_params,
            iteration=train_state.iteration + 1,
            total_episodes=train_state.total_episodes + n_episodes,
            total_timesteps=train_state.total_timesteps + T * N,
            precond=trpo_stats.precond_next
            if trpo_stats.precond_next is not None
            else train_state.precond,
            cg_damping=trpo_stats.damping_next
            if cfg.adaptive_damping else train_state.cg_damping,
            ladder=trpo_stats.ladder_next
            if trpo_stats.ladder_next is not None
            else train_state.ladder,
            obs_norm=new_obs_norm,
        )
        fit_pack = {
            "vf_in": vf_in,
            "vtarg": flat(vtarg),
            "values": flat(values),
            "weight": weight,
            "trpo_stats": trpo_stats._replace(precond_next=None,
                                              ladder_next=None),
            "total_episodes": new_state.total_episodes,
            "mean_episode_reward": mean_ep_reward,
            "mean_episode_length": mean_ep_length,
            "episodes_in_batch": n_episodes.to(torch.int32),
            # the post-update ladder: its counters surface in the stats
            "ladder": new_state.ladder,
        }
        return new_state, fit_pack

    def _vf_stats_phase(self, vf_state: VFState, fit_pack):
        """Critic fit (after the advantages, the reference's ordering) and
        the stats dict."""
        s = fit_pack["trpo_stats"]
        new_vf_state, vf_loss = self.vf.fit(
            vf_state, fit_pack["vf_in"], fit_pack["vtarg"],
            fit_pack["weight"],
        )
        stats = {
            "total_episodes": fit_pack["total_episodes"],
            "mean_episode_reward": fit_pack["mean_episode_reward"],
            "entropy": s.entropy,
            "vf_explained_variance": explained_variance(
                fit_pack["values"], fit_pack["vtarg"], fit_pack["weight"]
            ),
            "kl_old_new": s.kl,
            "surrogate_loss": s.surrogate_after,
            "mean_episode_length": fit_pack["mean_episode_length"],
            "episodes_in_batch": fit_pack["episodes_in_batch"],
            "vf_loss": vf_loss,
            "surrogate_before": s.surrogate_before,
            "grad_norm": s.grad_norm,
            "step_norm": s.step_norm,
            "cg_iterations": s.cg_iterations,
            "cg_residual": s.cg_residual,
            "linesearch_success": s.linesearch_success,
            "linesearch_step_fraction": s.step_fraction,
            "kl_quadratic_pred": self.cfg.max_kl * s.step_fraction ** 2,
            "kl_rolled_back": s.rolled_back,
            "cg_damping": s.damping,
            "linesearch_trials": s.linesearch_trials,
            "cg_early_exit": s.cg_iterations < s.cg_budget,
            "nan_guard": s.nan_guard,
        }
        lad = fit_pack.get("ladder")
        if lad is not None:
            stats.update({
                "solve_cosine": s.solve_cosine,
                "solve_audited": s.solve_audited,
                "solve_fallback": s.solve_fallback,
                "solve_pinned": lad.pinned,  # post-update pin state
                "cg_budget": lad.cg_budget,
                "solve_cosine_min": lad.cosine_min,
                "audit_runs": lad.audit_runs,
                "fallbacks": lad.fallbacks,
            })
        return new_vf_state, stats

    def _process_trajectory(self, train_state: TrainState, traj: Trajectory):
        """advantages → TRPO update → critic fit → stats."""
        state, fit_pack = self._policy_phase(train_state, traj)
        new_vf_state, stats = self._vf_stats_phase(state.vf_state, fit_pack)
        return state._replace(vf_state=new_vf_state), stats

    def run_iteration(self, train_state: TrainState):
        """One training iteration; returns ``(new_state, stats)`` with the
        stats as 0-d tensors (read them on the host when needed)."""
        new_carry, traj = device_rollout(
            self.env, self._normed_policy(train_state.obs_norm),
            train_state.policy_params, train_state.env_carry,
            train_state.rng, self.n_steps, chunk=self.cfg.rollout_chunk,
        )
        train_state = train_state._replace(env_carry=new_carry)
        return self._process_trajectory(train_state, traj)

    def run_iterations(self, train_state: TrainState, n: int):
        """``n`` iterations back to back with no host read in between
        (beyond an audited update's one read of the ladder's pin flag);
        returns ``(state, stats)`` with every stat stacked on the device
        along a leading ``(n,)`` axis."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        rows = []
        for _ in range(n):
            train_state, stats = self.run_iteration(train_state)
            rows.append(stats)
        return train_state, {
            k: torch.stack([torch.as_tensor(r[k], device=self.device)
                            for r in rows])
            for k in rows[0]
        }

    # ------------------------------------------------------------------
    # act and greedy evaluation
    # ------------------------------------------------------------------

    def act(self, state: TrainState, obs, generator=None,
            eval_mode: bool = False, policy_carry=None):
        """Sample (train) or take the mode (eval: the Gaussian mean, the
        categorical argmax) of the policy at ``obs``, one observation or a
        batch, normalized with ``state.obs_norm``. Returns ``(action,
        dist_params)``; a recurrent policy returns ``(action, dist_params,
        new_policy_carry)``: pass the carry back on the next call
        (``policy_carry=None`` starts a fresh memory). Train mode needs an
        explicit ``generator``: a silent default would sample the same
        action on every call. Pixels keep their uint8 dtype."""
        if generator is None and not eval_mode:
            raise ValueError(
                "act(eval_mode=False) needs an explicit torch.Generator; "
                "pass generator=... or use eval_mode=True"
            )
        obs = torch.as_tensor(obs, device=self.device)
        if obs.dtype != torch.uint8:
            obs = obs.float()
        if state.obs_norm is not None:
            obs = normalize(state.obs_norm, obs)
        squeeze = obs.ndim == len(self.obs_shape)
        if squeeze:
            obs = obs[None]
        h_new = None
        with torch.no_grad():
            if self.is_recurrent:
                h = (self.policy.initial_state(obs.shape[0],
                                               device=self.device)
                     if policy_carry is None else
                     torch.as_tensor(policy_carry, device=self.device))
                if squeeze and policy_carry is not None:
                    h = h[None]
                h_new, dist = self.policy.step(state.policy_params, h, obs)
            else:
                dist = self.policy.apply(state.policy_params, obs)
            if eval_mode:
                action = self.policy.dist.mode(dist)
            else:
                action = self.policy.dist.sample(dist, generator=generator)
        if squeeze:
            action = action[0]
            dist = {k: v[0] for k, v in dist.items()}
            h_new = None if h_new is None else h_new[0]
        if self.is_recurrent:
            return action, dist, h_new
        return action, dist

    def evaluate(self, train_state: TrainState,
                 n_steps: Optional[int] = None, seed: int = 0):
        """Greedy evaluation: ``n_steps`` per env (default: one training
        window) of mode actions on a fresh carry from a generator seeded
        by ``seed``; the training carry and generator are untouched.
        Returns ``(mean_episode_reward, episodes_completed)`` over the
        episodes that finish in the window; with none finished, the mean
        partial-episode return (a lower bound) and 0."""
        n_steps = self.n_steps if n_steps is None else n_steps
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        carry = init_env_states(self.env, self.n_envs, gen,
                                policy=self.policy)
        _, traj = device_rollout(
            self.env, self._normed_policy(train_state.obs_norm),
            train_state.policy_params, carry, gen, n_steps,
            deterministic=True,
        )
        done = traj.done
        n_done = done.sum()
        mean_done = torch.sum(traj.episode_return * done) / torch.clamp(
            n_done, min=1)
        n_done, mean_done, mean_partial = torch.stack([
            n_done.double(), mean_done.double(),
            traj.episode_return[-1].mean().double()]).tolist()
        if n_done:
            return mean_done, int(n_done)
        return mean_partial, 0

    # ------------------------------------------------------------------
    # learn: the serial training loop
    # ------------------------------------------------------------------

    def learn(self, n_iterations: Optional[int] = None,
              state: Optional[TrainState] = None,
              logger: Optional[StatsLogger] = None, checkpointer=None,
              callback=None) -> TrainState:
        """Train for ``n_iterations`` more iterations (``cfg.n_iterations``
        by default) from ``state`` (a fresh ``init_state()`` by default);
        returns the final state.

        Stops early on ``cfg.reward_target`` or
        ``cfg.stop_on_explained_variance``, checked per iteration but
        acted on at the end of a chunk; raises ``FloatingPointError`` on
        NaN entropy after logging the row, unless
        ``cfg.recover_on_nan="restore"`` (``resilience.recovery``). With
        ``cfg.on_preempt="checkpoint"`` a SIGTERM/SIGINT ends the run at
        the next chunk boundary with a final checkpoint and
        ``resilience.Preempted``. ``callback(state, stats)`` runs once per
        chunk with the chunk's last row; ``checkpointer`` (a
        ``utils.checkpoint.Checkpointer``) saves whenever a chunk crosses
        a multiple of ``cfg.checkpoint_every``."""
        cfg = self.cfg
        n_iterations = n_iterations or cfg.n_iterations
        state = self.init_state() if state is None else state
        own_logger = logger is None
        logger = logger or StatsLogger(jsonl_path=cfg.log_jsonl)
        timer = PhaseTimer()
        recovery = (RecoveryPolicy(cfg) if cfg.recover_on_nan == "restore"
                    else None)
        guard = PreemptionGuard(enabled=cfg.on_preempt == "checkpoint")
        chunk = max(1, cfg.fuse_iterations)
        steps_per_iter = self.n_steps * self.n_envs
        reward_running = RunningEpisodeMean()
        # absolute iteration base: the recovery rewind counts in absolute
        # iterations, across a resume
        it0 = state.iteration
        try:
            with guard:
                done = 0
                while done < n_iterations:
                    if guard.triggered:
                        # every finished chunk's rows are processed, so
                        # the state is clean to persist
                        self._preempt_shutdown(state, checkpointer, guard)
                    if recovery is not None:
                        recovery.snapshot(it0 + done + 1, state)
                    k = min(chunk, n_iterations - done)
                    with timer.phase("iteration"):
                        state, stack = self.run_iterations(state, k)
                        rows = _host_rows(stack)
                    done += k
                    it_end = state.iteration
                    per_iter_ms = timer.last_ms("iteration") / k
                    ts_end = state.total_timesteps
                    stop = False
                    host_stats = None
                    flagged_j = None
                    if recovery is not None:
                        # the chunk's first nonfinite row: the whole chunk
                        # re-runs from its snapshot, so its other rows are
                        # neither logged nor folded
                        flagged_j = next(
                            (j for j, r in enumerate(rows)
                             if r["entropy"] != r["entropy"]
                             or r.get("nan_guard")), None)
                    for j, host_stats in enumerate(rows):
                        if flagged_j is not None and j != flagged_j:
                            continue
                        stop = self._finish_iteration_stats(
                            host_stats, reward_running, logger,
                            iteration=it_end - k + 1 + j,
                            iteration_ms=per_iter_ms,
                            timesteps_total=ts_end
                            - (k - 1 - j) * steps_per_iter,
                            recovery=recovery,
                        ) or stop
                    if recovery is not None and recovery.pending is not None:
                        # before the callback and the checkpoint, so
                        # neither ever sees the poisoned state
                        restored_at, state = recovery.recover()
                        done = restored_at - 1 - it0
                        continue
                    if callback is not None:
                        callback(state, host_stats)
                    if checkpointer is not None and (
                        it_end // cfg.checkpoint_every
                        > (it_end - k) // cfg.checkpoint_every
                    ):
                        checkpointer.save(it_end, state)
                    if stop:
                        break
        finally:
            if own_logger:
                logger.close()
        return state

    def _finish_iteration_stats(self, host_stats, reward_running, logger, *,
                                iteration: int, iteration_ms: float,
                                timesteps_total: int,
                                recovery=None) -> bool:
        """Add the running episode mean, the wall-clock fields and the
        timestep total to one iteration's host stats, log the row, then
        apply the stop rules: raise on NaN entropy, return True on
        ``cfg.reward_target`` or ``cfg.stop_on_explained_variance``. With
        ``recovery``, a nonfinite row is logged and flagged for the loop
        instead, and not folded into the running mean."""
        cfg = self.cfg

        def log():
            host_stats["reward_running"] = reward_running.mean
            host_stats["time_elapsed_min"] = logger.elapsed_minutes()
            host_stats["iteration_ms"] = iteration_ms
            host_stats["timesteps_total"] = timesteps_total
            logger.log(iteration, host_stats)

        ent = host_stats["entropy"]
        if recovery is not None:
            pend = recovery.pending
            if pend is not None and iteration > pend[0]:
                return False
            if ent != ent or host_stats.get("nan_guard"):
                log()
                recovery.flag(iteration,
                              "nan_entropy" if ent != ent else "nan_guard")
                return False
        reward_running.update(host_stats["mean_episode_reward"],
                              host_stats["episodes_in_batch"])
        log()
        if recovery is not None:
            recovery.mark_clean(iteration)
        if ent != ent:
            raise FloatingPointError(
                "policy entropy is NaN — aborting training")
        if (cfg.reward_target is not None
                and host_stats["episodes_in_batch"] > 0
                and host_stats["mean_episode_reward"] >= cfg.reward_target):
            return True
        return (cfg.stop_on_explained_variance is not None
                and host_stats["vf_explained_variance"]
                > cfg.stop_on_explained_variance)

    def _preempt_shutdown(self, state: TrainState, checkpointer, guard):
        """The orderly preemption exit: a final checkpoint (unless the
        cadence has just written this step), then ``Preempted`` with the
        requeue exit code."""
        step = state.iteration
        saved = False
        if checkpointer is not None and step > 0:
            if checkpointer.latest_step() != step:
                checkpointer.save(step, state)
            saved = True
        raise Preempted(
            f"preempted by signal {guard.signum} after iteration {step}",
            state=state,
            step=step if saved else 0,
            signum=guard.signum,
            exit_code=self.cfg.requeue_exit_code,
        )


def _host_rows(stack: dict) -> list:
    """Per-iteration dicts of Python scalars from stats stacked on the
    device, brought over in ONE transfer: every stat cast to f64 (exact
    for the f32, int32 and int64 counter values), stacked, one ``.cpu()``.
    Bools come back as bools, integers as ints."""
    keys = list(stack)
    block = torch.stack([stack[k].to(torch.float64) for k in keys])
    block = block.cpu().tolist()
    casts = [bool if stack[k].dtype == torch.bool
             else float if stack[k].is_floating_point() else int
             for k in keys]
    return [{k: cast(vals[j]) for k, cast, vals in zip(keys, casts, block)}
            for j in range(len(block[0]))]
