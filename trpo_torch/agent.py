"""``TRPOAgent`` — one training iteration on a device env (counterpart:
``trpo_tpu/agent.py``, the device-env feedforward path).

An iteration is: on-device rollout (``rollout.device_rollout``) → GAE over
the critic's values (``ops/returns.gae_from_next_values``, through the
reverse-scan kernel) → the TRPO update (``trpo.make_trpo_update``, whose
CG matvec is the fused FVP kernel) → the critic fit (``vf.py``) → the
stats dict, with the keys of the reference's ``_vf_stats_phase``.

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
from trpo_torch.models.policy import make_policy
from trpo_torch.ops.flat import tree_map
from trpo_torch.ops.precond import init_gaussian_head_precond
from trpo_torch.ops.returns import gae_from_next_values
from trpo_torch.rollout import Trajectory, device_rollout, init_env_states
from trpo_torch.trpo import (
    TRPOBatch,
    make_trpo_update,
    standardize_advantages,
)
from trpo_torch.utils.metrics import explained_variance
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
    env_carry: Any                 # (states, obs, episode_return, length)
    rng: torch.Generator           # rollout noise, on the agent's device
    iteration: int
    total_episodes: torch.Tensor   # int64 scalar on the device
    total_timesteps: int
    precond: Any = None            # ops.precond.PrecondState or None


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
        self.obs_shape = tuple(env.obs_shape)
        compute_dtype = getattr(torch, cfg.compute_dtype)
        self.policy = make_policy(
            self.obs_shape, env.action_spec,
            hidden=tuple(cfg.policy_hidden),
            activation=cfg.policy_activation,
            init_log_std=cfg.init_log_std,
            compute_dtype=compute_dtype,
        )
        self.vf = create_value_function(
            int(math.prod(self.obs_shape)),
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
            env_carry=init_env_states(self.env, self.n_envs, rng),
            rng=rng,
            iteration=0,
            total_episodes=torch.zeros((), dtype=torch.int64,
                                       device=self.device),
            total_timesteps=0,
            precond=init_gaussian_head_precond(policy_params)
            if self._precond_stateful else None,
        )

    def _vf_features(self, traj: Trajectory):
        """Critic inputs ``(current, next)``, flattened to ``(T·N, F)``."""
        T, N = traj.rewards.shape
        return (traj.obs.reshape(T * N, -1), traj.next_obs.reshape(T * N, -1))

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

        adv, vtarg, values = self._advantages(train_state.vf_state, traj)
        weight = torch.ones(T * N, device=adv.device)
        adv_flat = flat(adv)
        if cfg.standardize_advantages:
            adv_flat = standardize_advantages(adv_flat, weight)
        vf_in, _ = self._vf_features(traj)
        batch = TRPOBatch(
            obs=flat(traj.obs),
            actions=flat(traj.actions),
            advantages=adv_flat,
            old_dist=tree_map(flat, traj.old_dist),
            weight=weight,
        )
        new_policy_params, trpo_stats = self.trpo_update(
            train_state.policy_params, batch, train_state.precond
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
        )
        fit_pack = {
            "vf_in": vf_in,
            "vtarg": flat(vtarg),
            "values": flat(values),
            "weight": weight,
            "trpo_stats": trpo_stats._replace(precond_next=None),
            "total_episodes": new_state.total_episodes,
            "mean_episode_reward": mean_ep_reward,
            "mean_episode_length": mean_ep_length,
            "episodes_in_batch": n_episodes.to(torch.int32),
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
            self.env, self.policy, train_state.policy_params,
            train_state.env_carry, train_state.rng, self.n_steps,
        )
        train_state = train_state._replace(env_carry=new_carry)
        return self._process_trajectory(train_state, traj)
