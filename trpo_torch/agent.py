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

Host envs (``native:``, ``gym:``; ``envs/native.py``,
``envs/gym_adapter.py``) step on the host: ``run_iteration`` collects with
``rollout.host_rollout`` (or, with ``cfg.host_pipeline_groups > 1``,
``rollout.pipelined_host_rollout``), the policy running on the agent's
device or, with ``cfg.host_inference="cpu"``, on the CPU from a CPU
generator (``TrainState.host_rng``); the trajectory then goes through the
same GAE, update and critic fit on the device. The adapter normalizes the
observations itself (``envs/obs_norm.py``) and its f64 statistics
round-trip through the f32 ``TrainState.obs_norm`` at every iteration
boundary, as in the reference. Its simulator state is not in
``TrainState``: ``snapshot_host_env``/``restore_host_env`` carry it, and
checkpoints write it as a sidecar (``utils/checkpoint.py``).

``learn`` is the reference's serial training loop: chunks of
``cfg.fuse_iterations`` iterations (``run_iterations``), the chunk's stats
brought to the host in one transfer, a JSONL row per iteration
(``utils/metrics.StatsLogger``), the stop rules, a checkpoint every
``cfg.checkpoint_every`` iterations, the preemption exit and the NaN
recovery (``resilience``). With ``cfg.host_async_pipeline`` (host envs)
it runs the asynchronous driver (:meth:`TRPOAgent._learn_host_async`),
bitwise equal to the serial one. With ``cfg.train_overlap=1`` (device
envs with ``cfg.rollout_chunk``) ``learn`` and ``run_iterations`` run the
overlapped actor/learner loop (:meth:`TRPOAgent._overlap_run`): update k on
a learner thread and its own CUDA stream while the calling thread collects
window k+1 on another, with the params the learner started from; the stale
window is importance-weighted (``trpo.TRPOBatch.is_weight``).

``learn(telemetry=...)`` drives an ``obs.Telemetry`` on every driver, as
the reference does (the manifest, an iteration event per row, health and
memory on each row, the profiler window, the phase summaries; the
overlapped loop's ``train/*`` spans with ``cfg.trace_sample_rate``).
``TrainState.metrics`` carries the reference's five run-cumulative solver
counters (``obs/device_metrics.py``), added to inside every update and
merged into every row. ``cfg.debug_nans`` checks each stage's outputs
(``config.py`` lists it as a stated difference). ``cfg.inject_faults``
arms a ``resilience.FaultInjector`` on the serial and async drivers (the
overlapped loop refuses it at config); a ``gymproc:`` env is wrapped in
``resilience.SupervisedEnv``, which ``learn`` hands the bus and the
injector.

The agent runs on ``cuda`` unless the caller passes ``device="cpu"`` (as
the tests do). With no device given and no CUDA available it raises; it
never carries on quietly on the CPU.

A mesh (``cfg.mesh_shape``/``cfg.mesh_axes``, ``parallel/``) runs one
process per rank (``torchrun``), as the reference's agent runs its mesh
in one program: the first axis splits the envs, so rank r of D steps
envs ``[r·N/D, (r+1)·N/D)``, drawing the resets and the action noise of
ALL N envs from the shared seeded generator and keeping its slice, so a
mesh run equals the one-rank run to float tolerance; every batch
reduction (advantage standardization, the update, the critic fit, the
observation statistics, the episode stats) is an all-reduce over that
axis, and the update takes the Gauss-Newton operator, as on the
reference's mesh. A ``"seq"`` axis runs GAE sequence-parallel
(``parallel/seq.py``): the ranks of one ``data`` coordinate roll out the
same envs and each scans its block of time on K2. A ``"model"`` or
``"expert"`` axis shards the policy (``parallel/tp.py``): each rank
holds its blocks, runs the sharded forward in the rollout and the
update, and the update solves over the blocks with the axis's inner
product (``trpo.make_trpo_update`` on a sharded policy), as the
reference's agent switches to its tree update there. Host envs run on a
mesh too: each data rank steps its slice of the envs, seeded by global
env index, folds every rank's observations into the statistics, and
checkpoints gather the sidecar; the ranks of one data coordinate step
copies of the same envs, compared once a window (a worker restart on one
of them alone raises). Only rank 0 writes rows, checkpoints
(``utils/checkpoint.py`` gathers the carry and the params) and
telemetry; a preemption signal to any rank stops every rank at the same
iteration boundary.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from trpo_torch import envs as envs_lib
from trpo_torch.config import TRPOConfig
from trpo_torch.envs.episode_stats import RunningEpisodeMean
from trpo_torch.models.conv import exact_convolutions
from trpo_torch.models.moe import make_moe_policy
from trpo_torch.models.policy import make_policy, spec_from_env
from trpo_torch.models.recurrent import SeqObs, make_recurrent_policy
from trpo_torch.obs.device_metrics import (
    accumulate_update,
    init_device_metrics,
    metrics_stats,
)
from trpo_torch.obs.trace import TraceContext, Tracer, mint_span_id
from trpo_torch.ops.allreduce import all_gather_cat, all_max, all_sum
from trpo_torch.ops.flat import tree_leaves, tree_map
from trpo_torch.ops.precond import init_gaussian_head_precond
from trpo_torch.ops.returns import gae_from_next_values
from trpo_torch.rollout import (
    ChunkedRollout,
    Trajectory,
    concat_chunks,
    device_rollout,
    host_rollout,
    init_env_states,
    make_host_act_fn,
    params_device,
    pipelined_host_rollout,
)
from trpo_torch.trpo import (
    TRPOBatch,
    init_ladder,
    ladder_stateful,
    make_staged_trpo_update,
    make_trpo_update,
    standardize_advantages,
)
from trpo_torch.resilience import (
    FaultInjector,
    Preempted,
    PreemptionGuard,
    RecoveryPolicy,
    SupervisedEnv,
    SupervisionConfig,
)
from trpo_torch.utils.async_pipe import StatsDrain
from trpo_torch.utils.metrics import StatsLogger, explained_variance
from trpo_torch.utils.normalize import (
    RunningStats,
    init_stats,
    normalize,
    update_stats,
)
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
    #                                cfg.normalize_obs (on host envs the f32
    #                                mirror of the adapter's statistics)
    host_rng: Any = None           # CPU generator of the rollout's samples
    #                                with host_inference="cpu"
    metrics: Any = None            # obs.device_metrics.DeviceMetrics: the
    #                                run-cumulative solver counters


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
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.debug_nans:
            # process-wide, as the reference's jax_debug_nans is
            torch.autograd.set_detect_anomaly(True)
        self.n_envs = cfg.resolved_n_envs()
        # steps per env per iteration, so T·N ≥ batch_timesteps
        self.n_steps = max(1, -(-cfg.batch_timesteps // self.n_envs))
        self.mesh = None
        self._group = self._seq_group = None
        self._dp, self._dp_rank = 1, 0
        self._tp_axis = self._tp_specs = None
        if cfg.mesh_shape is not None:
            self._setup_mesh()
        if isinstance(env, str):
            kwargs = {}
            if env.startswith(envs_lib.HOST_PREFIXES):
                if (cfg.fleet_n_envs is not None
                        and env.startswith(("gym:", "gymproc:"))
                        and self.n_envs > envs_lib.HOST_ENV_FLEET_MAX):
                    raise ValueError(
                        f"fleet_n_envs={cfg.fleet_n_envs} exceeds the host "
                        "simulator fleet cap "
                        f"({envs_lib.HOST_ENV_FLEET_MAX}) for {env!r}: the "
                        "gym:/gymproc: families construct one simulator "
                        "instance per env and cannot honor a thousands-wide "
                        "fleet — use a device env family (e.g. the -sim "
                        "stand-ins) or native:, or set n_envs explicitly if "
                        "you really want this many host simulators")
                kwargs["n_envs"] = self.n_envs
                if cfg.normalize_obs:
                    kwargs["normalize_obs"] = True
                if env.startswith("gymproc:") and cfg.env_step_timeout:
                    # a dead or hung worker raises WorkerDiedError instead
                    # of hanging host_step (0/None = wait forever)
                    kwargs["step_timeout"] = cfg.env_step_timeout
                if self.mesh is not None:
                    # this data rank's slice of the envs, seeded as the
                    # one-rank run seeds those global indices
                    kwargs["env_offset"] = self._dp_rank * self.n_envs
            else:
                kwargs["device"] = self.device
            env = envs_lib.make(env, max_episode_steps=cfg.max_pathlength,
                                **kwargs)
        if hasattr(env, "restart_worker") and not isinstance(
                env, SupervisedEnv):
            # a worker pool (gymproc:, or a constructed ProcVecEnv): dead
            # or hung workers restart with backoff, degrade in-process past
            # max_worker_restarts, abort below min_env_workers; learn()
            # attaches the bus and the injector
            env = SupervisedEnv(env, SupervisionConfig(
                max_worker_restarts=cfg.max_worker_restarts,
                min_proc_workers=cfg.min_env_workers,
                backoff_base=cfg.worker_backoff))
        self.env = env
        self.is_device_env = envs_lib.is_device_env(env)
        # the rollout's env: on a mesh, resets draw every rank's envs from
        # the shared generator and keep this rank's slice
        self._roll_env = env
        if self.mesh is not None and not self.is_device_env:
            self._setup_host_mesh()
        elif self.mesh is not None:
            from trpo_torch.parallel.sharded import LocalSliceEnv

            self._roll_env = LocalSliceEnv(env, self._dp_rank, self._dp)
        self._overlap = bool(cfg.train_overlap)
        if self._overlap and not self.is_device_env:
            raise ValueError(
                "train_overlap applies to device envs (the overlapped "
                "pipeline streams rollout.ChunkedRollout chunks on the "
                "actor's stream while the learner updates); host-simulator "
                "envs overlap host stepping with host_async_pipeline "
                "instead")
        self._obs_norm_on_device = cfg.normalize_obs and self.is_device_env
        self._obs_norm_host = (not self.is_device_env
                               and bool(getattr(env, "has_obs_norm", False)))
        if cfg.normalize_obs and not self.is_device_env \
                and not self._obs_norm_host:
            raise NotImplementedError(
                "normalize_obs supports the device envs and the host "
                'adapters (GymVecEnv/NativeVecEnv — "gym:<Id>"/'
                '"native:<kind>" names construct them with '
                "normalize_obs=True; pre-constructed adapters must pass "
                "it themselves); this host env has no normalization hook")
        self.obs_shape, action_spec = spec_from_env(env)
        compute_dtype = getattr(torch, cfg.compute_dtype)
        family = dict(hidden=tuple(cfg.policy_hidden),
                      activation=cfg.policy_activation,
                      init_log_std=cfg.init_log_std,
                      compute_dtype=compute_dtype)
        if cfg.policy_gru is not None and cfg.policy_experts is not None:
            raise ValueError(
                "policy_gru and policy_experts are mutually exclusive "
                "(no recurrent-MoE model family)"
            )
        make = self._policy_family(action_spec, family)
        self.policy = make()
        if cfg.policy_gru is None and cfg.policy_experts is None \
                and len(self.obs_shape) == 3:
            exact_convolutions()
        if self._tp_axis is not None:
            self._setup_param_axis(make)
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
        # on a mesh the update's batch reductions are all-reduced over the
        # batch axis, and the operator is the Gauss-Newton one, for parity
        # with the reference's mesh (whose GSPMD partitioner cannot split
        # the fused kernel). A mesh run therefore launches no K1:
        # parallel/sharded.py's make_sharded_fused_fvp, which runs K1 on
        # each rank's rows, is not on the training path
        # (on a parameter axis the update solves over this rank's blocks
        # with the axis's inner products: the reference's tree update)
        if self.mesh is None:
            self.trpo_update = make_trpo_update(self.policy, cfg)
        else:
            self.trpo_update = make_trpo_update(
                self.policy, cfg, group=self._group, allow_fused=False)
        if self._overlap:
            # the update split at the solve → line-search seam, so the
            # learner's stage times are real
            self._overlap_solve, self._overlap_finish = \
                make_staged_trpo_update(self.policy, cfg)
        self._precond_stateful = (
            cfg.cg_precondition == "head_block"
            and cfg.precond_refresh_every > 1
        )
        self._ladder_stateful = ladder_stateful(cfg)
        self._check_host_options()
        self._host_act_fn = self._host_eval_act_fn = None
        self._host_env_reset_pending = False

    def _setup_mesh(self) -> None:
        """The reference's mesh validation (``trpo_tpu/agent.py``), made
        on the config before any process group exists, then the mesh:
        ``self.n_envs`` becomes this rank's share of the envs."""
        cfg = self.cfg
        from trpo_torch.parallel.mesh import check_shape, make_mesh

        axes = tuple(cfg.mesh_axes)
        shape = check_shape(cfg.mesh_shape, axes)
        if axes[0] in ("seq", "model", "expert"):
            raise ValueError(
                "mesh_axes[0] is the batch/env axis and cannot be named "
                f'"{axes[0]}"; put the {axes[0]!r} axis second, e.g. '
                f'mesh_axes=("data", "{axes[0]}")')
        dp = shape[0]
        if self.n_envs % dp != 0:
            raise ValueError(
                f"n_envs={self.n_envs} must divide evenly over the "
                f"{axes[0]}={dp} mesh axis")
        param_axes = [ax for ax in ("model", "expert") if ax in axes[1:]]
        if len(param_axes) > 1:
            raise ValueError(
                'mesh axes "model" and "expert" do not compose in one '
                "mesh — pick one parameter-sharding axis")
        if param_axes:
            # "model": Megatron col/row tensor parallelism; "expert": whole
            # experts per rank (models/moe.py). Either way the update is
            # the tree update over this rank's blocks (parallel/tp.py)
            self._tp_axis = param_axes[0]
            if self._tp_axis == "expert" and cfg.policy_experts is None:
                raise ValueError(
                    'an "expert" mesh axis needs an MoE policy — set '
                    "policy_experts")
        if "seq" in axes[1:]:
            sp = shape[axes.index("seq")]
            if self.n_steps % sp != 0:
                raise ValueError(
                    f"steps per iteration ({self.n_steps} = "
                    f"ceil(batch_timesteps/n_envs)) must divide evenly "
                    f"over the seq={sp} mesh axis")
        self.mesh = make_mesh(shape, axes, device=self.device)
        self.device = self.mesh.device
        self._group = self.mesh.group(axes[0])
        self._dp, self._dp_rank = dp, self.mesh.coordinate(axes[0])
        if "seq" in axes[1:]:
            self._seq_group = self.mesh.group("seq")
        self.n_envs //= dp

    def _policy_family(self, action_spec, family):
        """``make(tp=None)``: the config's policy family (recurrent with
        ``policy_gru``, MoE with ``policy_experts``, else MLP or conv) over
        this env's spaces, its forward on this rank's blocks with ``tp``."""
        cfg = self.cfg
        if cfg.policy_gru is not None:
            return lambda tp=None: make_recurrent_policy(
                self.obs_shape, action_spec, gru_size=cfg.policy_gru,
                cell=cfg.policy_cell, tp=tp, **family)
        if cfg.policy_experts is not None:
            return lambda tp=None: make_moe_policy(
                self.obs_shape, action_spec, n_experts=cfg.policy_experts,
                tp=tp, **family)
        return lambda tp=None: make_policy(self.obs_shape, action_spec,
                                           tp=tp, **family)

    def _setup_param_axis(self, make) -> None:
        """The split of every policy leaf over the parameter axis (from a
        throwaway init: the layout depends on the shapes only), and the
        policy rebuilt to run its forward on this rank's blocks."""
        from trpo_torch.parallel.tp import model_axis, policy_param_shardings

        full = self.policy.init(torch.Generator().manual_seed(0))
        self._tp_specs = policy_param_shardings(full, self.mesh,
                                                self._tp_axis)
        self.policy = make(model_axis(self.mesh, self._tp_axis,
                                      self._tp_specs))

    def _setup_host_mesh(self) -> None:
        """Host envs on a mesh: this data rank steps its slice of the
        envs (built with the slice's global offset), the observation
        statistics fold every data rank's rows of a step in global row
        order, and the host pipeline's groups are this rank's share of
        the one-rank run's groups."""
        from trpo_torch.ops.allreduce import all_gather_cat

        if self.cfg.host_pipeline_groups > 1 and (
                self.cfg.host_pipeline_groups % self._dp):
            raise ValueError(
                f"host_pipeline_groups={self.cfg.host_pipeline_groups} "
                f"must divide evenly over the {self.mesh.axis_names[0]}="
                f"{self._dp} mesh axis (each data rank steps its share of "
                "the groups)")
        group, dev = self._group, self.device

        def gather(batch: np.ndarray) -> np.ndarray:
            t = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
            return all_gather_cat(t, group).cpu().numpy()

        if getattr(self.env, "has_obs_norm", False):
            self.env.fold_across(gather)

    def _sampling_policy(self, policy):
        """``policy`` for the rollout: on a mesh its samples draw the noise
        of every rank's envs and keep this rank's slice."""
        if self.mesh is None:
            return policy
        from trpo_torch.parallel.sharded import global_draw_policy

        return global_draw_policy(policy, self._dp_rank, self._dp)

    def _check_host_options(self) -> None:
        """The reference's construction-time checks of the host options."""
        cfg = self.cfg
        if cfg.rollout_chunk is not None and not self.is_device_env:
            raise ValueError(
                "rollout_chunk applies to device envs (the time-chunked "
                "rollout); host-simulator envs collect with host_rollout "
                "and have nothing to chunk — set rollout_chunk=None")
        if cfg.host_async_pipeline:
            if self.is_device_env:
                raise ValueError(
                    "host_async_pipeline applies to host-simulator envs "
                    "(gym:/native:); device envs chunk the host syncs with "
                    "fuse_iterations instead")
            if self.is_recurrent:
                raise ValueError(
                    "host_async_pipeline supports feedforward policies "
                    "only (the recurrent window-replay carry is threaded "
                    "through the serial driver); set policy_gru=None or "
                    "host_async_pipeline=False")
        if cfg.host_pipeline_groups > 1:
            if self.is_device_env:
                raise ValueError(
                    "host_pipeline_groups applies to host-simulator envs "
                    "(gym:/native:); device envs have no host loop to "
                    "pipeline")
            if self.is_recurrent:
                raise ValueError(
                    "host_pipeline_groups supports feedforward policies "
                    "only (recurrent window-replay bookkeeping is not "
                    "pipelined); set policy_gru=None or groups=1")
            if not hasattr(self.env, "host_step_slice"):
                raise ValueError(
                    f"{type(self.env).__name__} has no host_step_slice — "
                    "group stepping is unavailable for this adapter")
            # on a mesh the adapter holds this data rank's slice
            env_count = getattr(self.env, "n_envs", self.n_envs) * self._dp
            if cfg.host_pipeline_groups > env_count:
                raise ValueError(
                    f"host_pipeline_groups={cfg.host_pipeline_groups} "
                    f"exceeds the adapter's n_envs={env_count}")
        self._host_inference_cpu = cfg.host_inference == "cpu"
        if self._host_inference_cpu and self.is_device_env:
            raise ValueError(
                'host_inference="cpu" applies to host-simulator envs '
                "(gym:/native:); device envs have no host inference to "
                "move")

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Params from CPU generators seeded by ``seed`` (the same weights
        on every device); rollout noise from a generator on the device."""
        seed = self.cfg.seed if seed is None else seed
        g_policy = torch.Generator().manual_seed(seed)
        g_vf = torch.Generator().manual_seed(seed + 1)
        rng = torch.Generator(device=self.device).manual_seed(seed + 2)
        policy_params = _to(self.policy.init(g_policy), self.device)
        if self._tp_axis is not None:
            policy_params = self._shard_params(policy_params)
        if self.is_device_env:
            env_carry = init_env_states(self._roll_env, self.n_envs, rng,
                                        policy=self.policy)
        elif self.is_recurrent:
            # the env lives in the adapter; the policy's memory is ours
            env_carry = self._fresh_policy_state()
        else:
            env_carry = None
        if self._obs_norm_on_device:
            obs_norm = init_stats(self.obs_shape, self.device)
        elif self._obs_norm_host:
            obs_norm = self._host_obs_norm()
        else:
            obs_norm = None
        return TrainState(
            policy_params=policy_params,
            vf_state=_to(self.vf.init(g_vf), self.device),
            env_carry=env_carry,
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
            obs_norm=obs_norm,
            host_rng=torch.Generator().manual_seed(seed + 3)
            if self._host_inference_cpu else None,
            metrics=init_device_metrics(self.device),
        )

    def _shard_params(self, params):
        """This rank's blocks of full policy params; a layout that splits
        no leaf raises the reference's error."""
        from trpo_torch.parallel.tp import shard_policy_params, shards_anything

        if not shards_anything(self._tp_specs):
            mp = self.mesh.shape[self._tp_axis]
            if self._tp_axis == "expert":
                dims = f"n_experts={self.cfg.policy_experts}"
            else:
                dims = f"hidden={tuple(self.cfg.policy_hidden)}"
                if self.is_recurrent:
                    dims += f", gru_size={self.cfg.policy_gru}"
            raise ValueError(
                f"parameter sharding over {self._tp_axis}={mp} shards "
                f"nothing: no policy dimension ({dims}) divides the axis — "
                "resize the model or the mesh")
        return shard_policy_params(params, self.mesh, self._tp_axis,
                                   self._tp_specs)

    @property
    def param_layout(self):
        """``(axis, split dims of the policy's leaves)`` on a parameter
        axis, else None: what ``Checkpointer(mesh=, param_layout=)``
        gathers and cuts the params by."""
        if self._tp_axis is None:
            return None
        return self._tp_axis, self._tp_specs

    def gather_params(self, params):
        """Full policy params from this rank's blocks (a collective over
        the parameter axis); ``params`` itself without one."""
        if self._tp_axis is None:
            return params
        from trpo_torch.parallel.tp import gather_policy_params

        return gather_policy_params(params, self.mesh, self._tp_specs,
                                    self._tp_axis)

    def _check_finite(self, stage: str, tree) -> None:
        """``cfg.debug_nans``: raise ``FloatingPointError`` naming
        ``stage`` when a floating tensor of ``tree`` holds a nonfinite
        value (one host read per call; a debug mode)."""
        if not self.cfg.debug_nans:
            return
        leaves = [t for t in tree_leaves(tree)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if leaves and not bool(torch.stack(
                [torch.isfinite(t).all() for t in leaves]).all()):
            raise FloatingPointError(
                f"debug_nans: a nonfinite value in the {stage}'s outputs")

    def _fresh_policy_state(self):
        """A recurrent policy's fresh host-env carry ``(h, prev_done)``."""
        return (self.policy.initial_state(self.n_envs, device=self.device),
                torch.ones(self.n_envs, dtype=torch.bool,
                           device=self.device))

    def _host_obs_norm(self) -> RunningStats:
        """The adapter's statistics as the f32 ``TrainState`` mirror."""
        return RunningStats(*(torch.as_tensor(np.asarray(x),
                                              device=self.device)
                              for x in self.env.obs_stats_state()))

    def _push_obs_norm(self, stats: RunningStats) -> None:
        """Install ``TrainState.obs_norm`` in the adapter."""
        self.env.set_obs_stats_state(
            tuple(x.detach().cpu().numpy() for x in stats))

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

    def _advantages(self, vf_state: VFState, traj: Trajectory, lam=None):
        """``(advantages, value targets, values)``; ``lam`` (a float)
        overrides ``cfg.lam``: the per-member axis of ``Population``
        sweeps."""
        T, N = traj.rewards.shape
        vf_in, vf_next_in = self._vf_features(traj)
        with torch.no_grad():
            values = self.vf.predict(vf_state, vf_in).reshape(T, N)
            next_values = self.vf.predict(vf_state, vf_next_in).reshape(T, N)
        lam = self.cfg.lam if lam is None else lam
        if self._seq_group is not None:
            # sequence-parallel GAE: this rank scans its block of time on
            # K2, the blocks exchange their summaries, and the window is
            # gathered back over the seq axis
            from trpo_torch.parallel.seq import make_seq_gae

            sp, s = self.mesh.shape["seq"], self.mesh.coordinate("seq")
            k = T // sp
            blk = lambda x: x[s * k:(s + 1) * k].contiguous()  # noqa: E731
            adv, vtarg = make_seq_gae(self.mesh, self.cfg.gamma, lam)(
                blk(traj.rewards), blk(values), blk(next_values),
                blk(traj.terminated), blk(traj.done))
            return (all_gather_cat(adv, self._seq_group),
                    all_gather_cat(vtarg, self._seq_group), values)
        adv, vtarg = gae_from_next_values(
            traj.rewards, values, next_values, traj.terminated, traj.done,
            self.cfg.gamma, lam,
        )
        return adv, vtarg, values

    def _batch_phase(self, train_state: TrainState, traj: Trajectory,
                     roll_stats, lam=None, stale: bool = False):
        """The head of the policy phase: obs-norm fold → GAE → advantage
        standardization → ``TRPOBatch``. Returns ``(batch, aux)``, ``aux``
        holding what :meth:`_merge_phase` needs.

        ``roll_stats`` are the normalization statistics the rollout used:
        ``train_state.obs_norm`` on the serial path, one window older under
        the overlap. The trajectory, the behavior distributions and the
        anchor all live in that one normalization space; the raw window is
        folded into the current statistics exactly once.

        ``stale`` (the overlap's steady windows, collected by the params
        one update old): the KL/Fisher anchor is recomputed at the current
        params (detached) and the importance weight π_anchor/π_behavior
        multiplies the surrogate's ratio, so the trust region is taken
        around the policy being updated."""
        cfg = self.cfg
        T, N = traj.rewards.shape
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])  # noqa: E731
        self._check_finite("rollout", (traj.obs, traj.actions, traj.rewards))

        new_obs_norm = train_state.obs_norm
        if self._obs_norm_on_device:
            # the statistics the rollout used, so the replayed
            # distributions match old_dist; the raw observations are
            # folded in afterwards, for the next iteration
            new_obs_norm = update_stats(train_state.obs_norm, flat(traj.obs),
                                        self._group)
            traj = traj._replace(obs=normalize(roll_stats, traj.obs),
                                 next_obs=normalize(roll_stats,
                                                    traj.next_obs))

        adv, vtarg, values = self._advantages(train_state.vf_state, traj,
                                              lam)
        self._check_finite("advantages", (adv, vtarg))
        weight = torch.ones(T * N, device=adv.device)
        adv_flat = flat(adv)
        if cfg.standardize_advantages:
            adv_flat = standardize_advantages(adv_flat, weight, self._group)
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
        if self.mesh is not None:
            # the rows' indices in the one-rank batch (t·N + env), so the
            # curvature subsample keeps the one-rank run's rows
            n_all = N * self._dp
            cols = self._dp_rank * N + torch.arange(N)
            batch = batch._replace(
                row_ids=cols if self.is_recurrent
                else (torch.arange(T)[:, None] * n_all + cols).reshape(-1))
        if stale:
            with torch.no_grad():
                anchor = self.policy.apply(train_state.policy_params,
                                           batch.obs)
                logp_anchor = self.policy.dist.logp(anchor, batch.actions)
                logp_behavior = self.policy.dist.logp(batch.old_dist,
                                                      batch.actions)
            batch = batch._replace(
                old_dist=anchor,
                is_weight=torch.exp(logp_anchor - logp_behavior))

        done_f = traj.done.float()
        g = self._group
        n_episodes = all_sum(traj.done.sum(), g)
        ep_denom = torch.clamp(n_episodes, min=1)
        no_eps = n_episodes == 0
        nan = torch.full((), float("nan"), device=adv.device)
        aux = {
            "vf_in": vf_in,
            "vtarg": flat(vtarg),
            "values": flat(values),
            "weight": weight,
            "new_obs_norm": new_obs_norm,
            "n_episodes": n_episodes,
            "mean_episode_reward": torch.where(
                no_eps, nan,
                all_sum(torch.sum(traj.episode_return * done_f), g)
                / ep_denom),
            "mean_episode_length": torch.where(
                no_eps, nan,
                all_sum(torch.sum(traj.episode_length.float() * done_f), g)
                / ep_denom),
        }
        return batch, aux

    def _merge_phase(self, train_state: TrainState, new_policy_params,
                     trpo_stats, aux):
        """The tail of the policy phase: the update's outputs folded into
        the state (all of it but ``vf_state``), and the pack the critic
        phase consumes."""
        T_N = aux["weight"].shape[0]
        self._check_finite("policy update", new_policy_params)
        new_state = train_state._replace(
            policy_params=new_policy_params,
            iteration=train_state.iteration + 1,
            total_episodes=train_state.total_episodes + aux["n_episodes"],
            total_timesteps=train_state.total_timesteps + T_N * self._dp,
            precond=trpo_stats.precond_next
            if trpo_stats.precond_next is not None
            else train_state.precond,
            cg_damping=trpo_stats.damping_next
            if self.cfg.adaptive_damping else train_state.cg_damping,
            ladder=trpo_stats.ladder_next
            if trpo_stats.ladder_next is not None
            else train_state.ladder,
            obs_norm=aux["new_obs_norm"],
            metrics=accumulate_update(train_state.metrics, trpo_stats)
            if train_state.metrics is not None else None,
        )
        fit_pack = {
            "vf_in": aux["vf_in"],
            "vtarg": aux["vtarg"],
            "values": aux["values"],
            "weight": aux["weight"],
            "trpo_stats": trpo_stats._replace(precond_next=None,
                                              ladder_next=None),
            "total_episodes": new_state.total_episodes,
            "mean_episode_reward": aux["mean_episode_reward"],
            "mean_episode_length": aux["mean_episode_length"],
            "episodes_in_batch": aux["n_episodes"].to(torch.int32),
            # the post-update ladder: its counters surface in the stats
            "ladder": new_state.ladder,
            "metrics": new_state.metrics,
        }
        return new_state, fit_pack

    def _policy_phase(self, train_state: TrainState, traj: Trajectory,
                      lam=None):
        """Advantages → TRPO policy update → episode scalars. Returns the
        state advanced in everything but ``vf_state``, and the pack the
        critic phase consumes."""
        batch, aux = self._batch_phase(train_state, traj,
                                       train_state.obs_norm, lam)
        new_policy_params, trpo_stats = self.trpo_update(
            train_state.policy_params, batch, train_state.cg_damping,
            train_state.precond, train_state.ladder,
        )
        return self._merge_phase(train_state, new_policy_params, trpo_stats,
                                 aux)

    def _vf_stats_phase(self, vf_state: VFState, fit_pack):
        """Critic fit (after the advantages, the reference's ordering) and
        the stats dict."""
        s = fit_pack["trpo_stats"]
        new_vf_state, vf_loss = self.vf.fit(
            vf_state, fit_pack["vf_in"], fit_pack["vtarg"],
            fit_pack["weight"], group=self._group,
        )
        self._check_finite("critic fit", new_vf_state)
        stats = {
            "total_episodes": fit_pack["total_episodes"],
            "mean_episode_reward": fit_pack["mean_episode_reward"],
            "entropy": s.entropy,
            "vf_explained_variance": explained_variance(
                fit_pack["values"], fit_pack["vtarg"], fit_pack["weight"],
                self._group,
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
        if fit_pack.get("metrics") is not None:
            stats.update(metrics_stats(fit_pack["metrics"]))
        return new_vf_state, stats

    def _process_trajectory(self, train_state: TrainState, traj: Trajectory,
                            lam=None):
        """advantages → TRPO update → critic fit → stats; ``lam``
        overrides ``cfg.lam``."""
        state, fit_pack = self._policy_phase(train_state, traj, lam)
        new_vf_state, stats = self._vf_stats_phase(state.vf_state, fit_pack)
        return state._replace(vf_state=new_vf_state), stats

    def run_iteration(self, train_state: TrainState, lam=None):
        """One training iteration; returns ``(new_state, stats)`` with the
        stats as 0-d tensors (read them on the host when needed). ``lam``
        (a float) overrides ``cfg.lam`` for this iteration's GAE
        (``Population`` sweeps)."""
        if not self.is_device_env:
            train_state, traj = self._host_collect(train_state)
            return self._process_trajectory(train_state, traj, lam)
        new_carry, traj = device_rollout(
            self._roll_env,
            self._sampling_policy(self._normed_policy(train_state.obs_norm)),
            train_state.policy_params, train_state.env_carry,
            train_state.rng, self.n_steps, chunk=self.cfg.rollout_chunk,
        )
        train_state = train_state._replace(env_carry=new_carry)
        return self._process_trajectory(train_state, traj, lam)

    # ------------------------------------------------------------------
    # host envs
    # ------------------------------------------------------------------

    def _make_host_act(self):
        """The cached act function of the training rollouts; CPU inference
        has no device round trip to save, so it fetches unpacked. On a
        mesh the serial rollout samples the global noise; the pipeline's
        groups each draw from their own generator already."""
        if self._host_act_fn is None:
            policy = (self.policy if self.cfg.host_pipeline_groups > 1
                      else self._sampling_policy(self.policy))
            self._host_act_fn = make_host_act_fn(
                policy, pack=not self._host_inference_cpu)
        return self._host_act_fn

    def _rollout_inputs(self, train_state: TrainState):
        """``(params, generator)`` of a host rollout: the state's, or their
        CPU copies with ``host_inference="cpu"``."""
        if self._host_inference_cpu:
            return _to(train_state.policy_params, "cpu"), train_state.host_rng
        return train_state.policy_params, train_state.rng

    def _host_collect(self, train_state: TrainState, timer=None):
        """One window of the host env: ``(state, Trajectory)`` with the
        trajectory on the agent's device, the state's ``obs_norm`` mirror
        and recurrent carry advanced."""
        cfg = self.cfg
        if self._obs_norm_host:
            # TrainState is the checkpointed source of truth: its stats go
            # into the adapter before the window, the adapter's come back
            self._push_obs_norm(train_state.obs_norm)
        params, gen = self._rollout_inputs(train_state)
        act_fn = self._make_host_act()
        if cfg.host_pipeline_groups > 1:
            n_groups = cfg.host_pipeline_groups // self._dp
            traj = pipelined_host_rollout(
                self.env, self.policy, params, gen, self.n_steps,
                n_groups=n_groups, act_fn=act_fn,
                stage_to_device=cfg.host_staged_transfers,
                device=self.device, timer=timer,
                group_offset=self._dp_rank * n_groups,
                total_groups=cfg.host_pipeline_groups)
        elif self.is_recurrent:
            policy_state = train_state.env_carry
            if self._host_env_reset_pending:
                # evaluate() hard-reset the envs: stale memory must not
                # leak into the fresh episodes
                policy_state = self._fresh_policy_state()
                self._host_env_reset_pending = False
            traj, (h, prev_done) = host_rollout(
                self.env, self.policy, params, gen, self.n_steps,
                act_fn=act_fn, device=self.device,
                policy_state=_to(policy_state, params_device(params)))
            train_state = train_state._replace(
                env_carry=(h.to(self.device), prev_done.to(self.device)))
        else:
            traj = host_rollout(self.env, self.policy, params, gen,
                                self.n_steps, act_fn=act_fn,
                                device=self.device)
        if self._obs_norm_host:
            train_state = train_state._replace(
                obs_norm=self._host_obs_norm())
        if self._tp_axis is not None:
            self._check_model_peers(traj)
        return train_state, traj

    def _check_model_peers(self, traj) -> None:
        """The ranks of one data coordinate step copies of the same host
        envs, which stay equal by determinism alone: a worker restart on
        one of them (a fault its peers do not share) parts the copies, and
        the sharded forward would then mix their rows. One all-gather a
        window over every rank compares the window's observations within
        each data coordinate, and every rank raises when any differ (so no
        rank is left waiting in a collective)."""
        import torch.distributed as dist

        x = torch.cat([leaf.reshape(-1).double()
                       for leaf in tree_leaves(traj.obs)])
        sig = all_gather_cat(torch.stack([
            torch.tensor(float(self._dp_rank), dtype=torch.float64,
                         device=x.device), x.sum(), (x * x).sum()])[None],
            dist.group.WORLD).cpu()
        if any(len({tuple(r[1:].tolist()) for r in sig if r[0] == d}) > 1
               for d in range(self._dp)):
            raise RuntimeError(
                f'the host envs of this data rank\'s "{self._tp_axis}" '
                "peers no longer agree (a worker restarted on one of them "
                "alone): a host env on a parameter axis cannot go on from "
                "such a fault — resume from the last checkpoint")

    def snapshot_host_env(self):
        """The host simulator's resume state, or None (device envs keep
        theirs in ``TrainState.env_carry``). On a mesh every rank calls
        it: the per-env entries of every data rank's snapshot are gathered
        in rank order, into the snapshot a one-rank run takes."""
        if self.is_device_env or not hasattr(self.env,
                                             "env_state_snapshot"):
            return None
        snap = self.env.env_state_snapshot()
        if self.mesh is None:
            return snap
        return _map_env_axis(snap, self.n_envs,
                             lambda x: _gather_objects(x, self._group))

    def restore_host_env(self, snapshot) -> None:
        """Install a :meth:`snapshot_host_env` snapshot (None: nothing);
        on a mesh, this data rank's slice of it."""
        if snapshot is None:
            return
        if self.is_device_env or not hasattr(self.env, "env_state_restore"):
            raise ValueError(
                "this agent's env has no host snapshot surface — the "
                "sidecar belongs to a gym:/native: adapter run")
        if self.mesh is not None:
            lo = self._dp_rank * self.n_envs
            snapshot = _map_env_axis(snapshot, self.n_envs * self._dp,
                                     lambda x: x[lo:lo + self.n_envs])
        self.env.env_state_restore(snapshot)

    def run_iterations(self, train_state: TrainState, n: int):
        """``n`` iterations back to back with no host read in between
        (beyond an audited update's one read of the ladder's pin flag);
        returns ``(state, stats)`` with every stat stacked on the device
        along a leading ``(n,)`` axis."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if self._overlap:
            # the overlapped loop is a host-driven pipeline with the same
            # (state, stacked stats) contract
            train_state, rows = self._overlap_run(train_state, n)
        else:
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
        batch. A device env's statistics (``state.obs_norm``) normalize it
        here; a host adapter's observations arrive normalized already, so
        a host-normalized agent applies the policy to ``obs`` as given, as
        the reference does. Returns ``(action,
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
        if self._obs_norm_on_device:
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

    # ------------------------------------------------------------------
    # serving (trpo_torch/serve)
    # ------------------------------------------------------------------

    def _serve_obs_dtype(self, obs_dtype):
        """The observation dtype the engines take: the caller's, else the
        env's (uint8 pixels stay uint8), else f32."""
        if obs_dtype is not None:
            return np.dtype(obs_dtype)
        return np.uint8 if len(self.obs_shape) == 3 else np.float32

    def _check_whole_params(self) -> None:
        """Serving runs one process over whole params: a policy sharded
        over a parameter axis serves from its gathered checkpoint."""
        if self._tp_axis is not None:
            raise ValueError(
                f'this agent shards its policy over a "{self._tp_axis}" mesh '
                "axis; a serving engine runs whole params in one process — "
                "build it on a meshless agent and load the checkpoint this "
                "run writes (gathered, as a one-rank run writes it)")

    def serve_engine(self, batch_shapes=None, obs_dtype=None):
        """The policy-inference engine over this agent's policy
        (``serve/engine.InferenceEngine``): eval-mode ``act`` at a fixed
        rung ladder (``cfg.serve_batch_shapes`` by default), one CUDA graph
        per rung on the agent's card. Load it with a state's
        ``(policy_params, obs_norm)`` and serve it through
        ``serve.MicroBatcher``/``serve.PolicyServer``. It normalizes when
        this agent normalizes (device or host-adapter statistics: both
        ride ``TrainState.obs_norm``), so clients send raw observations.
        Feedforward policies only."""
        from trpo_torch.serve.engine import InferenceEngine

        self._check_whole_params()
        if self.is_recurrent:
            raise ValueError(
                "serve_engine supports feedforward policies only — a "
                "recurrent policy's hidden state is per-client session "
                "state the stateless /act data plane cannot carry; use "
                "serve_session_engine() (the POST /session protocol)"
            )
        return InferenceEngine(
            self.policy,
            self.obs_shape,
            batch_shapes=tuple(batch_shapes if batch_shapes is not None
                               else self.cfg.serve_batch_shapes),
            with_obs_norm=self._obs_norm_on_device or self._obs_norm_host,
            obs_dtype=self._serve_obs_dtype(obs_dtype),
            device=self.device,
        )

    def serve_session_engine(self, obs_dtype=None, batch_shapes=None):
        """The recurrent twin of :meth:`serve_engine`
        (``serve/session.RecurrentServeEngine``): the eval-mode
        ``policy.step`` over ``(carry, obs)`` at a fixed rung ladder
        (``cfg.serve_session_batch_shapes`` by default), for the ``POST
        /session`` protocol. Recurrent policies only."""
        from trpo_torch.serve.session import RecurrentServeEngine

        self._check_whole_params()
        if not self.is_recurrent:
            raise ValueError(
                "serve_session_engine supports recurrent policies only — "
                "a feedforward policy has no carry to thread; use "
                "serve_engine() (the stateless POST /act plane)"
            )
        return RecurrentServeEngine(
            self.policy,
            self.obs_shape,
            with_obs_norm=self._obs_norm_on_device or self._obs_norm_host,
            obs_dtype=self._serve_obs_dtype(obs_dtype),
            batch_shapes=tuple(batch_shapes if batch_shapes is not None
                               else self.cfg.serve_session_batch_shapes),
            device=self.device,
        )

    def evaluate(self, train_state: TrainState,
                 n_steps: Optional[int] = None, seed: int = 0,
                 render: bool = False):
        """Greedy evaluation: ``n_steps`` per env (default: one training
        window) of mode actions. Returns ``(mean_episode_reward,
        episodes_completed)`` over the episodes that finish in the window;
        with none finished, the mean partial-episode return (a lower
        bound) and 0. ``render=True`` (a host adapter with a renderer,
        e.g. ``gym:`` made with ``render_mode="rgb_array"``) adds one RGB
        frame of env 0 per step as a third element.

        A device env evaluates on a fresh carry from a generator seeded by
        ``seed``; the training carry and generator are untouched. A host
        env is shared state: it is reset with ``seed`` before and
        hard-reset after (the next ``learn`` starts from fresh episodes),
        and its normalization statistics are frozen throughout, so the
        training statistics do not move."""
        n_steps = self.n_steps if n_steps is None else n_steps
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        frames: list = []
        step_callback = None
        if render:
            if self.is_device_env or not hasattr(self.env, "render_frame"):
                raise ValueError(
                    "render=True needs a host adapter with a renderer — "
                    "construct the env with rendering enabled, e.g. "
                    "envs.make('gym:<Id>', render_mode='rgb_array') "
                    "(device envs and the native C++ stepper have no "
                    "pixel renderer)")
            step_callback = lambda t: frames.append(  # noqa: E731
                self.env.render_frame())
        if self.is_device_env:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            carry = init_env_states(self.env, self.n_envs, gen,
                                    policy=self.policy)
            _, traj = device_rollout(
                self.env, self._normed_policy(train_state.obs_norm),
                train_state.policy_params, carry, gen, n_steps,
                deterministic=True,
            )
        else:
            traj = self._host_evaluate(train_state, n_steps, seed,
                                       step_callback)
        done = traj.done
        n_done = done.sum()
        mean_done = torch.sum(traj.episode_return * done) / torch.clamp(
            n_done, min=1)
        n_done, mean_done, mean_partial = torch.stack([
            n_done.double(), mean_done.double(),
            traj.episode_return[-1].mean().double()]).tolist()
        out = (mean_done, int(n_done)) if n_done else (mean_partial, 0)
        return out + (frames,) if render else out

    def _host_evaluate(self, train_state: TrainState, n_steps: int,
                       seed: int, step_callback):
        """The greedy window on the host env (see :meth:`evaluate`)."""
        if self._obs_norm_host:
            self._push_obs_norm(train_state.obs_norm)
            self.env.freeze_obs_stats(True)
        params, _ = self._rollout_inputs(train_state)
        gen = torch.Generator(device=params_device(params)).manual_seed(seed)
        try:
            self.env.reset_all(seed=seed)
            if self.is_recurrent:
                # the hard resets make the carried training memory stale
                self._host_env_reset_pending = True
                traj, _ = host_rollout(
                    self.env, self.policy, params, gen, n_steps,
                    deterministic=True, step_callback=step_callback,
                    device=self.device)
            else:
                if self._host_eval_act_fn is None:
                    self._host_eval_act_fn = make_host_act_fn(
                        self.policy, deterministic=True,
                        pack=not self._host_inference_cpu)
                traj = host_rollout(
                    self.env, self.policy, params, gen, n_steps,
                    act_fn=self._host_eval_act_fn,
                    step_callback=step_callback, device=self.device)
        finally:
            # hard-reset even on failure, so training resumes from clean
            # episode boundaries
            try:
                self.env.reset_all()
            finally:
                if self._obs_norm_host:
                    self.env.freeze_obs_stats(False)
        return traj

    # ------------------------------------------------------------------
    # learn: the serial training loop
    # ------------------------------------------------------------------

    def learn(self, n_iterations: Optional[int] = None,
              state: Optional[TrainState] = None,
              logger: Optional[StatsLogger] = None, checkpointer=None,
              callback=None, telemetry=None) -> TrainState:
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
        a multiple of ``cfg.checkpoint_every``, with the host env's
        snapshot as the step's sidecar. Host envs run one iteration a
        chunk; with ``cfg.host_async_pipeline`` they run the asynchronous
        driver (:meth:`_learn_host_async`), where the stop rules act as
        the stats drain (up to ``cfg.stats_drain_maxsize`` iterations
        late) and ``callback`` runs on the drain thread. With
        ``cfg.train_overlap`` it runs the overlapped loop
        (:meth:`_learn_overlap`): one iteration a chunk, and a stop
        discards the window already collected for the next update.

        ``telemetry`` (an ``obs.Telemetry``) routes the run through the
        event bus, as in the reference: the run manifest at the start, an
        iteration event per row (the logger re-emits through the bus),
        the health rules and memory gauges on each row, the recompile
        monitor marked steady after two iterations, the profiler window,
        and the phase summaries at the end (in a ``finally``, so a
        raising run still closes its profiler window). ``learn`` drives
        its lifecycle; the creator closes it.

        On a mesh every rank calls ``learn``: rank 0 alone logs rows (the
        others log to nowhere), drives ``telemetry`` and writes through
        ``checkpointer``, which is given the mesh so that it saves the
        gathered global state; a preemption signal on any rank stops every
        rank at the same chunk boundary."""
        cfg = self.cfg
        n_iterations = n_iterations or cfg.n_iterations
        state = self.init_state() if state is None else state
        quiet = None
        if self.mesh is not None:
            if checkpointer is not None and checkpointer.mesh is None:
                checkpointer.mesh = self.mesh
                checkpointer.param_layout = self.param_layout
            if not self.mesh.is_writer:
                quiet = open(os.devnull, "w")
                logger, telemetry = StatsLogger(stream=quiet), None
        own_logger = logger is None
        logger = logger or StatsLogger(jsonl_path=cfg.log_jsonl)
        timer = PhaseTimer(use_profiler=telemetry is not None
                           and telemetry.profile_dir is not None)
        bus = telemetry.bus if telemetry is not None else None
        if telemetry is not None:
            telemetry.attach_timer(timer)
            if logger.bus is None:
                # one schema for the JSONL rows and the event stream
                logger.bus = bus
            telemetry.start_run(
                cfg, device=self.device, n_iterations=n_iterations,
                driver="overlap" if self._overlap else "async"
                if cfg.host_async_pipeline and not self.is_device_env
                else "serial")
        recovery = (RecoveryPolicy(cfg, bus=bus)
                    if cfg.recover_on_nan == "restore" else None)
        guard = PreemptionGuard(enabled=cfg.on_preempt == "checkpoint")
        injector = (FaultInjector.from_spec(cfg.inject_faults, bus=bus)
                    if cfg.inject_faults else None)
        if isinstance(self.env, SupervisedEnv):
            # the pool reports restarts and degradation on the run's bus,
            # and hosts the env-level faults (kill/hang/delay)
            if bus is not None and self.env.bus is None:
                self.env.bus = bus
            if injector is not None:
                self.env.injector = injector
        driver = None
        if cfg.host_async_pipeline and not self.is_device_env:
            driver = lambda: self._learn_host_async(  # noqa: E731
                n_iterations, state, logger, checkpointer, callback, timer,
                recovery, guard, telemetry, injector=injector)
        elif self._overlap:
            driver = lambda: self._learn_overlap(  # noqa: E731
                n_iterations, state, logger, checkpointer, callback, timer,
                guard, telemetry)
        if driver is not None:
            try:
                with guard:
                    return driver()
            finally:
                if telemetry is not None:
                    telemetry.finish_run(timer)
                if own_logger:
                    logger.close()
        chunk = max(1, cfg.fuse_iterations) if self.is_device_env else 1
        steps_per_iter = self.n_steps * self.n_envs
        reward_running = RunningEpisodeMean()
        # absolute iteration base: the recovery rewind counts in absolute
        # iterations, across a resume
        it0 = state.iteration
        try:
            with guard:
                done = 0
                while done < n_iterations:
                    if self.mesh is not None:
                        self._agree_preempt(guard)
                    if guard.triggered:
                        # every finished chunk's rows are processed, so
                        # the state is clean to persist
                        self._preempt_shutdown(state, checkpointer, guard,
                                               bus)
                    if recovery is not None:
                        # parked before the injector can poison the state
                        recovery.snapshot(it0 + done + 1, state)
                    k = min(chunk, n_iterations - done)
                    if injector is not None:
                        # span=k: a fused chunk's fault lands at its start
                        state = injector.before_iteration(
                            it0 + done + 1, state, span=k)
                    if telemetry is not None:
                        # span=k: the window opens for the chunk that
                        # contains the requested iteration
                        telemetry.profile_tick(it0 + done + 1, span=k)
                    with timer.phase("iteration"):
                        state, stack = self.run_iterations(state, k)
                        rows = _host_rows(stack)
                    done += k
                    if telemetry is not None and done >= 2:
                        # every kernel has been built by now: a later
                        # build or capture is unexpected
                        telemetry.mark_steady()
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
                            recovery=recovery, telemetry=telemetry,
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
                        checkpointer.save(it_end, state,
                                          host_env=self.snapshot_host_env())
                    if stop:
                        break
                if injector is not None:
                    self._warn_unfired_faults(injector, bus)
        finally:
            if telemetry is not None:
                telemetry.finish_run(timer)
            if own_logger:
                logger.close()
            if quiet is not None:
                quiet.close()
        return state

    def _agree_preempt(self, guard) -> None:
        """One all-reduce MAX over every rank of the preemption flag (and
        its signal number): a signal to any rank triggers every rank's
        guard at the same chunk boundary."""
        import torch.distributed as dist

        flag = all_max(torch.tensor([int(guard.triggered),
                                     int(guard.signum or 0)],
                                    device=self.device),
                       dist.group.WORLD)
        if flag[0] and not guard.triggered:
            guard.triggered, guard.signum = True, int(flag[1])

    @staticmethod
    def _warn_unfired_faults(injector, bus) -> None:
        """A completed run whose chaos specs never fired exercised nothing
        for them: say so, on the bus (a ``health`` ``fault_unfired``
        warning) or through ``warnings``."""
        unfired = injector.unfired
        if not unfired:
            return
        msg = ("fault spec(s) never fired: " + "; ".join(unfired) + " — the "
               "run completed without exercising them (trigger beyond the "
               "run's steps/iterations, or an env without the targeted "
               "workers)")
        if bus is not None:
            bus.emit("health", check="fault_unfired", level="warn",
                     message=msg, data={"unfired": list(unfired)})
        else:
            import warnings

            warnings.warn(msg)

    def _finish_iteration_stats(self, host_stats, reward_running, logger, *,
                                iteration: int, iteration_ms: float,
                                timesteps_total: int,
                                recovery=None, telemetry=None) -> bool:
        """Add the running episode mean, the wall-clock fields and the
        timestep total to one iteration's host stats, log the row, then
        apply the stop rules: raise on NaN entropy, return True on
        ``cfg.reward_target`` or ``cfg.stop_on_explained_variance``. With
        ``recovery``, a nonfinite row is logged and flagged for the loop
        instead, and not folded into the running mean. ``telemetry`` sees
        every logged row before the NaN abort can raise, so its finding
        reaches the sinks on the abort path too."""
        cfg = self.cfg

        def log():
            host_stats["reward_running"] = reward_running.mean
            host_stats["time_elapsed_min"] = logger.elapsed_minutes()
            host_stats["iteration_ms"] = iteration_ms
            host_stats["timesteps_total"] = timesteps_total
            logger.log(iteration, host_stats)
            if telemetry is not None:
                telemetry.on_iteration(iteration, host_stats)

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

    def _preempt_shutdown(self, state: TrainState, checkpointer, guard,
                          bus=None):
        """The orderly preemption exit: a final checkpoint (unless the
        cadence has just written this step), the ``preempted`` health
        event, then ``Preempted`` with the requeue exit code."""
        step = state.iteration
        saved = False
        if checkpointer is not None and step > 0:
            if checkpointer.latest_step() != step:
                checkpointer.save(step, state,
                                  host_env=self.snapshot_host_env())
            saved = True
        if bus is not None:
            bus.emit(
                "health", check="preempted", level="warn",
                message=(f"signal {guard.signum}: pipeline drained, "
                         + (f"final checkpoint at step {step}, " if saved
                            else "no checkpointer configured, ")
                         + "exiting for requeue"),
                data={"signum": guard.signum, "step": step, "saved": saved})
        raise Preempted(
            f"preempted by signal {guard.signum} after iteration {step}",
            state=state,
            step=step if saved else 0,
            signum=guard.signum,
            exit_code=self.cfg.requeue_exit_code,
        )

    # ------------------------------------------------------------------
    # the overlapped actor/learner loop (cfg.train_overlap)
    # ------------------------------------------------------------------

    def _overlap_collect(self, params, roll_stats, carry, rng, timer,
                         ctx=None, root_id=None):
        """One ``(T, N)`` window from ``params`` normalized by
        ``roll_stats``, streamed chunk by chunk
        (:meth:`rollout.ChunkedRollout.iter_chunks`) on the calling
        thread's stream, each chunk timed as ``rollout_chunk`` up to its
        end on that stream. Returns ``(carry, Trajectory)``.

        The window stays on the device, where the reference brings it to
        host memory so that it never pins the actor device's: on one card
        the two windows in flight are ≈ 0.3 GB at humanoid-sim-fleet's
        width, and a host copy would only add a transfer each way. The
        rollout builds new tensors every step, so the carry it returns
        never aliases one that ``TrainState.env_carry`` holds. With a trace
        context each chunk is also a ``train/rollout_chunk`` span under
        ``root_id`` (the reference's ``train/transfer`` span has no
        counterpart: the window never leaves the card)."""
        chunks = ChunkedRollout(self.env, self._normed_policy(roll_stats),
                                self.cfg.rollout_chunk).iter_chunks(
            params, carry, rng, self.n_steps)
        parts = []
        for _ in range(self.n_steps // self.cfg.rollout_chunk):
            t0, p0 = time.time(), time.perf_counter()
            with timer.phase("rollout_chunk"):
                carry, part = next(chunks)
                _sync_stream(self.device)
            if ctx is not None:
                ctx.record("train/rollout_chunk", t0,
                           (time.perf_counter() - p0) * 1e3,
                           parent_id=root_id)
            parts.append(part)
        return carry, concat_chunks(parts)

    def _overlap_learner_step(self, state: TrainState, window: Trajectory,
                              roll_stats, stale: bool, timer, ctx=None,
                              root_id=None):
        """One update on a window, on the calling thread's stream: the
        batch, the CG solve, the line search, the merge and the critic fit,
        the policy phase of the serial loop split into stages. Each stage
        is timed (``update/advantage``, ``update/fvp_cg_solve``,
        ``update/linesearch``, ``update/vf_fit``) up to its end on this
        stream only: a device-wide synchronize would also wait for the
        actor's work. With a trace context each stage is also a
        ``train/<stage>`` span inside a ``train/update`` span under
        ``root_id``. Returns ``(state, stats, host_row)``."""
        up_id = mint_span_id() if ctx is not None else None

        def staged(name, fn, *args):
            t0, p0 = time.time(), time.perf_counter()
            with timer.phase(name):
                out = fn(*args)
                _sync_stream(self.device)
            if ctx is not None:
                ctx.record(f"train/{name}", t0,
                           (time.perf_counter() - p0) * 1e3,
                           parent_id=up_id)
            return out

        t_up, p_up = time.time(), time.perf_counter()
        with timer.phase("update"):
            batch, aux = staged("advantage", self._batch_phase, state,
                                window, roll_stats, None, stale)
            pack = staged("fvp_cg_solve", self._overlap_solve,
                          state.policy_params, batch, state.cg_damping,
                          state.precond, state.ladder)
            new_params, trpo_stats = staged(
                "linesearch", self._overlap_finish, state.policy_params,
                batch, pack)
            new_state, fit_pack = self._merge_phase(state, new_params,
                                                    trpo_stats, aux)
            new_vf, stats = staged("vf_fit", self._vf_stats_phase,
                                   new_state.vf_state, fit_pack)
            row = _host_row(stats)
        if ctx is not None:
            ctx.record("train/update", t_up,
                       (time.perf_counter() - p_up) * 1e3,
                       parent_id=root_id, span_id=up_id, stale=bool(stale))
        return new_state._replace(vf_state=new_vf), stats, row

    def _overlap_run(self, state: TrainState, n_iterations: int, *,
                     timer: Optional[PhaseTimer] = None, on_row=None,
                     pre_iter=None, tracer=None):
        """The overlapped actor/learner loop (``cfg.train_overlap``).

        Schedule, staleness hard-bounded at one window: collect window 0
        with the current state; then at iteration k submit the update on
        window k to one learner thread, while this thread collects window
        k+1 with the params and normalization statistics the learner
        STARTED from. The fill window (k = 0) was collected by the current
        params and is the plain synchronous batch (``stale=False``), so
        the first iteration is bitwise equal to the serial loop's; every
        later window is one update stale and importance-weighted.

        On CUDA the learner runs on a stream of its own and this thread
        on another. Each window crosses to the learner behind an event,
        each new state back to the actor behind one, and every tensor
        read on the other stream is marked for it (``record_stream``), so
        the caching allocator does not hand its memory out under the
        reader. Only this thread draws from ``state.rng``, in the serial
        loop's order.

        ``pre_iter(k, state)`` runs before each submission;
        ``on_row(k, state, host_row, iter_ms) -> stop`` after each join,
        with ``state.env_carry`` already the carry after the window in
        flight (and ``state.rng`` past it), so a checkpoint taken there
        resumes both chains; a stop discards that window. Returns
        ``(state, [stats of each iteration])``.

        ``tracer`` (an ``obs.trace.Tracer``): one trace for the run, a
        ``train/run`` root span booked at the end, and under it each
        window's ``train/rollout_chunk`` and each update's stage spans;
        the context is flushed and renewed after every iteration, so the
        tracer's pending buffer holds one window whatever the run's
        length."""
        timer = PhaseTimer() if timer is None else timer
        ctx = root_id = None
        if tracer is not None:
            ctx = tracer.begin()
            root_id = mint_span_id()
            run_t0, run_p0 = time.time(), time.perf_counter()
        cuda = self.device.type == "cuda"
        actor = learner = caller = None
        if cuda:
            caller = torch.cuda.current_stream(self.device)
            actor = torch.cuda.Stream(self.device)
            learner = torch.cuda.Stream(self.device)
            for stream in (actor, learner):
                stream.wait_stream(caller)
                _record_stream(state, stream)

        def on_stream(stream):
            return (torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext())

        def learner_step(st, window, roll_stats, stale, ready, ctx):
            with on_stream(learner):
                if ready is not None:
                    learner.wait_event(ready)
                out = self._overlap_learner_step(st, window, roll_stats,
                                                 stale, timer, ctx, root_id)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(learner)
            return out, done

        def hand_over(window):
            """The window's event on this stream, the window marked as
            used on the learner's."""
            if not cuda:
                return None
            _record_stream(window, learner)
            ready = torch.cuda.Event()
            ready.record(actor)
            return ready

        rows = []
        try:
            with on_stream(actor), ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="trpo-learner") as pool:
                roll_stats = state.obs_norm
                carry, window = self._overlap_collect(
                    state.policy_params, roll_stats, state.env_carry,
                    state.rng, timer, ctx, root_id)
                for k in range(n_iterations):
                    if pre_iter is not None:
                        pre_iter(k, state)
                    t0 = time.perf_counter()
                    fut = pool.submit(learner_step, state, window, roll_stats,
                                      k > 0, hand_over(window), ctx)
                    next_window = next_stats = None
                    if k + 1 < n_iterations:
                        # read before the join: the state the learner started
                        # from is the behavior policy of the stale window
                        next_stats = state.obs_norm
                        carry, next_window = self._overlap_collect(
                            state.policy_params, next_stats, carry, state.rng,
                            timer, ctx, root_id)
                    (new_state, stats, row), done = fut.result()
                    if done is not None:
                        actor.wait_event(done)
                        _record_stream((new_state, stats), actor)
                    state = new_state._replace(env_carry=carry)
                    iter_s = time.perf_counter() - t0
                    timer.record("iteration", iter_s)
                    rows.append(stats)
                    if tracer is not None:
                        # flush this window's spans (all ended), renew
                        tracer.finish(ctx)
                        ctx = TraceContext(ctx.trace_id, ctx.sampled)
                    if on_row is not None and on_row(k, state, row,
                                                     iter_s * 1e3):
                        break
                    window, roll_stats = next_window, next_stats
        finally:
            if cuda:
                # the caller's stream runs after both sides, and what it
                # frees is not handed out again under their work
                caller.wait_stream(actor)
                caller.wait_stream(learner)
                _record_stream((state, rows), caller)
            if tracer is not None:
                ctx.record("train/run", run_t0,
                           (time.perf_counter() - run_p0) * 1e3,
                           span_id=root_id, overlap=1,
                           staleness_bound=int(self.cfg.train_overlap),
                           iterations=len(rows))
                tracer.finish(ctx)
        return state, rows

    def _learn_overlap(self, n_iterations, state, logger, checkpointer,
                       callback, timer, guard, telemetry=None) -> TrainState:
        """``learn``'s overlapped driver: every row goes through
        :meth:`_finish_iteration_stats` (stop rules, NaN abort, logging),
        then the callback and the checkpoint cadence, as in the serial
        loop with one iteration a chunk. NaN recovery is refused by the
        config for this driver. With ``cfg.trace_sample_rate > 0`` and a
        telemetry bus, a ``Tracer(process="train")`` spans the loop."""
        cfg = self.cfg
        reward_running = RunningEpisodeMean()
        it0 = state.iteration
        bus = telemetry.bus if telemetry is not None else None
        tracer = None
        if bus is not None and cfg.trace_sample_rate > 0:
            tracer = Tracer(bus, cfg.trace_sample_rate, process="train")

        def pre_iter(k, st):
            if guard.triggered:
                # every finished iteration's row is processed, and st holds
                # the refreshed carry and generator
                self._preempt_shutdown(st, checkpointer, guard, bus)
            if telemetry is not None:
                telemetry.profile_tick(it0 + k + 1, span=1)

        def on_row(k, st, row, iter_ms):
            it = it0 + k + 1
            stop = self._finish_iteration_stats(
                row, reward_running, logger, iteration=it,
                iteration_ms=iter_ms, timesteps_total=st.total_timesteps,
                telemetry=telemetry)
            if telemetry is not None and k + 1 >= 2:
                telemetry.mark_steady()
            if callback is not None:
                callback(st, row)
            if checkpointer is not None and it % cfg.checkpoint_every == 0:
                checkpointer.save(it, st)
            return stop

        try:
            state, _ = self._overlap_run(state, n_iterations, timer=timer,
                                         on_row=on_row, pre_iter=pre_iter,
                                         tracer=tracer)
        finally:
            if tracer is not None:
                tracer.drain()
                tracer.close()
        return state

    # ------------------------------------------------------------------
    # learn: the asynchronous host-env driver
    # ------------------------------------------------------------------

    def _learn_host_async(self, n_iterations, state, logger, checkpointer,
                          callback, timer, recovery, guard,
                          telemetry=None, injector=None) -> TrainState:
        """The asynchronous driver for host envs (counterpart: the
        reference's ``_learn_host_async``).

        Per iteration: the host rollout → phase A, the policy update (the
        only thing the next rollout waits for: its params) → phase B, the
        critic fit and the stats → the next rollout. On CUDA phase B is
        queued on a side stream behind phase A (``wait_stream``, with every
        tensor it reads marked ``record_stream`` for it), so its device
        time overlaps the next rollout; its stats go to a
        :class:`~trpo_torch.utils.async_pipe.StatsDrain` with an event
        recorded behind them, and the drain thread brings them over, logs
        and applies the stop rules. The next phase A waits for phase B's
        event. Phase B is launched from this thread: from a thread of its
        own, its launches contended with the rollout's for the GIL, and
        the iteration was no faster than serial on the card (PERF.md).

        Bitwise equal to the serial driver: the same programs on the same
        inputs in the same order per stream, the rollout generator
        advanced only by the rollouts, and the rows consumed in order,
        exactly once. A checkpoint is a sync point: the drain catches up
        first."""
        cfg = self.cfg
        steps_per_iter = self.n_steps * self.n_envs
        reward_running = RunningEpisodeMean()
        it0, ts0 = state.iteration, state.total_timesteps
        bus = telemetry.bus if telemetry is not None else None
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)

        def consume(tag, host_stats) -> bool:
            i, iter_ms, cb_state = tag
            stop = self._finish_iteration_stats(
                host_stats, reward_running, logger, iteration=i + 1,
                iteration_ms=iter_ms,
                timesteps_total=ts0 + (i - it0 + 1) * steps_per_iter,
                recovery=recovery, telemetry=telemetry)
            if callback is not None and (recovery is None
                                         or recovery.pending is None):
                callback(cb_state, host_stats)
            return stop

        drain = StatsDrain(consume, fetch=_host_row, timer=timer,
                           maxsize=cfg.stats_drain_maxsize,
                           span_context=timer.current_context())

        def phase_b(state_a, fit_pack, tag):
            """Queue the critic fit and the stats behind phase A; returns
            the new critic state and the event behind it."""
            if side is None:
                new_vf, stats = self._vf_stats_phase(state_a.vf_state,
                                                     fit_pack)
                done = None
            else:
                side.wait_stream(torch.cuda.current_stream(self.device))
                _record_stream((state_a.vf_state, fit_pack), side)
                with torch.cuda.stream(side):
                    new_vf, stats = self._vf_stats_phase(state_a.vf_state,
                                                         fit_pack)
                    done = torch.cuda.Event()
                    done.record(side)
            cb_state = (state_a._replace(vf_state=new_vf)
                        if callback is not None else None)
            drain.submit(tag + (cb_state,), stats, ready=done)
            return new_vf, done

        cur, pending = state, None
        prev_t = time.perf_counter()
        stop = False

        def agreed_flags():
            """``(stop, recover)``: the drain's stop request and a pending
            NaN recovery. On a mesh, as any rank sees them (one all-reduce
            MAX): the drain thread reaches a row at a different moment on
            each rank, and every rank must take the same branch (after a
            ``drain.drain()`` each has the flag itself)."""
            flags = (drain.stop_requested,
                     recovery is not None and recovery.pending is not None)
            if self.mesh is None:
                return flags
            import torch.distributed as dist

            got = all_max(torch.tensor([int(f) for f in flags],
                                       device=self.device), dist.group.WORLD)
            return bool(got[0]), bool(got[1])

        def land_b() -> None:
            """Make the pending phase B's critic the state's (the main
            stream waits for its event)."""
            nonlocal cur, pending
            if pending is None:
                return
            new_vf, done = pending
            pending = None
            if done is not None:
                main = torch.cuda.current_stream(self.device)
                main.wait_event(done)
                _record_stream(new_vf, main)
            cur = cur._replace(vf_state=new_vf)

        try:
            j = 0
            while True:
                if self.mesh is not None:
                    self._agree_preempt(guard)
                if j >= n_iterations or (
                        stop if self.mesh is not None
                        else drain.stop_requested):
                    land_b()
                    drain.drain()
                    if recovery is not None and recovery.pending is not None:
                        restored_at, cur = recovery.recover()
                        if not drain.stop_requested:
                            j = restored_at - 1 - it0
                            continue
                    break
                i = it0 + j
                if guard.triggered:
                    land_b()
                    drain.drain()
                    if recovery is not None and recovery.pending is not None:
                        _, cur = recovery.recover()
                    self._preempt_shutdown(cur, checkpointer, guard, bus)
                if recovery is not None:
                    land_b()
                    recovery.snapshot(i + 1, cur)
                if injector is not None:
                    cur = injector.before_iteration(i + 1, cur)
                if telemetry is not None:
                    telemetry.profile_tick(i + 1)
                    if j >= 2:
                        telemetry.mark_steady()
                with timer.phase("rollout"):
                    cur, traj = self._host_collect(cur, timer=timer)
                if callback is not None:
                    drain.drain()
                with timer.phase("dispatch"):
                    land_b()
                    state_a, fit_pack = self._policy_phase(cur, traj)
                    now = time.perf_counter()
                    pending = phase_b(state_a, fit_pack,
                                      (i, (now - prev_t) * 1e3))
                    prev_t = now
                    cur = state_a
                if checkpointer is not None and (
                        (i + 1) % cfg.checkpoint_every == 0):
                    land_b()
                    drain.drain()  # a diverged row raises before the save
                    if recovery is None or recovery.pending is None:
                        checkpointer.save(i + 1, cur,
                                          host_env=self.snapshot_host_env())
                drain.raise_if_failed()
                stop, recover = agreed_flags()
                if recover:
                    land_b()
                    drain.drain()
                    restored_at, cur = recovery.recover()
                    j = restored_at - 1 - it0
                    continue
                if telemetry is not None:
                    # host-side gauges only, never a device read
                    telemetry.observe_drain(drain.depth, drain.high_water,
                                            drain.maxsize)
                if stop:
                    continue  # the epilogue above lands phase B first
                j += 1
            if injector is not None:
                self._warn_unfired_faults(injector, bus)
        finally:
            drain.close()
        return cur


def _map_env_axis(snap: dict, n: int, fn) -> dict:
    """``snap`` with ``fn`` applied to every entry whose leading axis is
    the ``n`` envs (arrays, and per-env lists such as simulator states)."""
    def per_env(x):
        return (isinstance(x, list) and len(x) == n) or (
            isinstance(x, np.ndarray) and x.ndim >= 1 and x.shape[0] == n)

    return {k: fn(v) if per_env(v) else v for k, v in snap.items()}


def _gather_objects(items, group):
    """Every rank's list or array joined in rank order along its first
    axis (pickled: a checkpoint-time collective, any dtype)."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, items, group=group)
    if isinstance(items, list):
        return [x for part in parts for x in part]
    return np.concatenate(parts)


def _host_row(stats: dict) -> dict:
    """One iteration's stats dict on the host, by :func:`_host_rows`."""
    dev = next(v.device for v in stats.values()
               if isinstance(v, torch.Tensor))
    return _host_rows({k: torch.as_tensor(v, device=dev)[None]
                       for k, v in stats.items()})[0]


def _sync_stream(device: torch.device) -> None:
    """Wait for the calling thread's current stream on ``device`` (nothing
    on the CPU); other streams run on."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _record_stream(tree, stream) -> None:
    """Mark every CUDA tensor of ``tree`` as used on ``stream``, so the
    caching allocator does not hand its memory out again before the work
    queued there has read it."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.record_stream(stream)


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
