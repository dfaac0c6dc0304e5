"""Configuration for trpo_torch (counterpart: ``trpo_tpu/config.py``).

The port keeps its own copy of the training fields of ``TRPOConfig`` and of
the preset ladder, so a preset name means the same run in both packages,
every ``serve_*`` field with the reference's validation, so a serving
configuration round-trips, the telemetry fields (``status_port``,
``memory_accounting``, ``trace_sample_rate``, ``debug_nans``), the
supervised worker pool's (``env_step_timeout``, ``max_worker_restarts``,
``min_env_workers``, ``worker_backoff``) and ``inject_faults``, parsed at
construction, and the mesh fields ``mesh_shape``/``mesh_axes``: data
parallelism over a ``"data"`` axis, sequence parallelism over a
``"seq"`` axis and parameter sharding over a ``"model"`` or ``"expert"``
axis (``parallel/``), one process per rank, with device or host envs.

Differences from the reference:

* ``scan_backend`` is gone. The port has one reverse affine scan
  (``ops/reverse_scan.py``): the CUDA kernel on a CUDA tensor and the plain
  loop on a CPU tensor.
* ``debug_nans`` cannot set ``jax_debug_nans``. Its counterpart turns on
  ``torch.autograd.set_detect_anomaly`` (process-wide, as the reference's
  flag is) and checks every stage's outputs for nonfinite values — the
  rollout, the advantages, the policy update and the critic fit — raising
  ``FloatingPointError`` naming the stage. It costs a host read per stage,
  so it is a debug mode only.
* Telemetry (``obs/``): the run manifest's ``jax_version`` is ``"n/a"``,
  with ``torch_version``, ``cuda_version`` and ``device_name`` beside it;
  ``memory_accounting`` emits no ``scope="program"`` record (no compiled
  program to analyse, ``obs/memory.py``); the ``recompile`` events count
  kernel builds and CUDA graph captures, not XLA retraces
  (``obs/recompile.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

__all__ = ["TRPOConfig", "PRESETS", "get_preset"]


@dataclasses.dataclass
class TRPOConfig:
    # --- environment -----------------------------------------------------
    env: str = "cartpole"
    n_envs: int = 8
    max_pathlength: Optional[int] = None  # None → the env's own horizon
    batch_timesteps: int = 1000    # total timesteps per iteration (T·N ≥ it)
    fleet_n_envs: Optional[int] = None  # overrides n_envs when set
    rollout_chunk: Optional[int] = None  # time-chunked device rollout:
    #                                steps per chunk, a divisor of the
    #                                steps per window (rollout.py)

    # --- discounting / advantages ---------------------------------------
    gamma: float = 0.95
    lam: float = 1.0
    standardize_advantages: bool = True

    # --- trust region solve ----------------------------------------------
    max_kl: float = 0.01
    cg_iters: int = 10
    cg_damping: float = 0.1
    adaptive_damping: bool = False  # grow λ after a failed line search or
    #                                a KL rollback, shrink it after a clean
    #                                step (trpo._next_damping); λ rides
    #                                TrainState.cg_damping as a device scalar
    damping_grow: float = 2.0
    damping_shrink: float = 0.95
    damping_min: float = 1e-3
    damping_max: float = 10.0
    cg_residual_tol: float = 1e-10
    cg_residual_rtol: float = 0.0
    cg_precondition: Any = False   # False, "jacobi" (True): a Hutchinson
    #                                diagonal of the CG operator, or
    #                                "head_block": the Gaussian head's exact
    #                                Fisher block inverse
    cg_precond_probes: int = 8     # jacobi: Rademacher probes, each one
    #                                more run of the CG operator per update
    precond_refresh_every: int = 1  # head_block: Gram/eigh refresh cadence
    linesearch_backtracks: int = 10
    linesearch_accept_ratio: float = 0.1
    linesearch_kl_cap: bool = False
    kl_rollback_factor: float = 2.0
    fvp_subsample: Optional[float] = None  # FVPs on this fraction of the batch
    fvp_dtype: str = "f32"         # "bf16": the cheap solve's matvec runs
    #                                its products in bf16 (kernel K1-bf16)
    solve_audit_every: int = 0     # every k-th update, re-solve at full
    #                                precision / full batch and gate the
    #                                cheap solution on the solution cosine
    solve_cosine_floor: float = 0.999  # below it the update falls back to
    #                                the full-precision solution
    solve_fallback_limit: int = 3  # consecutive failed audits that pin the
    #                                ladder at the full-precision solve
    cg_budget_adaptive: bool = False  # shrink the CG iteration cap toward
    #                                the residual rule's exit point (+1),
    #                                grow it (+2) after an unconverged solve
    cg_budget_floor: int = 2
    cg_budget_ceiling: Optional[int] = None  # None = cg_iters
    solve_fault_skew: float = 0.0  # test lever: solve a skewed system
    #                                D·F·D in the cheap solve only
    fvp_mode: str = "auto"         # "auto"/"fused" → the fused FVP kernel for a
    #                                plain-MLP diagonal-Gaussian policy; "ggn"
    #                                → the torch.func Gauss-Newton operator

    # --- networks --------------------------------------------------------
    policy_hidden: Tuple[int, ...] = (64,)
    policy_activation: str = "tanh"
    policy_gru: Optional[int] = None  # recurrent-cell size → a recurrent
    #                                policy (models/recurrent.py; POMDPs)
    policy_cell: str = "gru"       # "gru" or "lstm" (packed [h|c] state);
    #                                read only when policy_gru is set
    policy_experts: Optional[int] = None  # K → a soft mixture-of-experts
    #                                torso (models/moe.py)
    vf_hidden: Tuple[int, ...] = (64, 64)
    vf_activation: str = "relu"
    vf_train_steps: int = 50
    vf_learning_rate: float = 1e-3
    init_log_std: float = 0.0
    compute_dtype: str = "float32"  # or "bfloat16": the policy's matmuls
    normalize_obs: bool = False    # running observation normalization:
    #                                TrainState.obs_norm on device envs,
    #                                inside the adapter on host envs
    #                                (envs/obs_norm.py)

    # --- run control -----------------------------------------------------
    seed: int = 1
    n_iterations: int = 1000
    fuse_iterations: int = 1       # learn() runs this many iterations per
    #                                chunk (agent.run_iterations) with one
    #                                stats transfer per chunk; stop
    #                                conditions fire at chunk granularity
    reward_target: Optional[float] = None  # stop once a batch's mean
    #                                episode reward reaches it
    stop_on_explained_variance: Optional[float] = None  # stop once the
    #                                critic's explained variance exceeds it
    recover_on_nan: str = "off"    # "off": NaN entropy raises
    #                                FloatingPointError; "restore": restore
    #                                the last-good state, escalate
    #                                cg_damping when adaptive, and raise
    #                                TrainingDiverged after max_recoveries
    #                                consecutive failures
    #                                (resilience/recovery.py)
    max_recoveries: int = 3
    on_preempt: str = "checkpoint"  # "checkpoint": SIGTERM/SIGINT write a
    #                                final checkpoint and raise Preempted
    #                                (the CLI exits requeue_exit_code);
    #                                "ignore": default signal behaviour
    requeue_exit_code: int = 75
    env_step_timeout: Optional[float] = 60.0  # gymproc: pools: seconds a
    #                                reply gather waits on a worker before
    #                                declaring it dead (WorkerDiedError);
    #                                0/None = wait forever
    max_worker_restarts: int = 2   # supervision: process restarts (with
    #                                exponential backoff) per env worker
    #                                before its slice degrades to the
    #                                in-process fallback
    min_env_workers: int = 0       # abort (WorkerPoolError) when fewer
    #                                process-backed workers remain healthy;
    #                                0 = degrade all the way
    worker_backoff: float = 0.5    # base seconds of the restart backoff
    #                                (base·2^(attempt-1), capped at 5 s)
    inject_faults: Optional[str] = None  # chaos spec
    #                                (resilience/inject.py grammar, e.g.
    #                                "nan_update@iter=2;sigterm@iter=4");
    #                                every fired fault is a fault_injected
    #                                event
    train_overlap: int = 0         # 1: the overlapped actor/learner
    #                                loop (agent._overlap_run): rollout
    #                                k+1 runs while update k does, one
    #                                window stale, importance-weighted;
    #                                device envs with rollout_chunk
    host_pipeline_groups: int = 1  # host envs: split the envs into this
    #                                many groups, each stepped by its own
    #                                thread while the others' inference
    #                                runs (rollout.pipelined_host_rollout);
    #                                feedforward policies only
    host_async_pipeline: bool = False  # host envs: learn() runs the async
    #                                driver (agent._learn_host_async): the
    #                                critic fit and the stats run behind the
    #                                next rollout, bitwise equal to serial
    stats_drain_maxsize: int = 2   # async driver: bound on the stats queue
    #                                (utils/async_pipe.StatsDrain); 0 =
    #                                unbounded
    host_staged_transfers: bool = True  # pipelined rollout: copy each
    #                                group's slice to the device as soon as
    #                                the group finishes (value-identical)
    host_inference: str = "device"  # host envs: where the rollout's policy
    #                                runs: "device" (the agent's), or "cpu"
    mesh_shape: Optional[Tuple[int, ...]] = None  # None → one rank, no
    #                                mesh; e.g. (2,) for data parallelism
    #                                over two ranks (torchrun)
    mesh_axes: Tuple[str, ...] = ("data",)
    debug_nans: bool = False       # anomaly detection and a finite check of
    #                                every stage's outputs (module
    #                                docstring); a debug mode
    # --- telemetry (obs/) ------------------------------------------------
    status_port: Optional[int] = None  # live /status and /metrics on
    #                                127.0.0.1 (obs/server.py); 0 = the OS
    #                                picks; None = no server thread
    memory_accounting: bool = False  # per-iteration allocator gauges and
    #                                the health:memory_leak rule
    #                                (obs/memory.py)
    trace_sample_rate: float = 0.0  # head-based trace sampling
    #                                (obs/trace.py): the serving plane's
    #                                requests, and the overlapped loop's
    #                                train/* spans when > 0

    # --- serving: the data plane (serve/) --------------------------------
    serve_batch_shapes: Tuple[int, ...] = (1, 8, 64)  # the engine's rung
    #                                ladder (serve/engine.py): one CUDA
    #                                graph per rung, requests pad up to
    #                                the nearest rung, over-sized batches
    #                                chunk at the top one
    serve_deadline_ms: float = 10.0  # micro-batcher budget: a batch goes
    #                                when it fills the top rung or when
    #                                its oldest request has waited half
    #                                of this
    serve_adaptive_deadline: bool = True  # cap the batcher's wait at ~2×
    #                                the EMA of the observed dispatch cost
    #                                (never above the half-budget)
    serve_poll_interval: float = 1.0  # seconds between the checkpoint
    #                                watcher's latest_step() polls
    serve_session_batch_shapes: Tuple[int, ...] = (1, 8, 64)  # the
    #                                session engine's rung ladder
    #                                (serve/session.py): concurrent
    #                                sessions gather into one padded
    #                                (N, carry) step
    serve_session_deadline_ms: float = 3.0  # session epoch budget
    serve_session_ttl: float = 300.0  # idle session lifetime (seconds)
    serve_max_sessions: int = 1024  # bounded session store; LRU beyond it
    serve_carry_sync_every: int = 1  # journal a session's carry every N
    #                                applied steps (serve/session.py
    #                                CarryJournal)
    # --- serving: the control plane (serve/router.py, replicaset.py,
    # autoscaler.py, transport.py; python -m trpo_torch.serve --replicas)
    serve_replicas: int = 1
    serve_health_interval: float = 0.5
    serve_replica_restarts: int = 3
    serve_max_inflight: int = 64
    serve_canary_fraction: float = 0.0
    serve_canary_window: int = 24
    serve_reward_window: int = 0
    serve_reward_min_episodes: int = 0
    serve_reward_budget: float = 0.0
    serve_min_replicas: int = 1
    serve_max_replicas: Optional[int] = None
    serve_slo_p99_ms: float = 250.0
    serve_drain_timeout: float = 30.0
    serve_autoscale_interval: float = 0.5
    serve_autoscale_min_samples: int = 16
    serve_hosts: Optional[Tuple[str, ...]] = None
    serve_lease_ttl: float = 3.0
    serve_replica_cmd: Optional[str] = None

    # --- io --------------------------------------------------------------
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    log_jsonl: Optional[str] = None

    def __post_init__(self):
        if self.fleet_n_envs is not None and self.fleet_n_envs < 1:
            raise ValueError(
                f"fleet_n_envs must be >= 1, got {self.fleet_n_envs}"
            )
        if self.rollout_chunk is not None:
            if self.rollout_chunk < 1:
                raise ValueError(
                    f"rollout_chunk must be >= 1, got {self.rollout_chunk}"
                )
            n_steps = max(
                1, -(-self.batch_timesteps // self.resolved_n_envs())
            )
            if self.rollout_chunk > n_steps or n_steps % self.rollout_chunk:
                raise ValueError(
                    f"rollout_chunk={self.rollout_chunk} must divide the "
                    f"steps per rollout window ({n_steps} = "
                    f"ceil(batch_timesteps={self.batch_timesteps} / "
                    f"n_envs={self.resolved_n_envs()})) — pick a divisor "
                    "or adjust batch_timesteps/the fleet width"
                )
        if self.train_overlap not in (0, 1):
            raise ValueError(
                f"train_overlap must be 0 (synchronous) or 1 (one-window "
                f"staleness), got {self.train_overlap} — the bound is a "
                "hard contract, not a queue depth"
            )
        if self.train_overlap:
            # each of these owns the iteration's sequencing in a way the
            # overlapped driver cannot compose with
            if self.rollout_chunk is None:
                raise ValueError(
                    "train_overlap=1 streams the rollout through the "
                    "chunked-rollout seam (rollout.ChunkedRollout) — set "
                    "rollout_chunk (a divisor of the steps per window)"
                )
            if self.host_async_pipeline:
                raise ValueError(
                    "train_overlap and host_async_pipeline are mutually "
                    "exclusive pipelines (device-env overlap vs host-env "
                    "overlap) — pick the one matching the env family"
                )
            if self.fuse_iterations != 1:
                raise ValueError(
                    f"train_overlap=1 is incompatible with fuse_iterations="
                    f"{self.fuse_iterations}: the overlap driver already "
                    "owns the iteration boundary (rollout k+1 streams "
                    "inside update k) — a fused multi-iteration chunk "
                    "has no boundary to overlap across"
                )
            if self.mesh_shape is not None:
                raise ValueError(
                    "train_overlap=1 places the actor and learner work "
                    "on streams itself and cannot compose with a mesh "
                    "(mesh_shape) — drop one of the two"
                )
            if self.recover_on_nan == "restore":
                raise ValueError(
                    'train_overlap=1 does not support recover_on_nan='
                    '"restore": the rewind would have to unwind an '
                    "in-flight stale window as well as the update — run "
                    "the synchronous loop when restore-recovery matters"
                )
            if self.inject_faults:
                raise ValueError(
                    "train_overlap=1 does not support inject_faults: the "
                    "chaos injector's iteration triggers assume the "
                    "serial driver's state handoff"
                )
        if self.status_port is not None and not (
                0 <= self.status_port < 65536):
            raise ValueError(
                "status_port must be in [0, 65535] (0 = OS-assigned) or "
                f"None, got {self.status_port}")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(
                "trace_sample_rate must be in [0, 1], got "
                f"{self.trace_sample_rate}")
        if self.host_inference not in ("device", "cpu"):
            raise ValueError(
                'host_inference must be "device" or "cpu", got '
                f"{self.host_inference!r}"
            )
        if self.host_pipeline_groups < 1:
            raise ValueError(
                "host_pipeline_groups must be >= 1, got "
                f"{self.host_pipeline_groups}"
            )
        if self.stats_drain_maxsize < 0:
            raise ValueError(
                "stats_drain_maxsize must be >= 0 (0 = unbounded), got "
                f"{self.stats_drain_maxsize}"
            )
        if self.cg_precond_probes < 1:
            raise ValueError(
                f"cg_precond_probes must be >= 1, got "
                f"{self.cg_precond_probes}"
            )
        if self.fvp_mode not in ("auto", "fused", "ggn", "jvp_grad"):
            raise ValueError(
                'fvp_mode must be "auto", "fused", "ggn" or "jvp_grad", '
                f"got {self.fvp_mode!r}"
            )
        if self.fvp_dtype not in ("f32", "bf16"):
            raise ValueError(
                f'fvp_dtype must be "f32" or "bf16", got {self.fvp_dtype!r}'
            )
        if self.fvp_subsample is not None and not (
            0.0 < self.fvp_subsample <= 1.0
        ):
            raise ValueError(
                f"fvp_subsample must be in (0, 1], got {self.fvp_subsample}"
            )
        if self.solve_audit_every < 0:
            raise ValueError(
                "solve_audit_every must be >= 0 (0 = no auditing), got "
                f"{self.solve_audit_every}"
            )
        if self.fvp_dtype == "bf16" and self.solve_audit_every < 1:
            raise ValueError(
                'fvp_dtype="bf16" requires solve_audit_every >= 1 — the '
                "precision ladder is only safe under the solution-cosine "
                'audit (set solve_audit_every, or keep fvp_dtype="f32")'
            )
        if not 0.0 < self.solve_cosine_floor <= 1.0:
            raise ValueError(
                "solve_cosine_floor must be in (0, 1], got "
                f"{self.solve_cosine_floor}"
            )
        if self.solve_fallback_limit < 1:
            raise ValueError(
                "solve_fallback_limit must be >= 1, got "
                f"{self.solve_fallback_limit}"
            )
        if self.solve_fault_skew < 0:
            raise ValueError(
                f"solve_fault_skew must be >= 0, got {self.solve_fault_skew}"
            )
        if self.cg_budget_adaptive:
            ceiling = self.resolved_cg_budget_ceiling()
            if not 1 <= self.cg_budget_floor <= ceiling:
                raise ValueError(
                    "need 1 <= cg_budget_floor <= cg_budget_ceiling, got "
                    f"({self.cg_budget_floor}, {ceiling})"
                )
            if not (self.cg_residual_tol > 0 or self.cg_residual_rtol > 0):
                raise ValueError(
                    "cg_budget_adaptive needs a residual rule to observe "
                    "early exits — set cg_residual_tol or "
                    "cg_residual_rtol > 0"
                )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                'compute_dtype must be "float32" or "bfloat16", got '
                f"{self.compute_dtype!r}"
            )
        if self.cg_precondition not in (
            False, True, "jacobi", "head_block"
        ):
            raise ValueError(
                'cg_precondition must be False, "jacobi" (True), or '
                f'"head_block", got {self.cg_precondition!r}'
            )
        if self.precond_refresh_every < 1:
            raise ValueError(
                "precond_refresh_every must be >= 1, got "
                f"{self.precond_refresh_every}"
            )
        if self.recover_on_nan not in ("off", "restore"):
            raise ValueError(
                'recover_on_nan must be "off" or "restore", got '
                f"{self.recover_on_nan!r}"
            )
        if self.on_preempt not in ("checkpoint", "ignore"):
            raise ValueError(
                'on_preempt must be "checkpoint" or "ignore", got '
                f"{self.on_preempt!r}"
            )
        if self.max_recoveries < 1:
            raise ValueError(
                f"max_recoveries must be >= 1, got {self.max_recoveries}"
            )
        if self.max_worker_restarts < 0:
            raise ValueError(
                "max_worker_restarts must be >= 0, got "
                f"{self.max_worker_restarts}"
            )
        if self.min_env_workers < 0:
            raise ValueError(
                f"min_env_workers must be >= 0, got {self.min_env_workers}"
            )
        if self.env_step_timeout is not None and self.env_step_timeout < 0:
            # 0/None = wait forever; a negative value would time every
            # gather out at once and burn the restart budget into silent
            # pool degradation
            raise ValueError(
                "env_step_timeout must be >= 0 (0 or None = no timeout), "
                f"got {self.env_step_timeout}"
            )
        if self.worker_backoff < 0:
            raise ValueError(
                f"worker_backoff must be >= 0, got {self.worker_backoff}"
            )
        if self.inject_faults:
            # fail at construction: a chaos run with an unparseable spec
            # would otherwise pass by injecting nothing
            from trpo_torch.resilience.inject import parse_fault_specs

            parse_fault_specs(self.inject_faults)
        if not 0 < self.requeue_exit_code < 256:
            raise ValueError(
                "requeue_exit_code must be in (0, 255], got "
                f"{self.requeue_exit_code}"
            )
        if self.adaptive_damping:
            if not self.damping_grow > 1.0:
                raise ValueError(
                    f"damping_grow must be > 1, got {self.damping_grow}"
                )
            if not 0.0 < self.damping_shrink <= 1.0:
                raise ValueError(
                    "damping_shrink must be in (0, 1], got "
                    f"{self.damping_shrink}"
                )
            if not 0.0 < self.damping_min <= self.damping_max:
                raise ValueError(
                    "need 0 < damping_min <= damping_max, got "
                    f"({self.damping_min}, {self.damping_max})"
                )
        self._check_serve()

    def _check_serve(self) -> None:
        """The reference's validation of the ``serve_*`` fields."""
        for name in ("serve_batch_shapes", "serve_session_batch_shapes"):
            shapes = getattr(self, name)
            if not shapes or any(not isinstance(b, int) or b < 1
                                 for b in shapes):
                raise ValueError(
                    f"{name} must be a non-empty tuple of positive ints, "
                    f"got {shapes!r}"
                )
        positive = ("serve_deadline_ms", "serve_poll_interval",
                    "serve_session_deadline_ms", "serve_health_interval",
                    "serve_session_ttl", "serve_slo_p99_ms",
                    "serve_drain_timeout", "serve_autoscale_interval")
        at_least_one = ("serve_replicas", "serve_max_inflight",
                        "serve_max_sessions", "serve_carry_sync_every",
                        "serve_canary_window", "serve_min_replicas",
                        "serve_autoscale_min_samples")
        non_negative = ("serve_replica_restarts", "serve_reward_window",
                        "serve_reward_min_episodes", "serve_reward_budget")
        for name in positive:
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"{name} must be > 0, got {getattr(self, name)}")
        for name in at_least_one:
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        for name in non_negative:
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}")
        if not 0.0 <= self.serve_canary_fraction <= 1.0:
            raise ValueError(
                "serve_canary_fraction must be in [0, 1], got "
                f"{self.serve_canary_fraction}"
            )
        if self.serve_max_replicas is not None:
            if self.serve_max_replicas < self.serve_min_replicas:
                raise ValueError(
                    "need serve_min_replicas <= serve_max_replicas, got "
                    f"({self.serve_min_replicas}, "
                    f"{self.serve_max_replicas})"
                )
            if not (self.serve_min_replicas <= self.serve_replicas
                    <= self.serve_max_replicas):
                raise ValueError(
                    "with autoscaling armed, serve_replicas must be in "
                    "[serve_min_replicas, serve_max_replicas], got "
                    f"{self.serve_replicas} outside "
                    f"[{self.serve_min_replicas}, "
                    f"{self.serve_max_replicas}]"
                )
        if self.serve_replica_cmd is not None and (
                not self.serve_replica_cmd.strip()):
            raise ValueError(
                "serve_replica_cmd must be a non-empty command template "
                "(or None for the local scripts/serve.py child)"
            )
        if self.serve_hosts is not None:
            if self.serve_lease_ttl <= self.serve_health_interval:
                raise ValueError(
                    "serve_lease_ttl must exceed serve_health_interval (a "
                    "lease shorter than its renewal cadence expires "
                    f"between polls), got ttl={self.serve_lease_ttl} "
                    f"interval={self.serve_health_interval}"
                )
            hosts = tuple(self.serve_hosts)
            if not hosts or any(not isinstance(h, str) or not h
                                for h in hosts):
                raise ValueError(
                    "serve_hosts must be a non-empty tuple of host "
                    f"names, got {self.serve_hosts!r}"
                )
            if len(set(hosts)) != len(hosts):
                raise ValueError(
                    f"serve_hosts has duplicate names: {self.serve_hosts!r}"
                )

    def resolved_n_envs(self) -> int:
        """``fleet_n_envs`` when set, else ``n_envs``."""
        return self.n_envs if self.fleet_n_envs is None else self.fleet_n_envs

    def resolved_cg_budget_ceiling(self) -> int:
        """The adaptive CG budget's ceiling: ``cg_budget_ceiling``, or
        ``cg_iters`` when it is None."""
        return (self.cg_iters if self.cg_budget_ceiling is None
                else self.cg_budget_ceiling)

    def replace(self, **kw) -> "TRPOConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets — copied from trpo_tpu/config.py for the training fields.
# ---------------------------------------------------------------------------

PRESETS = {
    "cartpole": TRPOConfig(env="cartpole"),
    "pendulum": TRPOConfig(
        env="pendulum",
        gamma=0.99,
        lam=0.95,
        batch_timesteps=4000,
        max_pathlength=200,
        n_envs=16,
        policy_hidden=(64, 64),
    ),
    "halfcheetah": TRPOConfig(
        env="gym:HalfCheetah-v4",
        gamma=0.99,
        lam=0.97,
        batch_timesteps=5000,
        max_pathlength=1000,
        n_envs=8,
        policy_hidden=(64, 64),
        cg_damping=0.1,
        cg_precondition="head_block",
        precond_refresh_every=25,
        fvp_subsample=0.75,
        solve_audit_every=25,
    ),
    "humanoid": TRPOConfig(
        env="gym:Humanoid-v4",
        gamma=0.99,
        lam=0.97,
        batch_timesteps=50_000,
        max_pathlength=1000,
        n_envs=64,
        policy_hidden=(256, 256),
        cg_damping=0.1,
        cg_precondition="head_block",
        precond_refresh_every=25,
        fvp_subsample=0.75,
        solve_audit_every=25,
    ),
    "halfcheetah-sim": TRPOConfig(
        env="halfcheetah-sim",
        gamma=0.99,
        lam=0.97,
        batch_timesteps=5000,
        max_pathlength=500,
        n_envs=32,
        policy_hidden=(64, 64),
        cg_damping=0.1,
        cg_precondition="head_block",
        precond_refresh_every=25,
        fvp_subsample=0.75,
        solve_audit_every=25,
    ),
    "humanoid-sim": TRPOConfig(
        env="humanoid-sim",
        gamma=0.99,
        lam=0.97,
        batch_timesteps=50_000,
        max_pathlength=500,
        n_envs=128,
        policy_hidden=(256, 256),
        cg_damping=0.1,
        cg_precondition="head_block",
        precond_refresh_every=25,
        fvp_subsample=0.75,
        solve_audit_every=25,
    ),
    "cartpole-po": TRPOConfig(
        env="cartpole-po",
        policy_hidden=(64,),
        policy_gru=64,
        gamma=0.99,
        lam=0.95,
        batch_timesteps=2000,
        n_envs=16,
    ),
    "catch": TRPOConfig(
        env="catch",
        gamma=0.99,
        lam=0.95,
        batch_timesteps=2048,
        n_envs=8,
        policy_hidden=(512,),
    ),
    "pong-sim": TRPOConfig(
        env="pong-sim",
        gamma=0.99,
        lam=0.95,
        batch_timesteps=2048,
        n_envs=8,
        policy_hidden=(512,),
    ),
    "pong": TRPOConfig(
        env="gym:ALE/Pong-v5",
        gamma=0.99,
        lam=0.95,
        batch_timesteps=8000,
        max_pathlength=10_000,
        n_envs=8,
        policy_hidden=(512,),
    ),
}

PRESETS.update({
    "cartpole-fleet": PRESETS["cartpole"].replace(
        batch_timesteps=8192,
        fleet_n_envs=2048,
        rollout_chunk=2,
    ),
    "halfcheetah-sim-fleet": PRESETS["halfcheetah-sim"].replace(
        batch_timesteps=5120,
        fleet_n_envs=1024,
    ),
    "humanoid-sim-fleet": PRESETS["humanoid-sim"].replace(
        batch_timesteps=50_000,
        fleet_n_envs=1024,
        rollout_chunk=7,
    ),
})


def get_preset(name: str) -> TRPOConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name])
