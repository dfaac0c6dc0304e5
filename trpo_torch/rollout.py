"""On-device rollout collection (counterpart: ``trpo_tpu/rollout.py``,
the device path).

A Python loop over time of a batched env+policy step with auto-reset,
producing fixed ``(T, N, ...)`` tensors: episodes pack contiguously with
explicit ``terminated``/``done`` flags, ``next_obs`` is taken before the
reset (so a truncated step bootstraps through the critic), and the running
episode return and length ride the carry across iterations.

Observations keep the env's dtype: pixel frames stay uint8 in the
trajectory (a 2,048-step window of 84×84×4 frames is 58 MB as uint8, four
times that as f32) and are cast only inside the policy's and the critic's
forward.

A recurrent policy (one with ``step``, ``models/recurrent.py``) adds its
state ``h`` and a ``prev_done`` flag to the carry: ``h`` threads through
the steps and is zeroed after an episode ends, and the trajectory gains
what the update needs to replay the window — ``reset`` (the state was
zeroed before step ``t``), ``policy_h0`` (the state entering the window)
— and what the critic reads, ``policy_h``/``policy_h_next`` (the state
before and after consuming ``obs[t]``).

Time-chunked rollouts (``cfg.rollout_chunk``): :func:`device_rollout`
with ``chunk`` and :class:`ChunkedRollout` run the same step body over
``n_steps // chunk`` chunks with the carry threaded through each chunk
boundary, so they are bit-exact against the unchunked rollout: the same
noise in the same step order through the same ops. ``ChunkedRollout``
also streams the chunks one at a time (:meth:`ChunkedRollout.iter_chunks`),
so a consumer holds one ``(chunk, N, ...)`` emission at a time.

Host envs (``native:``, ``gym:``; ``envs/native.py``,
``envs/gym_adapter.py``) step on the host: :func:`host_rollout` runs the
policy batched over the N envs each step and brings the actions and every
distribution leaf back in ONE transfer (:func:`make_host_act_fn` packs
them into one ``(N, K)`` f32 tensor; f32 leaves and integer actions below
2²⁴ round-trip exactly), records the step into ``(T, N, ...)`` host
buffers (pinned when the trajectory goes to a CUDA device) and moves each
field to the device in one copy at the end. ``next_obs`` is the
adapter's ``final_obs``, the observation before the auto-reset.

:func:`pipelined_host_rollout` splits the envs into G contiguous groups
so that one group's inference overlaps the others' host stepping. The
inference of all groups runs on the calling thread, in
group order (a design with each group's inference on its own thread ran
slower on the card as the groups grew: its launches and syncs queued
behind one another); each group's env steps (``host_step_slice``; the C++
stepper and MuJoCo release the GIL) run on a worker thread, so group g
steps while group g + 1's actions are computed. The overlap pays when an
env step is long and leaves the GIL (``tests/test_torch_host_rollout.py``
holds it with sleeping envs). On the native stepper a group step costs
what a whole step costs (the act's launches and sync, the adapter's
numpy bookkeeping: fixed costs, not width), so G groups pay them G times
and the threads' GIL handoffs on top (PERF.md §5). Each group samples from its own generator, derived
at the start of the window from the caller's, so a fixed seed reproduces
bitwise however the workers interleave; with a deterministic policy the
discrete actions equal :func:`host_rollout`'s bitwise (a continuous mode
action is rounded by a GEMM of another batch width). A normalizing adapter
runs the window in deferred-fold mode (``envs/obs_norm.py``). With
``stage_to_device`` each group's slice is copied to the device on a side
stream as soon as the group finishes, and the slices are joined there.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from trpo_torch.models.policy import Policy
from trpo_torch.ops.flat import tree_leaves, tree_map

__all__ = ["ChunkedRollout", "Trajectory", "concat_chunks", "device_rollout",
           "host_rollout", "init_carry", "init_env_states", "make_host_act_fn",
           "params_device", "pipelined_host_rollout"]


class Trajectory(NamedTuple):
    """Fixed-shape ``(T, N, ...)`` rollout tensors (time-major)."""
    obs: torch.Tensor             # (T, N, *obs_shape) — s_t
    actions: torch.Tensor         # (T, N, A) float, or (T, N) int64
    rewards: torch.Tensor         # (T, N)
    terminated: torch.Tensor      # (T, N) bool — terminal state at t
    done: torch.Tensor            # (T, N) bool — terminated OR truncated
    old_dist: Any                 # dist params dict, each (T, N, ...)
    next_obs: torch.Tensor        # (T, N, *obs_shape) — s_{t+1} BEFORE reset
    episode_return: torch.Tensor  # (T, N) running return, valid where done
    episode_length: torch.Tensor  # (T, N) running length, valid where done
    # recurrent policies only (None otherwise)
    reset: Any = None          # (T, N) bool — state zeroed before step t
    policy_h0: Any = None      # (N, S) — state entering the window
    policy_h: Any = None       # (T, N, S) — state entering step t
    policy_h_next: Any = None  # (T, N, S) — state after obs[t] (pre-reset)


def _recurrent(policy) -> bool:
    return hasattr(policy, "step")


def init_env_states(env, n_envs: int, generator: torch.Generator,
                    policy=None):
    """The rollout carry of ``n_envs`` fresh envs: ``(states, obs,
    episode_return, episode_length)``, and for a recurrent ``policy`` its
    zero state and a ``prev_done`` flag (True: the first step starts a
    fresh memory)."""
    states, obs = env.reset(n_envs, generator)
    dev = obs.device
    carry = (
        states,
        obs,
        torch.zeros(n_envs, device=dev),
        torch.zeros(n_envs, dtype=torch.int32, device=dev),
    )
    if policy is not None and _recurrent(policy):
        carry += (policy.initial_state(n_envs, device=dev),
                  torch.ones(n_envs, dtype=torch.bool, device=dev))
    return carry


def init_carry(env, generator: torch.Generator, n_envs: int, policy=None):
    """:func:`init_env_states` in the reference's argument order."""
    return init_env_states(env, n_envs, generator, policy=policy)


def _rollout_steps(env, policy: Policy, params, carry, generator,
                   n_steps: int, action_noise: Optional[torch.Tensor],
                   deterministic: bool = False):
    """``n_steps`` env+policy steps from ``carry``; returns ``(new_carry,
    Trajectory)`` of ``(n_steps, N, ...)`` tensors. ``deterministic``
    takes the distribution's mode instead of a sample."""
    recurrent = _recurrent(policy)
    states, obs, ep_ret, ep_len = carry[:4]
    h = prev_done = h_new = None
    if recurrent:
        h0 = h = carry[4]
        prev_done = carry[5]
    n = obs.shape[0]
    steps = []
    with torch.no_grad():
        for t in range(n_steps):
            if recurrent:
                h_new, dist = policy.step(params, h, obs)
            else:
                dist = policy.apply(params, obs)
            if deterministic:
                actions = policy.dist.mode(dist)
            else:
                actions = policy.dist.sample(
                    dist,
                    noise=None if action_noise is None else action_noise[t],
                    generator=generator,
                )
            new_states, next_obs, rewards, terminated, truncated = env.step(
                states, actions
            )
            done = terminated | truncated
            ep_ret = ep_ret + rewards
            ep_len = ep_len + 1
            steps.append((obs, actions, rewards, terminated, done, dist,
                          next_obs, ep_ret, ep_len, prev_done, h, h_new))
            reset_states, reset_obs = env.reset(n, generator)
            sel = lambda a, b: torch.where(  # noqa: E731
                done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
            )
            states = tree_map(sel, reset_states, new_states)
            obs = sel(reset_obs, next_obs)
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            ep_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
            if recurrent:
                h = torch.where(done[:, None], torch.zeros_like(h_new),
                                h_new)
                prev_done = done
    cols = list(zip(*steps))
    stack = lambda xs: torch.stack(list(xs))  # noqa: E731
    traj = Trajectory(
        obs=stack(cols[0]), actions=stack(cols[1]), rewards=stack(cols[2]),
        terminated=stack(cols[3]), done=stack(cols[4]),
        old_dist={k: stack(d[k] for d in cols[5]) for k in cols[5][0]},
        next_obs=stack(cols[6]), episode_return=stack(cols[7]),
        episode_length=stack(cols[8]),
    )
    new_carry = (states, obs, ep_ret, ep_len)
    if recurrent:
        traj = traj._replace(reset=stack(cols[9]), policy_h0=h0,
                             policy_h=stack(cols[10]),
                             policy_h_next=stack(cols[11]))
        new_carry += (h, prev_done)
    return new_carry, traj


def concat_chunks(parts):
    """Trajectories of consecutive chunks joined along time; the window's
    ``policy_h0`` is the first chunk's."""
    if len(parts) == 1:
        return parts[0]
    h0 = parts[0].policy_h0
    joined = tree_map(lambda *xs: torch.cat(xs, dim=0),
                      *[p._replace(policy_h0=None) for p in parts])
    return joined._replace(policy_h0=h0)


def device_rollout(env, policy: Policy, params, carry, generator,
                   n_steps: int, action_noise: Optional[torch.Tensor] = None,
                   chunk: Optional[int] = None, deterministic: bool = False):
    """Collect ``n_steps × N`` transitions; returns ``(new_carry,
    Trajectory)``. ``action_noise`` (T, N, ...) passes pre-drawn noise for
    the action samples (standard normals for the Gaussian, standard Gumbel
    draws for the categorical); otherwise they and the reset perturbations
    come from ``generator``. ``chunk`` (a divisor of ``n_steps``) runs the
    rollout in time-chunks, bit-exact against ``chunk=None``.
    ``deterministic`` acts with the distribution's mode (greedy
    evaluation); resets still draw from ``generator``."""
    if chunk is None or chunk == n_steps:
        return _rollout_steps(env, policy, params, carry, generator, n_steps,
                              action_noise, deterministic)
    return ChunkedRollout(env, policy, chunk)(params, carry, generator,
                                              n_steps, action_noise,
                                              deterministic)


class ChunkedRollout:
    """A rollout driven chunk by chunk: ``n_steps // chunk`` calls of the
    step body over ``chunk`` steps each, the carry threaded across."""

    def __init__(self, env, policy: Policy, chunk: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.env, self.policy, self.chunk = env, policy, chunk

    def iter_chunks(self, params, carry, generator, n_steps: int,
                    action_noise: Optional[torch.Tensor] = None,
                    deterministic: bool = False):
        """Yield ``(carry_after, Trajectory_chunk)`` per chunk, each
        trajectory ``(chunk, N, ...)``; the last carry is the rollout's."""
        c = self.chunk
        if n_steps < 1 or n_steps % c:
            raise ValueError(
                f"rollout chunk ({c}) must divide the steps per rollout "
                f"({n_steps}) — pad batch_timesteps or pick a divisor"
            )
        for i in range(n_steps // c):
            noise = (None if action_noise is None
                     else action_noise[i * c:(i + 1) * c])
            carry, traj = _rollout_steps(self.env, self.policy, params, carry,
                                         generator, c, noise, deterministic)
            yield carry, traj

    def __call__(self, params, carry, generator, n_steps: int,
                 action_noise: Optional[torch.Tensor] = None,
                 deterministic: bool = False):
        """The whole ``(T, N, ...)`` trajectory, assembled from the
        chunks; returns ``(new_carry, Trajectory)``."""
        parts = []
        for carry, traj in self.iter_chunks(params, carry, generator,
                                            n_steps, action_noise,
                                            deterministic):
            parts.append(traj)
        return carry, concat_chunks(parts)


# ---------------------------------------------------------------------------
# Host envs
# ---------------------------------------------------------------------------


def params_device(params) -> torch.device:
    """The device of the first tensor of ``params``."""
    return next(t for t in tree_leaves(params)
                if isinstance(t, torch.Tensor)).device


def _obs_tensor(obs: np.ndarray, device) -> torch.Tensor:
    """Host observations as the policy reads them: uint8 pixels stay
    uint8, everything else becomes f32 (an f64 gymnasium observation
    rounds once, as the reference's cast does)."""
    t = torch.from_numpy(np.ascontiguousarray(obs))
    if t.dtype != torch.uint8:
        t = t.float()
    return t.to(device)


def _int_action_safe(policy) -> bool:
    """Integer actions pack exactly into f32 below 2²⁴: known for the
    categorical head (an index into its logits)."""
    return getattr(policy.dist, "name", None) == "categorical"


def make_host_act_fn(policy: Policy, deterministic: bool = False,
                     pack: bool = True):
    """The host loop's policy call: ``(params, obs, generator) ->
    (actions, dist)`` as numpy arrays (a recurrent policy takes a trailing
    ``h`` and returns a trailing ``h'``, which stays on the params'
    device). ``obs`` is a numpy batch; it is moved to the params' device.

    ``pack=True``: the actions and every distribution leaf are joined into
    one ``(N, K)`` f32 tensor on the device and fetched with ONE ``.cpu()``
    (each fetch is a device round trip), then split on the host; the
    split is exact (f32 leaves round-trip bitwise, categorical actions are
    integers below 2²⁴). ``pack=False`` fetches each array by itself."""
    recurrent = _recurrent(policy)

    def forward(params, obs, generator, h):
        dev = params_device(params)
        x = _obs_tensor(obs, dev)
        with torch.no_grad():
            h_new = None
            if recurrent:
                h_new, dist = policy.step(params, h, x)
            else:
                dist = policy.apply(params, x)
            action = (policy.dist.mode(dist) if deterministic
                      else policy.dist.sample(dist, generator=generator))
        return action, dist, h_new

    def fetch(action, dist):
        keys = sorted(dist)
        if pack and (action.is_floating_point() or _int_action_safe(policy)):
            n = action.shape[0]
            cols = [action.reshape(n, -1).float()] + [
                dist[k].reshape(n, -1).float() for k in keys]
            out = torch.cat(cols, dim=1).cpu().numpy()  # the ONE transfer
            a_cols = cols[0].shape[1]
            act = out[:, :a_cols].reshape(action.shape).astype(
                np.dtype(str(action.dtype).replace("torch.", "")))
            off, leaves = a_cols, {}
            for k, col in zip(keys, cols[1:]):
                c = col.shape[1]
                leaves[k] = out[:, off:off + c].reshape(dist[k].shape)
                off += c
            return act, leaves
        return (action.cpu().numpy(),
                {k: dist[k].cpu().numpy() for k in keys})

    if recurrent:
        def act_rec(params, obs, generator, h):
            action, dist, h_new = forward(params, obs, generator, h)
            return (*fetch(action, dist), h_new)

        return act_rec

    def act(params, obs, generator):
        action, dist, _ = forward(params, obs, generator, None)
        return fetch(action, dist)

    return act


class _Buffers:
    """``(T, N, ...)`` host buffers filled step by step; pinned when the
    trajectory goes to a CUDA device, so each field moves in one
    asynchronous copy. Steps write through numpy views of the buffers:
    a torch call per field would release and retake the GIL each time,
    a handoff to any other thread that wants it (the group workers)."""

    def __init__(self, n_steps: int, device: torch.device):
        self.T, self.device = n_steps, torch.device(device)
        self.pin = self.device.type == "cuda"
        self.host = {}
        self._views = {}

    def put(self, t: int, name: str, value: np.ndarray) -> None:
        view = self._views.get(name)
        if view is None:
            value = np.asarray(value)
            dtype = torch.from_numpy(np.zeros(1, value.dtype)).dtype
            buf = torch.empty((self.T,) + value.shape, dtype=dtype,
                              pin_memory=self.pin)
            self.host[name] = buf
            view = self._views[name] = buf.numpy()
        view[t] = value

    def to_device(self, stream=None) -> dict:
        """Every field on the device (``stream``: issue the copies there).
        The pinned buffers stay referenced by ``self`` until the caller is
        done with the copies."""
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            return {k: v.to(self.device, non_blocking=self.pin)
                    for k, v in self.host.items()}


_FIELD_CASTS = {"obs": None, "next_obs": None, "actions": None,
                "rewards": torch.float32, "terminated": torch.bool,
                "done": torch.bool, "ret": torch.float32,
                "len": torch.int32}


def _cast_obs(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.uint8 else t.float()


def _assemble(dev: dict) -> Trajectory:
    """A Trajectory from device fields named as the buffers name them."""
    cast = lambda k: dev[k].to(_FIELD_CASTS[k])  # noqa: E731
    actions = dev["actions"]
    if not actions.is_floating_point():
        actions = actions.long()
    return Trajectory(
        obs=_cast_obs(dev["obs"]),
        actions=actions,
        rewards=cast("rewards"),
        terminated=cast("terminated"),
        done=cast("done"),
        old_dist={k[len("dist."):]: v for k, v in dev.items()
                  if k.startswith("dist.")},
        next_obs=_cast_obs(dev["next_obs"]),
        episode_return=cast("ret"),
        episode_length=cast("len"),
    )


def _record_step(buf: _Buffers, t: int, obs, actions, dist, next_obs,
                 rewards, terminated, truncated, ret, length) -> np.ndarray:
    done = np.logical_or(terminated, truncated)
    buf.put(t, "obs", obs)
    buf.put(t, "actions", actions)
    for k, v in dist.items():
        buf.put(t, "dist." + k, v)
    buf.put(t, "next_obs", next_obs)
    buf.put(t, "rewards", np.asarray(rewards, np.float32))
    buf.put(t, "terminated", terminated)
    buf.put(t, "done", done)
    buf.put(t, "ret", ret)
    buf.put(t, "len", np.asarray(length, np.int32))
    return done


def host_rollout(vec_env, policy: Policy, params, generator, n_steps: int,
                 act_fn=None, policy_state=None, deterministic: bool = False,
                 step_callback=None, device=None):
    """Collect a ``(T, N)`` trajectory from a host env adapter; its tensors
    land on ``device`` (default: the params' device). ``act_fn`` is a
    :func:`make_host_act_fn` callable to reuse across calls; actions are
    sampled from ``generator`` (on the params' device).

    A recurrent policy carries ``policy_state = (h, prev_done)`` across
    windows (None: a fresh memory), zeroes ``h`` where an episode ended,
    and returns ``(Trajectory, (h, prev_done))``; the trajectory carries
    ``reset``/``policy_h0``/``policy_h``/``policy_h_next`` for the
    update's replay. ``step_callback(t)`` runs after step t's inference
    and before the env steps."""
    recurrent = _recurrent(policy)
    if act_fn is None:
        act_fn = make_host_act_fn(policy, deterministic=deterministic)
    pdev = params_device(params)
    device = pdev if device is None else torch.device(device)
    obs = vec_env.current_obs()
    N = vec_env.n_envs
    buf = _Buffers(n_steps, device)
    if recurrent:
        if policy_state is None:
            policy_state = (policy.initial_state(N, device=pdev),
                            torch.ones(N, dtype=torch.bool))
        h, prev_done = policy_state
        h = h.to(pdev)
        prev_done = torch.as_tensor(prev_done).cpu().numpy()
        h0, h_pre, h_post = h, [], []
    for t in range(n_steps):
        if recurrent:
            actions, dist, h_new = act_fn(params, obs, generator, h)
            buf.put(t, "reset", prev_done)
            h_pre.append(h)
            h_post.append(h_new)
        else:
            actions, dist = act_fn(params, obs, generator)
        if step_callback is not None:
            step_callback(t)
        next_obs, rewards, terminated, truncated, final_obs = \
            vec_env.host_step(actions)
        done = _record_step(buf, t, obs, actions, dist, final_obs, rewards,
                            terminated, truncated,
                            vec_env.last_episode_returns.copy(),
                            vec_env.last_episode_lengths.copy())
        obs = next_obs
        if recurrent:
            d = torch.from_numpy(done).to(pdev)
            h = torch.where(d[:, None], torch.zeros_like(h_new), h_new)
            prev_done = done
    dev = buf.to_device()
    traj = _assemble(dev)
    if not recurrent:
        return traj
    traj = traj._replace(
        reset=dev["reset"].to(torch.bool),
        policy_h0=h0.to(device),
        policy_h=torch.stack(h_pre).to(device),
        policy_h_next=torch.stack(h_post).to(device),
    )
    return traj, (h, torch.from_numpy(np.asarray(prev_done)))


def _group_generators(generator: torch.Generator, n_groups: int,
                     device) -> list:
    """``n_groups`` generators on ``device``, seeded from ``generator``:
    one draw of the caller's stream per window, so the groups' samples
    follow from the seed alone, whatever the threads' interleaving."""
    seeds = torch.randint(0, 2 ** 62, (n_groups,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def pipelined_host_rollout(vec_env, policy: Policy, params, generator,
                           n_steps: int, n_groups: int = 2, act_fn=None,
                           deterministic: bool = False,
                           stage_to_device: bool = False, device=None,
                           timer=None, group_offset: int = 0,
                           total_groups: Optional[int] = None):
    """:func:`host_rollout` with the envs split into ``n_groups``
    contiguous groups whose env steps run on worker threads, so one
    group's host stepping overlaps the next group's inference (see the
    module docstring). Feedforward policies only. ``timer`` (a
    ``utils.timers.PhaseTimer``) records each group's window as a span
    under the calling thread's open phase, ended on the worker thread
    that finishes it. ``group_offset``/``total_groups``: these groups are
    ``[group_offset, group_offset + n_groups)`` of a window of
    ``total_groups`` (a data rank's share on a mesh), so each samples from
    the generator that group draws in the one-rank run."""
    if _recurrent(policy):
        raise NotImplementedError(
            "pipelined_host_rollout supports feedforward policies; "
            "recurrent policies use host_rollout")
    if not hasattr(vec_env, "host_step_slice"):
        raise TypeError(
            f"{type(vec_env).__name__} has no host_step_slice — the env "
            "adapter does not support group stepping")
    N = vec_env.n_envs
    if not 2 <= n_groups <= N:
        raise ValueError(
            f"n_groups must be in [2, n_envs={N}], got {n_groups} "
            "(1 group is host_rollout)")
    if act_fn is None:
        act_fn = make_host_act_fn(policy, deterministic=deterministic)
    pdev = params_device(params)
    device = pdev if device is None else torch.device(device)
    total = total_groups or n_groups
    # the one-rank window's cuts (its N·total/n_groups envs), then this
    # share's: a rank's share starts at a cut of the whole window
    cuts = np.linspace(0, N * total // n_groups, total + 1).round().astype(
        int)[group_offset:group_offset + n_groups + 1]
    cuts = cuts - cuts[0]
    groups = [(int(cuts[g]), int(cuts[g + 1])) for g in range(n_groups)]
    gens = _group_generators(generator, total, pdev)[
        group_offset:group_offset + n_groups]
    obs0 = vec_env.current_obs()
    bufs = [_Buffers(n_steps, device) for _ in range(n_groups)]
    context = timer.current_context() if timer is not None else ()
    spans = [timer.span(f"group{g}", context=context) if timer else None
             for g in range(n_groups)]

    def step(g: int, t: int, obs, actions, dist):
        """Group ``g``'s env step ``t``, on a worker thread; returns the
        group's next observations."""
        lo, hi = groups[g]
        next_obs, rewards, terminated, truncated, final_obs = \
            vec_env.host_step_slice(actions, lo, hi)
        _record_step(bufs[g], t, obs, actions, dist, final_obs, rewards,
                     terminated, truncated,
                     vec_env.last_episode_returns[lo:hi].copy(),
                     vec_env.last_episode_lengths[lo:hi].copy())
        if t == n_steps - 1 and spans[g] is not None:
            spans[g].end()
        return next_obs

    stage = (torch.cuda.Stream(device) if stage_to_device
             and device.type == "cuda" else None)
    staged = []
    deferred = hasattr(vec_env, "begin_deferred_fold")
    if deferred:
        vec_env.begin_deferred_fold()
    try:
        with concurrent.futures.ThreadPoolExecutor(n_groups) as pool:
            obs = [obs0[lo:hi] for lo, hi in groups]
            pending = [None] * n_groups
            for t in range(n_steps):
                for g in range(n_groups):
                    if pending[g] is not None:
                        obs[g] = pending[g].result()
                    actions, dist = act_fn(params, obs[g], gens[g])
                    pending[g] = pool.submit(step, g, t, obs[g], actions,
                                             dist)
            for g in range(n_groups):
                pending[g].result()  # re-raises a group's exception
                if stage_to_device:
                    # this group's slice streams to the device while the
                    # later groups finish their last step
                    staged.append(bufs[g].to_device(stream=stage))
    finally:
        if deferred:
            vec_env.end_deferred_fold()

    if stage_to_device:
        if stage is not None:
            main = torch.cuda.current_stream(device)
            main.wait_stream(stage)
            for part in staged:
                for t in part.values():
                    t.record_stream(main)
        joined = {k: torch.cat([p[k] for p in staged], dim=1)
                  for k in staged[0]}
    else:
        whole = _Buffers(n_steps, device)
        whole.host = {
            k: torch.cat([b.host[k] for b in bufs], dim=1).pin_memory()
            if whole.pin else torch.cat([b.host[k] for b in bufs], dim=1)
            for k in bufs[0].host}
        joined = whole.to_device()
    return _assemble(joined)
