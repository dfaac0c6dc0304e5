"""The port's training on host envs against the reference's tests
(``tests/test_async_pipeline.py``, ``tests/test_host_env_checkpoint.py``,
``tests/test_host_inference.py``): one policy phase on a trajectory the
reference collected from ``gym:HalfCheetah-v4``, the asynchronous driver
bitwise equal to the serial one, the ``StatsDrain`` contract, resume from
the host-env sidecar, the sidecar's format, greedy evaluation on a host
env, and the construction-time checks.
"""

import importlib.util
import io
import math
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_torch import train
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig, get_preset
from trpo_torch.ops.flat import flatten_params
from trpo_torch.utils.async_pipe import StatsDrain
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.metrics import StatsLogger

from test_torch_checkpoint import assert_state_equal

_TINY = dict(env="native:pendulum", n_envs=4, batch_timesteps=48,
             vf_train_steps=3, cg_iters=4, policy_hidden=(16,),
             vf_hidden=(16,), seed=3, max_pathlength=9)
_TIME_KEYS = {"time_elapsed_min", "iteration_ms"}


def _learn(cfg, n, tmp_path, tag, checkpointer=None, state=None,
           agent=None):
    path = str(tmp_path / f"{tag}.jsonl")
    agent = agent or TRPOAgent(cfg.env, cfg, device="cpu")
    logger = StatsLogger(jsonl_path=path, stream=io.StringIO())
    final = agent.learn(n_iterations=n, logger=logger, state=state,
                        checkpointer=checkpointer)
    logger.close()
    with open(path) as f:
        return agent, final, [json.loads(line) for line in f]


def _assert_rows_equal(a, b, skip=()):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for k in ra:
            if k not in _TIME_KEYS and k not in skip:
                assert ra[k] == rb[k] or (ra[k] != ra[k] and rb[k] != rb[k]), \
                    (k, ra[k], rb[k])


@pytest.mark.parametrize("extra", [
    {},
    {"normalize_obs": True},
    {"env": "native:cartpole"},
])
def test_async_learn_bitwise_equals_serial(tmp_path, extra):
    cfg = TRPOConfig(**{**_TINY, **extra})
    _, f_ser, r_ser = _learn(cfg, 3, tmp_path, "serial")
    _, f_asy, r_asy = _learn(cfg.replace(host_async_pipeline=True), 3,
                             tmp_path, "async")
    assert_state_equal(f_ser, f_asy)
    _assert_rows_equal(r_ser, r_asy)
    assert [r["iteration"] for r in r_asy] == [1, 2, 3]


def test_async_grouped_staged_equals_serial_unstaged(tmp_path):
    cfg = TRPOConfig(**_TINY, host_pipeline_groups=2,
                     host_staged_transfers=False)
    _, f_a, r_a = _learn(cfg, 3, tmp_path, "grp_serial")
    _, f_b, r_b = _learn(cfg.replace(host_staged_transfers=True,
                                     host_async_pipeline=True), 3,
                         tmp_path, "grp_async")
    assert_state_equal(f_a, f_b)
    _assert_rows_equal(r_a, r_b)


def test_async_early_stop_logs_every_iteration_once(tmp_path):
    cfg = TRPOConfig(**{**_TINY, "env": "native:cartpole"},
                     host_async_pipeline=True, reward_target=3.0)
    _, final, rows = _learn(cfg, 30, tmp_path, "stop")
    assert final.iteration < 30
    assert [r["iteration"] for r in rows] == list(range(1, final.iteration
                                                        + 1))


def test_stats_drain_in_order_exactly_once_and_waits_for_ready():
    seen = []

    class Ready:
        def __init__(self):
            self.waited = False

        def synchronize(self):
            self.waited = True

    readies = [Ready() for _ in range(10)]
    drain = StatsDrain(lambda tag, stats: seen.append((tag, stats["v"])),
                       fetch=lambda s: {"v": float(s["v"])})
    for i in range(10):
        drain.submit(i, {"v": torch.tensor(float(i))}, ready=readies[i])
    drain.drain()
    drain.close()
    assert seen == [(i, float(i)) for i in range(10)]
    assert all(r.waited for r in readies)
    with pytest.raises(RuntimeError, match="closed"):
        drain.submit(10, {})


def test_stats_drain_stop_still_delivers_submitted():
    seen = []
    drain = StatsDrain(lambda tag, stats: seen.append(tag) or tag == 2)
    for i in range(6):
        drain.submit(i, {})
    drain.drain()
    assert drain.stop_requested
    drain.close()
    assert seen == list(range(6))


def test_stats_drain_propagates_errors_and_discards_after():
    seen = []

    def consume(tag, stats):
        seen.append(tag)
        if tag == 1:
            raise FloatingPointError("boom")

    drain = StatsDrain(consume)
    for i in range(4):
        drain.submit(i, {})
    with pytest.raises(FloatingPointError, match="boom"):
        drain.drain()
    assert seen == [0, 1] and drain.stop_requested
    with pytest.raises(FloatingPointError):
        drain.close()


def test_stats_drain_bound_blocks_submit():
    gate = threading.Event()
    drain = StatsDrain(lambda tag, stats: gate.wait(), maxsize=2)
    for i in range(3):  # one in the consumer, two queued
        drain.submit(i, {})
    t0 = time.perf_counter()
    threading.Timer(0.3, gate.set).start()
    drain.submit(3, {})  # blocks until the consumer frees a slot
    assert time.perf_counter() - t0 > 0.2
    assert drain.high_water <= 2
    drain.close()


@pytest.mark.parametrize("async_", [False, True])
def test_resume_from_sidecar_is_bitwise(tmp_path, async_):
    cfg = TRPOConfig(**_TINY, normalize_obs=True, checkpoint_every=2,
                     host_async_pipeline=async_)
    ck_a = Checkpointer(str(tmp_path / "a"))
    agent_a, final_a, rows_a = _learn(cfg, 4, tmp_path, "a", ck_a)
    assert ck_a.all_steps() == [2, 4]
    snap_a = agent_a.snapshot_host_env()

    # a fresh process: restore step 2's state AND its env, run 2 more
    ck = Checkpointer(str(tmp_path / "a"))
    agent_b = TRPOAgent(cfg.env, cfg, device="cpu")
    state = ck.restore(agent_b.init_state(), step=2)
    agent_b.restore_host_env(ck.restore_host_env(step=2))
    _, final_b, rows_b = _learn(cfg, 2, tmp_path, "b", state=state,
                                agent=agent_b)
    assert_state_equal(final_a, final_b)
    # a resumed run restarts the running episode mean's window
    _assert_rows_equal(rows_a[2:], rows_b, skip={"reward_running"})
    snap_b = agent_b.snapshot_host_env()
    for k in ("state", "t", "rng", "obs", "raw_obs", "running_returns",
              "running_lengths", "last_returns", "last_lengths"):
        np.testing.assert_array_equal(snap_a[k], snap_b[k], err_msg=k)


def test_cli_resume_restores_the_sidecar(tmp_path):
    base = ["--preset", "pendulum", "--env", "native:cartpole",
            "--n-envs", "4", "--batch-timesteps", "32", "--cg-iters", "3",
            "--policy-hidden", "8", "--device", "cpu", "--checkpoint-dir",
            str(tmp_path / "ck"), "--checkpoint-every", "1",
            "--host-pipeline-groups", "2", "--host-async-pipeline"]
    assert train.main(base + ["--iterations", "2"]) == 0
    ck = Checkpointer(str(tmp_path / "ck"))
    snap = ck.restore_host_env()
    assert snap["kind"] == "cartpole" and snap["rng"].dtype == np.uint64
    assert train.main(base + ["--iterations", "1", "--resume"]) == 0
    assert ck.latest_step() == 3


def test_sidecar_is_pickle_free_keeps_uint64_and_is_pruned(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    rng = np.array([2 ** 64 - 1, 2 ** 63 + 5], np.uint64)
    snap = {"rng": rng, "nested": [{"a": np.arange(3)}, (1, None)],
            "big": 2 ** 100, "f": np.float32(0.5)}
    state = {"x": torch.zeros(2)}
    for step in (1, 2, 3):
        ck.save(step, state, host_env=snap)
    assert ck.all_steps() == [2, 3]
    assert not os.path.exists(tmp_path / "ck" / "step_1")
    path = tmp_path / "ck" / "step_3" / "host_env.npz"
    with np.load(path, allow_pickle=False) as z:  # loads without pickle
        assert "__structure__" in z.files
    back = ck.restore_host_env()
    assert back["rng"].dtype == np.uint64
    np.testing.assert_array_equal(back["rng"], rng)
    assert back["nested"][1] == (1, None) and back["big"] == 2 ** 100
    np.testing.assert_array_equal(back["nested"][0]["a"], np.arange(3))
    ck.save(4, state)  # a device-env step: no sidecar
    assert ck.restore_host_env() is None
    path.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="unreadable"):
        ck.restore_host_env(step=3)
    with pytest.raises(TypeError, match="object"):
        ck.save(5, state, host_env={"o": np.array([None], object)})


def test_sidecar_is_written_before_the_marker(tmp_path, monkeypatch):
    from trpo_torch.utils import checkpoint as ck_mod

    ck = Checkpointer(str(tmp_path / "ck"))
    order = []
    real = ck_mod._write_synced
    monkeypatch.setattr(ck_mod, "_write_synced", lambda path, write: (
        order.append(os.path.basename(path)), real(path, write)))
    ck.save(1, {"x": torch.zeros(1)}, host_env={"a": np.zeros(1)})
    assert order.index("host_env.npz") < order.index("step_1.complete")


def test_evaluate_on_host_env_leaves_training_stats_unmoved():
    cfg = TRPOConfig(**_TINY, normalize_obs=True)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state, _ = agent.run_iteration(agent.init_state())
    before = agent.env.obs_stats_state()
    mean_a, n_a = agent.evaluate(state, n_steps=20, seed=5)
    mean_b, n_b = agent.evaluate(state, n_steps=20, seed=5)
    assert (mean_a, n_a) == (mean_b, n_b) and n_a > 0  # seeded: repeats
    for x, y in zip(agent.env.obs_stats_state(), before):
        np.testing.assert_array_equal(x, y)
    assert agent.env._running_lengths.sum() == 0  # hard-reset after
    state, stats = agent.run_iteration(state)  # training continues
    assert np.isfinite(float(stats["entropy"]))


def test_recurrent_policy_trains_on_a_host_env():
    cfg = TRPOConfig(**{**_TINY, "env": "native:cartpole"}, policy_gru=8)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state = agent.init_state()
    h0 = state.env_carry[0].clone()
    for _ in range(2):
        state, stats = agent.run_iteration(state)
    assert not torch.equal(state.env_carry[0], h0)
    assert np.isfinite(float(stats["kl_old_new"]))
    agent.evaluate(state, n_steps=5)
    assert agent._host_env_reset_pending
    state, _ = agent.run_iteration(state)
    assert not agent._host_env_reset_pending


def test_host_inference_cpu_carries_its_generator(tmp_path):
    cfg = TRPOConfig(**_TINY, host_inference="cpu", host_pipeline_groups=2)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state = agent.init_state()
    assert state.host_rng.device.type == "cpu"
    g0 = state.host_rng.get_state().clone()
    state, _ = agent.run_iteration(state)
    assert not torch.equal(state.host_rng.get_state(), g0)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    assert_state_equal(ck.restore(agent.init_state()), state)


@pytest.mark.parametrize("kw, env, match", [
    ({"host_async_pipeline": True}, "cartpole", "host-simulator"),
    ({"host_pipeline_groups": 2}, "pendulum", "host-simulator"),
    ({"host_inference": "cpu"}, "cartpole", "host-simulator"),
    ({"host_async_pipeline": True, "policy_gru": 8}, "native:cartpole",
     "feedforward"),
    ({"host_pipeline_groups": 2, "policy_gru": 8}, "native:cartpole",
     "feedforward"),
    ({"host_pipeline_groups": 5}, "native:cartpole", "exceeds"),
    ({"rollout_chunk": 2, "batch_timesteps": 32}, "native:cartpole",
     "rollout_chunk"),
])
def test_host_options_are_checked_at_construction(kw, env, match):
    cfg = TRPOConfig(**{**_TINY, "env": env, **kw})
    with pytest.raises(ValueError, match=match):
        TRPOAgent(env, cfg, device="cpu")


@pytest.mark.parametrize("kw, match", [
    ({"host_inference": "tpu"}, "host_inference"),
    ({"host_pipeline_groups": 0}, "host_pipeline_groups"),
    ({"stats_drain_maxsize": -1}, "stats_drain_maxsize"),
    ({"cg_precond_probes": 0}, "cg_precond_probes"),
    ({"train_overlap": 1, "rollout_chunk": 1, "host_async_pipeline": True},
     "mutually exclusive"),
])
def test_config_rejects_what_the_reference_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        TRPOConfig(**kw)


def test_cli_flags_map_to_config():
    args = train.parse_args([
        "--preset", "pendulum", "--env", "native:pendulum",
        "--host-pipeline-groups", "3", "--host-async-pipeline",
        "--no-host-staged-transfers", "--host-inference", "cpu",
        "--stats-drain-maxsize", "4", "--cg-precondition", "jacobi",
        "--cg-precond-probes", "5", "--fvp-mode", "jvp_grad"])
    cfg = train.build_config(args)
    assert (cfg.env, cfg.host_pipeline_groups, cfg.host_async_pipeline,
            cfg.host_staged_transfers, cfg.host_inference,
            cfg.stats_drain_maxsize, cfg.cg_precondition,
            cfg.cg_precond_probes, cfg.fvp_mode) == (
        "native:pendulum", 3, True, False, "cpu", 4, "jacobi", 5,
        "jvp_grad")


needs_mujoco = pytest.mark.skipif(
    importlib.util.find_spec("gymnasium") is None
    or importlib.util.find_spec("mujoco") is None,
    reason="gymnasium or mujoco unavailable")


@needs_mujoco
def test_policy_phase_on_reference_halfcheetah_trajectory():
    from trpo_tpu.agent import TRPOAgent as TpuAgent
    from trpo_tpu.config import get_preset as tpu_get_preset
    from trpo_tpu.ops import flatten_params as tpu_flatten
    from trpo_torch.convert import (
        policy_params_from_numpy,
        trajectory_from_numpy,
        vf_state_from_numpy,
    )

    narrow = dict(n_envs=4, batch_timesteps=64, max_pathlength=10,
                  policy_hidden=(32, 32), solve_audit_every=0)
    tpu_agent = TpuAgent("gym:HalfCheetah-v4",
                         tpu_get_preset("halfcheetah").replace(**narrow))
    ref_state = tpu_agent.init_state(seed=0)
    ref_state = ref_state._replace(vf_state=ref_state.vf_state._replace(
        initialized=jnp.asarray(True)))
    from trpo_tpu.rollout import host_rollout as tpu_host_rollout
    traj = tpu_host_rollout(tpu_agent.env, tpu_agent.policy,
                            ref_state.policy_params, jax.random.key(5),
                            tpu_agent.n_steps)
    traj_np = jax.tree_util.tree_map(np.array, traj)
    assert traj_np.done.any()  # truncations inside the window
    vf_np = jax.tree_util.tree_map(np.array, ref_state.vf_state)
    adam = vf_np.opt_state[0]

    cfg = get_preset("halfcheetah").replace(**narrow)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    assert agent.obs_shape == (17,)
    state = agent.init_state(seed=0)._replace(
        policy_params=policy_params_from_numpy(
            jax.tree_util.tree_map(np.array, ref_state.policy_params)),
        vf_state=vf_state_from_numpy(vf_np.params, adam.mu, adam.nu,
                                     int(adam.count), True))
    ref_new, ref_pack = jax.jit(tpu_agent._policy_phase)(ref_state, traj)
    new, pack = agent._policy_phase(state, trajectory_from_numpy(traj_np))
    want = np.asarray(tpu_flatten(ref_new.policy_params)[0], np.float64)
    got = flatten_params(new.policy_params)[0].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    assert new.precond.age == 1
    assert int(pack["trpo_stats"].cg_iterations) == int(
        ref_pack["trpo_stats"].cg_iterations)


@needs_mujoco
def test_halfcheetah_preset_cli_on_cpu(capsys):
    assert train.main([
        "--preset", "halfcheetah", "--iterations", "1", "--n-envs", "2",
        "--batch-timesteps", "32", "--policy-hidden", "16,16",
        "--solve-audit-every", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "env=gym:HalfCheetah-v4" in out and "iter 1 " in out


def test_restore_of_a_state_saved_before_host_rng(tmp_path):
    # a checkpoint written before TrainState gained host_rng restores, and
    # the field comes back absent (None) as the template has it
    agent = TRPOAgent("cartpole", TRPOConfig(n_envs=2, batch_timesteps=8,
                                             policy_hidden=(4,)),
                      device="cpu")
    state = agent.init_state()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    path = tmp_path / "step_1" / "state.json"
    saved = json.loads(path.read_text())
    del saved["state"]["fields"]["host_rng"]
    path.write_text(json.dumps(saved))
    back = ck.restore(agent.init_state())
    assert back.host_rng is None
    assert_state_equal(back, state)


@needs_mujoco
@pytest.mark.slow
@pytest.mark.parametrize("preset", ["halfcheetah", "humanoid"])
def test_mujoco_presets_run_unchanged_on_cpu(preset):
    # BASELINE.json configs 3 and 4 at full width: humanoid is 64 MuJoCo
    # envs x 782 steps and the flagship's 376→256→256→17 policy
    cfg = get_preset(preset)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state, stats = agent.run_iteration(agent.init_state())
    assert math.isfinite(float(stats["kl_old_new"]))
    assert float(stats["kl_old_new"]) <= 2 * cfg.max_kl
    assert bool(stats["solve_audited"])  # update 1 of the ladder
