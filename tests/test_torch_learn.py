"""The port's ``learn`` loop and CLI, case by case against the
reference's tests (``tests/test_train_cli.py``,
``tests/test_multi_iteration.py``, ``tests/test_episode_stats.py``,
``tests/test_resilience.py``): JSONL rows, checkpoint/resume, greedy
evaluation, fused chunks, the running episode mean, preemption, NaN
recovery, the port bench's CPU path, and the port's first rule (it
imports nothing of JAX or ``trpo_tpu``).
"""

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from trpo_tpu.envs.episode_stats import RunningEpisodeMean as TpuMean
from trpo_torch import bench, train
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.envs.episode_stats import RunningEpisodeMean
from trpo_torch.resilience import (
    Preempted,
    PreemptionGuard,
    RecoveryPolicy,
    TrainingDiverged,
)
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.metrics import StatsLogger, repair_jsonl_tail
from trpo_torch.utils.timers import PhaseTimer

from test_torch_checkpoint import assert_equal, assert_state_equal

REPO = Path(__file__).resolve().parents[1]
TINY = ["--preset", "cartpole", "--iterations", "2", "--batch-timesteps",
        "64", "--n-envs", "4", "--cg-iters", "4", "--reward-target",
        "100000", "--device", "cpu"]


def _cfg(**kw):
    base = dict(env="cartpole", n_iterations=4, n_envs=4, batch_timesteps=64,
                cg_iters=4, vf_train_steps=5, policy_hidden=(16,), seed=7)
    base.update(kw)
    return TRPOConfig(**base)


def _agent(**kw):
    return TRPOAgent("cartpole", _cfg(**kw), device="cpu")


class Recorder(StatsLogger):
    """A logger that keeps each row instead of printing it."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def log(self, iteration, stats):
        self.rows.append((iteration, dict(stats)))


def test_cli_trains_and_logs_reference_keys(tmp_path, capsys):
    jsonl = tmp_path / "stats.jsonl"
    assert train.main(TINY + ["--log-jsonl", str(jsonl)]) == 0
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2]
    # the reference's seven stats, and learn()'s row decorations
    for key in ("total_episodes", "mean_episode_reward", "entropy",
                "vf_explained_variance", "kl_old_new", "surrogate_loss",
                "time_elapsed_min", "reward_running", "iteration_ms",
                "timesteps_total"):
        assert key in rows[0], key
    assert rows[1]["timesteps_total"] == 128
    assert isinstance(rows[0]["linesearch_success"], bool)
    assert isinstance(rows[0]["episodes_in_batch"], int)
    out = capsys.readouterr().out
    assert "done: 2 iterations" in out and "iter 2 " in out


def test_cli_checkpoint_resume(tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    assert train.main(TINY + ["--checkpoint-dir", ckdir,
                              "--checkpoint-every", "1"]) == 0
    capsys.readouterr()
    assert train.main(TINY[:2] + ["--iterations", "1"] + TINY[4:]
                      + ["--checkpoint-dir", ckdir, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "done: 3 iterations" in out


@pytest.mark.parametrize("preset, extra", [
    ("cartpole", []),
    ("cartpole-po", ["--policy-hidden", "16", "--policy-gru", "8"]),
])
def test_cli_resume_from_step_1_is_bitwise(tmp_path, capsys, preset, extra):
    # the [learn] resume legs of chip_smoke.py at CPU size: 2 iterations
    # with a checkpoint at 1, then a run resumed from a copy of step 1
    # must reach the same step-2 state leaf by leaf
    base = ["--preset", preset, "--batch-timesteps", "64", "--n-envs", "4",
            "--cg-iters", "4", "--device", "cpu", "--checkpoint-every",
            "1"] + extra
    a, b = tmp_path / "a", tmp_path / "b"
    assert train.main(base + ["--iterations", "2", "--checkpoint-dir",
                              str(a)]) == 0
    b.mkdir()
    os.rename(a / "step_1", b / "step_1")
    for name in ("step_1.complete", ".markers_enabled"):
        os.rename(a / name, b / name)
    capsys.readouterr()
    assert train.main(base + ["--iterations", "1", "--checkpoint-dir",
                              str(b), "--resume"]) == 0
    assert "resumed from step 1" in capsys.readouterr().out
    cfg = train.build_config(train.parse_args(base))
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    want = Checkpointer(str(a)).restore(agent.init_state(), step=2)
    got = Checkpointer(str(b)).restore(agent.init_state(), step=2)
    assert got.iteration == want.iteration == 2
    assert_state_equal(want, got)


def test_cli_evaluate(capsys):
    assert train.main(TINY + ["--evaluate", "64"]) == 0
    assert "greedy eval:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.parse_args(["--evaluate", "0"])
    capsys.readouterr()


def test_run_iterations_matches_sequential_and_rejects_zero():
    agent = _agent()
    s_seq = agent.init_state(0)
    seq = []
    for _ in range(3):
        s_seq, stats = agent.run_iteration(s_seq)
        seq.append(stats)
    s_run, stack = agent.run_iterations(agent.init_state(0), 3)
    assert stack["entropy"].shape == (3,) and s_run.iteration == 3
    assert_state_equal(s_seq, s_run)
    for j, stats in enumerate(seq):
        for k, v in stats.items():
            assert_equal(torch.as_tensor(v), stack[k][j])
    with pytest.raises(ValueError):
        agent.run_iterations(agent.init_state(0), 0)


def test_learn_fused_chunks_match_unfused_exactly():
    a1, log1 = _agent(), Recorder()
    s1 = a1.learn(n_iterations=4, state=a1.init_state(0), logger=log1)
    a2, log2 = _agent(fuse_iterations=3), Recorder()
    s2 = a2.learn(n_iterations=4, state=a2.init_state(0), logger=log2)
    assert [i for i, _ in log1.rows] == [1, 2, 3, 4]
    assert [i for i, _ in log2.rows] == [1, 2, 3, 4]  # chunk 3, then 1
    assert_state_equal(s1, s2)
    skip = ("time_elapsed_min", "iteration_ms")  # wall-clock fields
    for (_, r1), (_, r2) in zip(log1.rows, log2.rows):
        for k in r1:
            if k not in skip:
                assert (r1[k] == r2[k]) or (r1[k] != r1[k] and r2[k] != r2[k])


def test_learn_fused_stop_and_checkpoint(tmp_path):
    agent = _agent(fuse_iterations=2, reward_target=5.0, checkpoint_every=2)
    ck = Checkpointer(str(tmp_path / "ck"))
    state = agent.learn(n_iterations=10, state=agent.init_state(0),
                        checkpointer=ck, logger=Recorder())
    # CartPole rewards exceed 5 at once: the first chunk stops the run
    assert state.iteration == 2 and ck.latest_step() == 2


@pytest.mark.parametrize("updates", [
    [(float("nan"), 0)],
    [(10.0, 2), (float("nan"), 0), (40.0, 1)],
    [(0.0, 5), (10.0, 1), (20.0, 1), (3.5, 4), (float("nan"), 0)],
])
def test_running_episode_mean_matches_reference(updates):
    for window in (2, 100):
        ref, got = TpuMean(window), RunningEpisodeMean(window)
        for mean, n in updates:
            ref.update(mean, n)
            got.update(mean, n)
            assert got.count == ref.count
            assert (got.mean == ref.mean) or (math.isnan(got.mean)
                                               and math.isnan(ref.mean))


def test_sigterm_from_callback_checkpoints_and_resumes(tmp_path):
    agent = _agent(n_iterations=6, checkpoint_every=2)
    ck = Checkpointer(str(tmp_path / "ck"))

    def callback(state, stats):
        if state.iteration == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Preempted) as ei:
        agent.learn(checkpointer=ck, callback=callback, logger=Recorder())
    assert signal.getsignal(signal.SIGTERM) is prev  # handler restored
    assert ei.value.step == 3 and ck.latest_step() == 3
    assert ei.value.exit_code == 75 and ei.value.signum == signal.SIGTERM
    state = ck.restore(agent.init_state())
    assert state.iteration == 3
    final = _agent().learn(n_iterations=1, state=state, logger=Recorder())
    assert final.iteration == 4


def test_on_preempt_ignore_installs_no_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard(enabled=False) as g:
        assert signal.getsignal(signal.SIGTERM) is prev
        assert not g.triggered
    seen = []
    _agent(on_preempt="ignore").learn(
        n_iterations=1, logger=Recorder(),
        callback=lambda s, r: seen.append(signal.getsignal(signal.SIGTERM)))
    assert seen == [prev]


def _poisoning(agent, at_iterations):
    """Patch ``agent.run_iteration`` to turn the policy's log-std to NaN
    before the iterations numbered ``at_iterations`` (once each, in
    order), so the update's entropy comes out NaN."""
    real, pending = agent.run_iteration, list(at_iterations)

    def run_iteration(state):
        if pending and state.iteration + 1 == pending[0]:
            pending.pop(0)
            params = dict(state.policy_params)
            params["net"] = dict(params["net"])
            layers = [dict(layer) for layer in params["net"]["layers"]]
            layers[-1]["b"] = torch.full_like(layers[-1]["b"], float("nan"))
            params["net"]["layers"] = layers
            state = state._replace(policy_params=params)
        return real(state)

    agent.run_iteration = run_iteration


def test_nan_recovery_restores_and_continues_bit_exactly():
    clean, log_c = _agent(), Recorder()
    s_clean = clean.learn(logger=log_c)
    faulty, log_f = _agent(recover_on_nan="restore"), Recorder()
    _poisoning(faulty, [2])
    s_fault = faulty.learn(logger=log_f)
    assert [i for i, _ in log_f.rows] == [1, 2, 2, 3, 4]
    assert math.isnan(log_f.rows[1][1]["entropy"])
    assert_state_equal(s_clean, s_fault)
    finite = [r for r in log_f.rows if not math.isnan(r[1]["entropy"])]
    for (ic, rc), (i_f, rf) in zip(log_c.rows, finite):
        assert ic == i_f
        for k in ("entropy", "kl_old_new", "surrogate_loss", "vf_loss",
                  "reward_running"):
            assert rc[k] == rf[k] or (rc[k] != rc[k] and rf[k] != rf[k])


def test_consecutive_nans_raise_training_diverged():
    agent = _agent(recover_on_nan="restore", max_recoveries=2)
    _poisoning(agent, [2, 2, 2])
    with pytest.raises(TrainingDiverged):
        agent.learn(logger=Recorder())


def test_nan_entropy_without_recovery_raises_after_logging():
    agent, log = _agent(), Recorder()
    _poisoning(agent, [2])
    with pytest.raises(FloatingPointError):
        agent.learn(logger=log)
    assert [i for i, _ in log.rows] == [1, 2]
    assert math.isnan(log.rows[-1][1]["entropy"])


def test_recovery_policy_counts_and_escalates_damping():
    cfg = _cfg(recover_on_nan="restore", max_recoveries=2,
               adaptive_damping=True)
    state = TRPOAgent("cartpole", cfg, device="cpu").init_state()
    policy = RecoveryPolicy(cfg)
    for n in range(2):
        policy.snapshot(n + 1, state)
        policy.flag(n + 1, "nan_entropy")
        _, state = policy.recover()
    assert float(state.cg_damping) == pytest.approx(0.1 * 2.0 ** 2)
    policy.snapshot(3, state)
    policy.flag(3, "nan_entropy")
    with pytest.raises(TrainingDiverged):
        policy.recover()
    # a clean row at the recovered iteration resets the count, one
    # before it does not
    policy2 = RecoveryPolicy(cfg)
    policy2.snapshot(3, state)
    policy2.flag(3, "nan_guard")
    policy2.recover()
    policy2.mark_clean(2)
    assert policy2.consecutive == 1
    policy2.mark_clean(3)
    assert policy2.consecutive == 0


def test_snapshot_is_a_deep_copy_of_the_generator():
    agent = _agent()
    state = agent.init_state()
    policy = RecoveryPolicy(agent.cfg)
    policy.snapshot(1, state)
    before = state.rng.get_state()
    agent.run_iteration(state)  # advances state.rng in place
    policy.flag(1, "nan_guard")
    _, restored = policy.recover()
    assert torch.equal(restored.rng.get_state(), before)


def test_jsonl_tail_repaired_on_open(tmp_path):
    path = tmp_path / "run.jsonl"
    path.write_text('{"iteration": 1}\n{"iteration": 2, "entr')
    logger = StatsLogger(jsonl_path=str(path), stream=open(os.devnull, "w"))
    logger.log(2, {"entropy": 1.5})
    logger.close()
    logger.close()  # idempotent
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows == [{"iteration": 1}, {"iteration": 2, "entropy": 1.5}]
    assert repair_jsonl_tail(str(path)) == 0
    assert repair_jsonl_tail(str(tmp_path / "absent.jsonl")) == 0


def test_phase_timer_nests_and_blocks():
    timer = PhaseTimer()
    with torch.profiler.profile() as prof:
        with timer.phase("iteration"):
            with timer.phase("rollout", block_on={"x": torch.ones(3)}):
                pass
    # the profiler's own state makes each phase a named range
    assert {"iteration", "iteration/rollout"} <= {e.name
                                                  for e in prof.events()}
    summary = timer.summary()
    assert set(summary) == {"iteration", "iteration/rollout"}
    assert summary["iteration"]["calls"] == 1
    assert timer.last_ms("iteration") >= timer.last_ms("iteration/rollout")


def test_act_needs_a_generator_in_train_mode():
    agent = _agent()
    state = agent.init_state()
    with pytest.raises(ValueError, match="generator"):
        agent.act(state, np.zeros(4, np.float32))
    gen = torch.Generator().manual_seed(0)
    action, dist = agent.act(state, np.zeros(4, np.float32), generator=gen)
    assert action.shape == () and dist["logits"].shape == (2,)
    greedy, _ = agent.act(state, np.zeros((5, 4), np.float32),
                          eval_mode=True)
    assert greedy.shape == (5,)


def test_evaluate_leaves_training_state_untouched():
    agent = _agent()
    state = agent.init_state()
    before = state.rng.get_state()
    mean_ret, n_done = agent.evaluate(state, n_steps=400, seed=3)
    assert torch.equal(state.rng.get_state(), before)
    assert n_done > 0 and math.isfinite(mean_ret)
    assert agent.evaluate(state, n_steps=400, seed=3) == (mean_ret, n_done)
    # no episode ends inside 40 greedy steps here: the partial return
    assert agent.evaluate(state, n_steps=40, seed=3) == (40.0, 0)
    with pytest.raises(ValueError):
        agent.evaluate(state, n_steps=0)


def test_bench_cpu_path_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu", "--batch", "512"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "cg_solve_ms_per_iter" and out["device"] == "cpu"
    assert set(out["paths"]) == {"k1_f32", "k1_bf16", "ggn_torch_func"}
    assert out["value"] == out["paths"]["k1_f32"] > 0
    assert out["updates_per_s"] > 0 and out["vs_baseline"] > 0
    assert out["solution_cosine_vs_baseline"] > 0.99
    with pytest.raises(ValueError, match="--batch"):
        bench.run("cpu")


_NO_JAX = """
import pkgutil, sys
sys.modules["jax"] = None
sys.modules["trpo_tpu"] = None
import trpo_torch
for mod in pkgutil.walk_packages(trpo_torch.__path__, "trpo_torch."):
    __import__(mod.name)
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
cfg = TRPOConfig(env="cartpole", n_envs=4, batch_timesteps=32, cg_iters=3,
                 vf_train_steps=2, policy_hidden=(8,))
state = TRPOAgent("cartpole", cfg, device="cpu").learn(n_iterations=1)
assert state.iteration == 1
assert not any(m == "jax" or m.startswith(("jax.", "trpo_tpu"))
               for m, v in sys.modules.items() if v is not None)
print("ok", len([m for m in sys.modules if m.startswith("trpo_torch")]))
"""


def test_port_imports_nothing_of_jax_or_the_reference():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1].split()[0] == "ok"


def test_cli_sigterm_exits_with_requeue_code(tmp_path):
    ck, jsonl = tmp_path / "ck", tmp_path / "run.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    child = subprocess.Popen(
        [sys.executable, "-m", "trpo_torch.train", *TINY[:2],
         "--iterations", "100000", *TINY[4:], "--checkpoint-dir", str(ck),
         "--checkpoint-every", "1", "--log-jsonl", str(jsonl)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while not (ck / "step_1.complete").exists():
            assert child.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        child.send_signal(signal.SIGTERM)
        out, _ = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 75, out[-2000:]
    step = Checkpointer(str(ck)).latest_step()
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert step >= 1 and rows[-1]["iteration"] == step
    assert f"final checkpoint at step {step}" in out
