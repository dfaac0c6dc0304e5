"""``python -m trpo_torch.serve --replicas N`` (the replicated path of the
reference's ``scripts/serve.py``) and ``trpo_torch.bench
--serving-scale`` on the CPU.

The CLI's control-plane flags build the config the reference's CLI
builds, its inconsistent combinations exit 2 with the reference's
refusals, and one child process serves two replicas behind its router
and exits 0 on SIGTERM with its ``routed …`` line. Launching subprocess
replicas from a ``--replica-cmd`` template (each child imports torch and
builds an agent) is slow-marked, as the reference marks its own
(``tests/test_router.py:797``).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_router import REPO, get_json, post
from trpo_torch import bench
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset
from trpo_torch.serve.__main__ import build_parser, config_from_args, main
from trpo_torch.utils.checkpoint import Checkpointer

_MODEL = ["--policy-hidden", "8", "--vf-hidden", "8", "--n-envs", "4"]


def test_control_plane_flags_build_the_config():
    args = build_parser().parse_args([
        "--checkpoint-dir", "/tmp/ck", "--replicas", "3",
        "--min-replicas", "2", "--max-replicas", "4", "--slo-p99-ms",
        "40", "--drain-timeout", "9", "--replica-cmd", "x {port}",
        "--hosts", "a, b,", "--lease-ttl", "4", "--health-interval", "0.2",
        "--replica-restarts", "5", "--max-inflight", "16",
        "--canary-fraction", "0.25", "--canary-window", "12",
        "--canary-parity-tol", "0.1", "--reward-window", "4",
        "--reward-min-episodes", "2", "--reward-budget", "0.5",
        "--router-core", "thread"])
    cfg = config_from_args(args)
    assert (cfg.serve_replicas, cfg.serve_min_replicas,
            cfg.serve_max_replicas) == (3, 2, 4)
    assert (cfg.serve_slo_p99_ms, cfg.serve_drain_timeout) == (40.0, 9.0)
    assert cfg.serve_replica_cmd == "x {port}"
    assert cfg.serve_hosts == ("a", "b") and cfg.serve_lease_ttl == 4.0
    assert (cfg.serve_health_interval, cfg.serve_replica_restarts,
            cfg.serve_max_inflight) == (0.2, 5, 16)
    assert (cfg.serve_canary_fraction, cfg.serve_canary_window) == (0.25,
                                                                     12)
    assert (cfg.serve_reward_window, cfg.serve_reward_min_episodes,
            cfg.serve_reward_budget) == (4, 2, 0.5)
    assert args.router_core == "thread" and args.canary_parity_tol == 0.1
    assert build_parser().parse_args(
        ["--checkpoint-dir", "x"]).router_core == "async"


@pytest.mark.parametrize("flags, words", [
    (["--min-replicas", "2"], "--min-replicas only bounds"),
    (["--hosts", "a,b"], "--hosts places replicas"),
    (["--replica-cmd", "x"], "--replica-cmd launches replicas"),
    (["--replicas", "1", "--max-replicas", "3"], "--max-replicas"),
    (["--replicas", "2", "--replica-cmd", "x", "--canary-fraction",
      "0.5"], "--canary-fraction needs in-process"),
])
def test_inconsistent_control_plane_flags_exit_2(flags, words, capsys):
    assert main(["--checkpoint-dir", "/nonexistent", "--device", "cpu",
                 *_MODEL, *flags]) == 2
    assert words in capsys.readouterr().err


def test_recurrent_refusals_exit_2(capsys):
    for flags, words in (
            (["--replicas", "2", "--canary-fraction", "0.5"],
             "reward-aware gate"),
            (["--replicas", "2", "--replica-cmd", "serve {port}"],
             "must wire the carry journal")):
        assert main(["--checkpoint-dir", "/nonexistent", "--device", "cpu",
                     "--preset", "cartpole-po", "--policy-gru", "8",
                     *flags]) == 2
        assert words in capsys.readouterr().err


def test_cli_routes_two_replicas_and_exits_on_sigterm(tmp_path):
    agent = TRPOAgent("cartpole", get_preset("cartpole").replace(
        policy_hidden=(8,), vf_hidden=(8,), n_envs=4), device="cpu")
    state = agent.init_state(seed=0)
    Checkpointer(str(tmp_path / "ck")).save(3, state)
    run_json = tmp_path / "run.json"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    child = subprocess.Popen(
        [sys.executable, "-m", "trpo_torch.serve", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "ck"), "--port", "0", *_MODEL,
         "--replicas", "2", "--health-interval", "0.1",
         "--run-descriptor", str(run_json)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 60
        while not run_json.exists():
            assert child.poll() is None, child.stdout.read()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        desc = json.loads(run_json.read_text())
        assert desc["replicas"] == 2 and desc["endpoints"] == [
            "/act", "/session", "/healthz", "/status", "/metrics"]
        while get_json(desc["url"] + "/status")["healthy"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        obs = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
        want = int(agent.act(state, obs, eval_mode=True)[0])
        for _ in range(3):
            status, out = post(desc["url"] + "/act", {"obs": obs.tolist()})
            assert status == 200 and out == {"step": 3, "action": want}
        child.send_signal(signal.SIGTERM)
        text, _ = child.communicate(timeout=60)
        assert child.returncode == 0, text
        assert "2 replica(s)" in text
        assert ("routed 3 requests (0 retried, 0 failed, 0 backpressured)"
                in text)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


@pytest.mark.slow  # each templated child imports torch and builds an agent
def test_templated_subprocess_replicas_behind_the_cli(tmp_path):
    agent = TRPOAgent("cartpole", get_preset("cartpole").replace(
        policy_hidden=(8,), vf_hidden=(8,), n_envs=4), device="cpu")
    Checkpointer(str(tmp_path / "ck")).save(1, agent.init_state(seed=0))
    run_json = tmp_path / "run.json"
    template = (f"{sys.executable} -m trpo_torch.serve --device cpu "
                "--port {port} --checkpoint-dir {checkpoint} "
                "--replica-name {replica} --policy-hidden 8 --vf-hidden 8 "
                "--n-envs 4")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    child = subprocess.Popen(
        [sys.executable, "-m", "trpo_torch.serve", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "ck"), "--port", "0", *_MODEL,
         "--replicas", "2", "--replica-cmd", template, "--hosts", "h0,h1",
         "--health-interval", "0.2", "--run-descriptor", str(run_json)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not run_json.exists():
            assert child.poll() is None, child.stdout.read()
            time.sleep(0.1)
        url = json.loads(run_json.read_text())["url"]
        while get_json(url + "/status")["healthy"] < 2:
            assert time.monotonic() < deadline, get_json(url + "/status")
            time.sleep(0.2)
        hosts = {r["host"] for r in get_json(url + "/status")[
            "replicas"].values()}
        assert hosts == {"h0", "h1"}
        assert post(url + "/act", {"obs": [0.0] * 4})[0] == 200
        assert os.path.exists(tmp_path / "ck" / "replicas" / "h0--r0" /
                              "run.json")
        child.send_signal(signal.SIGTERM)
        text, _ = child.communicate(timeout=60)
        assert child.returncode == 0, text
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


def test_serving_scale_block_on_the_cpu():
    out = bench.serving_scale("cpu", "simulated", replica_counts=(1, 2),
                              clients=4, per_client=4, sim_cost_ms=20.0)
    rows = out["rows"]
    assert [r["replicas"] for r in rows] == [1, 2]
    assert all(r["requests"] == 16 and r["retried"] == 0 for r in rows)
    assert rows[0]["scaling_efficiency"] == 1.0
    assert all(r["p50_ms"] <= r["p99_ms"] for r in rows)
    # a capacity-bound replica: 4 clients on a 20 ms engine at rung 1
    assert rows[1]["actions_per_sec"] > rows[0]["actions_per_sec"]
    with pytest.raises(ValueError, match="simulated or humanoid"):
        bench.serving_scale("cpu", "other")
