"""The port's train CLI (``trpo_torch/train.py``) held to the reference's
flag set (``trpo_tpu/train.py``): every reference flag is parsed by the
port, refused naming its ROADMAP.md item, or a stated difference; the
solver flags the port runs (``--cg-residual-rtol``,
``--linesearch-kl-cap``) reach the config and run an iteration;
``--debug-nans`` turns on the port's nonfinite checks.
"""

import pytest
import torch

from trpo_torch import train
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.ops.flat import tree_map

TINY = ["--preset", "cartpole", "--iterations", "1", "--batch-timesteps",
        "64", "--n-envs", "4", "--device", "cpu"]


def _reference_flags():
    from trpo_tpu.train import build_parser

    return sorted(
        opt for action in build_parser()._actions
        for opt in action.option_strings
        if opt.startswith("--") and opt != "--help"
    )


def _port_parsed_flags():
    import argparse

    seen = []
    real = argparse.ArgumentParser.add_argument

    def spy(self, *names, **kw):
        if kw.get("help") is not argparse.SUPPRESS:
            seen.extend(n for n in names if n.startswith("--"))
        return real(self, *names, **kw)

    argparse.ArgumentParser.add_argument = spy
    try:
        train.parse_args(["--device", "cpu"])
    finally:
        argparse.ArgumentParser.add_argument = real
    return set(seen)


def test_every_reference_flag_is_parsed_refused_or_a_stated_difference():
    parsed = _port_parsed_flags()
    for flag in _reference_flags():
        assert (flag in parsed) + (flag in train.REFUSED) + (
            flag in train.STATED_DIFFERENCES) == 1, flag
    # each refusal names its ROADMAP item and raises on use
    for flag, (item, kind) in train.REFUSED.items():
        value = "2" if kind in (int, float) else "x"
        with pytest.raises(NotImplementedError, match=item.replace(".",
                                                                   r"\.")):
            train.main(TINY + [flag, value])
    with pytest.raises(SystemExit, match="--device"):
        train.main(TINY + ["--platform", "cpu"])


def test_solver_flags_reach_the_config():
    cfg = train.build_config(train.parse_args(
        TINY + ["--cg-residual-rtol", "0.1", "--linesearch-kl-cap",
                "--debug-nans", "--status-port", "0", "--memory-accounting",
                "--trace-sample-rate", "0.5"]))
    assert cfg.cg_residual_rtol == 0.1 and cfg.linesearch_kl_cap is True
    assert cfg.debug_nans is True and cfg.status_port == 0
    assert cfg.memory_accounting is True and cfg.trace_sample_rate == 0.5
    # unset flags leave the preset's values
    cfg = train.build_config(train.parse_args(TINY))
    assert cfg.cg_residual_rtol == 0.0 and cfg.linesearch_kl_cap is False
    assert cfg.debug_nans is False and cfg.status_port is None


def test_cli_runs_a_residual_rtol_iteration_with_the_adaptive_budget(
        capsys):
    assert train.main(TINY + ["--cg-residual-rtol", "0.1",
                              "--cg-budget-adaptive"]) == 0
    out = capsys.readouterr().out
    assert "done: 1 iterations" in out and "cg_budget=" in out


def test_debug_nans_names_the_stage_with_a_nonfinite_output():
    was = torch.is_anomaly_enabled()
    try:
        agent = TRPOAgent("cartpole", TRPOConfig(
            n_envs=4, batch_timesteps=64, cg_iters=3, vf_train_steps=2,
            policy_hidden=(8,), debug_nans=True), device="cpu")
        assert torch.is_anomaly_enabled()
        # a clean iteration passes the checks (and fits the critic)
        state, _ = agent.run_iteration(agent.init_state())
        poisoned = state._replace(vf_state=state.vf_state._replace(
            params=tree_map(lambda t: t * float("nan"),
                            state.vf_state.params)))
        with pytest.raises(FloatingPointError, match="advantages"):
            agent.run_iteration(poisoned)
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_trace_sample_rate_needs_the_event_log():
    with pytest.raises(SystemExit, match="--metrics-jsonl"):
        train.main(TINY + ["--trace-sample-rate", "0.5"])
    with pytest.raises(SystemExit, match="--profile-dir"):
        train.main(TINY + ["--profile-iteration", "1"])
