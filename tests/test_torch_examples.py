"""The port's user examples (``trpo_torch/scripts/``: ``learning_evidence``,
``quickstart``, ``quickstart.ipynb``, ``pomdp_recurrent``, ``mujoco_host``
and ``population_sweep``) held against the reference's ``examples/``.

Each script builds the reference example's config field by field
(``scan_backend`` excepted: the port has one reverse scan), read from a
stub agent that records its arguments and stops the run. The sweep's
members, λ values and labels equal the reference's, and with the same
scores both scripts print the same lines and write the same ``--out``
keys. Each script then runs end to end on the CPU at a cut depth
(``--device cpu``; one or two iterations, the widest batches narrowed),
and a ``gym:`` env without gymnasium exits with the adapter's error. The
slow test trains the cartpole rung as published to the reference's bar
(``tests/test_agent.py``: a best reading ≥ 400).
"""

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trpo_tpu.agent as ref_agent_mod
import trpo_tpu.population as ref_population_mod
from trpo_torch import agent as port_agent_mod
from trpo_torch.scripts import (
    learning_evidence,
    mujoco_host,
    pomdp_recurrent,
    population_sweep,
    quickstart,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
NOTEBOOK = REPO / "trpo_torch" / "scripts" / "quickstart.ipynb"
SCRIPTS = {"quickstart": quickstart, "pomdp_recurrent": pomdp_recurrent,
           "mujoco_host": mujoco_host}


class _Built(Exception):
    """Raised by a stub once it has recorded what the script built."""


def _recording_agent(calls, stop=True):
    class Agent:
        def __init__(self, env, config=None, device=None):
            calls.append((env, config))
            if stop:
                raise _Built

    return Agent


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fields(cfg) -> dict:
    fields = dataclasses.asdict(cfg)
    fields.pop("scan_backend", None)
    return fields


def _assert_same_build(port_calls, ref_calls):
    assert len(port_calls) == len(ref_calls) == 1
    (env, cfg), (ref_env, ref_cfg) = port_calls[0], ref_calls[0]
    assert env == ref_env
    assert _fields(cfg) == _fields(ref_cfg)


def _code_cells(path) -> list:
    nb = json.loads(path.read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def _cut_agent(monkeypatch, module, **cut):
    """Make ``module``'s agent the port's with every config cut by
    ``cut``."""
    real = port_agent_mod.TRPOAgent

    class Cut(real):
        def __init__(self, env, config=None, device=None):
            super().__init__(env, config.replace(**cut), device=device)

    monkeypatch.setattr(module, "TRPOAgent", Cut)


# ---------------------------------------------------------------------------
# config parity
# ---------------------------------------------------------------------------

HOST_FLAGS = ["--env", "native:pendulum", "--iterations", "3", "--batch",
              "512", "--pipeline", "2", "--host-inference", "cpu"]


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("pomdp_recurrent", []),
    ("mujoco_host", []),
    ("mujoco_host", HOST_FLAGS),
], ids=["quickstart", "pomdp_recurrent", "mujoco_host", "mujoco_host-flags"])
def test_script_builds_the_reference_config(name, argv, monkeypatch):
    ref = _reference_example(name)
    ref_calls, port_calls = [], []
    monkeypatch.setattr(ref, "TRPOAgent", _recording_agent(ref_calls))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with pytest.raises(_Built):
        ref.main()
    port = SCRIPTS[name]
    monkeypatch.setattr(port, "TRPOAgent", _recording_agent(port_calls))
    with pytest.raises(_Built):
        port.main(["--device", "cpu", *argv])
    _assert_same_build(port_calls, ref_calls)


def test_notebook_builds_the_reference_config(monkeypatch):
    ref_calls, port_calls = [], []
    monkeypatch.setattr(ref_agent_mod, "TRPOAgent",
                        _recording_agent(ref_calls))
    with pytest.raises(_Built):
        exec(_code_cells(EXAMPLES / "quickstart.ipynb")[0], {})
    first = _code_cells(NOTEBOOK)[0]
    # the card by default, with no choice made for the user
    assert 'DEVICE = "cuda"' in first and "is_available" not in first
    monkeypatch.setattr(port_agent_mod, "TRPOAgent",
                        _recording_agent(port_calls))
    with pytest.raises(_Built):
        exec(first, {})
    _assert_same_build(port_calls, ref_calls)


def test_learning_evidence_rungs_are_the_references():
    ref = _reference_example("learning_evidence")
    assert list(learning_evidence.RUNGS.items()) == list(ref.RUNGS.items())


@pytest.mark.parametrize("rung", list(learning_evidence.RUNGS))
def test_learning_evidence_rung_builds_the_reference_config(rung,
                                                            monkeypatch):
    ref = _reference_example("learning_evidence")
    ref_calls, port_calls = [], []
    monkeypatch.setattr(ref, "TRPOAgent", _recording_agent(ref_calls))
    monkeypatch.setattr(learning_evidence, "TRPOAgent",
                        _recording_agent(port_calls))
    iters, chunk = ref.RUNGS[rung]
    with pytest.raises(_Built):
        ref.train(rung, iters, chunk)
    with pytest.raises(_Built):
        learning_evidence.train(rung, iters, chunk, device="cpu")
    _assert_same_build(port_calls, ref_calls)


def _sweep(main, argv, patch, scores, tensor):
    """Run a sweep's ``main`` on a stub agent and population that score
    each chunk ``scores``; returns what it built and printed."""
    built = {"agents": []}

    class Population:
        def __init__(self, agent, seeds, lam=None, **_):
            built["seeds"] = list(seeds)
            built["lam"] = None if lam is None else list(lam)
            self.seeds = tuple(seeds)

        def run_iterations(self, n):
            built.setdefault("chunks", []).append(n)
            return {}

        def member_scores(self, stats):
            return tensor(np.asarray(scores[:len(self.seeds)], np.float32))

        def best_member(self, stats):
            return int(np.nanargmax(scores[:len(self.seeds)]))

    patch(_recording_agent(built["agents"], stop=False), Population)
    assert main(argv) == 0
    return built


SWEEP_CASES = [
    [],
    ["--lam-grid", "0.9,0.97", "--seeds", "2"],
    ["--env", "humanoid-sim", "--lam-grid", "0.9,0.97,1.0", "--seeds", "2",
     "--chunks", "2", "--iters-per-chunk", "3"],
]


@pytest.mark.parametrize("argv", SWEEP_CASES,
                         ids=["seeds", "lam-grid", "humanoid-grid"])
def test_population_sweep_matches_the_reference(argv, monkeypatch, capsys,
                                                tmp_path):
    """The same members, λ values, labels and config as the reference's
    sweep; on the same scores the same lines (times masked) and the same
    ``--out`` row (wall and rate dropped)."""
    ref = _reference_example("population_sweep")
    scores = [12.5, np.nan, 30.25, -4.0, 8.0, 17.75]

    def ref_patch(agent, population):
        monkeypatch.setattr(ref_agent_mod, "TRPOAgent", agent)
        monkeypatch.setattr(ref_population_mod, "Population", population)

    def port_patch(agent, population):
        monkeypatch.setattr(population_sweep, "TRPOAgent", agent)
        monkeypatch.setattr(population_sweep, "Population", population)

    def ref_main(args):
        monkeypatch.setattr(sys, "argv", ["population_sweep.py", *args])
        return ref.main()

    outs, built = [], []
    for tag, main, patch, tensor, extra in (
            ("ref", ref_main, ref_patch, jnp.asarray, []),
            ("port", population_sweep.main, port_patch, torch.from_numpy,
             ["--device", "cpu"])):
        out = tmp_path / f"{tag}.json"
        built.append(_sweep(main, [*extra, *argv, "--out", str(out)],
                            patch, scores, tensor))
        outs.append((capsys.readouterr().out, json.loads(out.read_text())))
    port, want = built[1], built[0]
    assert port["seeds"] == want["seeds"] and port["lam"] == want["lam"]
    assert port["chunks"] == want["chunks"]
    _assert_same_build(port["agents"], want["agents"])
    (ref_out, ref_row), (port_out, port_row) = outs

    def mask(text):
        return re.sub(r"in [0-9.]+s \([0-9.]+ member", "in Ts (R member",
                      text)

    assert mask(port_out) == mask(ref_out)
    for row in (ref_row, port_row):
        row.pop("wall_s"), row.pop("member_updates_per_sec")
    assert port_row == ref_row
    if "--lam-grid" in argv:
        assert "final-chunk reward by λ" in port_out


# ---------------------------------------------------------------------------
# CPU runs at a cut depth
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_cpu(monkeypatch, capsys):
    _cut_agent(monkeypatch, quickstart, n_iterations=1)
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "finished at iteration 1"


def test_notebook_runs_on_cpu(monkeypatch):
    cells = _code_cells(NOTEBOOK)
    cells[0] = cells[0].replace('DEVICE = "cuda"', 'DEVICE = "cpu"')
    _cut_agent(monkeypatch, port_agent_mod, n_iterations=1)
    ns = {}
    for cell in cells:
        exec(cell, ns)
    assert int(ns["state"].iteration) == 1
    assert ns["env"].obs_shape == (4,)
    assert ns["action"].shape == () and int(ns["action"]) in (0, 1)


def test_pomdp_recurrent_runs_on_cpu(monkeypatch, capsys):
    _cut_agent(monkeypatch, pomdp_recurrent, batch_timesteps=128)
    assert pomdp_recurrent.main(["--device", "cpu", "--iterations", "1"]) \
        == 0
    line = capsys.readouterr().out.splitlines()[-1]
    assert re.fullmatch(
        r"GRU policy on velocity-masked CartPole after 1 iterations: "
        r"greedy eval -?\d+\.\d( over \d+ episodes| \(partial episode\))",
        line), line


def test_mujoco_host_runs_native_pendulum_on_cpu(capsys):
    assert mujoco_host.main(["--device", "cpu", "--env", "native:pendulum",
                             "--iterations", "1", "--batch", "64"]) == 0
    line = capsys.readouterr().out.splitlines()[-1]
    assert re.fullmatch(
        r"finished at iteration 1; greedy eval return -?\d+\.\d "
        r"(over \d+ episodes|\(partial episode\))", line), line


def test_mujoco_host_refuses_gym_without_gymnasium():
    """The card's machine has no gymnasium: the default ``gym:`` env
    raises the adapter's error naming it, and the script exits
    nonzero, with no other env tried."""
    code = ("import sys; sys.modules['gymnasium'] = None; "
            "from trpo_torch.scripts import mujoco_host; "
            "sys.exit(mujoco_host.main(['--device', 'cpu']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "ImportError: gymnasium is required for gym:* envs" in out.stderr
    assert "finished at iteration" not in out.stdout


def test_population_sweep_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "row.json"
    assert population_sweep.main([
        "--device", "cpu", "--lam-grid", "0.9,0.97", "--seeds", "1",
        "--chunks", "1", "--iters-per-chunk", "1", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"iter    1  λ=0\.9/s0: +-?[\d.]+  λ=0\.97/s0: "
                        r"+-?[\d.]+", lines[0]), lines[0]
    assert re.fullmatch(r"2 members x 1 iterations in [\d.]+s \([\d.]+ "
                        r"member-updates/s\); best member: λ=0\.97?/s0",
                        lines[1]), lines[1]
    assert lines[2] == "final-chunk reward by λ (mean over seeds ± spread):"
    row = json.loads(out.read_text())
    assert row["labels"] == ["λ=0.9/s0", "λ=0.97/s0"]
    assert row["members"] == 2 and row["iterations"] == 1
    assert all(v is None or np.isfinite(v)
               for v in row["final_chunk_scores"])


def test_learning_evidence_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setitem(learning_evidence.RUNGS, "cartpole", (2, 1))
    assert learning_evidence.main(["--device", "cpu", "--rungs",
                                   "cartpole"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["| rung | iterations | wall | mean episode reward |",
                         "|---|---|---|---|"]
    assert re.fullmatch(r"\| cartpole \| 2 \| [\d.]+ s \| \d+ → \d+ \|",
                        lines[2]), lines[2]
    assert len(lines) == 3


def test_learning_evidence_train_returns_the_stats_rows(monkeypatch,
                                                       capsys):
    """The rows a caller reads the audits from: halfcheetah-sim's ladder
    (audited every 25 updates) fires on update 1, narrowed here, with
    episodes cut to the window so the row has a reading."""
    _cut_agent(monkeypatch, learning_evidence, n_envs=4, batch_timesteps=64,
               policy_hidden=(16, 16), max_pathlength=16)
    rows = learning_evidence.train("halfcheetah-sim", 3, 2, device="cpu")
    assert re.fullmatch(r"\| halfcheetah-sim \| 3 \| [\d.]+ s \| -?\d+ → "
                        r"-?\d+ \|\n", capsys.readouterr().out)
    assert len(rows) == 3
    assert all(r["iteration_ms"] > 0 for r in rows)
    assert rows[0]["iteration_ms"] == rows[1]["iteration_ms"]  # one chunk
    assert [r["solve_audited"] for r in rows] == [True, False, False]
    assert np.isfinite(rows[0]["solve_cosine"])
    assert isinstance(rows[0]["solve_fallback"], bool)
    assert all(isinstance(r["cg_iterations"], int) for r in rows)


@pytest.mark.slow
def test_learning_evidence_cartpole_rung_learns_on_cpu(capsys):
    iters, chunk = learning_evidence.RUNGS["cartpole"]
    rows = learning_evidence.train("cartpole", iters, chunk, device="cpu")
    rewards = [r["mean_episode_reward"] for r in rows]
    assert len(rows) == iters
    assert np.nanmax(rewards) >= 400.0, rewards
