"""The port's fleet orchestrator (``trpo_torch.fleet``) held against the
reference's (``trpo_tpu.fleet``).

The same stub members (``python -c``: no torch, no jax, no training) run
under both schedulers, scenario by scenario: the ``fleet`` event
sequences (state, attempt, exit code, resume step, score, reason), the
launch contexts and the result dicts (member rows, scores, culls, gate
verdicts, exit code) must be equal. The spec layer (grid, spec files,
rejections, argv rendering), the Prometheus text of one snapshot and the
PBT respawn overrides must be identical. The port's own pieces: the
marker-gated resume point over ``step_<n>/`` directories, the CLI's
parser against the reference's flag set, and (slow) a real two-member
``--device cpu`` cartpole fleet whose sigterm'd member loses zero
iterations.
"""

import json
import os
import random
import subprocess
import sys

import pytest

import trpo_torch.fleet as port_fleet
import trpo_tpu.fleet as tpu_fleet
from trpo_torch.obs.events import EventBus as PortBus
from trpo_tpu.obs.events import EventBus as TpuBus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (port_fleet, PortBus), "ref": (tpu_fleet, TpuBus)}


def _manifest_rec(**extra):
    rec = {
        "v": 1, "t": 1.0, "kind": "run_manifest",
        "schema": "trpo-tpu-events", "jax_version": "0", "backend": "cpu",
        "config_hash": "0123456789abcdef", "config": None,
    }
    rec.update(extra)
    return rec


def _iter_rec(i, ms, reward=None, episodes=None):
    stats = {"iteration_ms": ms, "cg_iters_total": i,
             "linesearch_trials_total": i}
    if reward is not None:
        stats["mean_episode_reward"] = reward
    if episodes is not None:
        stats["episodes_in_batch"] = episodes
    return {"v": 1, "t": float(i), "kind": "iteration", "iteration": i,
            "stats": stats}


# a stub member: appends a manifest and the given rows to its event log,
# then exits with the given code (after the marker file exists, with 0)
_STUB = """
import sys, os, json
member_dir, code, rows, marker = sys.argv[1:5]
with open(os.path.join(member_dir, "events.jsonl"), "a") as f:
    f.write(json.dumps({"v":1,"t":0.0,"kind":"run_manifest",
        "schema":"trpo-tpu-events","jax_version":"0","backend":"cpu",
        "config_hash":"0123456789abcdef",
        "config":{"n_iterations": 8}}) + "\\n")
    for row in json.loads(rows):
        f.write(json.dumps(row) + "\\n")
if marker != "-":
    if os.path.exists(marker):
        sys.exit(0)
    open(marker, "w").close()
sys.exit(int(code))
"""


def _stub(ctx, code, rows=(), marker="-"):
    return [sys.executable, "-c", _STUB, ctx["member_dir"], str(code),
            json.dumps(list(rows)), marker]


def _rewards(rewards):
    def launcher(member, ctx, _tmp):
        rows = [_iter_rec(i, 10.0, reward=rewards[member.member_id],
                          episodes=2) for i in (1, 2, 3)]
        return _stub(ctx, 0, rows)
    return launcher


# name -> (members, spec kwargs, launcher(member, ctx, tmp), latest step,
#          timeout)
SCENARIOS = {
    "clean": (["m0"], {}, lambda m, c, t: _stub(c, 0), None, 30),
    "requeue_once": (
        ["m0"], {"base_args": ("--iterations", "6")},
        lambda m, c, t: _stub(c, 75, marker=str(t / "fired")), 4, 30),
    "preempted_after_final_save": (
        ["m0"], {"base_args": ("--iterations", "6")},
        lambda m, c, t: _stub(c, 75, marker=str(t / "fired")), 6, 30),
    "total_from_manifest": (
        ["m0"], {}, lambda m, c, t: _stub(c, 75, marker=str(t / "fired")),
        5, 30),
    "requeue_budget": (
        ["m0"], {"max_requeues": 1, "base_args": ("--iterations", "6")},
        lambda m, c, t: _stub(c, 75), None, 30),
    "crash_budget": (
        ["bad", "good"], {"max_restarts": 1, "max_workers": 2},
        lambda m, c, t: _stub(c, 3 if m.member_id == "bad" else 0),
        None, 30),
    "crash_after_completed_budget": (
        ["m0"], {"base_args": ("--iterations", "6")},
        lambda m, c, t: _stub(c, 1), 6, 30),
    "timeout": (
        ["m0", "m1"], {"max_workers": 1},
        lambda m, c, t: [sys.executable, "-c",
                         "import time; time.sleep(600)"], None, 0.5),
    "cull_bottom_k": (
        ["a", "b", "c"], {"max_workers": 3, "cull_bottom_k": 1},
        _rewards({"a": 100.0, "b": 10.0, "c": 50.0}), None, 60),
    "gate": (
        ["ref", "ok", "slow"], {"max_workers": 3},
        lambda m, c, t: _stub(c, 0, [_iter_rec(i + 1, ms) for i, ms in
                                     enumerate({
                                         "ref": [10.0] * 4,
                                         "ok": [11.0] * 4,
                                         "slow": [10.0, 90.0, 90.0, 90.0],
                                     }[m.member_id])]), None, 60),
}


def _fleet_seq(events):
    """Each member's fleet records in order (members running side by
    side interleave by wall clock, so the sequence is per member)."""
    seq = {}
    for e in events:
        if e["kind"] == "fleet":
            seq.setdefault(e["member"], []).append(
                (e["state"], e["attempt"], e.get("exit_code"),
                 e.get("resume_step"), e.get("score"), e.get("reason")))
    return seq


def _result_view(result):
    rows = {mid: {k: row[k] for k in (
        "state", "attempt", "requeues", "failures", "exit_code",
        "resume_step", "score", "respawned")}
        for mid, row in result["members"].items()}
    return {"members": rows, "scores": result["scores"],
            "culled": result["culled"], "failed": result["failed"],
            "respawned": result["respawned"], "gate": result["gate"],
            "exit_code": result["exit_code"]}


def _ctx_view(ctx):
    return {k: ctx[k] for k in ("attempt", "resume_step",
                                "remaining_iterations")}


def _run(pkg_name, scenario, tmp_path):
    pkg, bus_cls = PACKAGES[pkg_name]
    members, spec_kw, launcher, latest, timeout = SCENARIOS[scenario]
    events, ctxs = [], []
    tmp = tmp_path / pkg_name
    tmp.mkdir()
    spec = pkg.FleetSpec(
        members=tuple(pkg.MemberSpec(m) for m in members),
        requeue_backoff=0.01, poll_interval=0.02, scrape_interval=60.0,
        **spec_kw)

    def launch(member, ctx):
        ctxs.append((member.member_id, _ctx_view(ctx)))
        return launcher(member, ctx, tmp)

    sch = pkg.FleetScheduler(spec, str(tmp / "fleet"),
                             bus=bus_cls(events.append), launcher=launch,
                             latest_step_fn=lambda d: latest)
    try:
        result = sch.run(timeout=timeout)
    finally:
        sch.close()
    return (_fleet_seq(events), sorted(ctxs, key=lambda c: (
        c[0], c[1]["attempt"])), _result_view(result))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_stub_fleets_run_like_the_reference(scenario, tmp_path):
    """Equal fleet events, launch contexts and result dicts under both
    schedulers, per lifecycle scenario: clean, preempted and requeued
    (with the remaining budget from the spec or the member's manifest),
    preempted after its final save, the requeue and crash budgets, a
    crash after the budget, the fleet timeout, the bottom-k cull and the
    gate's ok/regressed verdicts."""
    got = _run("port", scenario, tmp_path)
    want = _run("ref", scenario, tmp_path)
    assert got == want
    seq, ctxs, result = got
    expected = {
        "clean": lambda: result["exit_code"] == 0,
        "requeue_once": lambda: ctxs[1][1]["remaining_iterations"] == 2,
        "preempted_after_final_save": lambda: seq["m0"][-1][5]
        == "complete_at_preemption",
        "total_from_manifest": lambda: ctxs[1][1]["remaining_iterations"]
        == 3,
        "requeue_budget": lambda: result["members"]["m0"]["requeues"] == 1,
        "crash_budget": lambda: result["failed"] == ["bad"],
        "crash_after_completed_budget": lambda: "crashed after"
        in seq["m0"][-1][5],
        "timeout": lambda: result["failed"] == ["m0", "m1"],
        "cull_bottom_k": lambda: result["culled"] == ["b"],
        "gate": lambda: result["gate"]["members"]["slow"]["verdict"]
        == "regressed" and result["exit_code"] == 1,
    }[scenario]
    assert expected(), (seq, ctxs, result)


def _pbt_run(pkg_name, tmp_path):
    """Two members, one PBT round: b scores lowest, is culled, and
    respawns from a's checkpoint directory."""
    pkg, bus_cls = PACKAGES[pkg_name]
    events, ctxs = [], []
    spec = pkg.FleetSpec(
        members=(pkg.MemberSpec("a", (("seed", 0), ("lam", 0.95),
                                      ("cg_damping", 0.1))),
                 pkg.MemberSpec("b", (("seed", 1), ("lam", 0.97),
                                      ("cg_damping", 0.3)))),
        base_args=("--iterations", "4"), max_workers=2, cull_bottom_k=1,
        pbt_rounds=1, pbt_iterations=2, requeue_backoff=0.01,
        poll_interval=0.02, scrape_interval=60.0)
    reward = {"a": 50.0, "b": 5.0}

    def launch(member, ctx):
        ctxs.append((member.member_id, dict(member.overrides),
                     _ctx_view(ctx)))
        os.makedirs(os.path.join(ctx["checkpoint_dir"], "step_4"),
                    exist_ok=True)
        rows = [_iter_rec(i, 10.0, reward=reward[member.member_id],
                          episodes=1) for i in (1, 2)]
        return _stub(ctx, 0, rows)

    sch = pkg.FleetScheduler(spec, str(tmp_path / pkg_name),
                             bus=bus_cls(events.append), launcher=launch,
                             latest_step_fn=lambda d: 4)
    try:
        result = sch.run(timeout=60)
    finally:
        sch.close()
    return (_fleet_seq(events), sorted(ctxs, key=lambda c: (
        c[0], c[2]["attempt"])), _result_view(result))


def test_pbt_respawn_is_identical_to_the_reference(tmp_path):
    """The culled member respawns from the winner's checkpoint with the
    SAME explore draw as the reference's (``random.Random(f"{mid}:
    {attempt}")`` is plain Python): seed, lam and cg_damping identical,
    resumed at the winner's step with the explore budget."""
    got = _pbt_run("port", tmp_path)
    want = _pbt_run("ref", tmp_path)
    assert got == want
    seq, ctxs, result = got
    assert result["respawned"] == ["b"]
    respawn = [c for c in ctxs if c[0] == "b"][-1]
    rng = random.Random("b:1")
    factor = 0.8 if rng.random() < 0.5 else 1.2
    assert respawn[1]["seed"] == rng.randrange(2 ** 31)
    assert respawn[1]["lam"] == round(1.0 - 0.03 * factor, 6)
    assert respawn[1]["cg_damping"] == round(0.3 * factor, 8)
    assert respawn[2] == {"attempt": 2, "resume_step": 4,
                          "remaining_iterations": 2}
    assert ("respawned", 1, None, 4, None,
            f"pbt exploit a@4 explore x{factor:g}") in seq["b"]
    # the exploit copied the winner's checkpoint directory
    assert os.path.isdir(tmp_path / "port" / "b" / "ck" / "step_4")


# ---------------------------------------------------------------------------
# the spec layer: pure Python, identical to the reference's
# ---------------------------------------------------------------------------

GRIDS = ["seed=0..2,cg_damping=0.1|0.3", "seed=1..2,batch_timesteps=64",
         "seed=5", "env=gymproc:CartPole-v1|gymproc:Acrobot-v1",
         "seed=1|01", "lam=0.9|0.95,seed=3", "seed=-2..0"]
BAD_GRIDS = ["seed", "seed=3..1", " , ", "=3", "seed=|"]


def _spec_view(members):
    return [(m.member_id, m.overrides) for m in members]


def _error(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # the message is the contract
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("grid", GRIDS + BAD_GRIDS)
def test_expand_grid_equals_the_reference(grid):
    got = _error(lambda: _spec_view(port_fleet.expand_grid(grid)))
    want = _error(lambda: _spec_view(tpu_fleet.expand_grid(grid)))
    assert got == want
    assert (got[0] == "ok") == (grid in GRIDS)


SPEC_FILES = {
    "good": {"base_args": ["--preset", "cartpole", "--iterations", "6"],
             "max_workers": 3, "pbt_rounds": 1, "pbt_perturb": 0.3,
             "members": [{"id": "ref", "overrides": {"seed": 0}},
                         {"id": "chaos", "overrides": {
                             "seed": 1, "inject_faults": "sigterm@iter=2",
                             "adaptive_damping": True, "env": None}}]},
    "typo": {"members": [{"id": "a"}], "max_wrokers": 2},
    "no_members": {"max_workers": 2},
    "bad_member": {"members": ["a"]},
    "bad_overrides": {"members": [{"id": "a", "overrides": [1]}]},
    "bad_id": {"members": [{"id": "a b"}]},
    "duplicate": {"members": [{"id": "a"}, {"id": "a"}]},
    "cull_all": {"members": [{"id": "a"}, {"id": "b"}], "cull_bottom_k": 2},
    "gate_ref": {"members": [{"id": "a"}], "gate_reference": "nope"},
    "workers": {"members": [{"id": "a"}], "max_workers": 0},
    "pbt_perturb": {"members": [{"id": "a"}], "pbt_perturb": 1.0},
    "pbt_iterations": {"members": [{"id": "a"}], "pbt_iterations": 0},
    "pbt_rounds": {"members": [{"id": "a"}], "pbt_rounds": -1},
    "exit_code": {"members": [{"id": "a"}], "requeue_exit_code": 0},
    "not_object": [1, 2],
}


def _load_view(pkg, path):
    spec = pkg.load_spec_file(path)
    return (_spec_view(spec.members), spec.base_args, spec.max_workers,
            spec.pbt_rounds, spec.pbt_perturb, spec.reference_id,
            [pkg.member_cli_args(m) for m in spec.members],
            [pkg.member_total_iterations(spec, m) for m in spec.members])


@pytest.mark.parametrize("name", sorted(SPEC_FILES))
def test_load_spec_file_equals_the_reference(name, tmp_path):
    """Spec files load, render argv and reject alike (the error message
    is the reference's, naming the file)."""
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(SPEC_FILES[name]))
    got = _error(_load_view, port_fleet, str(path))
    want = _error(_load_view, tpu_fleet, str(path))
    assert got == want
    assert (got[0] == "ok") == (name == "good")


# ---------------------------------------------------------------------------
# the fleet endpoint's text
# ---------------------------------------------------------------------------


def _snapshot():
    return {
        "schema": "trpo-tpu-fleet",
        "members": {
            "m0": {"state": "running", "attempt": 2, "requeues": 1,
                   "failures": 0,
                   "live": {"iteration": 7, "stats": {
                       "iteration_ms": 12.5, "reward_running": 30.0,
                       "timesteps_total": 4096,
                       "mean_episode_reward": float("nan")}}},
            "m1": {"state": "pending", "attempt": 0, "requeues": 0,
                   "failures": 3, "live": None},
            'we"ird\\id': {"state": "culled", "attempt": 1, "requeues": 0,
                           "failures": 0, "live": {"iteration": None}},
        },
        "state_counts": {"running": 1, "pending": 1, "culled": 1},
        "finished": False,
    }


def test_render_fleet_prometheus_is_identical():
    text = port_fleet.render_fleet_prometheus(_snapshot())
    assert text == tpu_fleet.render_fleet_prometheus(_snapshot())
    assert 'trpo_fleet_member_iteration_ms{member="m0"} 12.5' in text
    assert 'trpo_fleet_member_state{member="m1",state="pending"} 1' in text


def test_fleet_status_server_serves_the_snapshot():
    import urllib.request

    server = port_fleet.FleetStatusServer(_snapshot, port=0)
    try:
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=10) as r:
            assert r.read().decode() == tpu_fleet.render_fleet_prometheus(
                _snapshot())
        with urllib.request.urlopen(server.url + "/status", timeout=10) as r:
            snap = json.load(r)
        # RFC-valid JSON: the NaN reward is null
        assert snap["members"]["m0"]["live"]["stats"][
            "mean_episode_reward"] is None
    finally:
        server.close()


def test_score_event_records_equals_the_reference():
    recs = [_manifest_rec(), _iter_rec(1, 10.0, reward=10.0, episodes=1),
            _iter_rec(2, 10.0, reward=40.0, episodes=3),
            _iter_rec(3, 10.0, reward=float("nan"), episodes=0),
            _iter_rec(4, 10.0, reward=7.0)]
    for r in (recs, [_manifest_rec()]):
        assert port_fleet.score_event_records(r) == \
            tpu_fleet.score_event_records(r)
    assert port_fleet.score_event_records(recs) == (10 + 120 + 7) / 5


# ---------------------------------------------------------------------------
# the port's own pieces
# ---------------------------------------------------------------------------


def test_checkpoint_latest_ignores_a_torn_step(tmp_path):
    """The default resume point is the port's marker-gated newest
    complete step: a ``step_<n>/`` without its ``step_<n>.complete``
    (a save torn by the preemption) is never selected."""
    import torch

    from trpo_torch.fleet.scheduler import FleetScheduler
    from trpo_torch.utils.checkpoint import Checkpointer

    ck = tmp_path / "ck"
    assert FleetScheduler._checkpoint_latest(str(ck)) is None
    saver = Checkpointer(str(ck))
    for step in (1, 2):
        saver.save(step, {"x": torch.zeros(2)})
    assert FleetScheduler._checkpoint_latest(str(ck)) == 2
    (ck / "step_3").mkdir()
    (ck / "step_3" / "tensors.pt").write_bytes(b"torn")
    assert FleetScheduler._checkpoint_latest(str(ck)) == 2
    saver.save(3, {"x": torch.ones(2)})
    assert FleetScheduler._checkpoint_latest(str(ck)) == 3


def test_default_member_argv_launches_the_port_trainer():
    spec = port_fleet.FleetSpec(
        members=(port_fleet.MemberSpec("s0", (("seed", 3),)),),
        base_args=("--preset", "cartpole", "--iterations", "6"))
    ctx = {"checkpoint_dir": "ck", "events_path": "ev.jsonl",
           "descriptor_path": "run.json", "resume_step": 4,
           "remaining_iterations": 2}
    argv = port_fleet.default_member_argv(spec, spec.members[0], ctx)
    ref = tpu_fleet.default_member_argv(
        tpu_fleet.FleetSpec(members=(tpu_fleet.MemberSpec(
            "s0", (("seed", 3),)),), base_args=spec.base_args),
        tpu_fleet.MemberSpec("s0", (("seed", 3),)), ctx)
    assert argv[:3] == [sys.executable, "-m", "trpo_torch.train"]
    assert argv[3:] == ref[3:]
    assert argv[-3:] == ["--resume", "--iterations", "2"]


def _reference_flags():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import fleet as ref_cli
    finally:
        sys.path.pop(0)
    return sorted(opt for action in ref_cli.build_parser()._actions
                  for opt in action.option_strings
                  if opt.startswith("--") and opt != "--help")


def test_fleet_cli_holds_the_reference_flag_set(tmp_path, capsys):
    """Every reference flag is parsed by the port's CLI or a stated
    difference; ``--platform`` refuses with exit 2."""
    import argparse

    from trpo_torch.scripts import fleet as cli

    parsed = {opt for action in cli.build_parser()._actions
              for opt in action.option_strings
              if action.help is not argparse.SUPPRESS}
    for flag in _reference_flags():
        assert (flag in parsed) + (flag in cli.STATED_DIFFERENCES) == 1, flag
    assert cli.main(["--fleet-dir", str(tmp_path), "--grid", "seed=0",
                     "--platform", "cpu"]) == 2
    assert "--device" in capsys.readouterr().err
    args = cli.build_parser().parse_args([
        "--fleet-dir", str(tmp_path), "--grid", "seed=0..1",
        "--max-workers", "1", "--inject", "seed1=sigterm@iter=2",
        "--cull-bottom-k", "1", "--pbt-rounds", "1", "--pbt-iterations",
        "1", "--", "--preset", "cartpole", "--iterations", "4"])
    spec = cli._build_spec(args)
    assert [m.member_id for m in spec.members] == ["seed0", "seed1"]
    assert spec.max_workers == 1 and spec.pbt_rounds == 1
    assert spec.members[1].overrides_dict["inject_faults"] == \
        "sigterm@iter=2"
    assert cli.main(["--fleet-dir", str(tmp_path), "--grid", "seed=0..1",
                     "--inject", "nope=sigterm@iter=2"]) == 2


def test_fleet_and_compat_import_no_jax():
    """Importing the fleet package, the compat module and the new entry
    points leaves jax and the reference out of ``sys.modules``."""
    code = ("import sys, trpo_torch.fleet, trpo_torch.compat, "
            "trpo_torch.scripts.fleet, trpo_torch.scripts.flywheel_smoke, "
            "trpo_torch.scripts.reference_style; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'trpo_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.slow
def test_real_cpu_fleet_requeue_loses_zero_iterations(tmp_path):
    """Two real ``python -m trpo_torch.train --device cpu`` cartpole
    members through the CLI: the sigterm'd one exits 75, requeues once,
    resumes at latest_step + 1 with a gapless iteration sequence, and
    both logs pass the validator."""
    fleet_dir = tmp_path / "fleet"
    out = subprocess.run(
        [sys.executable, "-m", "trpo_torch.scripts.fleet", "--fleet-dir",
         str(fleet_dir), "--grid", "seed=0..1", "--max-workers", "2",
         "--backoff", "0.1", "--inject", "seed1=sigterm@iter=2", "--json",
         "--", "--preset", "cartpole", "--iterations", "4",
         "--batch-timesteps", "64", "--n-envs", "4", "--device", "cpu",
         "--checkpoint-every", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout)
    row = result["members"]["seed1"]
    assert (row["state"], row["requeues"], row["attempt"]) == (
        "finished", 1, 2)
    records = [json.loads(line) for line in
               open(fleet_dir / "seed1" / "events.jsonl")]
    manifests = [i for i, r in enumerate(records)
                 if r["kind"] == "run_manifest"]
    assert len(manifests) == 2
    its = [r["iteration"] for r in records if r["kind"] == "iteration"]
    assert its == [1, 2, 3, 4], its
    resumed = [r["iteration"] for r in records[manifests[1]:]
               if r["kind"] == "iteration"]
    assert resumed[0] == row["resume_step"] + 1
    check = subprocess.run(
        [sys.executable, "-m", "trpo_torch.scripts.validate_events",
         str(fleet_dir / "fleet_events.jsonl"),
         str(fleet_dir / "seed0" / "events.jsonl"),
         str(fleet_dir / "seed1" / "events.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
