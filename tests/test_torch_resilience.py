"""The port's resilience layer (``trpo_torch/resilience``: the fault
injector, the worker-pool supervisor, NaN recovery, preemption) against
the reference's (``tests/test_resilience.py``, ``tests/test_failover.py``).

* The fault grammar is held to the reference's: every one of its 18 kinds
  parses to equal fields and the same ``str()``, and every malformed spec
  the reference rejects raises ``ValueError`` in the port too.
* Kill and hang faults on the ``gymproc:`` pool are detected (no hang),
  supervised (restart with backoff, the heal window, in-process
  degradation, the floor), and reported on the bus.
* ``nan_update`` under ``recover_on_nan="restore"`` ends in a
  ``TrainState`` bitwise equal (tolerance 0) to the unfaulted run's, on
  the serial driver and in a fused chunk. The host drivers do not rewind
  the host simulator (the reference's fault model: the poisoned batch is
  skipped, the env stays where it is), so the async driver is held to the
  reference's own checks: one recovery, the full budget, no poisoned state
  delivered or saved.
* The serving hooks fire on the port's own ``ReplicaSet``, transport and
  ``PolicyServer``; the boundary methods are called directly (their
  caller, the promotion controller, is ROADMAP.md Queue 1 item 18.6).
* The reference's ``scripts/validate_events.py`` finds no error in the
  port's chaos event logs, train and serve: every fault is matched by the
  record it must cause.

The kill/hang/restart legs the reference slow-marks are slow here too;
each family keeps a fast representative.
"""

import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from trpo_torch import train
from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.obs.events import EventBus, JsonlSink
from trpo_torch.ops.flat import tree_leaves, tree_map
from trpo_torch.resilience import (
    FaultInjector,
    PromoterKilled,
    SupervisedEnv,
    SupervisionConfig,
    WorkerDiedError,
    WorkerPoolError,
    parse_fault_specs,
)
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.metrics import StatsLogger
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.resilience import inject as tpu_inject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "CartPole-v1"


def _recording_bus():
    events = []
    return EventBus(events.append), events


class _Recorder:
    """A bus stand-in that records ``emit`` calls as they are made."""

    def __init__(self):
        self.calls = []

    def emit(self, kind, **fields):
        self.calls.append((kind, fields))


def _reference_validate_file(path):
    spec = importlib.util.spec_from_file_location(
        "validate_events", os.path.join(REPO, "scripts", "validate_events.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_file(path)


# ---------------------------------------------------------------------------
# the grammar, against the reference's
# ---------------------------------------------------------------------------

# one spec of each of the reference's 18 kinds, every parameter set
EVERY_KIND = [
    "kill_worker@step=3:worker=1",
    "hang_worker@step=5",
    "delay_step@step=2:seconds=0.5",
    "nan_update@iter=4",
    "sigterm@iter=9",
    "kill_replica@request=3:replica=1",
    "stall_replica@request=2:replica=0:seconds=1.5",
    "wedge_reload@step=2",
    "drop_carry_journal@request=4:replica=1",
    "overload_storm@request=2:rps=200:seconds=8",
    "slow_replica@request=5:replica=1:ms=40",
    "flap_replica@request=6:replica=0:times=3",
    "partition_host@request=7:host=hA:seconds=10",
    "slow_network@request=8:host=hB:ms=25",
    "lost_descriptor@request=9:host=hA",
    "corrupt_checkpoint@step=3",
    "regress_checkpoint@step=4",
    "kill_promoter@step=5",
]


@pytest.mark.parametrize("spec", EVERY_KIND)
def test_every_reference_kind_parses_to_equal_fields_and_str(spec):
    (port,) = parse_fault_specs(spec)
    (ref,) = tpu_inject.parse_fault_specs(spec)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert str(port) == str(ref)
    assert (port.env_level, port.serve_level) == (ref.env_level,
                                                  ref.serve_level)
    assert parse_fault_specs(str(port)) == (port,)  # str() round-trips


def test_the_grammar_covers_the_reference_kinds():
    from trpo_torch.resilience import inject

    assert inject._KINDS == tpu_inject._KINDS
    assert {s.split("@")[0] for s in EVERY_KIND} == set(tpu_inject._KINDS)
    both = parse_fault_specs(";".join(EVERY_KIND))
    assert [str(s) for s in both] == [
        str(s) for s in tpu_inject.parse_fault_specs(";".join(EVERY_KIND))]


# the reference's rejections (tests/test_resilience.py:109-117 and
# tests/test_failover.py's grammar cases)
MALFORMED = [
    "explode@iter=1",
    "nan_update@step=1",
    "kill_worker@worker=0",
    "nan_update@iter=0",
    "kill_worker@step=2:pid=9",
    "",
    "kill_replica@step=3:replica=1",
    "kill_replica@request=3:target=1",
    "kill_replica@request=3:replica=-1",
    "partition_host@request=1:seconds=2",
    "overload_storm@request=1:rps=0",
    "flap_replica@request=1:times=0",
    "delay_step@step=1:seconds=-1",
    "nan_update@iter=x",
    "nan_update",
]


@pytest.mark.parametrize("bad", MALFORMED)
def test_what_the_reference_rejects_the_port_rejects(bad):
    with pytest.raises(ValueError):
        tpu_inject.parse_fault_specs(bad)
    with pytest.raises(ValueError):
        parse_fault_specs(bad)


@pytest.mark.parametrize("kw", [
    {"env_step_timeout": -1.0},
    {"worker_backoff": -0.5},
    {"max_worker_restarts": -1},
    {"min_env_workers": -1},
    {"inject_faults": "explode@iter=1"},
    {"train_overlap": 1, "rollout_chunk": 5, "inject_faults":
     "nan_update@iter=2"},
])
def test_config_validates_as_the_reference(kw):
    with pytest.raises(ValueError):
        TpuConfig(**kw)
    with pytest.raises(ValueError):
        TRPOConfig(**kw)


def test_config_defaults_and_accepted_values_match_the_reference():
    for kw in ({}, {"env_step_timeout": 0.0}, {"env_step_timeout": None},
               {"max_worker_restarts": 0, "min_env_workers": 3,
                "worker_backoff": 0.0},
               {"inject_faults": "nan_update@iter=2;sigterm@iter=4"}):
        port, ref = TRPOConfig(**kw), TpuConfig(**kw)
        for name in ("env_step_timeout", "max_worker_restarts",
                     "min_env_workers", "worker_backoff", "inject_faults"):
            assert getattr(port, name) == getattr(ref, name), (kw, name)


def test_fault_records_match_the_reference():
    """The same calls on both injectors emit the same ``fault_injected``
    records (env level, the reload seam, the boundary)."""
    spec = "delay_step@step=1:seconds=0;wedge_reload@step=2;kill_promoter@step=5"
    from trpo_torch.resilience import inject as port_inject

    out = []
    for mod in (tpu_inject, port_inject):
        bus = _Recorder()
        inj = mod.FaultInjector.from_spec(spec, bus=bus)
        inj.on_env_step(1, None)
        poisoned = inj.on_checkpoint_load(2, {"w": np.ones(3, np.float32)})
        assert np.isnan(np.asarray(poisoned["w"])).all()
        with pytest.raises(Exception, match="kill_promoter"):
            inj.on_promotion(5)
        assert inj.all_fired and inj.unfired == ()
        out.append(bus.calls)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the worker pool under faults (gymnasium)
# ---------------------------------------------------------------------------

gymnasium = pytest.importorskip("gymnasium")

from trpo_torch.envs.proc_env import ProcVecEnv  # noqa: E402


def _acts(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2, size=n)


def _kill(pool, w, sig=signal.SIGKILL):
    os.kill(pool._procs[w].pid, sig)
    if sig == signal.SIGKILL:
        pool._procs[w].join(timeout=10)


def test_kill_and_hang_are_detected_and_revived():
    """The fast representative of the detection and supervision family:
    a SIGKILLed worker and a SIGSTOPped one, each detected within the step
    timeout and revived; the step retries and the pool keeps stepping."""
    bus, events = _recording_bus()
    raw = ProcVecEnv(ENV, n_envs=4, seed=3, n_workers=2, step_timeout=1.0)
    env = SupervisedEnv(raw, SupervisionConfig(max_worker_restarts=2,
                                               backoff_base=0.01), bus=bus)
    try:
        for _ in range(3):
            env.host_step(_acts(4))
        _kill(raw, 0)
        out = env.host_step(_acts(4, 1))
        assert np.isfinite(out[0]).all() and env.restarts == {0: 1}
        # episode restart for the revived slice only
        assert raw._running_lengths[:2].max() <= 1
        assert raw._running_lengths[2:].min() >= 4
        _kill(raw, 1, signal.SIGSTOP)
        t0 = time.monotonic()
        env.host_step(_acts(4, 2))
        assert time.monotonic() - t0 < 20.0
        assert env.restarts == {0: 1, 1: 1}
        restarts = [e["data"] for e in events if e["kind"] == "health"
                    and e["check"] == "worker_restart"]
        assert [(d["worker"], d["kind"]) for d in restarts] == [
            (0, "died"), (1, "timeout")]
        for _ in range(3):
            env.host_step(_acts(4, 3))
    finally:
        env.close()


@pytest.mark.slow
def test_killed_worker_raises_worker_died_not_hang():
    pool = ProcVecEnv(ENV, n_envs=2, seed=3, n_workers=2, step_timeout=30)
    try:
        pool.host_step(_acts(2))
        _kill(pool, 0)
        with pytest.raises(WorkerDiedError) as ei:
            pool.host_step(_acts(2, 1))
        assert ei.value.workers == [0] and ei.value.kind == "died"
        assert ei.value.last_action is not None
        assert "worker" in str(ei.value).lower()
    finally:
        pool.close()


@pytest.mark.slow
def test_hung_worker_times_out():
    pool = ProcVecEnv(ENV, n_envs=2, seed=3, n_workers=2, step_timeout=1.0)
    try:
        pool.host_step(_acts(2))
        _kill(pool, 1, signal.SIGSTOP)
        with pytest.raises(WorkerDiedError) as ei:
            pool.host_step(_acts(2, 1))
        assert ei.value.kind == "timeout" and 1 in ei.value.workers
    finally:
        pool.close()  # SIGKILLs the stopped worker


def test_degrades_to_an_in_process_slice_with_correct_data():
    """Past max_worker_restarts the slice runs in this process: the same
    steps, bit for bit, as an unfaulted pool after the slice's restart."""
    bus, events = _recording_bus()
    raw = ProcVecEnv(ENV, n_envs=4, seed=3, n_workers=2, step_timeout=30)
    env = SupervisedEnv(raw, SupervisionConfig(max_worker_restarts=0,
                                               backoff_base=0.01), bus=bus)
    ref = ProcVecEnv(ENV, n_envs=4, seed=3, n_workers=2)
    try:
        _kill(raw, 1)
        env.reset_all(seed=5)
        assert env.degraded_workers == (1,) and raw.is_local_worker(1)
        assert "worker_degraded" in [e.get("check") for e in events]
        ref.reset_all(seed=5)
        for k in range(20):
            a = _acts(4, k)
            for x, y in zip(env.host_step(a), ref.host_step(a)):
                np.testing.assert_array_equal(x, y)
        assert len(env.env_state_snapshot()["sims"]) == 4
    finally:
        env.close()
        ref.close()


class _FakePool:
    env_id = "fake"
    n_workers = 2

    def __init__(self):
        self.restarted = []

    def restart_worker(self, w, local=False):
        self.restarted.append((w, local))


def test_restart_budget_resets_after_heal_window():
    pool = _FakePool()
    env = SupervisedEnv(pool, SupervisionConfig(
        max_worker_restarts=1, backoff_base=0.0, heal_window=60.0))
    err = WorkerDiedError(0, "fake")
    env._revive(err)
    assert env.restarts == {0: 1}
    env._last_restart[0] -= 120.0  # the revival held past the window
    env._revive(err)
    assert env.restarts == {0: 1}
    assert pool.restarted == [(0, False), (0, False)]
    env._revive(err)  # a death inside the window: the budget burns
    assert pool.restarted[-1] == (0, True)
    assert env.degraded_workers == (0,)


def test_the_floor_raises_worker_pool_error():
    bus, events = _recording_bus()
    env = SupervisedEnv(_FakePool(), SupervisionConfig(
        max_worker_restarts=0, min_proc_workers=2, backoff_base=0.0),
        bus=bus)
    with pytest.raises(WorkerPoolError, match="floor"):
        env._revive(WorkerDiedError(1, "fake"))
    assert [e["check"] for e in events] == ["worker_degraded",
                                            "worker_pool_floor"]
    with pytest.raises(WorkerPoolError, match="unrevivable"):
        env._revive(WorkerDiedError(1, "fake"))


def test_step_clock_counts_each_call_once_across_threads():
    class _Pool(_FakePool):
        def host_step_slice(self, actions, lo, hi):
            return lo

    class _Clock:
        def __init__(self):
            self.seen = []

        def on_env_step(self, idx, env):
            self.seen.append(idx)

    clock = _Clock()
    env = SupervisedEnv(_Pool(), injector=clock)
    threads = [threading.Thread(target=lambda g=g: [
        env.host_step_slice(None, g, g + 1) for _ in range(25)])
        for g in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(clock.seen) == list(range(1, 101))
    # delegation: the pool's surface passes through the wrapper
    assert env.n_workers == 2 and env.env_id == "fake"


def test_injector_skips_degraded_worker_and_reports_unfired():
    class _DegradedPool:
        _procs = [None]

    inj = FaultInjector.from_spec("kill_worker@step=3:worker=0")
    inj.on_env_step(3, _DegradedPool())
    assert not inj.all_fired
    assert inj.unfired == ("kill_worker@step=3:worker=0",)
    with pytest.raises(ValueError, match="no worker 4"):
        FaultInjector.from_spec("hang_worker@step=1:worker=4").on_env_step(
            1, _DegradedPool())


@pytest.mark.slow
def test_injected_kill_through_agent_learn():
    bus, events = _recording_bus()
    cfg = TRPOConfig(env="gymproc:" + ENV, n_iterations=2,
                     batch_timesteps=32, n_envs=2, policy_hidden=(8,),
                     env_step_timeout=30, worker_backoff=0.01,
                     inject_faults="kill_worker@step=5:worker=0")
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    try:
        final = agent.learn(telemetry=_BusTelemetry(bus))
        assert final.iteration == 2
        kinds = [(e["kind"], e.get("check") or e.get("fault"))
                 for e in events]
        assert ("fault_injected", "kill_worker") in kinds
        assert ("health", "worker_restart") in kinds
    finally:
        agent.env.close()


# ---------------------------------------------------------------------------
# NaN recovery, preemption, unfired faults
# ---------------------------------------------------------------------------


class _BusTelemetry:
    """A stand-in threading only a bus through learn()."""

    profile_dir = None

    def __init__(self, bus):
        self.bus = bus

    def __getattr__(self, name):
        return lambda *a, **k: None


def _tiny(**kw):
    base = dict(n_iterations=4, batch_timesteps=64, n_envs=4, seed=7,
                policy_hidden=(8,), vf_hidden=(8,), cg_iters=4)
    base.update(kw)
    return TRPOConfig(**base)


def _rows(logger):
    rows = []
    orig = logger.log
    logger.log = lambda i, s: (rows.append((i, dict(s))), orig(i, s))[0]
    return rows


def _assert_states_bitwise(a, b):
    assert a.iteration == b.iteration
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def _run(fault, **kw):
    cfg = (_tiny(recover_on_nan="restore", inject_faults=fault, **kw)
           if fault else _tiny(**kw))
    agent = TRPOAgent("cartpole", cfg, device="cpu")
    logger = StatsLogger()
    rows = _rows(logger)
    return agent.learn(logger=logger), rows


_NUMERIC = ("entropy", "surrogate_loss", "kl_old_new", "grad_norm",
            "step_norm", "vf_loss", "cg_iters_total")


@pytest.mark.parametrize("fuse, at, logged", [
    (1, 2, [1, 2, 2, 3, 4]),
    # the poison lands at the [3, 4] chunk's start: both its rows are
    # nonfinite and only the first is logged before the re-run
    (2, 3, [1, 2, 3, 3, 4]),
])
def test_nan_update_restore_is_bitwise_the_unfaulted_run(fuse, at, logged):
    clean, clean_rows = _run(None, fuse_iterations=fuse)
    final, rows = _run(f"nan_update@iter={at}", fuse_iterations=fuse)
    assert [i for i, _ in rows] == logged
    poisoned = rows[logged.index(at)][1]
    assert poisoned["entropy"] != poisoned["entropy"]
    finite = [(i, r) for i, r in rows if r["entropy"] == r["entropy"]]
    assert [i for i, _ in finite] == [1, 2, 3, 4]
    for (ic, rc), (i_f, rf) in zip(clean_rows, finite):
        assert ic == i_f
        for key in _NUMERIC:
            assert rc[key] == rf[key] or (rc[key] != rc[key]
                                          and rf[key] != rf[key]), key
    _assert_states_bitwise(clean, final)


def test_recovery_emits_events_and_the_default_path_aborts():
    bus, events = _recording_bus()
    agent = TRPOAgent("cartpole", _tiny(
        recover_on_nan="restore", inject_faults="nan_update@iter=3"),
        device="cpu")
    assert agent.learn(telemetry=_BusTelemetry(bus)).iteration == 4
    recs = [e for e in events if e["kind"] == "recovery"]
    assert len(recs) == 1 and recs[0]["iteration"] == 3
    assert recs[0]["reason"] in ("nan_entropy", "nan_guard")
    (fault,) = [e for e in events if e["kind"] == "fault_injected"]
    assert (fault["fault"], fault["at"], fault["iteration"]) == (
        "nan_update", 3, 3)
    # recover_on_nan="off": the injected NaN still aborts the run
    with pytest.raises(FloatingPointError):
        TRPOAgent("cartpole", _tiny(inject_faults="nan_update@iter=2"),
                  device="cpu").learn()


def test_unfired_fault_warns_at_completion():
    bus, events = _recording_bus()
    agent = TRPOAgent("cartpole", _tiny(n_iterations=2,
                                        inject_faults="nan_update@iter=50"),
                      device="cpu")
    agent.learn(telemetry=_BusTelemetry(bus))
    (warn,) = [e for e in events if e.get("check") == "fault_unfired"]
    assert warn["data"]["unfired"] == ["nan_update@iter=50"]
    with pytest.warns(UserWarning, match="never fired"):
        agent.learn(n_iterations=1)


@pytest.mark.slow
def test_async_driver_nan_recovery_never_delivers_or_saves_poison(tmp_path):
    """The async driver flags the poisoned row on its drain thread, maybe
    after the next rollout: recovery still rewinds to the flagged
    iteration, finishes the budget, and no callback or checkpoint ever
    sees a nonfinite policy (the reference's test_async_driver_*)."""
    bus, events = _recording_bus()
    cfg = TRPOConfig(env="gym:" + ENV, n_iterations=4, batch_timesteps=32,
                     n_envs=2, seed=5, policy_hidden=(8,),
                     host_async_pipeline=True, recover_on_nan="restore",
                     checkpoint_every=2, inject_faults="nan_update@iter=2")
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"))
    finite = []

    def cb(st, _):
        finite.append(all(torch.isfinite(t).all().item()
                          for t in tree_leaves(st.policy_params)))

    try:
        final = agent.learn(checkpointer=ck, telemetry=_BusTelemetry(bus),
                            callback=cb)
        assert final.iteration == 4
        recs = [e for e in events if e["kind"] == "recovery"]
        assert len(recs) == 1 and recs[0]["iteration"] == 2
        assert finite and all(finite)
        for step in (2, 4):
            st = ck.restore(agent.init_state(), step)
            assert all(torch.isfinite(t).all().item()
                       for t in tree_leaves(st.policy_params))
    finally:
        agent.env.close()


def test_async_driver_rewinds_a_poisoned_final_iteration():
    bus, events = _recording_bus()
    cfg = TRPOConfig(env="gym:" + ENV, n_iterations=3, batch_timesteps=32,
                     n_envs=2, seed=5, policy_hidden=(8,),
                     host_async_pipeline=True, recover_on_nan="restore",
                     inject_faults="nan_update@iter=3")
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    try:
        final = agent.learn(telemetry=_BusTelemetry(bus))
        assert final.iteration == 3
        assert all(torch.isfinite(t).all().item()
                   for t in tree_leaves(final.policy_params))
        recs = [e for e in events if e["kind"] == "recovery"]
        assert len(recs) == 1 and recs[0]["iteration"] == 3
        assert [e["fault"] for e in events
                if e["kind"] == "fault_injected"] == ["nan_update"]
    finally:
        agent.env.close()


def test_sigterm_exits_75_with_its_checkpoint(tmp_path, capsys):
    code = train.main([
        "--preset", "cartpole", "--iterations", "6", "--batch-timesteps",
        "64", "--n-envs", "4", "--policy-hidden", "8", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
        "--inject-faults", "sigterm@iter=3"])
    assert code == 75
    # the signal lands before iteration 3; the guard acts before 4
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 3
    assert "exiting 75 for requeue" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the serving hooks on the port's objects
# ---------------------------------------------------------------------------


def test_host_faults_arm_the_transport_gates():
    from trpo_torch.serve.transport import LocalExecTransport

    tr = LocalExecTransport(lambda rid: None)
    inj = FaultInjector.from_spec(
        "partition_host@request=1:host=local:seconds=30;"
        "slow_network@request=2:host=local:ms=25;"
        "lost_descriptor@request=3:host=local;"
        "partition_host@request=4:host=elsewhere:seconds=1")
    inj.on_serve_request(1, transport=tr)
    assert tr.partitioned("local")
    tr.heal("local")
    inj.on_serve_request(2, transport=tr)
    assert tr._latency_ms == {"local": 25.0}
    inj.on_serve_request(3, transport=tr)
    assert "local" in tr._lost_descriptors
    with pytest.raises(ValueError, match="no host 'elsewhere'"):
        inj.on_serve_request(4, transport=tr)
    # a fault that could not execute stays unfired, loudly
    assert inj.unfired == ("partition_host@request=4:host=elsewhere:"
                           "seconds=1",)


def test_replica_faults_on_a_port_replica_set(tmp_path):
    from test_torch_router import ff_factory, make_set, port_agent

    from trpo_torch.serve.session import journal_path

    agent, state = port_agent()
    rs = make_set(lambda rid: ff_factory(agent, state.policy_params), 2)
    try:
        bus = _Recorder()
        jdir = str(tmp_path / "cj")
        os.makedirs(jdir)
        open(journal_path(jdir, "r1"), "w").close()
        inj = FaultInjector.from_spec(
            "slow_replica@request=1:replica=1:ms=40;"
            "stall_replica@request=2:replica=1:seconds=30;"
            "drop_carry_journal@request=3:replica=1;"
            "kill_replica@request=4:replica=0;"
            "kill_replica@request=5:replica=7", bus=bus)
        server = rs.replicas["r1"].handle.server
        inj.on_serve_request(1, replicaset=rs)
        assert server._slow_ms == 40.0
        inj.on_serve_request(2, replicaset=rs)
        assert server._stall_until > time.monotonic() + 25
        server._stall_until = 0.0
        inj.on_serve_request(3, replicaset=rs, journal_dir=jdir)
        assert not os.path.exists(journal_path(jdir, "r1"))
        inj.on_serve_request(4, replicaset=rs)
        assert not rs.replicas["r0"].handle.alive()
        with pytest.raises(ValueError, match="no replica r7"):
            inj.on_serve_request(5, replicaset=rs)
        assert [(k, f["fault"], f.get("replica")) for k, f in bus.calls] == [
            ("fault_injected", "slow_replica", "r1"),
            ("fault_injected", "stall_replica", "r1"),
            ("fault_injected", "drop_carry_journal", "r1"),
            ("fault_injected", "kill_replica", "r0")]
    finally:
        rs.close()


def test_stall_of_a_subprocess_replica_stops_and_continues_it():
    import types

    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])

    def state():
        with open(f"/proc/{proc.pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]

    try:
        rs = types.SimpleNamespace(replicas={"r0": types.SimpleNamespace(
            handle=types.SimpleNamespace(proc=proc))})
        FaultInjector.from_spec(
            "stall_replica@request=1:replica=0:seconds=2"
        ).on_serve_request(1, replicaset=rs)
        # SIGSTOP lands asynchronously: poll for the stop inside the 2 s
        # window, then for the timed SIGCONT
        deadline = time.monotonic() + 1.5
        while state() != "T" and time.monotonic() < deadline:
            time.sleep(0.005)
        assert state() == "T"
        deadline = time.monotonic() + 10
        while state() == "T" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert state() != "T"
    finally:
        proc.kill()
        proc.wait()


def test_overload_storm_replays_the_triggering_body():
    import http.server
    import types

    hits = []

    class _H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            hits.append((self.path, self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        router = types.SimpleNamespace(
            url=f"http://127.0.0.1:{srv.server_address[1]}")
        body = json.dumps({"obs": [0.1, 0.2]}).encode()
        FaultInjector.from_spec(
            "overload_storm@request=1:rps=40:seconds=0.5"
        ).on_serve_request(1, router=router, path="/act", body=body)
        time.sleep(1.0)
        assert len(hits) >= 5 and all(h == ("/act", body) for h in hits)
    finally:
        srv.shutdown()


def test_wedge_reload_poisons_the_loaded_snapshot(tmp_path):
    from test_torch_router import port_agent

    from trpo_torch.serve import MicroBatcher, PolicyServer

    agent, state = port_agent("pendulum")
    ck = str(tmp_path / "ck")
    Checkpointer(ck).save(1, state)
    bus = _Recorder()
    engine = agent.serve_engine()
    batcher = MicroBatcher(engine, deadline_ms=5.0)
    srv = PolicyServer(engine, batcher, port=0, checkpointer=Checkpointer(ck),
                       template=agent.init_state(), poll_interval=60.0,
                       injector=FaultInjector.from_spec(
                           "wedge_reload@step=1", bus=bus))
    try:
        assert engine.loaded_step == 1
        leaves = tree_leaves(engine._snapshot.params)
        assert leaves and all(torch.isnan(t).all() for t in leaves)
        # the trainer's state was not written
        assert all(torch.isfinite(t).all()
                   for t in tree_leaves(state.policy_params))
        assert bus.calls == [("fault_injected", {
            "fault": "wedge_reload", "at": 1, "spec": "wedge_reload@step=1",
            "step": 1})]
    finally:
        srv.close()
        batcher.close()


def test_boundary_faults_by_direct_calls(tmp_path):
    from test_torch_router import port_agent

    agent, state = port_agent("pendulum")
    inj = FaultInjector.from_spec(
        "regress_checkpoint@step=4;corrupt_checkpoint@step=5;"
        "kill_promoter@step=6")
    assert inj.on_checkpoint_publish(3, state) is state
    out = inj.on_checkpoint_publish(4, state)
    for a, b in zip(tree_leaves(out.policy_params),
                    tree_leaves(state.policy_params)):
        assert torch.equal(a, b * 8.0)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, state)
    step_dir = str(tmp_path / "ck" / "step_5")
    sizes = {n: os.path.getsize(os.path.join(step_dir, n))
             for n in os.listdir(step_dir)}
    inj.on_checkpoint_published(5, step_dir)
    for n, size in sizes.items():
        assert os.path.getsize(os.path.join(step_dir, n)) == size // 2
    with pytest.raises(Exception):
        Checkpointer(str(tmp_path / "ck")).restore(agent.init_state(), 5)
    inj.on_promotion(5)  # not its step: nothing
    with pytest.raises(PromoterKilled, match="step 6"):
        inj.on_promotion(6)
    inj.on_promotion(6)  # fires once
    assert inj.all_fired


# ---------------------------------------------------------------------------
# the chaos event logs, read by the reference's validator
# ---------------------------------------------------------------------------


def test_train_chaos_log_passes_the_reference_validator(tmp_path):
    """The worker kill, the poisoned update and the preemption through the
    train CLI on a gymproc: pool: exit 75, every fault matched (a
    worker_restart, a recovery, the preempted record)."""
    ev = tmp_path / "chaos.jsonl"
    code = train.main([
        "--preset", "cartpole", "--env", "gymproc:" + ENV, "--iterations",
        "6", "--batch-timesteps", "32", "--n-envs", "2", "--policy-hidden",
        "8", "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
        "--checkpoint-every", "2", "--recover-on-nan", "restore",
        "--env-step-timeout", "30", "--max-worker-restarts", "2",
        "--inject-faults",
        "kill_worker@step=3:worker=0;nan_update@iter=2;sigterm@iter=4",
        "--metrics-jsonl", str(ev), "--health-checks"])
    assert code == 75
    recs = [json.loads(x) for x in ev.read_text().splitlines()]
    assert [r["fault"] for r in recs if r["kind"] == "fault_injected"] == [
        "kill_worker", "nan_update", "sigterm"]
    assert _reference_validate_file(str(ev)) == []


def test_serve_chaos_log_passes_the_reference_validator(tmp_path):
    """A replica killed and one stalled past the router's act timeout under
    client load, then a wedged step through the canary: every fault fired
    and matched, 0 client errors."""
    from test_torch_router import make_set, port_agent, post

    from trpo_torch.serve import (
        CanaryController,
        MicroBatcher,
        PolicyServer,
        Router,
    )

    from trpo_torch.obs.events import manifest_fields

    ev = str(tmp_path / "serve.jsonl")
    bus = EventBus(JsonlSink(ev))
    agent, state = port_agent("pendulum")
    bus.emit("run_manifest", **manifest_fields(agent.cfg, extra={
        "driver": "serve", "replicas": 3}, device=agent.device))
    ck_dir = str(tmp_path / "ck")
    trainer = Checkpointer(ck_dir)
    trainer.save(1, state)
    incumbent = {"step": None}
    inj = FaultInjector.from_spec(
        "kill_replica@request=5:replica=0;"
        "stall_replica@request=60:replica=1:seconds=3;wedge_reload@step=2",
        bus=bus)

    def make(rid):
        def factory():
            engine = agent.serve_engine()
            batcher = MicroBatcher(engine, deadline_ms=5.0)
            return PolicyServer(
                engine, batcher, port=0, checkpointer=Checkpointer(ck_dir),
                template=agent.init_state(), poll_interval=60.0,
                managed_reload=True, initial_step=incumbent["step"],
                injector=inj, bus=bus), [batcher]
        return factory

    rs = make_set(make, 3, health_interval=0.1, bus=bus)
    rs.start()
    router = Router(rs, port=0, act_timeout_s=0.5, canary_fraction=0.25,
                    injector=inj, bus=bus)
    ctrl = CanaryController(rs, router, Checkpointer(ck_dir).latest_step,
                            incumbent=incumbent, window_requests=16,
                            poll_interval=0.1, gate_timeout_s=30.0, bus=bus)
    stop, errors, answered = threading.Event(), [], [0]

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            status, out = post(router.url + "/act", {
                "obs": r.standard_normal(agent.obs_shape).tolist()})
            if status == 200:
                answered[0] += 1
            else:
                errors.append((status, out))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(3)]
    def wait(cond):
        deadline = time.monotonic() + 30
        while not cond():
            assert time.monotonic() < deadline, rs.snapshot()
            time.sleep(0.005)

    def healed(rid):
        return (rs.replicas[rid].restarts >= 1
                and rs.snapshot()["healthy"] == 3)

    try:
        ctrl.tick()
        for t in threads:
            t.start()
        # one fault at a time: the router retries a request once, so a
        # retry that lands on the second fault's replica would fail. The
        # clock pauses while the killed replica comes back
        wait(lambda: 0 in inj._fired)
        router.injector = None
        wait(lambda: healed("r0"))
        router.injector = inj
        wait(lambda: 1 in inj._fired and healed("r1"))
        trainer.save(2, state)
        ctrl.tick()
        assert ctrl.last_decision == "rolled_back" and ctrl.last_step == 2
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[:3]
        assert inj.all_fired and answered[0] > 30
    finally:
        stop.set()
        ctrl.close()
        router.close()
        rs.close()
        bus.close()
    assert _reference_validate_file(ev) == []
