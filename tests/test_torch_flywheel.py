"""The port's train→serve flywheel (``trpo_torch/fleet/promote.py``) held
against the reference's (``trpo_tpu/fleet/promote.py``).

``pick_winner`` and ``feedback_scores`` answer alike on the same inputs.
``PromotionController``'s state machine — the candidate → canary →
promoted walk and its journal cache, a rejected step blacklisted and
never reassigned, the deadline rollback, a ``kill_promoter`` restart
that converges without republishing, a torn publish republished at the
same step, and the monotonic serving step — gives the same outcomes,
``promote`` records, journal and publish count in both packages over the
same scripted gate. Then the port's controller on its own checkpoints
(``step_<n>/`` and ``step_<n>.complete``): ``corrupt_checkpoint`` tears
the files of the published step directory, and over the port's
``CanaryController`` and in-process replicas a step is promoted, a torn
one rejected by its failed reload, and a clean one promoted through the
gate. Both packages' validators pass and fail the same logs.
"""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

from test_torch_router import make_set, port_agent, post
from trpo_torch.fleet import promote as port_promote
from trpo_torch.obs.events import EventBus as PortBus
from trpo_torch.resilience import inject as port_inject
from trpo_tpu.fleet import promote as tpu_promote
from trpo_tpu.obs.events import EventBus as TpuBus
from trpo_tpu.resilience import inject as tpu_inject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (port_promote, PortBus, port_inject),
            "ref": (tpu_promote, TpuBus, tpu_inject)}


# ---------------------------------------------------------------------------
# pick_winner / feedback_scores
# ---------------------------------------------------------------------------

RESULTS = [
    {"scores": {"a": 3.0, "b": 9.0, "c": 7.0, "d": 8.0, "e": 6.0,
                "f": float("-inf")},
     "culled": ["c"], "failed": ["e"],
     "gate": {"members": {"a": {"verdict": "ok"},
                          "b": {"verdict": "regressed"},
                          "d": {"verdict": "skipped"}}}},
    {"scores": {"a": 3.0, "d": 8.0},
     "gate": {"members": {"d": {"verdict": "unreadable"}}}},
    {"scores": {}},
    {"scores": {"m2": 5.0, "m1": 5.0, "m0": 4.0}, "gate": {}},
    {"scores": {"x": float("nan"), "y": True, "z": "9"}},
    {},
]


@pytest.mark.parametrize("k", range(len(RESULTS)))
def test_pick_winner_equals_the_reference(k):
    assert port_promote.pick_winner(RESULTS[k]) == \
        tpu_promote.pick_winner(RESULTS[k])


def test_feedback_scores_equal_the_reference():
    def fb(member, mean, episodes):
        return {"v": 1, "t": 1.0, "kind": "promote", "member": member,
                "event": "feedback", "step": 1, "mean_return": mean,
                "episodes": episodes}

    records = [fb("m0", 2.0, 3), fb("m0", 4.0, 1), fb("m1", -1.0, 2),
               fb("m2", float("nan"), 2), fb("m3", 1.0, 0),
               fb("", 1.0, 1), fb("m4", 1.0, True), fb("m5", True, 1),
               {"kind": "promote", "member": "m0", "event": "promoted",
                "step": 1}, {"kind": "iteration", "iteration": 1}, "junk"]
    got = port_promote.feedback_scores(records)
    assert got == tpu_promote.feedback_scores(records)
    assert got == {"m0": (2.5, 4), "m1": (-1.0, 2)}


# ---------------------------------------------------------------------------
# the controller's state machine, in both packages over one scripted gate
# ---------------------------------------------------------------------------


class FakeCheckpointer:
    """An in-memory, marker-faithful checkpointer speaking both packages'
    dialects (``latest_step(refresh=)``/``close`` of the reference's,
    ``_step_dir`` of the port's): one store per directory shared across
    handles, saves counted."""

    registry: dict = {}

    def __init__(self, directory):
        self.dir = os.path.abspath(directory)
        self.store = self.registry.setdefault(
            self.dir, {"steps": {}, "markers": set(), "saves": 0})

    def latest_step(self, refresh=False):
        return max(self.store["markers"]) if self.store["markers"] else None

    def restore(self, template, step=None, prune=True):
        return self.store["steps"][step]

    def save(self, step, state):
        self.store["steps"][step] = state
        self.store["markers"].add(step)
        self.store["saves"] += 1

    def refresh(self):
        pass

    def prune_incomplete(self):
        for s in list(self.store["steps"]):
            if s not in self.store["markers"]:
                del self.store["steps"][s]

    def _complete_steps(self):
        return sorted(self.store["markers"])

    def _step_dir(self, step):
        return os.path.join(self.dir, f"step_{step}")

    def close(self):
        pass


class FakeCanary:
    """A scripted gate: ``script[serve_step]`` is ``"promote"``,
    ``"reject"`` or absent (never resolves)."""

    def __init__(self, serve_dir, script=None):
        self.serve_dir = serve_dir
        self.script = dict(script or {})
        self.incumbent = {"step": None}
        self._rejected_steps = set()
        self.router = self.replicaset = None

    def tick(self):
        step = FakeCheckpointer(self.serve_dir).latest_step()
        if step is None or step == self.incumbent["step"] \
                or step in self._rejected_steps:
            return
        verdict = self.script.get(step)
        if verdict == "promote":
            self.incumbent["step"] = step
        elif verdict == "reject":
            self._rejected_steps.add(step)


def _records(events):
    return [(e["kind"], e.get("event") or e.get("fault"), e.get("member"),
             e.get("step"), e.get("src_step"), e.get("reason"))
            for e in events if e["kind"] in ("promote", "fault_injected")]


def _scenario(name, pkg_name, tmp):
    """Run one scenario in one package: (outcomes, records, journal,
    publishes, incumbent, blacklist)."""
    promote, bus_cls, inject = PACKAGES[pkg_name]
    FakeCheckpointer.registry.clear()
    serve = str(tmp / "serve")
    events = []
    bus = bus_cls(events.append)

    def ctrl(canary, injector=None, **kw):
        return promote.PromotionController(
            serve, template=None, canary=canary, bus=bus, injector=injector,
            checkpointer_factory=FakeCheckpointer,
            gate_timeout_s=kw.pop("gate_timeout_s", 10.0),
            poll_interval=0.002, **kw)

    def member(mid, step, w):
        d = str(tmp / mid)
        FakeCheckpointer(d).save(step, {"w": w})
        return d

    out = []
    if name == "walk_and_cache":
        canary = FakeCanary(serve, {1: "promote"})
        c, src = ctrl(canary), member("m0", 7, [1.0, 2.0])
        out += [c.promote("m0", src), c.promote("m0", src)]
    elif name == "reject_then_next":
        canary = FakeCanary(serve, {1: "reject", 2: "promote"})
        c = ctrl(canary)
        out += [c.promote("m0", member("m0", 3, [0.5])),
                c.promote("m1", member("m1", 5, [0.7]))]
    elif name == "deadline":
        canary = FakeCanary(serve, {})
        out.append(ctrl(canary).promote("m0", member("m0", 2, [1.0]),
                                        timeout_s=0.05))
    elif name == "kill_restart":
        canary = FakeCanary(serve, {1: "promote"})
        injector = inject.FaultInjector.from_spec("kill_promoter@step=1",
                                                  bus=bus)
        src = member("m0", 4, [9.0])
        with pytest.raises(inject.PromoterKilled):
            ctrl(canary, injector).promote("m0", src)
        out.append(json.load(open(os.path.join(
            serve, promote.JOURNAL_NAME)))["entries"]["m0@4"])
        out.append(ctrl(canary).promote("m0", src))
    elif name == "torn_publish":
        canary = FakeCanary(serve, {2: "promote"})
        src = member("m0", 6, [3.0])
        os.makedirs(serve, exist_ok=True)
        with open(os.path.join(serve, promote.JOURNAL_NAME), "w") as f:
            json.dump({"entries": {"m0@6": {
                "member": "m0", "src_step": 6, "serve_step": 2,
                "phase": "publishing", "outcome": None, "reason": None}}}, f)
        FakeCheckpointer(serve).store["steps"][2] = {"w": ["TORN"]}
        out.append(ctrl(canary).promote("m0", src))
        out.append(FakeCheckpointer(serve).store["steps"][2])
    elif name == "monotonic_serve_step":
        canary = FakeCanary(serve)
        c = ctrl(canary)
        out.append(c._next_serve_step())
        canary.incumbent["step"] = 5
        out.append(c._next_serve_step())
        FakeCheckpointer(serve).save(7, {})
        out.append(c._next_serve_step())
        c._save_entry("mX@1", {"serve_step": 11})
        out.append(c._next_serve_step())
    elif name == "no_source":
        canary = FakeCanary(serve)
        with pytest.raises(FileNotFoundError) as e:
            ctrl(canary).promote("m0", str(tmp / "empty"))
        out.append(str(e.value).replace(str(tmp), "<tmp>"))
    journal_path = os.path.join(serve, promote.JOURNAL_NAME)
    journal = (json.load(open(journal_path))
               if os.path.exists(journal_path) else None)
    return (out, _records(events), journal,
            FakeCheckpointer(serve).store["saves"], canary.incumbent,
            sorted(canary._rejected_steps))


SCENARIOS = ["walk_and_cache", "reject_then_next", "deadline",
             "kill_restart", "torn_publish", "monotonic_serve_step",
             "no_source"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_state_machine_equals_the_reference(name, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = _scenario(name, "port", tmp_path / "port")
    want = _scenario(name, "ref", tmp_path / "ref")
    assert got == want
    out, records, journal, saves, incumbent, rejected = got
    check = {
        "walk_and_cache": lambda: (
            [o["outcome"] for o in out] == ["promoted", "promoted"]
            and saves == 1 and [r[1] for r in records]
            == ["candidate", "canary", "promoted"]),
        "reject_then_next": lambda: (
            [(o["outcome"], o["serve_step"]) for o in out]
            == [("rejected", 1), ("promoted", 2)] and rejected == [1]),
        "deadline": lambda: out[0]["outcome"] == "rolled_back"
        and "did not resolve" in out[0]["reason"],
        "kill_restart": lambda: (
            out[0]["phase"] == "published" and out[0]["outcome"] is None
            and out[1]["outcome"] == "promoted" and saves == 1
            and [r[1] for r in records if r[0] == "promote"]
            == ["candidate", "canary", "promoted"]),
        "torn_publish": lambda: (
            out[0]["serve_step"] == 2 and out[0]["outcome"] == "promoted"
            and out[1] == {"w": [3.0]} and saves == 1),
        "monotonic_serve_step": lambda: out == [1, 6, 8, 12],
        "no_source": lambda: "no complete checkpoint" in out[0],
    }[name]
    assert check(), got


def test_feedback_pools_the_routers_episodes_like_the_reference(tmp_path):
    got = []
    for name in ("port", "ref"):
        promote, bus_cls, _ = PACKAGES[name]
        canary = FakeCanary(str(tmp_path / name))
        canary.router = types.SimpleNamespace(
            replica_episode_returns=lambda rid: {
                "r0": [1.0, 3.0], "r1": [5.0]}.get(rid, []))
        canary.replicaset = types.SimpleNamespace(
            lock=threading.Lock(), replicas={"r0": None, "r1": None})
        events = []
        ctrl = promote.PromotionController(
            str(tmp_path / name), None, canary, bus=bus_cls(events.append),
            checkpointer_factory=FakeCheckpointer)
        got.append((ctrl.feedback("m0", 3), _records(events),
                    promote.feedback_scores(events)))
    assert got[0] == got[1]
    assert got[0][0] == {"member": "m0", "step": 3, "episodes": 3,
                         "mean_return": 3.0}


# ---------------------------------------------------------------------------
# the port's controller on the port's checkpoints
# ---------------------------------------------------------------------------


def test_corrupt_checkpoint_tears_the_published_step_directory(tmp_path):
    """The published step is the port's ``step_<n>/``: the injector is
    handed that directory, tears every file in it to half its size after
    the marker landed, and the step then fails to restore."""
    from trpo_torch.utils.checkpoint import Checkpointer

    agent, state = port_agent("pendulum")
    src = str(tmp_path / "member")
    Checkpointer(src).save(4, state)
    serve = str(tmp_path / "serve")
    events = []
    injector = port_inject.FaultInjector.from_spec(
        "corrupt_checkpoint@step=1", bus=PortBus(events.append))
    seen = {}
    real = injector.on_checkpoint_published

    def spy(step, step_dir):
        seen["dir"] = step_dir
        for root, _, files in os.walk(step_dir):
            for f in files:
                path = os.path.join(root, f)
                seen[path] = os.path.getsize(path)
        real(step, step_dir)

    injector.on_checkpoint_published = spy
    canary = FakeCanary(serve, {})
    ctrl = port_promote.PromotionController(
        serve, agent.init_state(), canary, injector=injector,
        gate_timeout_s=0.05, poll_interval=0.01)
    canary.tick = lambda: None   # the gate never resolves: rolled back
    res = ctrl.promote("m0", src)
    assert res["serve_step"] == 1 and res["outcome"] == "rolled_back"
    assert seen["dir"] == os.path.join(serve, "step_1")
    torn = {p: n for p, n in seen.items() if p != "dir"}
    assert len(torn) >= 2   # tensors.pt and state.json at least
    for path, size in torn.items():
        assert os.path.getsize(path) == size // 2, path
    fault = [e for e in events if e["kind"] == "fault_injected"]
    assert fault and fault[0]["files"] == len(torn)
    # the marker landed before the tear: the step looks complete, and
    # only a restore finds it broken
    ck = Checkpointer(serve)
    assert ck.latest_step() == 1
    with pytest.raises(Exception):
        ck.restore(agent.init_state(), step=1)


def test_promotions_through_the_ports_canary(tmp_path):
    """Over the port's ``CanaryController`` and two in-process replicas
    under live /act traffic: the first promotion is adopted (serving step
    1), a torn publish (``corrupt_checkpoint@step=2``) is rejected by its
    failed reload and blacklisted, a clean third promotion passes the
    gate (step 3), every replica ends on step 3, and the log passes both
    packages' validators."""
    from trpo_torch.serve import (
        CanaryController,
        MicroBatcher,
        PolicyServer,
        Router,
    )
    from trpo_torch.utils.checkpoint import Checkpointer

    agent, state = port_agent("pendulum")
    serve = str(tmp_path / "serve")
    members = {}
    for i, mid in enumerate(("m0", "m1", "m2")):
        members[mid] = str(tmp_path / mid)
        Checkpointer(members[mid]).save(i + 1, state)
    incumbent = {"step": None}
    log = tmp_path / "flywheel.jsonl"
    from trpo_torch.obs.events import JsonlSink, manifest_fields

    bus = PortBus(JsonlSink(str(log)))
    bus.emit("run_manifest", **manifest_fields(None, device="cpu"))

    def make(rid):
        def factory():
            engine = agent.serve_engine()
            batcher = MicroBatcher(engine, deadline_ms=1.0)
            return PolicyServer(
                engine, batcher, port=0, checkpointer=Checkpointer(serve),
                template=agent.init_state(), poll_interval=60.0,
                managed_reload=True, bus=bus, replica_name=rid,
                initial_step=incumbent["step"]), [batcher]
        return factory

    injector = port_inject.FaultInjector.from_spec(
        "corrupt_checkpoint@step=2", bus=bus)
    # the first publish lands before any replica runs, as in a
    # deployment: a stand-in gate adopts it
    adopt = types.SimpleNamespace(
        incumbent=incumbent, _rejected_steps=set(),
        tick=lambda: incumbent.update(step=Checkpointer(serve).latest_step()))
    ctrl = port_promote.PromotionController(
        serve, agent.init_state(), adopt, bus=bus, injector=injector,
        gate_timeout_s=60.0, poll_interval=0.05)
    first = ctrl.promote("m0", members["m0"])
    assert (first["serve_step"], first["outcome"]) == (1, "promoted")
    rs = make_set(make, 2, bus=bus)
    router = Router(rs, port=0, canary_fraction=0.5, bus=bus)
    canary = CanaryController(rs, router, Checkpointer(serve).latest_step,
                              incumbent=incumbent, window_requests=6,
                              poll_interval=0.05, gate_timeout_s=30.0,
                              p99_budget_pct=1000.0, bus=bus)
    ctrl.canary = canary
    stop, errors = threading.Event(), []

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            status, out = post(router.url + "/act", {
                "obs": r.standard_normal(agent.obs_shape).tolist()})
            if status != 200:
                errors.append((status, out))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        torn = ctrl.promote("m1", members["m1"])
        assert (torn["serve_step"], torn["outcome"]) == (2, "rejected")
        assert 2 in canary._rejected_steps and incumbent["step"] == 1
        clean = ctrl.promote("m2", members["m2"])
        assert (clean["serve_step"], clean["outcome"]) == (3, "promoted")
        assert incumbent["step"] == 3
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            rs.tick()
            steps = {r["loaded_step"]
                     for r in rs.snapshot()["replicas"].values()}
            if steps == {3}:
                break
            time.sleep(0.05)
        assert steps == {3}
        # a repeat of a resolved promotion is answered from the journal
        assert ctrl.promote("m1", members["m1"])["outcome"] == "rejected"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15.0)
        canary.close()
        router.close()
        rs.close()
        bus.close()
    assert not errors, errors[:5]
    assert injector.all_fired
    assert _validate("port", str(log)) == []
    assert _validate("ref", str(log)) == []


# ---------------------------------------------------------------------------
# the validators: the same verdicts on the same logs
# ---------------------------------------------------------------------------


def _validate(which, path):
    if which == "port":
        from trpo_torch.scripts.validate_events import validate_file
    else:
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        try:
            from validate_events import validate_file
        finally:
            sys.path.pop(0)
    return validate_file(path)


def _manifest():
    from trpo_torch.obs.events import manifest_fields

    return {"v": 1, "kind": "run_manifest", "t": 0.0,
            **manifest_fields(None, device="cpu")}


def _promote(event, step, t, **extra):
    return {"v": 1, "kind": "promote", "t": t, "member": "m0",
            "event": event, "step": step, **extra}


def _fault(kind, at):
    return {"v": 1, "kind": "fault_injected", "t": 1.0, "fault": kind,
            "at": at, "spec": f"{kind}@step={at}"}


_HEALTH = {"v": 1, "kind": "health", "t": 2.0, "check": "canary_rejected",
           "level": "warn", "message": "reload failed",
           "data": {"step": 3, "replica": "r1"}}
_ROLLED = {"v": 1, "kind": "canary", "t": 2.0, "step": 5,
           "event": "rolled_back", "replica": "r1",
           "reason": "canary realized return -3.1 under incumbent -0.2 by "
                     "more than budget 0.5"}

LOGS = {
    "walk": [_promote("candidate", 2, 1.0, src_step=5),
             _promote("canary", 2, 2.0), _promote("promoted", 2, 3.0),
             _promote("feedback", 2, 4.0, episodes=3, mean_return=1.5)],
    "stranded": [_promote("candidate", 2, 1.0)],
    "other_step": [_promote("candidate", 2, 1.0),
                   _promote("rejected", 3, 2.0)],
    "bad_event": [_promote("teleported", 2, 1.0)],
    "corrupt_health": [_fault("corrupt_checkpoint", 3), _HEALTH],
    "corrupt_terminal": [_promote("candidate", 3, 0.5),
                         _fault("corrupt_checkpoint", 3),
                         _promote("rejected", 3, 2.0)],
    "corrupt_missed": [_fault("corrupt_checkpoint", 3),
                       {**_HEALTH, "data": {"step": 4, "replica": "r1"}}],
    "regress_caught": [_fault("regress_checkpoint", 5),
                       {**_ROLLED, "t": 1.5, "event": "started",
                        "reason": None}, _ROLLED],
    "regress_p99": [_fault("regress_checkpoint", 5),
                    {**_ROLLED, "t": 1.5, "event": "started",
                     "reason": None},
                    {**_ROLLED, "reason": "canary p99 9.0ms over budget "
                                          "5.0ms"}],
    "kill_converged": [_promote("candidate", 4, 0.5),
                       _fault("kill_promoter", 4),
                       _promote("promoted", 4, 3.0)],
    "kill_stranded": [_fault("kill_promoter", 4)],
}


@pytest.mark.parametrize("name", sorted(LOGS))
def test_validators_agree_on_promotion_logs(name, tmp_path):
    path = tmp_path / "log.jsonl"
    with open(path, "w") as f:
        for rec in [_manifest()] + LOGS[name]:
            f.write(json.dumps(rec) + "\n")
    port, ref = _validate("port", str(path)), _validate("ref", str(path))
    assert bool(port) == bool(ref), (port, ref)
    assert bool(port) == (name in ("stranded", "other_step", "bad_event",
                                   "corrupt_missed", "regress_p99",
                                   "kill_stranded"))


@pytest.mark.slow
def test_flywheel_smoke_on_the_cpu(tmp_path):
    """``python -m trpo_torch.scripts.flywheel_smoke --device cpu
    --quick``: the whole loop exits 0 with 0 client errors, and its log
    passes both validators."""
    import subprocess

    out = subprocess.run(
        [sys.executable, "-m", "trpo_torch.scripts.flywheel_smoke",
         "--tmp", str(tmp_path), "--device", "cpu", "--quick"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-2])
    assert summary["client_errors"] == 0 and summary["episodes"] > 0
    log = str(tmp_path / "flywheel_events.jsonl")
    assert _validate("port", log) == []
    assert _validate("ref", log) == []
