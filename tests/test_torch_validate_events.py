"""The port's event-log validator (``python -m
trpo_torch.scripts.validate_events``, on the port's ``validate_event``)
against the reference's (``scripts/validate_events.py``): valid logs the
port wrote (a train run, a routed serve run with spans and captures) and
deliberately broken copies of them give the same error lists from both,
and the same exit codes.
"""

import json

import pytest

from trpo_torch.scripts import validate_events as port_validate

from test_torch_alerts import _load_script
from test_torch_analyze import serve_log, train_log  # noqa: F401


@pytest.fixture(scope="module")
def ref_validate():
    return _load_script("validate_events")


def _rows(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _write(path, rows, tail=""):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write(tail)
    return str(path)


def _first(rows, kind, **match):
    return next(i for i, r in enumerate(rows) if r.get("kind") == kind
                and all(r.get(k) == v for k, v in match.items()))


def _breakages(rows):
    """``{name: broken rows}``: each a defect the validator must name."""
    out = {}
    out["unknown_kind"] = rows + [dict(rows[-1], kind="mystery")]
    out["newer_schema"] = rows + [dict(rows[-1], v=99)]
    i = _first(rows, "span")
    out["span_missing_name"] = [
        {k: v for k, v in r.items() if not (j == i and k == "name")}
        for j, r in enumerate(rows)]
    orphan = dict(rows[i], span="f" * 16, parent="e" * 16)
    orphan.pop("remote", None)  # a local parent must be in the file
    out["orphan_span"] = rows + [orphan]
    c = _first(rows, "capture")
    out["capture_bad_endpoint"] = [
        dict(r, endpoint="nope") if j == c else r for j, r in enumerate(rows)]
    out["unmatched_fault"] = rows + [{
        "v": 1, "t": rows[-1]["t"], "kind": "fault_injected",
        "fault": "kill_replica", "at": 9,
        "spec": "kill_replica@request=9:replica=0"}]
    out["no_manifest"] = [r for r in rows if r.get("kind") != "run_manifest"]
    out["bad_alert"] = rows + [{
        "v": 1, "t": rows[-1]["t"], "kind": "alert", "rule": "slo_p99",
        "state": "firing", "target": "router"}]
    return out


def test_valid_logs_pass_both_validators(train_log, serve_log,  # noqa: F811
                                         ref_validate):
    for path in (train_log, serve_log):
        assert port_validate.validate_file(path) == []
        assert ref_validate.validate_file(path) == []
        assert port_validate.main([path]) == ref_validate.main([path]) == 0


@pytest.mark.parametrize("breakage", [
    "unknown_kind", "newer_schema", "span_missing_name", "orphan_span",
    "capture_bad_endpoint", "unmatched_fault", "no_manifest", "bad_alert",
    "torn_line"])
def test_broken_logs_give_the_reference_errors(breakage, serve_log,  # noqa: F811
                                               ref_validate, tmp_path):
    rows = _rows(serve_log)
    if breakage == "torn_line":
        path = _write(tmp_path / "b.jsonl", rows, tail='{"v": 1, "ki')
    else:
        path = _write(tmp_path / "b.jsonl", _breakages(rows)[breakage])
    errs = port_validate.validate_file(path)
    assert errs == ref_validate.validate_file(path)
    assert errs, breakage
    assert port_validate.main([path]) == ref_validate.main([path]) == 1


def test_train_log_breakages_match(train_log, ref_validate,  # noqa: F811
                                   tmp_path):
    rows = _rows(train_log)
    i = _first(rows, "iteration")
    broken = {
        "stats_not_scalar": [dict(r, stats={"x": [1, 2]}) if j == i else r
                             for j, r in enumerate(rows)],
        "iteration_gap": [r for j, r in enumerate(rows) if j != i],
        "bad_health_level": rows + [{
            "v": 1, "t": rows[-1]["t"], "kind": "health", "check": "x",
            "level": "fatal", "message": "m"}],
    }
    for name, brows in broken.items():
        path = _write(tmp_path / f"{name}.jsonl", brows)
        errs = port_validate.validate_file(path)
        assert errs == ref_validate.validate_file(path), name
