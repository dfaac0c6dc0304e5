"""The plain reference against the program's update, on the CPU at small
shapes, for each cell: the same weights and batches give the same
updates, and a planted fault (the reference on half of each batch) is
far off."""

import pytest
import torch

from benchmark import check
from benchmark.spec import Cell
from benchmark.tests._small import CELLS, small_config


def _readings(cell_name, seed):
    cell = Cell(cell_name)
    wl = cell.unit.Workload(cell, seed, torch.device("cpu"),
                            config=small_config(cell_name))
    wl.build_program()
    prog = wl.check_program()
    wl.drop_program()
    return cell, wl, prog, check.reference_readings(cell, wl)


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_agrees_with_the_program(cell_name):
    cell, wl, prog, ref = _readings(cell_name, 4_000_000_007)
    fed = int(wl.mix["check_updates"])
    # the window-fed updates move: no rollback, a real step on every leaf
    assert all(s < 0 for s in ref["surrogate_after"][:fed])
    assert all(0 < k <= 0.02 for k in ref["kl"][:fed])
    assert ref["rolled_back"][:fed] == [False] * fed
    # the planted stale batch rolls back, on both sides
    kinds = [k for k in wl.mix["check_stress"]
             if cell.family.stress_batch(k, wl.config, torch.Generator(),
                                         "cpu", 4, wl.params0) is not None]
    if "rollback" in kinds:
        assert ref["rolled_back"][fed + kinds.index("rollback")]
    nums = check.numbers(prog, ref, wl.params0)
    assert nums["search"] == 0, (prog["step_fraction"], ref["step_fraction"])
    assert nums["grad"] < 1e-5
    assert nums["loss"] < 5e-2 and nums["change"] < 5e-2
    correct, _ = check.verdict(nums, cell.limits)
    assert correct, nums


@pytest.mark.parametrize("cell_name", CELLS)
def test_half_batch_fault_is_caught(cell_name):
    cell, wl, _, ref = _readings(cell_name, 4_000_000_011)
    half = check.reference_readings(cell, wl, half_batch=True)
    correct, check_out = check.verdict(check.numbers(half, ref, wl.params0),
                                       cell.limits)
    assert not correct, check_out


def test_planted_far_actions_make_the_search_backtrack():
    """At small shapes on the CPU: the planted batch
    of far-out actions makes the reference and the program backtrack to
    the same fraction."""
    cell = Cell("humanoid-sim.update")
    config = dict(small_config("humanoid-sim.update"),
                  steps_per_env=256)
    wl = cell.unit.Workload(cell, 4_000_000_013, torch.device("cpu"),
                            config=config)
    wl.build_program()
    prog = wl.check_program()
    wl.drop_program()
    ref = check.reference_readings(cell, wl)
    fed = int(wl.mix["check_updates"])
    assert ref["step_fraction"][fed] < 1.0, ref["step_fraction"]
    assert prog["step_fraction"] == ref["step_fraction"]
    assert prog["rolled_back"] == ref["rolled_back"]


def test_keep_rows_is_the_programs_subsample():
    from benchmark.spec import load_module
    from trpo_torch.trpo import _fvp_keep_indices

    keep = load_module("reference", "trpo").keep_rows
    for n in (1, 2, 7, 64, 50_048):
        for f in (0.25, 0.5, 0.75, 0.9, None):
            want = (list(range(n)) if f is None
                    else _fvp_keep_indices(n, f).tolist())
            assert keep(n, f).tolist() == want, (n, f)
