"""The port's checkpoints (``trpo_torch/utils/checkpoint.py``), case by case
against the reference's tests of ``trpo_tpu/utils/checkpoint.py``
(``tests/test_checkpoint.py``, ``tests/test_resilience.py``'s save-integrity
gate, ``tests/test_solver_ladder.py``'s presence flips): a round trip is
equal leaf by leaf, a resumed run continues bit for bit, restores tolerate
the config's presence flips and refuse any other mismatch, and a torn save
is never selected.
"""

import os
import pickle

import pytest
import torch

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig, get_preset
from trpo_torch.ops.flat import tree_leaves
from trpo_torch.utils.checkpoint import Checkpointer

KW = dict(n_envs=4, batch_timesteps=64, cg_iters=4, vf_train_steps=5,
          policy_hidden=(16,), vf_hidden=(16,), seed=7)


def _agent(**kw):
    return TRPOAgent("cartpole", TRPOConfig(**{**KW, **kw}), device="cpu")


def _leaves(state):
    """Every leaf, the rollout generator as its state bytes."""
    return [leaf.get_state() if isinstance(leaf, torch.Generator) else leaf
            for leaf in tree_leaves(state)]


def assert_equal(x, y):
    """Bit for bit: same dtype, equal values, NaN where the other is NaN
    (a batch with no finished episode logs a NaN mean by contract)."""
    torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def assert_state_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_save_restore_roundtrip(tmp_path):
    agent = _agent()
    state, _ = agent.run_iteration(agent.init_state())
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(state.iteration, state)
    assert ck.latest_step() == 1
    restored = ck.restore(agent.init_state())
    assert_state_equal(state, restored)
    assert restored.rng is not state.rng


@pytest.mark.parametrize("preset, narrow", [
    ("cartpole", KW),
    # the flagship's state: head-block preconditioner, ladder (audit on
    # update 1), adaptive damping
    ("humanoid-sim", dict(n_envs=4, batch_timesteps=64,
                          policy_hidden=(16, 16), vf_train_steps=3,
                          adaptive_damping=True)),
    # the recurrent carry (h, prev_done) and the pixel env's state
    ("cartpole-po", dict(KW, policy_gru=8, policy_cell="lstm")),
    ("catch", dict(KW, batch_timesteps=32)),
])
def test_resume_continues_identically(tmp_path, preset, narrow):
    cfg = get_preset(preset).replace(**narrow)
    agent = TRPOAgent(cfg.env, cfg, device="cpu")
    state, _ = agent.run_iteration(agent.init_state())
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(state.iteration, state)
    restored = ck.restore(agent.init_state())
    cont_orig, stats_orig = agent.run_iteration(state)
    cont_rest, stats_rest = agent.run_iteration(restored)
    assert_state_equal(cont_orig, cont_rest)
    assert set(stats_orig) == set(stats_rest)
    for k in stats_orig:
        assert_equal(torch.as_tensor(stats_orig[k]),
                     torch.as_tensor(stats_rest[k]))
    assert cont_rest.iteration == 2


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(None)


def test_max_to_keep_prunes_steps_and_markers(tmp_path):
    agent = _agent()
    state = agent.init_state()
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, state)
        state, _ = agent.run_iteration(state)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not os.path.exists(ck._marker_path(1))
    assert os.path.exists(ck._marker_path(2))
    assert os.path.exists(ck._marker_path(3))


def test_restore_across_adaptive_damping_flip(tmp_path):
    adaptive, fixed = _agent(adaptive_damping=True), _agent()
    state, _ = adaptive.run_iteration(adaptive.init_state())
    ck = Checkpointer(str(tmp_path / "a2f"))
    ck.save(state.iteration, state)
    restored = ck.restore(fixed.init_state())
    assert restored.cg_damping is None
    assert_state_equal(state._replace(cg_damping=None), restored)
    fixed.run_iteration(restored)

    state_f, _ = fixed.run_iteration(fixed.init_state())
    ck = Checkpointer(str(tmp_path / "f2a"))
    ck.save(state_f.iteration, state_f)
    restored2 = ck.restore(adaptive.init_state())
    assert float(restored2.cg_damping) == pytest.approx(0.1)
    assert_state_equal(state_f, restored2._replace(cg_damping=None))
    adaptive.run_iteration(restored2)


def test_restore_across_ladder_and_precond_flips(tmp_path):
    off = _agent()
    on = _agent(fvp_subsample=0.75, solve_audit_every=5)
    s_off, _ = off.run_iteration(off.init_state(0))
    ck = Checkpointer(str(tmp_path / "off"))
    ck.save(1, s_off)
    restored = ck.restore(on.init_state(0))
    assert restored.ladder is not None
    assert int(restored.ladder.step) == 0 and restored.ladder.step_host == 0
    assert float(restored.ladder.cosine_min) == 1.0
    s2, _ = on.run_iteration(restored)
    assert int(s2.ladder.step) == 1

    s_on, _ = on.run_iteration(on.init_state(0))
    ck = Checkpointer(str(tmp_path / "on"))
    ck.save(1, s_on)
    assert ck.restore(off.init_state(0)).ladder is None

    cfg = get_preset("halfcheetah-sim").replace(
        n_envs=4, batch_timesteps=64, policy_hidden=(16,), vf_train_steps=3,
        solve_audit_every=0)
    amortized = TRPOAgent(cfg.env, cfg, device="cpu")
    plain = TRPOAgent(cfg.env, cfg.replace(precond_refresh_every=1),
                      device="cpu")
    s_pre, _ = amortized.run_iteration(amortized.init_state(0))
    ck = Checkpointer(str(tmp_path / "pre"))
    ck.save(1, s_pre)
    assert s_pre.precond is not None
    assert ck.restore(plain.init_state(0)).precond is None
    back = ck.restore(amortized.init_state(0))
    assert back.precond.age == 1


def test_restore_refuses_other_mismatches(tmp_path):
    agent = _agent()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, agent.init_state())
    with pytest.raises(ValueError, match="policy_params"):
        ck.restore(_agent(policy_hidden=(8,)).init_state())
    with pytest.raises(ValueError, match="obs_norm"):
        ck.restore(_agent(normalize_obs=True).init_state())


def test_restore_unpickles_no_object(tmp_path):
    agent = _agent()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, agent.init_state())
    path = os.path.join(ck._step_dir(1), "tensors.pt")
    with open(path, "wb") as f:
        pickle.dump({"x": os.system}, f)
    with pytest.raises(pickle.UnpicklingError):
        ck.restore(agent.init_state())


def test_torn_save_never_selected_and_pruned(tmp_path):
    agent = _agent()
    state = agent.init_state()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(2, state)
    state2, _ = agent.run_iteration(state)
    ck.save(4, state2)
    assert ck.latest_step() == 4
    os.remove(ck._marker_path(4))  # the tear: step written, no marker
    assert ck.latest_step() == 2
    restored = ck.restore(agent.init_state())
    assert restored.iteration == 0  # step 2 held the initial state
    assert 4 not in ck.all_steps()


def test_torn_first_save_in_fresh_directory_not_trusted(tmp_path):
    agent = _agent()
    ck = Checkpointer(str(tmp_path / "ck"))
    assert os.path.exists(ck._sentinel_path())
    ck.save(2, agent.init_state())
    os.remove(ck._marker_path(2))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(agent.init_state())
    assert 2 not in ck.all_steps()


def test_directory_without_markers_or_sentinel_still_restores(tmp_path):
    agent = _agent()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, agent.init_state())
    os.remove(ck._marker_path(5))
    os.remove(ck._sentinel_path())
    assert ck.latest_step() == 5
    assert ck.restore(agent.init_state()).iteration == 0
