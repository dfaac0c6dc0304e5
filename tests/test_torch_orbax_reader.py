"""``scripts/orbax_to_torch.py``: a step that ``trpo_tpu``'s Orbax
``Checkpointer`` wrote, converted into the port's format and restored by
the port — weights, critic, Adam moments, observation statistics, damping
and counters exactly; the greedy action within 1e-6; training goes on
from it. The reader's marker gate never picks a torn step, and asking for
one exits 2.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset
from trpo_torch.ops.flat import tree_leaves
from trpo_torch.utils.checkpoint import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import orbax_to_torch  # noqa: E402

sys.path.pop(0)

FLAGS = ["--preset", "cartpole", "--normalize-obs", "--adaptive-damping",
         "--batch-timesteps", "256", "--device", "cpu"]


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


@pytest.mark.slow
def test_reference_step_converts_and_resumes_in_the_port(tmp_path):
    from trpo_tpu.agent import TRPOAgent as TpuAgent
    from trpo_tpu.config import TRPOConfig as TpuConfig
    from trpo_tpu.utils.checkpoint import Checkpointer as TpuCheckpointer

    src, dst = tmp_path / "ref", tmp_path / "port"
    ref_cfg = TpuConfig(env="cartpole", normalize_obs=True,
                        adaptive_damping=True, batch_timesteps=256)
    ref = TpuAgent("cartpole", ref_cfg)
    ref_state, _ = ref.run_iterations(ref.init_state(0), 2)
    TpuCheckpointer(str(src)).save(2, ref_state)

    assert orbax_to_torch.main(["--src", str(src), "--dst", str(dst)]
                               + FLAGS) == 0
    cfg = get_preset("cartpole").replace(normalize_obs=True,
                                         adaptive_damping=True,
                                         batch_timesteps=256)
    agent = TRPOAgent("cartpole", cfg, device="cpu")
    state = Checkpointer(str(dst)).restore(agent.init_state(0))

    for got, want in (
            (state.policy_params, ref_state.policy_params),
            (state.vf_state.params, ref_state.vf_state.params),
            (state.vf_state.opt_state.mu, ref_state.vf_state.opt_state[0].mu),
            (state.vf_state.opt_state.nu, ref_state.vf_state.opt_state[0].nu),
            (state.obs_norm, ref_state.obs_norm),
            (state.metrics, ref_state.metrics)):
        for g, w in zip(_port_leaves(got), _np_leaves(want)):
            np.testing.assert_array_equal(g, w)
    assert state.vf_state.opt_state.count == int(
        ref_state.vf_state.opt_state[0].count)
    assert float(state.cg_damping) == float(ref_state.cg_damping)
    assert state.iteration == int(ref_state.iteration) == 2
    assert state.total_timesteps == int(ref_state.total_timesteps)
    assert int(state.total_episodes) == int(ref_state.total_episodes)
    # the device env's carry matched the port's fields and came over
    np.testing.assert_array_equal(state.env_carry[1].numpy(),
                                  np.asarray(ref_state.env_carry[1]))

    obs = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    _, d_ref = ref.act(ref_state, jnp.asarray(obs), key=jax.random.key(0),
                       eval_mode=True)
    _, d_port = agent.act(state, torch.from_numpy(obs), eval_mode=True)
    np.testing.assert_allclose(d_port["logits"].numpy(),
                               np.asarray(d_ref["logits"]), atol=1e-6)

    state, stats = agent.run_iteration(state)
    assert state.iteration == 3
    assert all(np.isfinite(float(stats[k])) for k in ("entropy",
                                                      "kl_old_new"))


def test_torn_step_is_never_picked_and_refused_by_name(tmp_path, capsys):
    src = tmp_path / "ref"
    for s in (1, 2, 3):
        (src / str(s)).mkdir(parents=True)
    for s in (1, 2):
        (src / f"step_{s}.complete").write_text("")
    (src / ".markers_enabled").write_text("")
    assert orbax_to_torch.complete_steps(str(src)) == ([1, 2], [3])
    assert orbax_to_torch.choose_step(str(src)) == 2
    code = orbax_to_torch.main(["--src", str(src), "--dst",
                                str(tmp_path / "port"), "--step", "3"]
                               + FLAGS)
    assert code == 2
    assert "step 3" in capsys.readouterr().err
    assert not (tmp_path / "port").exists()
    # a marker-enabled directory whose every save tore has no step at all
    shutil.rmtree(src / "1")
    for s in (1, 2):
        (src / f"step_{s}.complete").unlink()
    assert orbax_to_torch.complete_steps(str(src)) == ([], [2, 3])
