"""``benchmark/flops/`` against hand counts at small shapes, against
torch's own operation counter on the reference's forward and gradient,
and at the flagship's FVP shape."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import layerflops
from benchmark.spec import load_json, load_module, HERE

MLP = {"obs_shape": [3], "hidden": [4], "action": {"kind": "box", "dim": 2},
       "activation": "tanh", "init_log_std": 0.0}
CNN = {"obs_shape": [36, 36, 4], "convs": [[8, 8, 32, 4], [4, 4, 64, 2],
                                           [3, 3, 64, 1]],
       "hidden": [16], "action": {"kind": "discrete", "n": 3},
       "activation": "tanh"}


def test_layer_rules_by_hand():
    # 3 -> 4 -> 2: 12 and 8 multiply-adds a row
    assert layerflops.forward([12, 8], 1) == 40
    assert layerflops.gradient([12, 8], 1) == 2 * (12 + 8) * 2 + 2 * 8
    # tangent forward 12 + 2*8, backward 12 (weights) + 2*8
    assert layerflops.fvp([12, 8], 1) == 2 * (12 + 16 + 12 + 16)


def test_families_by_hand():
    g = load_module("flops", "gaussian_mlp")
    assert g.macs(MLP) == [12, 8]
    assert g.n_params(MLP) == 12 + 4 + 8 + 2 + 2
    c = load_module("flops", "nature_cnn")
    # 36 -> 8 -> 3 -> 1: (8*8*32)*(8*8*4), (3*3*64)*(4*4*32), 64*(3*3*64)
    assert c.macs(CNN)[:3] == [8 * 8 * 32 * 256, 3 * 3 * 64 * 512,
                               1 * 1 * 64 * 576]
    assert c.macs(CNN)[3:] == [64 * 16, 16 * 3]


def test_flagship_fvp_is_35_44_gflop():
    g = load_module("flops", "gaussian_mlp")
    cfg = load_json(HERE / "configs" / "humanoid-sim.json")
    assert g.fvp(cfg, 37_536) == 35_438_788_608
    pong = load_json(HERE / "configs" / "pong-sim.json")
    assert load_module("flops", "nature_cnn").forward(pong, 1) == 18_689_024


@pytest.mark.parametrize("family,cfg", [("gaussian_mlp", MLP),
                                        ("nature_cnn", CNN)])
def test_against_torch_counter(family, cfg):
    """The forward and the gradient as torch counts the reference's
    matrix products and convolutions."""
    fam = load_module("families", family)
    ref = load_module("reference", family)
    flops = load_module("flops", family)
    gen = torch.Generator().manual_seed(0)
    drawn = fam.draw_params(cfg, gen, "cpu")
    obs, actions = fam.draw_batch(cfg, gen, "cpu", 5, drawn)
    params = {k: v.requires_grad_(True) for k, v in drawn.items()}
    with FlopCounterMode(display=False) as fwd:
        d = ref.forward(cfg, params, obs)
    assert fwd.get_total_flops() == flops.forward(cfg, 5)
    with FlopCounterMode(display=False) as both:
        loss = ref.logp(ref.forward(cfg, params, obs), actions).sum()
        torch.autograd.grad(loss, list(params.values()))
    assert both.get_total_flops() == flops.gradient(cfg, 5)
    assert d is not None
