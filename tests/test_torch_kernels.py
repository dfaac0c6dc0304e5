"""The port's CUDA kernels against their plain versions on the card.

These need an sm_90 card and nvcc; on a machine without them each test
skips with the reason (decided in the fixture, never at import). On the
card: ``python -m pytest tests/test_torch_kernels.py -q -m gpu``.
"""

import numpy as np
import pytest
import torch

from trpo_torch.config import get_preset
from trpo_torch.models.policy import BoxSpec, make_policy
from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params
from trpo_torch.ops.fused_fvp import (
    fused_fvp_net_plain,
    make_fused_gaussian_mlp_fvp,
)
from trpo_torch.ops.fvp import make_ggn_fvp
from trpo_torch.ops.reverse_scan import (
    reverse_affine_scan,
    reverse_affine_scan_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(391, 128), (1000, 300), (1, 1), (17, 1), (392, 33)])
def test_reverse_scan_kernel_matches_plain(hopper, shape):
    rng = np.random.default_rng(0)
    c = torch.as_tensor(rng.uniform(0, 1, shape), dtype=torch.float32,
                        device=hopper)
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=hopper)
    _build.reset_launches()
    y = reverse_affine_scan(c, x)
    assert _build.LAUNCHES["reverse_scan"] == 1
    # 2e-5: the reference's scan tolerance (tests/test_pallas_scan.py:32)
    torch.testing.assert_close(y, reverse_affine_scan_plain(c, x),
                               rtol=2e-5, atol=2e-5)


def _fvp_case(dev, rows, dims, activation, compute_dtype=torch.float32):
    policy = make_policy((dims[0],), BoxSpec(dims[-1]), hidden=dims[1:-1],
                         activation=activation)
    params = policy.init(torch.Generator().manual_seed(0))
    params = {"net": {"layers": [{k: t.to(dev) for k, t in layer.items()}
                                 for layer in params["net"]["layers"]]},
              "log_std": torch.linspace(-0.5, 0.2, dims[-1], device=dev)}
    g = torch.Generator(device=dev).manual_seed(1)
    obs = torch.randn(rows, dims[0], generator=g, device=dev)
    weight = torch.ones(rows, device=dev)
    weight[rows - rows // 6:] = 0.0  # a zero-weight tail, as padding makes
    flat0, unravel = flatten_params(params)
    v = torch.randn(flat0.shape, generator=g, device=dev)
    op = make_fused_gaussian_mlp_fvp(params["net"], obs, weight,
                                     params["log_std"], 0.1,
                                     activation=activation,
                                     compute_dtype=compute_dtype)
    return policy, obs, weight, flat0, unravel, v, op


# tile edges of the kernel: rows around its 64- and 128-row tiles, hidden
# widths around its 8-column fragments, 24-wide narrow and 128-wide tiles
_EDGE_CASES = [(rows, (376, width, width, 17), "tanh")
               for rows in (1, 127, 129, 1025) for width in (8, 17, 31, 33)]


@pytest.mark.parametrize(
    "rows, dims, activation",
    [(300, (11, 96, 160, 5), "tanh"), (300, (11, 96, 160, 5), "relu"),
     (257, (7, 33, 5), "elu"), (1000, (376, 256, 256, 17), "tanh")]
    + _EDGE_CASES,
)
def test_fused_fvp_kernel_matches_plain_and_ggn(hopper, rows, dims,
                                                activation):
    policy, obs, weight, flat0, unravel, v, op = _fvp_case(
        hopper, rows, dims, activation)
    _build.reset_launches()
    out = op.flat(v)
    assert _build.LAUNCHES["fused_fvp"] == 1
    plain = torch.cat([(2.0 * op.sum_wn + 0.1) * v[:dims[-1]],
                       fused_fvp_net_plain(op.obs, op.hs, op.ws, v, op.wn,
                                           op.m, 0.1, activation)])
    ggn = make_ggn_fvp(lambda x: policy.apply(unravel(x), obs),
                       policy.dist.fisher_weight, flat0, weight, 0.1)(v)
    # 1e-5: the reference's operator tolerance (tests/test_fused_fvp.py:73)
    assert ((out - plain).norm() / plain.norm()).item() < 1e-5
    assert ((out - ggn).norm() / ggn.norm()).item() < 1e-5


def test_fused_fvp_kernel_is_bitwise_deterministic(hopper):
    # the weight gradients are summed in a fixed order, with no atomics
    *_, v, op = _fvp_case(hopper, 1000, (376, 256, 256, 17), "tanh")
    first = op.flat(v)
    for _ in range(3):
        assert torch.equal(op.flat(v), first)


# K1-bf16's tile edges: rows around its 64-row warpgroup halves and 128-row
# tiles, and past 132 x 128 rows (the card's SMs each take several tiles);
# widths around its 8-column fragments, 32-wide (head and backward) and
# 64-wide (tangent) products, and a width past one 64-column swizzle atom
# that is not a multiple of 64
_BF16_EDGE_CASES = (
    [(rows, (376, width, width, 17), "tanh")
     for rows in (1, 63, 65, 127, 129, 1025)
     for width in (8, 17, 31, 33, 200)]
    + [(20000, (376, 33, 33, 17), "tanh")])

# Torsos past one accumulator's 256 columns, where phase A runs product by
# product in 256-column tiles: hidden widths 264 and 512 (the Atari-style
# presets' torso), and a head wider than 256
_BF16_WIDE_CASES = [
    (300, (376, 264, 17), "tanh"), (129, (376, 264, 264, 17), "relu"),
    (1000, (128, 512, 6), "tanh"), (300, (11, 512, 512, 17), "elu"),
    (65, (11, 64, 300), "tanh")]

# K1-bf16 against its plain version (the same rounding points, products of
# bf16 values in f32): 1e-2 relative L2, the bound the port holds the bf16
# operator to; a value that lands on the other side of a bf16 rounding
# boundary (the sums run in another order) moves by one bf16 ulp. A second,
# tighter limit checks the rounding points themselves: sound runs read
# 1e-5 or less, while f32 K1 on the same inputs (a kernel that rounds
# nowhere) reads 1e-3 or more and must fail it. Depths one and three show
# the on-chip chain at other lengths.
K1_BF16_TIGHT = 1e-4


@pytest.mark.parametrize(
    "rows, dims, activation",
    [(300, (11, 96, 160, 5), "tanh"), (300, (11, 96, 160, 5), "relu"),
     (257, (7, 33, 5), "elu"), (1000, (376, 256, 256, 17), "tanh"),
     (300, (11, 96, 5), "tanh"), (300, (20, 64, 40, 130, 6), "relu")]
    + _BF16_EDGE_CASES + _BF16_WIDE_CASES,
)
def test_fused_fvp_bf16_kernel_matches_plain(hopper, rows, dims, activation):
    *_, v, op = _fvp_case(hopper, rows, dims, activation, torch.bfloat16)
    *_, op32 = _fvp_case(hopper, rows, dims, activation)
    _build.reset_launches()
    out = op.flat(v)
    assert _build.LAUNCHES["fused_fvp_bf16"] == 1
    plain = op.plain(v)
    assert torch.isfinite(out).all()
    rel = ((out - plain).norm() / plain.norm()).item()
    control = ((op32.flat(v) - plain).norm() / plain.norm()).item()
    assert rel < 1e-2
    assert rel < K1_BF16_TIGHT
    assert control > K1_BF16_TIGHT


# the on-chip chain (one phase-A launch) and a wide torso's product-by-
# product launches
@pytest.mark.parametrize("dims", [(376, 256, 256, 17), (376, 512, 17)])
def test_fused_fvp_bf16_kernel_is_bitwise_deterministic(hopper, dims):
    *_, v, op = _fvp_case(hopper, 1000, dims, "tanh", torch.bfloat16)
    first = op.flat(v)
    for _ in range(3):
        assert torch.equal(op.flat(v), first)


def test_small_iteration_on_the_card_goes_through_the_kernels(hopper):
    cfg = get_preset("humanoid-sim").replace(
        solve_audit_every=0, n_envs=16, batch_timesteps=512,
        policy_hidden=(64, 64))  # unaudited: every matvec is K1
    from trpo_torch.agent import TRPOAgent

    agent = TRPOAgent("humanoid-sim", cfg, device=hopper)
    state = agent.init_state()
    _build.reset_launches()
    state, stats = agent.run_iteration(state)
    torch.cuda.synchronize()
    # one matvec per CG iteration that took effect, and one for sᵀFs
    assert _build.LAUNCHES["fused_fvp"] == int(stats["cg_iterations"]) + 1
    assert _build.LAUNCHES["reverse_scan"] == 1
    assert _build.LAUNCHES["fused_fvp_plain"] == 0
    assert _build.LAUNCHES["reverse_scan_plain"] == 0
    assert float(stats["kl_old_new"]) <= 2 * cfg.max_kl
