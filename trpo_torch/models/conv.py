"""The Nature-DQN convolutional torso for pixel policies (counterpart:
``trpo_tpu/models/conv.py``).

Observations stay channels-last ``(N, H, W, C)``, as the envs emit them
and the reference convolves them. The weights are stored ``(O, I, kh, kw)``
(PyTorch's layout, the reference's ``HWIO`` permuted by
``w.permute(3, 2, 0, 1)``, see ``convert.py``), and the forward runs the
convolutions in NCHW through ``torch.nn.functional.conv2d`` — the
counterpart of the reference's ``lax.conv_general_dilated``, an XLA op
outside any Pallas kernel. The features are permuted back to NHWC before
they are flattened, so the head's first dense layer sees its rows in the
reference's order.

``uint8`` pixels are cast to the compute dtype first and then divided by
255 in it, as in the reference (a product by 1/255 would round
differently).

Convolutions on the card go through cuDNN, whose defaults would compute
them in TF32 (``torch.backends.cudnn.allow_tf32``) and pick algorithms by
timing (``benchmark``) and among nondeterministic ones: an f32 Fisher
operator, and a resumed run equal bit for bit to an uninterrupted one,
need neither. :func:`exact_convolutions` sets those flags; the agent calls
it when it builds a conv policy.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ATARI_TORSO_SPEC", "apply_atari_torso", "exact_convolutions",
           "init_atari_torso", "torso_features"]

# (kernel_h, kernel_w, out_channels, stride)
ATARI_TORSO_SPEC = ((8, 8, 32, 4), (4, 4, 64, 2), (3, 3, 64, 1))


def exact_convolutions() -> None:
    """cuDNN convolutions in f32, with deterministic algorithms chosen
    without timing: the f32 operator the solve audit assumes, and bitwise
    resumes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def torso_features(obs_shape: Tuple[int, int, int],
                   spec=ATARI_TORSO_SPEC) -> int:
    """The flattened feature width of the torso on ``(H, W, C)`` inputs
    (VALID padding)."""
    h, w, _ = obs_shape
    for kh, kw, _c, stride in spec:
        h, w = (h - kh) // stride + 1, (w - kw) // stride + 1
    if h < 1 or w < 1:
        raise ValueError(f"observation {obs_shape} is too small for the "
                         "conv torso")
    return h * w * spec[-1][2]


def init_atari_torso(generator: torch.Generator, in_channels: int = 4,
                     spec: Sequence = ATARI_TORSO_SPEC):
    """He-normal filters (``N(0, 2/fan_in)``), zero biases, drawn on the
    CPU generator given; weights ``(O, I, kh, kw)``."""
    convs = []
    c_in = in_channels
    for kh, kw, c_out, _stride in spec:
        fan_in = kh * kw * c_in
        w = torch.randn(kh, kw, c_in, c_out, generator=generator)
        w = (w * math.sqrt(2.0 / fan_in)).permute(3, 2, 0, 1).contiguous()
        convs.append({"w": w, "b": torch.zeros(c_out)})
        c_in = c_out
    return {"convs": convs}


def apply_atari_torso(params, x: torch.Tensor, spec=ATARI_TORSO_SPEC,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """``x``: (N, H, W, C) uint8 or float. Returns (N, features) f32, the
    features in NHWC order."""
    h = x.to(compute_dtype)
    if x.dtype == torch.uint8:
        h = h / 255.0
    h = h.permute(0, 3, 1, 2)
    for layer, (_kh, _kw, _c, stride) in zip(params["convs"], spec):
        h = F.conv2d(h, layer["w"].to(compute_dtype), stride=stride)
        h = F.relu(h + layer["b"].to(compute_dtype)[:, None, None])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return h.float()
