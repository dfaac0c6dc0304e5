"""The Nature-DQN conv torso with a categorical head
(``trpo_torch.models.policy`` on ``(H, W, C)`` observations): what the
program is handed for a configuration of this family. Weights and frames
are drawn on the device from the benchmark's generator; actions are drawn
from the drawn policy with the plain forward (``reference/``)."""

from __future__ import annotations

import math

import torch

from benchmark import tree
from benchmark.spec import load_module

# The logits layer at unit gain, as a policy's is a few updates into
# training (the program's own initial scale is 0.01: a uniform policy).
HEAD_GAIN = 1.0


def _policy_probs(config, params: dict, frames: torch.Tensor):
    """The drawn policy's action probabilities on ``frames`` (the plain
    forward, f32, TF32 off, deterministic convolutions)."""
    ref = load_module("reference", "nature_cnn")
    flags = torch.backends.cudnn
    old = (flags.allow_tf32, flags.deterministic,
           torch.backends.cuda.matmul.allow_tf32)
    flags.allow_tf32, flags.deterministic = False, True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return torch.softmax(ref.forward(config, params, frames)["logits"],
                                 dim=-1)
    finally:
        (flags.allow_tf32, flags.deterministic,
         torch.backends.cuda.matmul.allow_tf32) = old


def _sample(probs: torch.Tensor, gen, device) -> torch.Tensor:
    u = torch.rand(probs.shape[0], 1, generator=gen, device=device)
    return (probs.cumsum(-1) < u).sum(-1).clamp(max=probs.shape[-1] - 1)


def conv_out(config) -> tuple:
    """``(h, w, c)`` after the torso (VALID padding)."""
    h, w, c = config["obs_shape"]
    for kh, kw, co, stride in config["convs"]:
        h, w, c = (h - kh) // stride + 1, (w - kw) // stride + 1, co
    return h, w, c


def head_dims(config) -> list:
    return [math.prod(conv_out(config)), *config["hidden"],
            config["action"]["n"]]


def draw_params(config, gen: torch.Generator, device) -> dict:
    """Named leaves: He-normal filters ``(O, I, kh, kw)``, ``N(0,
    2/fan_in)`` dense weights, ``HEAD_GAIN/sqrt(fan_in)`` for the logits,
    zero biases."""
    shapes, scales = [], []
    c_in = config["obs_shape"][2]
    for kh, kw, co, _ in config["convs"]:
        shapes.append((co, c_in, kh, kw))
        scales.append(math.sqrt(2.0 / (kh * kw * c_in)))
        c_in = co
    d = head_dims(config)
    for i, (a, b) in enumerate(zip(d[:-1], d[1:])):
        shapes.append((a, b))
        scales.append((HEAD_GAIN if i == len(d) - 2 else math.sqrt(2.0))
                      / math.sqrt(a))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    named, off = {}, 0
    n_conv = len(config["convs"])
    for j, (shape, scale, n) in enumerate(zip(shapes, scales, sizes)):
        w = (flat[off:off + n].view(shape) * scale).contiguous()
        off += n
        if j < n_conv:
            named[f"torso.convs.{j}.w"] = w
            named[f"torso.convs.{j}.b"] = torch.zeros(shape[0], device=device)
        else:
            named[f"head.layers.{j - n_conv}.w"] = w
            named[f"head.layers.{j - n_conv}.b"] = torch.zeros(
                shape[1], device=device)
    return named


def draw_batch(config, gen: torch.Generator, device, rows: int,
               params: dict):
    """``(frames, actions)``: uniform uint8 frames, and actions drawn from
    the policy ``params``."""
    frames = torch.randint(0, 256, (rows, *config["obs_shape"]),
                           generator=gen, device=device, dtype=torch.uint8)
    return frames, _sample(_policy_probs(config, params, frames), gen,
                           device)


STALE_LOGIT = 4.0  # the rollback batch's behaviour policy's preference


def stress_batch(kind: str, config, gen: torch.Generator, device,
                 rows: int, params: dict):
    """``(frames, actions, old)`` of a planted batch, or None.

    ``"rollback"``: a stale behaviour policy that prefers one action a
    row (chosen uniformly) by ``STALE_LOGIT`` in its logits, and actions
    drawn from it; ``KL(old ‖ π)`` is about 0.9 nats, far over the
    rollback's limit whatever the step. ``"backtrack"``: None. A
    categorical log-density moves by at most the logits' change, about
    0.2 along a KL-sized step, and no batch tried made the search
    backtrack on this head."""
    if kind != "rollback":
        return None
    n = config["action"]["n"]
    frames = torch.randint(0, 256, (rows, *config["obs_shape"]),
                           generator=gen, device=device, dtype=torch.uint8)
    prefer = torch.randint(0, n, (rows,), generator=gen, device=device)
    logits = STALE_LOGIT * torch.nn.functional.one_hot(prefer, n).float()
    actions = _sample(torch.softmax(logits, dim=-1), gen, device)
    return frames, actions, {"logits": logits}


def program_policy(config):
    from trpo_torch.models.conv import ATARI_TORSO_SPEC
    from trpo_torch.models.policy import DiscreteSpec, make_policy

    if [list(s) for s in ATARI_TORSO_SPEC] != config["convs"]:
        raise ValueError(f"the program's torso is {ATARI_TORSO_SPEC}, the "
                         f"configuration states {config['convs']}")
    return make_policy(tuple(config["obs_shape"]),
                       DiscreteSpec(config["action"]["n"]),
                       hidden=tuple(config["hidden"]),
                       activation=config["activation"])


def prepare_program(config) -> None:
    """cuDNN as the agent sets it for a conv policy."""
    if config.get("cudnn") == "exact":
        from trpo_torch.models.conv import exact_convolutions

        exact_convolutions()


def to_program(named: dict):
    return tree.nest(named)


def from_program(params) -> dict:
    return tree.flatten(params)
