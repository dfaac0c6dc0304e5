"""The plain-MLP diagonal-Gaussian policy (``trpo_torch.models.policy``
on 1-D observations): what the program is handed for a configuration of
this family. Weights and inputs are drawn on the device from the
benchmark's generator, in a few large calls, in f32; actions are drawn
from the drawn policy with the plain forward (``reference/``)."""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark import tree
from benchmark.spec import load_module

# The head's weights at unit gain, as a policy's are a few updates into
# training. At the program's own initial scale (0.01) the torso's
# gradient is all but nought and the preconditioned CG stops after one
# to three iterations, where a training run's updates take ten from
# about its sixth update on.
HEAD_GAIN = 1.0


def _policy_mean(config, params: dict, obs: torch.Tensor):
    """The drawn policy's mean and std on ``obs`` (the plain forward, f32
    with TF32 off)."""
    ref = load_module("reference", "gaussian_mlp")
    with torch.no_grad(), _no_tf32():
        d = ref.forward(config, params, obs)
    return d["mean"], torch.exp(d["log_std"])


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def dims(config) -> list:
    return [math.prod(config["obs_shape"]), *config["hidden"],
            config["action"]["dim"]]


def draw_params(config, gen: torch.Generator, device) -> dict:
    """Named leaves: ``N(0, 2/fan_in)`` hidden weights, ``HEAD_GAIN /
    sqrt(fan_in)`` head weights, zero biases, ``log_std`` at the
    configuration's value."""
    d = dims(config)
    sizes = [a * b for a, b in zip(d[:-1], d[1:])]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    named, off = {}, 0
    for i, (a, b) in enumerate(zip(d[:-1], d[1:])):
        scale = (HEAD_GAIN if i == len(d) - 2 else math.sqrt(2.0)) / math.sqrt(a)
        named[f"net.layers.{i}.w"] = (flat[off:off + a * b].view(a, b)
                                      * scale).contiguous()
        named[f"net.layers.{i}.b"] = torch.zeros(b, device=device)
        off += a * b
    named["log_std"] = torch.full((d[-1],), float(config["init_log_std"]),
                                  device=device)
    return named


def draw_batch(config, gen: torch.Generator, device, rows: int,
               params: dict):
    """``(obs, actions)``: N(0, 1) observations, as the port's observation
    normalizer emits, and actions drawn from the policy ``params``."""
    obs = torch.randn(rows, *config["obs_shape"], generator=gen,
                      device=device)
    noise = torch.randn(rows, config["action"]["dim"], generator=gen,
                        device=device)
    mean, std = _policy_mean(config, params, obs)
    return obs, mean + std * noise


# planted check batches (``mixes/update.py``'s ``check_stress``)
FAR_OUT = 30.0        # the backtrack batch's actions, in standard deviations
STALE_NARROWING = 0.5  # the rollback batch's behaviour policy's std, relative


def stress_batch(kind: str, config, gen: torch.Generator, device,
                 rows: int, params: dict):
    """``(obs, actions, old)`` of a planted batch, or None, around the
    policy ``params``.

    ``"backtrack"``: actions ``FAR_OUT`` standard deviations from the
    policy's mean, ``old`` None (the update's own distribution). Their log-densities move by hundreds of nats along the
    KL-sized step, so the full step's improvement falls short of its
    linear prediction and the search backtracks. ``"rollback"``: a stale
    behaviour policy, the drawn one with its standard deviation times
    ``STALE_NARROWING``, and actions drawn from it; ``KL(old ‖ π)`` is
    about 0.32 nats an action dimension, far over the rollback's limit
    whatever the step."""
    obs = torch.randn(rows, *config["obs_shape"], generator=gen,
                      device=device)
    noise = torch.randn(rows, config["action"]["dim"], generator=gen,
                        device=device)
    mean, std = _policy_mean(config, params, obs)
    if kind == "backtrack":
        return obs, mean + FAR_OUT * std * noise, None
    if kind == "rollback":
        std = STALE_NARROWING * std
        return obs, mean + std * noise, {"mean": mean,
                                         "log_std": torch.log(std)}
    return None


def program_policy(config):
    from trpo_torch.models.policy import BoxSpec, make_policy

    return make_policy(tuple(config["obs_shape"]),
                       BoxSpec(config["action"]["dim"]),
                       hidden=tuple(config["hidden"]),
                       activation=config["activation"],
                       init_log_std=float(config["init_log_std"]))


def prepare_program(config) -> None:
    """Nothing to set for this family."""


def to_program(named: dict):
    return tree.nest(named)


def from_program(params) -> dict:
    return tree.flatten(params)
