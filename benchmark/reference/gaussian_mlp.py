"""Plain PyTorch forward of the diagonal-Gaussian MLP policy, in f32:
``mean = MLP(obs)`` with the configuration's activation on every hidden
layer, and a state-independent ``log_std``. Parameters are named leaves
(``net.layers.<i>.w`` of shape ``(in, out)``, ``net.layers.<i>.b``,
``log_std``). Imports nothing of the program."""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)
_ACT = {"tanh": torch.tanh, "relu": torch.relu}


def n_layers(p: dict) -> int:
    return sum(1 for k in p if k.startswith("net.layers.") and k.endswith(".w"))


def features(config, p: dict, obs: torch.Tensor) -> torch.Tensor:
    """The last hidden layer's output, which the head reads."""
    act = _ACT[config["activation"]]
    h = obs.reshape(obs.shape[0], -1).float()
    for i in range(n_layers(p) - 1):
        h = act(h @ p[f"net.layers.{i}.w"] + p[f"net.layers.{i}.b"])
    return h


def head_names(p: dict) -> tuple:
    last = n_layers(p) - 1
    return f"net.layers.{last}.w", f"net.layers.{last}.b"


def forward(config, p: dict, obs: torch.Tensor) -> dict:
    w, b = head_names(p)
    mean = features(config, p, obs) @ p[w] + p[b]
    return {"mean": mean, "log_std": p["log_std"].expand_as(mean)}


def logp(d: dict, actions: torch.Tensor) -> torch.Tensor:
    z = (actions - d["mean"]) * torch.exp(-d["log_std"])
    return -0.5 * (z * z).sum(-1) - d["log_std"].sum(-1) - 0.5 * _LOG_2PI * z.shape[-1]


def kl(old: dict, new: dict) -> torch.Tensor:
    """KL(old ‖ new) per row."""
    var_ratio = torch.exp(2.0 * (old["log_std"] - new["log_std"]))
    dm = (old["mean"] - new["mean"]) * torch.exp(-new["log_std"])
    return (new["log_std"] - old["log_std"]
            + 0.5 * (var_ratio + dm * dm) - 0.5).sum(-1)
