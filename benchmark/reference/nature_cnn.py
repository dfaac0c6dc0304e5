"""Plain PyTorch forward of the Nature-DQN torso with a categorical head,
in f32 (Mnih et al. 2015, Methods): frames ``(N, H, W, C)`` uint8 scaled
by 1/255, three VALID ReLU convolutions, the features flattened in
``(h, w, c)`` order, a dense layer with the configuration's activation,
then the logits. Parameters are named leaves (``torso.convs.<i>.w`` of
shape ``(out, in, kh, kw)``, ``head.layers.<i>.w`` of shape ``(in,
out)``). Imports nothing of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACT = {"tanh": torch.tanh, "relu": torch.relu}


def forward(config, p: dict, frames: torch.Tensor) -> dict:
    x = frames.float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    for i, (_kh, _kw, _c, stride) in enumerate(config["convs"]):
        x = F.relu(F.conv2d(x, p[f"torso.convs.{i}.w"],
                            p[f"torso.convs.{i}.b"], stride=stride))
    h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    n_dense = sum(1 for k in p if k.startswith("head.layers.")
                  and k.endswith(".w"))
    act = _ACT[config["activation"]]
    for i in range(n_dense):
        h = h @ p[f"head.layers.{i}.w"] + p[f"head.layers.{i}.b"]
        if i < n_dense - 1:
            h = act(h)
    return {"logits": h}


def logp(d: dict, actions: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(d["logits"], dim=-1)
    return lp.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def kl(old: dict, new: dict) -> torch.Tensor:
    """KL(old ‖ new) per row."""
    lo = torch.log_softmax(old["logits"], dim=-1)
    ln = torch.log_softmax(new["logits"], dim=-1)
    return (lo.exp() * (lo - ln)).sum(-1)
