"""Operations and bytes of the Nature-DQN policy's update work, from the
configuration's shapes (``layerflops.py`` for the counting rules; a
convolution's multiply-adds a frame are ``out_h · out_w · out_c · kh ·
kw · in_c``). 18.69 MFLOP a frame forward at 84×84×4 → 3 actions."""

from __future__ import annotations

import math

from benchmark import layerflops


def macs(config) -> list:
    h, w, c = config["obs_shape"]
    out = []
    for kh, kw, co, stride in config["convs"]:
        h, w = (h - kh) // stride + 1, (w - kw) // stride + 1
        out.append(h * w * co * kh * kw * c)
        c = co
    d = [h * w * c, *config["hidden"], config["action"]["n"]]
    return out + [a * b for a, b in zip(d[:-1], d[1:])]


def n_params(config) -> int:
    h, w, c = config["obs_shape"]
    total = 0
    for kh, kw, co, stride in config["convs"]:
        h, w = (h - kh) // stride + 1, (w - kw) // stride + 1
        total += co * c * kh * kw + co
        c = co
    d = [h * w * c, *config["hidden"], config["action"]["n"]]
    return total + sum(a * b + b for a, b in zip(d[:-1], d[1:]))


def forward(config, rows: int) -> int:
    return layerflops.forward(macs(config), rows)


def gradient(config, rows: int) -> int:
    return layerflops.gradient(macs(config), rows)


def fvp(config, rows: int) -> int:
    return layerflops.fvp(macs(config), rows)


def fvp_bytes(config, rows: int) -> int:
    """The uint8 frames, one f32 weight a row, the f32 parameters and
    ``v`` in, the product out."""
    return rows * math.prod(config["obs_shape"]) + 4 * (rows + 3 * n_params(config))


def operator_build(config, rows: int) -> int:
    return forward(config, rows)


def precond_refresh(config, rows: int) -> int:
    return 0
