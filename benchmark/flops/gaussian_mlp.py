"""Operations and bytes of the diagonal-Gaussian MLP policy's update
work, from the configuration's shapes (``layerflops.py`` for the
counting rules)."""

from __future__ import annotations

import math

from benchmark import layerflops


def macs(config) -> list:
    d = [math.prod(config["obs_shape"]), *config["hidden"],
         config["action"]["dim"]]
    return [a * b for a, b in zip(d[:-1], d[1:])]


def n_params(config) -> int:
    d = [math.prod(config["obs_shape"]), *config["hidden"],
         config["action"]["dim"]]
    return sum(a * b + b for a, b in zip(d[:-1], d[1:])) + d[-1]


def forward(config, rows: int) -> int:
    return layerflops.forward(macs(config), rows)


def gradient(config, rows: int) -> int:
    return layerflops.gradient(macs(config), rows)


def fvp(config, rows: int) -> int:
    """One Fisher-vector product on ``rows`` rows: 35.44 GFLOP at 37,536
    rows of 376 → 256 → 256 → 17."""
    return layerflops.fvp(macs(config), rows)


def fvp_bytes(config, rows: int) -> int:
    """What one product must read and write, each byte once: the f32
    observations, one f32 weight a row, the parameters and ``v`` in, the
    product out."""
    return 4 * (rows * math.prod(config["obs_shape"]) + rows
                + 3 * n_params(config))


def operator_build(config, rows: int) -> int:
    """The forward whose activations a solve's products read."""
    return forward(config, rows)


def precond_refresh(config, rows: int) -> int:
    """The head-block preconditioner's refresh: the torso forward on the
    subsample and the ``(H+1)²`` Gram of the head's input."""
    h = config["hidden"][-1]
    return layerflops.forward(macs(config)[:-1], rows) + 2 * rows * (h + 1) ** 2
