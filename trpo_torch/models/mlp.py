"""Functional MLPs (counterpart: ``trpo_tpu/models/mlp.py``).

Networks are dicts ``{"layers": [{"w": (in, out), "b": (out,)}, ...]}``
applied as ``x @ w + b`` — the reference's layout, no transposes — so
params flatten in ``ravel_pytree`` order (``ops/flat.py``) and cross
between the packages as they are.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["init_linear", "init_mlp", "apply_mlp", "ACTIVATIONS"]

ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
}


def _orthogonal(generator: torch.Generator, rows: int, cols: int,
                scale: float) -> torch.Tensor:
    """Orthogonal ``(rows, cols)`` matrix from a QR of a Gaussian draw,
    signs fixed by the diagonal of R (the standard construction)."""
    n, m = max(rows, cols), min(rows, cols)
    a = torch.randn(n, m, generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return scale * q.contiguous()


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                scale: Optional[float] = None):
    """Orthogonal weight init, zero bias (on the generator's device)."""
    if scale is None:
        scale = math.sqrt(2.0)
    w = _orthogonal(generator, in_dim, out_dim, scale)
    return {"w": w, "b": torch.zeros(out_dim, dtype=torch.float32)}


def init_mlp(generator: torch.Generator, in_dim: int,
             hidden: Sequence[int], out_dim: int, final_scale: float = 0.01):
    """Init ``in_dim -> hidden... -> out_dim``; the small ``final_scale``
    keeps the initial policy near zero-mean. Draws on the CPU generator
    given, so one seed gives the same weights on every device."""
    sizes = [in_dim, *hidden, out_dim]
    layers = []
    for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = final_scale if i == len(sizes) - 2 else None
        layers.append(init_linear(generator, d_in, d_out, scale))
    return {"layers": layers}


def apply_mlp(params, x, activation: str = "tanh",
              compute_dtype=torch.float32):
    """Forward pass; activation on all but the last layer. Returns f32."""
    act = ACTIVATIONS[activation]
    h = x.to(compute_dtype)
    layers = params["layers"]
    for i, layer in enumerate(layers):
        h = h @ layer["w"].to(compute_dtype) + layer["b"].to(compute_dtype)
        if i < len(layers) - 1:
            h = act(h)
    return h.float()
