"""Policy action distributions (counterpart: ``trpo_tpu/distributions.py``).

The diagonal Gaussian only; the categorical head waits for the cartpole
slice (ROADMAP.md Queue 1 item 2). Distribution parameters are plain dicts
of tensors, ``{"mean": (..., D), "log_std": (..., D)}``, and every op
returns per-sample values over the leading axes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["DiagGaussian"]

_LOG_2PI = math.log(2.0 * math.pi)


class DiagGaussian:
    """Diagonal Gaussian over continuous actions (mean + per-dim log std)."""

    name = "diag_gaussian"

    @staticmethod
    def logp(params, actions):
        mean, log_std = params["mean"], params["log_std"]
        z = (actions - mean) / torch.exp(log_std)
        return -0.5 * torch.sum(z * z + 2.0 * log_std + _LOG_2PI, dim=-1)

    @staticmethod
    def kl(params_old, params_new):
        mo, lso = params_old["mean"], params_old["log_std"]
        mn, lsn = params_new["mean"], params_new["log_std"]
        var_o, var_n = torch.exp(2.0 * lso), torch.exp(2.0 * lsn)
        return torch.sum(
            lsn - lso + (var_o + (mo - mn) ** 2) / (2.0 * var_n) - 0.5, dim=-1
        )

    @staticmethod
    def entropy(params):
        log_std = params["log_std"]
        return torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1)

    @staticmethod
    def sample(params, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """``mean + σ·ε``. ``noise`` passes pre-drawn standard normals (the
        tests hand both packages the same numbers); otherwise ε is drawn
        from ``generator``."""
        mean, log_std = params["mean"], params["log_std"]
        if noise is None:
            noise = torch.randn(
                mean.shape, generator=generator, device=mean.device,
                dtype=mean.dtype,
            )
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def fisher_weight(params0, tangent):
        """Dist-space Fisher action ``M·d`` at ``params0``: ``1/σ²`` on the
        mean block, ``2`` on the log-std block, no cross terms."""
        inv_var = torch.exp(-2.0 * params0["log_std"])
        return {
            "mean": tangent["mean"] * inv_var,
            "log_std": 2.0 * tangent["log_std"],
        }

    @staticmethod
    def mode(params):
        return params["mean"]

