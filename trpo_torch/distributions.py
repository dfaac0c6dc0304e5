"""Policy action distributions (counterpart: ``trpo_tpu/distributions.py``).

Distribution parameters are plain dicts of tensors — Categorical
``{"logits": (..., K)}``, DiagGaussian ``{"mean": (..., D), "log_std":
(..., D)}`` — and every op returns per-sample values over the leading axes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["Categorical", "DiagGaussian", "make_distribution"]

_LOG_2PI = math.log(2.0 * math.pi)


class Categorical:
    """Categorical distribution over ``K`` actions, parameterized by
    logits, in log space throughout."""

    name = "categorical"

    @staticmethod
    def logp(params, actions):
        """Log π(a|s) for integer ``actions`` of shape (...,)."""
        lp = torch.log_softmax(params["logits"], dim=-1)
        return torch.gather(lp, -1, actions.long()[..., None])[..., 0]

    @staticmethod
    def kl(params_old, params_new):
        lp_old = torch.log_softmax(params_old["logits"], dim=-1)
        lp_new = torch.log_softmax(params_new["logits"], dim=-1)
        return torch.sum(torch.exp(lp_old) * (lp_old - lp_new), dim=-1)

    @staticmethod
    def entropy(params):
        lp = torch.log_softmax(params["logits"], dim=-1)
        return -torch.sum(torch.exp(lp) * lp, dim=-1)

    @staticmethod
    def sample(params, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Gumbel-max sampling, ``argmax(logits + g)``. ``noise`` passes
        pre-drawn standard Gumbel draws shaped like the logits (the tests
        hand both packages the same numbers); otherwise they are drawn
        from ``generator``."""
        logits = params["logits"]
        if noise is None:
            noise = Categorical.draw_noise(logits.shape, generator,
                                           logits.device, logits.dtype)
        return torch.argmax(logits + noise, dim=-1)

    @staticmethod
    def draw_noise(shape, generator, device, dtype):
        """The standard Gumbel draws :meth:`sample` takes from
        ``generator`` for logits of ``shape``."""
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=dtype)
        u = torch.clamp(u, min=torch.finfo(dtype).tiny)
        return -torch.log(-torch.log(u))

    @staticmethod
    def mode(params):
        return torch.argmax(params["logits"], dim=-1)

    @staticmethod
    def fisher_weight(params0, tangent):
        """Dist-space Fisher action ``M·d`` at ``params0``: ``diag(p) −
        p pᵀ`` per sample, the Hessian of ``KL(π₀ ‖ π)`` in the logits."""
        p = torch.softmax(params0["logits"], dim=-1)
        d = tangent["logits"]
        return {"logits": p * d - p * torch.sum(p * d, dim=-1, keepdim=True)}


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
            noise = DiagGaussian.draw_noise(mean.shape, generator,
                                            mean.device, mean.dtype)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def draw_noise(shape, generator, device, dtype):
        """The standard normals :meth:`sample` takes from ``generator``
        for a mean of ``shape``."""
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)

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


_REGISTRY = {d.name: d for d in (Categorical, DiagGaussian)}


def make_distribution(name: str):
    """The distribution class named ``name`` (``"categorical"``,
    ``"diag_gaussian"``)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown distribution {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
