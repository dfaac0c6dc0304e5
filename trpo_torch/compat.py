"""The reference ``utils.py`` helper surface, re-expressed over PyTorch
(counterpart: ``trpo_tpu/compat.py``).

The reference exposes its numeric/optimizer toolbox as a flat module
imported wholesale (``from utils import *``): ``discount``, ``rollout``,
``VF``, ``cat_sample``, ``var_shape``, ``numel``, ``flatgrad``,
``SetFromFlat``, ``GetFlat``, ``slice_2d``, ``linesearch``,
``conjugate_gradient``, ``explained_variance``, ``dict2``. This module
provides every one of those names with the same call shapes and
semantics as ``trpo_tpu.compat``:

* ``discount`` is the reverse affine scan of ``ops/returns.discount``:
  on a CUDA tensor it launches the hand-written scan kernel (K2), on a
  CPU tensor its plain version — no other path;
* ``flatgrad``/``GetFlat``/``SetFromFlat``/``slice_2d`` work on params
  trees in the port's flat order (``ops/flat.py``, equal to the
  reference's ``ravel_pytree`` order); ``flatgrad`` is one
  ``torch.autograd.grad`` over the flat vector, and ``SetFromFlat``
  RETURNS a new tree (views of the vector) instead of assigning into
  live variables;
* ``linesearch``/``conjugate_gradient`` keep the reference's exact
  host-driven loops, for arbitrary Python closures; the production
  path is the on-device solve of ``ops/cg.py`` over the fused FVP;
* ``VF`` is an ``nn.Module``: features ``[obs, action_dists, t/10]``,
  64-relu ×2 → 1, 50 full-batch Adam steps at ``optax.adam``'s defaults
  per fit, zeros before the first fit;
* ``cat_sample`` draws with ``torch.multinomial`` from an explicit
  ``torch.Generator`` (or the module's stream);
* ``rollout`` packs an episode cut at ``max_pathlength`` like any
  other.

Divergences kept from the reference: no import-time seeding (call
:func:`seed_everything`, which returns a ``torch.Generator``), and
building ``VF`` touches no other state (no global re-initialization,
and no draw from torch's global generator).

Helpers that place data take ``device`` and default to the card
(``cuda``); a numpy input goes there, a tensor input stays where it is.
Their numpy results have the reference's types (``discount`` float32,
``cat_sample`` int32, ``GetFlat`` float32, CG and line search float64,
``explained_variance`` a float).
"""

from __future__ import annotations

import random as _random
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from trpo_torch.models.mlp import init_mlp
from trpo_torch.ops.flat import flatten_params as _flatten_params
from trpo_torch.ops.flat import tree_leaves as _tree_leaves
from trpo_torch.ops.returns import discount as _discount
from trpo_torch.utils.metrics import explained_variance as _explained_variance

__all__ = [
    "seed_everything",
    "discount",
    "rollout",
    "VF",
    "cat_sample",
    "var_shape",
    "numel",
    "flatgrad",
    "SetFromFlat",
    "GetFlat",
    "slice_2d",
    "linesearch",
    "conjugate_gradient",
    "explained_variance",
    "dict2",
]


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _tensor(x, device=None) -> torch.Tensor:
    """A tensor input stays on its device unless ``device`` is given;
    anything else goes to ``device`` (the card by default). Floating
    point becomes float32, as under the reference's default precision."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.float()
    if device is not None or not isinstance(x, torch.Tensor):
        t = t.to(_device(device))
    return t


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Seeding (an import side effect in the reference; explicit here)
# ---------------------------------------------------------------------------

_stream: Optional[torch.Generator] = None


def seed_everything(seed: int = 1, device=None) -> torch.Generator:
    """Seed ``random``, NumPy, torch and the module's sampling stream on
    ``device``; return a fresh ``torch.Generator`` there, seeded alike.

    The reference seeds ``random``/``numpy``/``tf`` as a side effect of
    ``import utils``; call this once at program start instead."""
    global _stream
    _random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    _stream = torch.Generator(_device(device)).manual_seed(seed)
    return torch.Generator(_device(device)).manual_seed(seed)


def _module_stream(device=None) -> torch.Generator:
    """The stateful stream of the generator-less call shapes, seeded
    with the reference's default seed on first use."""
    if _stream is None:
        seed_everything(1, device)
    if device is not None and _stream.device != _device(device):
        raise ValueError(
            f"the module's sampling stream lives on {_stream.device}; "
            f"call seed_everything(seed, device={str(device)!r}) or pass a "
            "generator")
    return _stream


# ---------------------------------------------------------------------------
# discount
# ---------------------------------------------------------------------------


def discount(x, gamma: float, device=None) -> np.ndarray:
    """Discounted cumulative return ``y_t = Σ_k γ^k x_{t+k}`` along axis
    0: the reference's ``lfilter([1], [1, -gamma], x[::-1])[::-1]``, as
    the reverse affine scan of ``ops/returns.discount`` — K2 on the card.
    Returns NumPy for host-side callers, as the reference does."""
    return _numpy(_discount(_tensor(x, device), gamma))


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------


def _reset_env(env):
    out = env.reset()
    if isinstance(out, tuple) and len(out) == 2:  # gymnasium: (obs, info)
        return np.asarray(out[0])
    return np.asarray(out)


def _step_env(env, action):
    out = env.step(action)
    if len(out) == 5:  # gymnasium: obs, reward, terminated, truncated, info
        ob, rew, terminated, truncated, _ = out
        return np.asarray(ob), float(rew), bool(terminated or truncated)
    ob, rew, done, _ = out  # classic gym: obs, reward, done, info
    return np.asarray(ob), float(rew), bool(done)


def rollout(env, agent, max_pathlength: int, n_timesteps: int,
            generator: Optional[torch.Generator] = None) -> List[dict]:
    """Serial episode collector with the reference's batch contract.

    Loops episodes until at least ``n_timesteps`` total steps are
    collected; each path is ``{"obs", "action_dists", "rewards",
    "actions"}``. ``agent`` is an object exposing ``act(ob) -> (action,
    action_dist, ...)`` or a callable ``act(ob, generator) -> (action,
    action_dist)``, which gets ``generator`` (default: the module's
    stream). ``env`` may speak classic gym (4-tuple step) or gymnasium
    (5-tuple step). An episode cut at ``max_pathlength`` is packed like
    any other (the reference's ``utils.py`` re-appends the previous
    episode there)."""
    act = agent.act if hasattr(agent, "act") else agent
    takes_generator = not hasattr(agent, "act")
    if takes_generator and generator is None:
        generator = _module_stream()
    paths: List[dict] = []
    timesteps_sofar = 0
    while timesteps_sofar < n_timesteps:
        obs, action_dists, rewards, actions = [], [], [], []
        ob = _reset_env(env)
        for _ in range(max_pathlength):
            obs.append(ob)
            if takes_generator:
                action, action_dist = act(ob, generator)
            else:
                action, action_dist = act(ob)[:2]
            action = _numpy(action)
            action_dists.append(_numpy(action_dist))
            actions.append(action)
            ob, rew, done = _step_env(env, action)
            rewards.append(rew)
            if done:
                break
        path = {
            "obs": np.stack(obs),
            "action_dists": np.stack(action_dists),
            "rewards": np.asarray(rewards, np.float32),
            "actions": np.stack(actions),
        }
        paths.append(path)
        timesteps_sofar += len(path["rewards"])
    return paths


# ---------------------------------------------------------------------------
# VF — value-function baseline
# ---------------------------------------------------------------------------


class VF(nn.Module):
    """The reference's critic, reference-shaped: built on the first
    ``fit``, features ``[obs, action_dists, t/10]``, 64-relu ×2 → 1, 50
    full-batch Adam steps per fit on the summed squared error, zero
    predictions before the first fit.

    The layers are ``nn.Linear`` (weights ``(out, in)``), initialized
    orthogonally from a ``torch.Generator`` of ``seed`` as the port's
    ``models/mlp.init_mlp`` draws them; Adam is ``torch.optim.Adam`` at
    ``optax.adam``'s defaults (β 0.9/0.999, ε 1e-8 outside the square
    root). Building the net draws nothing from torch's global generator.
    The production critic (``trpo_torch.vf``) is observation-only; this
    class keeps the reference's features."""

    def __init__(
        self,
        hidden: Sequence[int] = (64, 64),
        train_steps: int = 50,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        self.hidden = tuple(hidden)
        self.train_steps = train_steps
        self.learning_rate = learning_rate
        self.device = _device(device)
        self.net: Optional[nn.Sequential] = None  # built on the first fit
        self.opt: Optional[torch.optim.Adam] = None
        self._generator = torch.Generator().manual_seed(seed)

    def _features(self, path) -> np.ndarray:
        o = np.asarray(path["obs"], np.float32)
        o = o.reshape(o.shape[0], -1)
        ad = np.asarray(path["action_dists"], np.float32)
        ad = ad.reshape(ad.shape[0], -1)
        t = np.arange(len(path["rewards"]), dtype=np.float32).reshape(-1, 1)
        return np.concatenate([o, ad, t / 10.0], axis=1)

    def _create_net(self, feat_dim: int) -> None:
        params = init_mlp(self._generator, feat_dim, self.hidden, 1,
                          final_scale=1.0)
        layers: List[nn.Module] = []
        for i, layer in enumerate(params["layers"]):
            d_in, d_out = layer["w"].shape
            lin = nn.utils.skip_init(nn.Linear, d_in, d_out,
                                     device=self.device)
            with torch.no_grad():
                lin.weight.copy_(layer["w"].T)
                lin.bias.copy_(layer["b"])
            layers.append(lin)
            if i < len(params["layers"]) - 1:
                layers.append(nn.ReLU())
        self.net = nn.Sequential(*layers)
        self.opt = torch.optim.Adam(
            self.net.parameters(), lr=self.learning_rate,
            betas=(0.9, 0.999), eps=1e-8)

    def forward(self, featmat: torch.Tensor) -> torch.Tensor:
        return self.net(featmat)[:, 0]

    def fit(self, paths: Sequence[dict]) -> None:
        """``train_steps`` full-batch Adam steps on the squared error
        against ``path["returns"]``."""
        featmat = np.concatenate([self._features(p) for p in paths])
        returns = np.concatenate(
            [np.asarray(p["returns"], np.float32) for p in paths]
        )
        if self.net is None:
            self._create_net(featmat.shape[1])
        featmat = torch.as_tensor(featmat, device=self.device)
        returns = torch.as_tensor(returns, device=self.device)
        with torch.enable_grad():
            for _ in range(self.train_steps):
                self.opt.zero_grad(set_to_none=True)
                loss = torch.sum((self(featmat) - returns) ** 2)
                loss.backward()
                self.opt.step()

    def predict(self, path) -> np.ndarray:
        """Per-step value estimates; zeros before the first ``fit`` — so
        iteration-0 advantages are raw returns, as in the reference."""
        if self.net is None:
            return np.zeros(len(path["rewards"]), np.float32)
        feats = torch.as_tensor(self._features(path), device=self.device)
        with torch.no_grad():
            return _numpy(self(feats))


# ---------------------------------------------------------------------------
# cat_sample
# ---------------------------------------------------------------------------


def cat_sample(prob_nk, generator: Optional[torch.Generator] = None,
               device=None) -> np.ndarray:
    """One categorical draw per row of an ``(N, K)`` probability matrix,
    by ``torch.multinomial`` on ``generator``'s device (default: the
    module's stream, seeded by :func:`seed_everything`). Returns int32
    NumPy, as the reference does."""
    if generator is None:
        generator = _module_stream(device)
    prob = _tensor(prob_nk, generator.device)
    out = torch.multinomial(prob, 1, generator=generator)[:, 0]
    return _numpy(out).astype(np.int32)


# ---------------------------------------------------------------------------
# var_shape / numel / flatgrad
# ---------------------------------------------------------------------------


def var_shape(x) -> List[int]:
    """Shape as a list of ints (always fully known here)."""
    return [int(d) for d in (x.shape if hasattr(x, "shape")
                             else np.shape(x))]


def numel(x) -> int:
    """Element count of an array, a tensor or a whole params tree."""
    return sum(
        int(leaf.numel()) if isinstance(leaf, torch.Tensor)
        else int(np.size(leaf))
        for leaf in _tree_leaves(x)
    )


def flatgrad(fn: Callable, params) -> torch.Tensor:
    """Flat gradient of scalar ``fn`` at ``params`` in the flat order:
    one ``torch.autograd.grad`` with respect to the flat vector, which
    ``fn`` sees as a tree of its views."""
    flat, unravel = _flatten_params(params)
    x = flat.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(fn(unravel(x)), x, allow_unused=True)
    return torch.zeros_like(x) if g is None else g


# ---------------------------------------------------------------------------
# GetFlat / SetFromFlat
# ---------------------------------------------------------------------------


class GetFlat:
    """The params tree as one flat float32 NumPy vector: construct with a
    template, call with current params, or with nothing to flatten the
    template."""

    def __init__(self, params):
        self._params = params

    def __call__(self, params=None) -> np.ndarray:
        target = self._params if params is None else params
        return _numpy(_flatten_params(target)[0]).astype(np.float32)


class SetFromFlat:
    """A params tree rebuilt from a flat vector. The reference assigns
    into live graph variables; this RETURNS the tree (views of the vector
    on the template's device, so autograd sees through it) and leaves
    the template untouched."""

    def __init__(self, template):
        self._unravel = _flatten_params(template)[1]
        self.total_size = numel(template)
        self._device = _tree_leaves(template)[0].device

    def __call__(self, theta):
        if isinstance(theta, torch.Tensor):
            theta = theta.to(self._device, torch.float32)
        else:
            theta = torch.tensor(np.asarray(theta), dtype=torch.float32,
                                 device=self._device)
        if tuple(theta.shape) != (self.total_size,):
            raise ValueError(
                f"expected flat vector of size {self.total_size}, "
                f"got shape {tuple(theta.shape)}"
            )
        return self._unravel(theta)


# ---------------------------------------------------------------------------
# slice_2d
# ---------------------------------------------------------------------------


def slice_2d(x, inds0, inds1, device=None) -> torch.Tensor:
    """Gather ``x[i, j]`` pairs (the reference flattens and gathers
    ``i·ncols + j``; here it is advanced indexing)."""
    x = _tensor(x, device)
    i0, i1 = (torch.as_tensor(i, dtype=torch.long, device=x.device)
              if isinstance(i, torch.Tensor) else
              torch.as_tensor(np.asarray(i), dtype=torch.long,
                              device=x.device)
              for i in (inds0, inds1))
    return x[i0, i1]


# ---------------------------------------------------------------------------
# linesearch — the reference's host loop
# ---------------------------------------------------------------------------


def linesearch(
    f: Callable[[Any], float],
    x,
    fullstep,
    expected_improve_rate,
    max_backtracks: int = 10,
    accept_ratio: float = 0.1,
):
    """Backtracking line search, the reference's host loop: step
    fractions ``0.5^k`` for k = 0..9, accept the first step with positive
    actual improvement and improvement ratio > ``accept_ratio``; return
    the original ``x`` if none is accepted. The production path is
    ``ops/linesearch.py``, inside the update."""
    x = _numpy(x)
    fullstep = _numpy(fullstep)
    fval = np.float64(float(f(x)))
    for k in range(max_backtracks):
        stepfrac = 0.5**k
        xnew = x + stepfrac * fullstep
        newfval = np.float64(float(f(xnew)))
        actual_improve = fval - newfval
        expected_improve = np.float64(float(expected_improve_rate)) * stepfrac
        # NumPy float division, as in the reference: expected_improve == 0
        # yields ±inf/nan rather than raising, and the acceptance test
        # resolves it (inf ratio with positive actual improvement accepts)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = actual_improve / expected_improve
        if ratio > accept_ratio and actual_improve > 0:
            return xnew
    return x


# ---------------------------------------------------------------------------
# conjugate_gradient — the reference's host loop
# ---------------------------------------------------------------------------


def conjugate_gradient(
    f_Ax: Callable,
    b,
    cg_iters: int = 10,
    residual_tol: float = 1e-10,
) -> np.ndarray:
    """Textbook CG solving ``A x = b`` with a host NumPy loop, the
    reference's algorithm and defaults, for any Python ``f_Ax`` closure
    (its result may be a tensor on any device). The production solve is
    ``ops/cg.py`` on the device, over the fused FVP."""
    b = _numpy(b).astype(np.float64)
    p = b.copy()
    r = b.copy()
    x = np.zeros_like(b)
    rdotr = r.dot(r)
    for _ in range(cg_iters):
        z = _numpy(f_Ax(p)).astype(np.float64)
        v = rdotr / p.dot(z)
        x += v * p
        r -= v * z
        newrdotr = r.dot(r)
        mu = newrdotr / rdotr
        p = r + mu * p
        rdotr = newrdotr
        if rdotr < residual_tol:
            break
    return x


# ---------------------------------------------------------------------------
# explained_variance
# ---------------------------------------------------------------------------


def explained_variance(ypred, y, device=None) -> float:
    """``1 − Var(y − ŷ)/Var(y)``; NaN when ``Var(y) = 0``."""
    return float(_explained_variance(_tensor(ypred, device),
                                     _tensor(y, device)))


# ---------------------------------------------------------------------------
# dict2
# ---------------------------------------------------------------------------


class dict2(dict):
    """Attribute-access dict (dead code in the reference; here so the
    helper surface is complete)."""

    def __init__(self, **kwargs):
        dict.__init__(self, kwargs)
        self.__dict__ = self
