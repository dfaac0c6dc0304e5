"""Recurrent (GRU / LSTM) policies for partially observable tasks
(counterpart: ``trpo_tpu/models/recurrent.py``).

MLP torso → recurrent cell → linear head. Both cells are plain functions
that mirror the reference's, not ``torch.nn.GRU``/``LSTM``: the GRU has an
input-side bias only, gate order ``r, z, n`` inside one ``(·, 3H)``
projection, and ``n = tanh(xn + r·hn)`` with no hidden bias; the LSTM has
gate order ``i, f, g, o`` in one ``(·, 4H)`` projection, its forget bias
starts at 1, and it packs ``[h | c]`` into one ``(N, 2H)`` state. So
every consumer of the state (the rollout carry, the episode-boundary
zeroing, the trajectory's ``policy_h`` tensors, the critic's ``[obs,
state]`` features, checkpoints) is the same for both cells.

``apply`` replays a window (:class:`SeqObs`): the torso and the gates'
input projection run once over all ``T·N`` rows, then a loop over time
runs the ``(N, H)·(H, gates·H)`` recurrence. ``reset[t]`` zeroes the state
before step ``t`` consumes ``obs[t]``, so one ``(T, N)`` window holds many
episodes. ``h0`` is detached: truncated backpropagation at the window.

With a ``tp`` (``parallel.tp.ModelAxis``) the torso runs sharded
(``models/mlp.py``) and both gate projections are row-parallel on their
input dimension: the partial sums of ``xw`` (once per window) and of
``hw`` (every step) are all-reduced, and the state stays replicated.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from trpo_torch.distributions import Categorical, DiagGaussian
from trpo_torch.models.mlp import (
    ACTIVATIONS,
    _orthogonal,
    apply_mlp,
    init_linear,
    init_mlp,
    mlp_forward_tp,
)
from trpo_torch.models.policy import BoxSpec, DiscreteSpec

__all__ = [
    "RecurrentPolicy",
    "SeqObs",
    "gru_step",
    "init_gru",
    "init_lstm",
    "lstm_step",
    "make_recurrent_policy",
]


class SeqObs(NamedTuple):
    """What a recurrent policy's ``apply`` consumes: a time-major window
    and the state context needed to replay it."""
    obs: torch.Tensor    # (T, N, *obs_shape)
    reset: torch.Tensor  # (T, N) bool — the state is zeroed BEFORE step t
    h0: torch.Tensor     # (N, S) state entering the window


class RecurrentPolicy(NamedTuple):
    """``Policy`` plus the recurrent surface: ``apply`` takes a
    :class:`SeqObs` and returns dist params with leading ``(T, N)``;
    ``step``/``initial_state`` are the single-step interface the rollout
    threads through time."""
    init: Callable[[torch.Generator], Any]
    apply: Callable[[Any, SeqObs], Any]
    dist: Any
    action_spec: Any
    initial_state: Callable[..., torch.Tensor]  # (n_envs, device) -> zeros
    step: Callable[[Any, torch.Tensor, torch.Tensor], Tuple[Any, Any]]
    state_size: int      # carried width: H (GRU) or 2H (LSTM [h|c])
    mlp_spec: Any = None     # no fused FVP kernel for this family
    apply_cast: Any = None   # no bf16 rung for this family
    # (params, state (..., S)) -> dist params: the state→dist head alone,
    # which the session engine recomputes per row (serve/session.py)
    head: Any = None
    tp: Any = None           # parallel.tp.ModelAxis of a sharded forward


def _fused_gates(generator: torch.Generator, rows: int, hidden: int,
                 gates: int) -> torch.Tensor:
    """``gates`` orthogonal ``(rows, hidden)`` blocks side by side."""
    return torch.cat([_orthogonal(generator, rows, hidden, 1.0)
                      for _ in range(gates)], dim=1)


def init_gru(generator: torch.Generator, in_dim: int, hidden: int):
    """GRU parameters with fused gate weights: ``wx (in, 3H)``, ``wh (H,
    3H)``, gate order ``[reset, update, candidate]``, ``b (3H,)``."""
    wx = _fused_gates(generator, in_dim, hidden, 3)
    wh = _fused_gates(generator, hidden, hidden, 3)
    return {"wx": wx, "wh": wh, "b": torch.zeros(3 * hidden)}


def init_lstm(generator: torch.Generator, in_dim: int, hidden: int):
    """LSTM parameters with fused gate weights: ``wx (in, 4H)``, ``wh (H,
    4H)``, gate order ``[input, forget, cell, output]``; the forget-gate
    bias starts at 1."""
    wx = _fused_gates(generator, in_dim, hidden, 4)
    wh = _fused_gates(generator, hidden, hidden, 4)
    b = torch.zeros(4 * hidden)
    b[hidden:2 * hidden] = 1.0
    return {"wx": wx, "wh": wh, "b": b}


def _input_proj(params, x, cd=torch.float32, tp=None, split=False):
    """``x @ wx + b``: the gates' input half, over any leading axes.
    ``tp``: ``wx`` may be this rank's row block; ``x`` is whole, or with
    ``split`` already the matching block of the features (a torso ending
    column-parallel on the same width)."""
    if tp is None or tp.specs["wx"] is None:
        return x.to(cd) @ params["wx"].to(cd) + params["b"].to(cd)
    from trpo_torch.parallel.tp import reduce_from_model, scatter_to_model

    if not split:
        x = scatter_to_model(x, tp)
    return (reduce_from_model(x.to(cd) @ params["wx"].to(cd), tp)
            + params["b"].to(cd))


def _hidden_proj(params, h, cd, tp):
    """``h @ wh``; with ``tp`` and a row-split ``wh``, this rank's block
    of ``h`` against it, summed over the axis."""
    if tp is None or tp.specs["wh"] is None:
        return h.to(cd) @ params["wh"].to(cd)
    from trpo_torch.parallel.tp import reduce_from_model, scatter_to_model

    return reduce_from_model(
        scatter_to_model(h.to(cd), tp) @ params["wh"].to(cd), tp)


def _gru_from_xw(params, h, xw, cd=torch.float32, tp=None):
    """The GRU update given the input projection ``xw``."""
    H = params["wh"].shape[1] // 3
    hw = _hidden_proj(params, h, cd, tp)
    r = torch.sigmoid(xw[..., :H] + hw[..., :H])
    z = torch.sigmoid(xw[..., H:2 * H] + hw[..., H:2 * H])
    n = torch.tanh(xw[..., 2 * H:] + r * hw[..., 2 * H:])
    return ((1.0 - z) * n + z * h.to(cd)).float()


def _lstm_from_xw(params, state, xw, cd=torch.float32, tp=None):
    """The LSTM update given the input projection, on the packed ``[h |
    c]`` state."""
    H = params["wh"].shape[1] // 4
    h, c = state[..., :H], state[..., H:]
    hw = _hidden_proj(params, h, cd, tp)
    i = torch.sigmoid(xw[..., :H] + hw[..., :H])
    f = torch.sigmoid(xw[..., H:2 * H] + hw[..., H:2 * H])
    g = torch.tanh(xw[..., 2 * H:3 * H] + hw[..., 2 * H:3 * H])
    o = torch.sigmoid(xw[..., 3 * H:] + hw[..., 3 * H:])
    c_new = f * c.to(cd) + i * g
    h_new = o * torch.tanh(c_new)
    return torch.cat([h_new, c_new], dim=-1).float()


def gru_step(params, h, x, compute_dtype=torch.float32):
    """One GRU step over leading axes; returns f32."""
    return _gru_from_xw(params, h, _input_proj(params, x, compute_dtype),
                        compute_dtype)


def lstm_step(params, state, x, compute_dtype=torch.float32):
    """One LSTM step over the packed ``[h | c]`` state; returns f32."""
    return _lstm_from_xw(params, state,
                         _input_proj(params, x, compute_dtype),
                         compute_dtype)


# cell name -> (init, update from xw, state multiple)
_CELLS = {
    "gru": (init_gru, _gru_from_xw, 1),
    "lstm": (init_lstm, _lstm_from_xw, 2),
}


def make_recurrent_policy(
    obs_shape: Tuple[int, ...],
    action_spec,
    hidden: Tuple[int, ...] = (64,),
    gru_size: int = 64,
    activation: str = "tanh",
    init_log_std: float = 0.0,
    compute_dtype=torch.float32,
    cell: str = "gru",
    tp=None,
) -> RecurrentPolicy:
    """MLP torso (activation after every layer, the last included) →
    ``cell`` (``"gru"`` or ``"lstm"``) of ``gru_size`` → linear head. 1-D
    observations only. ``tp`` (a ``parallel.tp.ModelAxis``): the forward
    over this rank's blocks of the params; the head stays replicated."""
    if activation not in ACTIVATIONS:
        raise KeyError(
            f"unknown activation {activation!r}; have {sorted(ACTIVATIONS)}"
        )
    if cell not in _CELLS:
        raise KeyError(f"unknown cell {cell!r}; have {sorted(_CELLS)}")
    cell_init, cell_from_xw, state_mult = _CELLS[cell]
    if isinstance(action_spec, DiscreteSpec):
        out_dim, dist = action_spec.n, Categorical
    elif isinstance(action_spec, BoxSpec):
        out_dim, dist = action_spec.dim, DiagGaussian
    else:
        raise TypeError(f"unsupported action spec: {action_spec!r}")
    obs_dim = math.prod(obs_shape)
    feat_dim = hidden[-1] if hidden else obs_dim
    act = ACTIVATIONS[activation]
    cd = compute_dtype

    def init(generator: torch.Generator):
        params = {}
        if hidden:
            params["torso"] = init_mlp(generator, obs_dim, hidden[:-1],
                                       hidden[-1], final_scale=None)
        params[cell] = cell_init(generator, feat_dim, gru_size)
        # small final scale: a near-uniform initial policy
        params["head"] = init_linear(generator, gru_size, out_dim,
                                     scale=0.01)
        if dist is DiagGaussian:
            params["log_std"] = torch.full((out_dim,), float(init_log_std))
        return params

    ttp = None if tp is None or not hidden else tp.sub("torso")
    ctp = None if tp is None else tp.sub(cell)

    def _features(params, obs):
        """``(features, split)``: ``split`` when they are this rank's
        block (a sharded torso that ends column-parallel)."""
        x = obs.reshape(obs.shape[:obs.ndim - len(obs_shape)] + (obs_dim,))
        if ttp is not None:
            h, split = mlp_forward_tp(params["torso"], x, act, cd, ttp)
            return act(h.float()), split
        if hidden:
            x = act(apply_mlp(params["torso"], x, activation, cd))
        return x, False

    def _xw(params, obs):
        x, split = _features(params, obs)
        return _input_proj(params[cell], x, cd, ctp, split)

    def _head(params, state):
        # the LSTM's head reads the h half of [h | c]
        h = state[..., :gru_size]
        raw = (h.to(cd) @ params["head"]["w"].to(cd)
               + params["head"]["b"].to(cd)).float()
        if dist is Categorical:
            return {"logits": raw}
        return {"mean": raw,
                "log_std": params["log_std"].expand_as(raw)}

    def initial_state(n_envs: int, device=None):
        return torch.zeros(n_envs, gru_size * state_mult, device=device)

    def step(params, h, obs):
        """``(params, state (N, S), obs (N, *o)) -> (state', dist)``."""
        h_new = cell_from_xw(params[cell], h, _xw(params, obs), cd, ctp)
        return h_new, _head(params, h_new)

    def apply(params, seq: SeqObs):
        """Replay a window: dist params with leading ``(T, N)``."""
        h = seq.h0.detach()
        xw = _xw(params, seq.obs)
        hs = []
        for t in range(xw.shape[0]):
            h = torch.where(seq.reset[t][:, None], torch.zeros_like(h), h)
            h = cell_from_xw(params[cell], h, xw[t], cd, ctp)
            hs.append(h)
        return _head(params, torch.stack(hs))

    return RecurrentPolicy(
        init=init,
        apply=apply,
        dist=dist,
        action_spec=action_spec,
        initial_state=initial_state,
        step=step,
        state_size=gru_size * state_mult,
        head=_head,
        tp=tp,
    )
