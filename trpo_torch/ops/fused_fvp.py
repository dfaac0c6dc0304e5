"""Fused Gauss-Newton Fisher-vector product for plain-MLP diagonal-Gaussian
policies (counterpart: ``trpo_tpu/ops/fused_fvp.py``).

Math (the same as ``ops/fvp.make_ggn_fvp``)::

    F·v = Jᵀ M J v + λv,   J = ∂(dist params)/∂θ at θ₀,
    M   = diag(wᵢ/Σw) ⊗ [e^{-2σ} on the mean block, 2·I on log σ]

Per row the operator runs a tangent forward sweep through the torso, the
Fisher weighting ``c = d_mean·(wₙ/Σw)·e^{-2 log σ}``, and a backward sweep
that accumulates every layer's weight and bias cotangents. The ``log_std``
block is the closed form ``(2Σwₙ + λ)v_σ``, outside the kernel.
Zero-weight rows contribute exactly nothing.

Kernel: ``trpo_torch/csrc/fused_fvp.cu`` replaces
``make_fused_gaussian_mlp_fvp`` (``trpo_tpu/ops/fused_fvp.py:298``). It is
bound by f32 operations (472,064 multiply-adds per row against ~3.6 KB of
compulsory reads per row — obs and the two stored activations — at the
training shape). Its design — row-parallel sweeps writing the per-row
cotangents to scratch, then parameter-parallel split-K weight gradients
reduced in a fixed order — is in the source's header. :func:`fused_fvp_net` launches it for CUDA tensors and runs the
plain version, :func:`fused_fvp_net_plain` (the same three sweeps as eager
tensor ops), for CPU tensors. There is no other path: a CUDA tensor
launches the kernel or raises. The activations ``h_k`` come from one
``torch.matmul`` forward per operator build, outside the kernel, as the
reference leaves that forward to XLA.

Flat layout: ``v`` and the result are the policy's flat vector in
``ravel_pytree`` order (``ops/flat.py``): ``log_std``, then per layer
``b`` then ``w`` (row-major ``(in, out)``). The kernel reads the tangents
straight out of that vector and writes the cotangents in the same
layout.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params

__all__ = [
    "FusedGaussianMLPFVP",
    "fused_fvp_net",
    "fused_fvp_net_plain",
    "fused_fvp_supported",
    "make_fused_gaussian_mlp_fvp",
]

# Activation derivatives from the activation OUTPUT h (what is stored).
_ACT_DERIV: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": lambda h: 1.0 - h * h,
    "relu": lambda h: (h > 0.0).float(),
    "elu": lambda h: torch.where(h > 0.0, torch.ones_like(h), h + 1.0),
}
_ACT_CODE = {"tanh": 0, "relu": 1, "elu": 2}
_ACT_FN = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "elu": torch.nn.functional.elu,
}
_EPI_DERIV, _EPI_FISHER = 0, 1
# rows summed by one block of the weight-gradient phase (split-K)
_ROWS_PER_SPLIT = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SWEEP_ARGTYPES = (
    [_I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I,
     _P, _P, _P, _I, _P]
)
_WGRAD_ARGTYPES = [_I, _I, _I, _I, _I, _P, _I, _P, _I, _P, ctypes.c_longlong,
                   _P]
_REDUCE_ARGTYPES = [_I, _I, _P, _P, ctypes.c_float, _P, _P]


def fused_fvp_supported(activation: str, net_params: Any) -> bool:
    """Whether the fused operator covers this (activation, torso) pair:
    tanh/relu/elu, at least one hidden layer, 2-D weights. Any widths: the
    kernel masks its own edges."""
    if activation not in _ACT_DERIV:
        return False
    try:
        layers = net_params["layers"]
    except (TypeError, KeyError):
        return False
    if not isinstance(layers, (list, tuple)) or len(layers) < 2:
        return False
    for layer in layers:
        try:
            w, _ = layer["w"], layer["b"]
        except (TypeError, KeyError):
            return False
        if getattr(w, "ndim", None) != 2:
            return False
    return True


def _layout(dims: Sequence[int]) -> Tuple[List[Tuple[int, int]], int]:
    """Per-layer ``(b_offset, w_offset)`` in the full flat vector (after the
    ``log_std`` block of ``dims[-1]`` floats), and the total length."""
    cur = dims[-1]
    offs = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        offs.append((cur, cur + d_out))
        cur += d_out + d_in * d_out
    return offs, cur


def fused_fvp_net_plain(obs, hs, ws, v, wn, m, damping: float,
                        activation: str) -> torch.Tensor:
    """The plain version: the three sweeps as eager tensor ops. Returns the
    net part of ``(F + λI)v`` (everything after the ``log_std`` block)."""
    _build.LAUNCHES["fused_fvp_plain"] += 1
    L = len(hs)
    dims = [obs.shape[1]] + [w.shape[1] for w in ws]
    offs, _ = _layout(dims)
    deriv = _ACT_DERIV[activation]
    ds = [deriv(h) for h in hs]

    def tangent(k):
        b_off, w_off = offs[k]
        d_in, d_out = dims[k], dims[k + 1]
        return (v[w_off:w_off + d_in * d_out].view(d_in, d_out),
                v[b_off:b_off + d_out])

    V0, vb0 = tangent(0)
    dh = ds[0] * (obs @ V0 + vb0)
    for k in range(1, L):
        Vk, vbk = tangent(k)
        dh = ds[k] * (hs[k - 1] @ Vk + dh @ ws[k] + vbk)
    VL, vbL = tangent(L)
    d_mean = dh @ ws[L] + hs[L - 1] @ VL + vbL
    c = d_mean * wn[:, None] * m[None, :]

    cots = [None] * (L + 1)
    cots[L] = (c.sum(0), hs[L - 1].T @ c)
    ch = c @ ws[L].T
    for k in range(L - 1, 0, -1):
        g = ds[k] * ch
        cots[k] = (g.sum(0), hs[k - 1].T @ g)
        ch = g @ ws[k].T
    g = ds[0] * ch
    cots[0] = (g.sum(0), obs.T @ g)
    net = torch.cat([t for cb, cw in cots for t in (cb, cw.reshape(-1))])
    return net + damping * v[dims[-1]:]


def _check_cuda(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(
            f"{name}: expected a float32 CUDA tensor, got {t.dtype} on "
            f"{t.device}"
        )
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {tuple(shape)}, got "
            f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _fused_fvp_net_cuda(obs, hs, ws, v, wn, m, damping: float,
                        activation: str) -> torch.Tensor:
    L = len(hs)
    B = obs.shape[0]
    dims = [obs.shape[1]] + [w.shape[1] for w in ws]
    offs, total = _layout(dims)
    A = dims[-1]
    _check_cuda("obs", obs, (B, dims[0]))
    for k in range(L):
        _check_cuda(f"h[{k}]", hs[k], (B, dims[k + 1]))
    for k in range(L + 1):
        _check_cuda(f"w[{k}]", ws[k], (dims[k], dims[k + 1]))
    _check_cuda("v", v, (total,))
    _check_cuda("wn", wn, (B,))
    _check_cuda("m", m, (A,))
    if B < 1:
        raise ValueError("fused FVP needs at least one row")

    sweep = _build.kernel("trpo_fvp_sweep_gemm", _SWEEP_ARGTYPES)
    wgrad = _build.kernel("trpo_fvp_wgrad", _WGRAD_ARGTYPES)
    reduce = _build.kernel("trpo_fvp_reduce", _REDUCE_ARGTYPES)
    stream = _build.stream_of(obs)
    act = _ACT_CODE[activation]
    vp = v.data_ptr()
    f32 = 4  # bytes

    def run_sweep(trans, N, a1, K1, b1, ldb1, a2, K2, b2, ldb2, bias, epi,
                  H, out):
        err = sweep(
            trans, B, N, a1.data_ptr(), K1, K1, b1, ldb1,
            a2.data_ptr() if a2 is not None else None, K2, K2, b2, ldb2,
            bias, epi, act,
            H.data_ptr() if H is not None else None, N,
            wn.data_ptr(), m.data_ptr(), out.data_ptr(), N, stream,
        )
        _build.check("trpo_fvp_sweep_gemm", err)

    def tangent_ptrs(k):
        b_off, w_off = offs[k]
        return vp + f32 * w_off, vp + f32 * b_off

    # ---- phase A: row-parallel sweeps ----------------------------------
    bufs = [torch.empty(B, dims[k + 1], device=obs.device) for k in range(L)]
    c = torch.empty(B, A, device=obs.device)
    V0, vb0 = tangent_ptrs(0)
    run_sweep(0, dims[1], obs, dims[0], V0, dims[1], None, 0, None, 0,
              vb0, _EPI_DERIV, hs[0], bufs[0])
    for k in range(1, L):
        Vk, vbk = tangent_ptrs(k)
        run_sweep(0, dims[k + 1], hs[k - 1], dims[k], Vk, dims[k + 1],
                  bufs[k - 1], dims[k], ws[k].data_ptr(), dims[k + 1],
                  vbk, _EPI_DERIV, hs[k], bufs[k])
    VL, vbL = tangent_ptrs(L)
    run_sweep(0, A, bufs[L - 1], dims[L], ws[L].data_ptr(), A,
              hs[L - 1], dims[L], VL, A, vbL, _EPI_FISHER, None, c)
    # backward dgrad chain; g_k overwrites the spent tangent buffer k
    run_sweep(1, dims[L], c, A, ws[L].data_ptr(), A, None, 0, None, 0,
              None, _EPI_DERIV, hs[L - 1], bufs[L - 1])
    for k in range(L - 1, 0, -1):
        run_sweep(1, dims[k], bufs[k], dims[k + 1], ws[k].data_ptr(),
                  dims[k + 1], None, 0, None, 0, None, _EPI_DERIV,
                  hs[k - 1], bufs[k - 1])

    # ---- phase B: parameter-parallel split-K weight gradients ---------
    P = total - A
    splits = math.ceil(B / _ROWS_PER_SPLIT)
    partial = torch.empty(splits, P, device=obs.device)
    for k in range(L + 1):
        a = obs if k == 0 else hs[k - 1]
        g = c if k == L else bufs[k]
        err = wgrad(
            B, _ROWS_PER_SPLIT, splits, dims[k], dims[k + 1],
            a.data_ptr(), dims[k], g.data_ptr(), dims[k + 1],
            partial.data_ptr() + f32 * (offs[k][0] - A), P, stream,
        )
        _build.check("trpo_fvp_wgrad", err)
    out = torch.empty(P, device=obs.device)
    err = reduce(P, splits, partial.data_ptr(), vp + f32 * A,
                 float(damping), out.data_ptr(), stream)
    _build.check("trpo_fvp_reduce", err)
    _build.LAUNCHES["fused_fvp"] += 1
    return out


def fused_fvp_net(obs, hs, ws, v, wn, m, damping: float,
                  activation: str) -> torch.Tensor:
    """The net part of ``(F + λI)v``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    ``obs`` (B, D₀); ``hs`` the L stored activations (B, H_k); ``ws`` the
    L+1 weights (in, out) (``ws[0]`` is not read); ``v`` the full flat
    tangent; ``wn`` (B,) the normalized row weights; ``m`` (A,)
    ``e^{-2 log σ}``; ``damping`` λ as a Python float."""
    if obs.device.type == "cuda":
        return _fused_fvp_net_cuda(obs, hs, ws, v, wn, m, damping,
                                   activation)
    if obs.device.type == "cpu":
        return fused_fvp_net_plain(obs, hs, ws, v, wn, m, damping,
                                   activation)
    raise ValueError(f"no fused FVP for device {obs.device}")


class FusedGaussianMLPFVP:
    """``v ↦ (F + λI)v`` over the policy tree ``{"net", "log_std"}``
    (``__call__``) or its flat vector (:meth:`flat`). Setup — the forward
    activations, the row weights, ``e^{-2σ}`` — runs once here, outside
    the CG loop."""

    def __init__(self, net_params: Any, obs: torch.Tensor,
                 weight: torch.Tensor, log_std: torch.Tensor,
                 damping: float, activation: str = "tanh"):
        if activation not in _ACT_DERIV:
            raise ValueError(
                f"fused FVP supports activations {sorted(_ACT_DERIV)}, "
                f"got {activation!r}"
            )
        if not fused_fvp_supported(activation, net_params):
            raise ValueError(
                "fused FVP needs a plain MLP with at least one hidden layer"
            )
        layers = net_params["layers"]
        with torch.no_grad():
            obs = obs.reshape(obs.shape[0], -1).float().contiguous()
            self.ws = [layer["w"].detach().float().contiguous()
                       for layer in layers]
            act_fn = _ACT_FN[activation]
            h, hs = obs, []
            for layer in layers[:-1]:
                h = act_fn(h @ layer["w"].float() + layer["b"].float())
                hs.append(h.contiguous())
            weight = weight.reshape(-1).float()
            sum_w = weight.sum()
            norm = torch.clamp(sum_w, min=1.0)
            self.wn = (weight / norm).contiguous()
            self.sum_wn = sum_w / norm
            self.m = torch.exp(-2.0 * log_std.detach().float()).contiguous()
        self.obs, self.hs = obs, hs
        self.damping = float(damping)
        self.activation = activation
        self.act_dim = self.ws[-1].shape[1]

    def flat(self, v: torch.Tensor) -> torch.Tensor:
        v = v.float().contiguous()
        net = fused_fvp_net(self.obs, self.hs, self.ws, v, self.wn, self.m,
                            self.damping, self.activation)
        sigma = (2.0 * self.sum_wn + self.damping) * v[:self.act_dim]
        return torch.cat([sigma, net])

    def __call__(self, v: Any) -> Any:
        flat, unravel = flatten_params(v)
        return unravel(self.flat(flat))


def make_fused_gaussian_mlp_fvp(net_params: Any, obs: torch.Tensor,
                                weight: torch.Tensor, log_std: torch.Tensor,
                                damping: float, *,
                                activation: str = "tanh"
                                ) -> FusedGaussianMLPFVP:
    """Build ``v ↦ (F + λI)v`` for the plain-MLP Gaussian policy: the tree
    in, the tree out (``{"net": ..., "log_std": ...}``)."""
    return FusedGaussianMLPFVP(net_params, obs, weight, log_std, damping,
                               activation)
