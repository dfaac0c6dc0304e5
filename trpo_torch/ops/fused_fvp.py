"""Fused Gauss-Newton Fisher-vector product for plain-MLP diagonal-Gaussian
policies (counterpart: ``trpo_tpu/ops/fused_fvp.py``).

Math (the same as ``ops/fvp.make_ggn_fvp``)::

    F·v = Jᵀ M J v + λv,   J = ∂(dist params)/∂θ at θ₀,
    M   = diag(wᵢ/Σw) ⊗ [e^{-2σ} on the mean block, 2·I on log σ]

Per row the operator runs a tangent forward sweep through the torso, the
Fisher weighting ``c = d_mean·(wₙ/Σw)·e^{-2 log σ}``, and a backward sweep
that accumulates every layer's weight and bias cotangents. The ``log_std``
block is the closed form ``(2Σwₙ + λ)v_σ``, outside the products.
Zero-weight rows contribute exactly nothing.

Kernel: ``trpo_torch/csrc/fused_fvp.cu`` replaces
``make_fused_gaussian_mlp_fvp`` (``trpo_tpu/ops/fused_fvp.py:298``). At the
training shape (37,536 rows × 376→256→256→17) it does 35.44 GFLOP of
products per call. It computes them on the tensor cores (``wgmma``) in
3xTF32 (each f32 operand split into two TF32 halves, three products
accumulated in f32; one TF32 pass misses the reference's 1e-5 tolerance),
so its bound on an H100 SXM is 3 × 35.44 GFLOP at 495 TFLOP/s ≈ 0.215 ms,
against ~135 MB of compulsory bytes (0.040 ms). Its design — row-parallel
sweeps writing the per-row cotangents to scratch, then one launch of
parameter-parallel split-K weight gradients reduced in a fixed order,
bitwise reproducible — is in the source's header. Everything of a launch
that does not depend on ``v`` (aligned copies of the fixed weights and
their transposes, the buffers the tangent blocks of ``v`` are unpacked
into, the scratch, the split-K partials) is prepared once per operator
build (:class:`_CudaPlan`), so a matvec allocates only its result.

:meth:`FusedGaussianMLPFVP.flat` launches the kernel for CUDA tensors and
runs the plain version, :func:`fused_fvp_net_plain` (the same three sweeps
as eager tensor ops), for CPU tensors. There is no other path: a CUDA
tensor launches the kernel or raises. The activations ``h_k`` come from
one ``torch.matmul`` forward per operator build, outside the kernel, as
the reference leaves that forward to XLA.

``compute_dtype=torch.bfloat16`` builds K1-bf16
(``trpo_torch/csrc/fused_fvp_bf16.cu``), the reference's kernel at its
default compute dtype: ``obs``, the activations (a bf16 forward), the
weights and the weight tangents are bf16, every product accumulates in
f32, and the tangent, ``c`` and ``g`` are rounded to bf16 exactly where
they feed the next product, while the bias cotangents sum the unrounded
f32 values. Its plain version rounds at the same places and multiplies
bf16 values as f32 (``preferred_element_type=f32``), never with a bf16
``matmul`` (which would round each product's result). Its bound at the
training shape is 35.44 GFLOP at 989 TFLOP/s dense bf16 ≈ 0.036 ms.

The damping λ is a device scalar (a float is moved to the device once per
operator build), read by the kernels from device memory, so an adapted λ
(``cfg.adaptive_damping``) never costs a host sync.

Flat layout: ``v`` and the result are the policy's flat vector in
``ravel_pytree`` order (``ops/flat.py``): ``log_std``, then per layer
``b`` then ``w`` (row-major ``(in, out)``). The kernel reads the bias
tangents straight out of that vector and unpacks the weight tangents into
aligned buffers with one small kernel per call, so that every tile copy
moves 16 bytes; it writes the cotangents in the same layout.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from trpo_torch.ops import _build
from trpo_torch.ops.flat import flatten_params

__all__ = [
    "FusedGaussianMLPFVP",
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
_BK = 32           # rows per k-step of the weight-gradient tiles
_MAX_LAYERS = 8    # layers one weight-gradient launch takes

_P, _I = ctypes.c_void_p, ctypes.c_int
_SWEEP_ARGTYPES = (
    [_I, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I,
     _P, _P, _P, _I, _P]
)
_WGRAD_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                   ctypes.c_longlong, _P]
_REDUCE_ARGTYPES = [_I, _I, _I, _P, _P, _P, _P, _P, _P]
_SWEEP16_ARGTYPES = (
    [_I, _I, _P, _I, _I, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I,
     _P, _P, _P, _I, _P]
)
_WGRAD16_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                     ctypes.c_longlong, _P]
_BM16 = 64  # K1-bf16's tile edge
_TILES_ARGTYPES = [_I, _P, _P, _P]
_UNPACK_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P]


def fused_fvp_supported(activation: str, net_params: Any) -> bool:
    """Whether the fused operator covers this (activation, torso) pair:
    tanh/relu/elu, 1 to 7 hidden layers, 2-D weights. Any widths: the
    kernel masks its own edges."""
    if activation not in _ACT_DERIV:
        return False
    try:
        layers = net_params["layers"]
    except (TypeError, KeyError):
        return False
    if not isinstance(layers, (list, tuple)) \
            or not 2 <= len(layers) <= _MAX_LAYERS:
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


def fused_fvp_net_plain(obs, hs, ws, v, wn, m, damping, activation: str,
                        matmul=torch.matmul,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """The plain version: the three sweeps as eager tensor ops. Returns the
    net part of ``(F + λI)v`` (everything after the ``log_std`` block).
    ``matmul`` computes every product (a test emulates the kernel's
    arithmetic through it). At ``compute_dtype=torch.bfloat16`` it is
    K1-bf16's plain version: ``obs``, ``hs``, ``ws`` and the weight tangents
    are rounded to bf16, the tangent ``dh``, ``c`` and ``g`` are rounded
    before each product, and every product multiplies the bf16 values in
    f32; the bias cotangents sum the unrounded values."""
    bf16 = compute_dtype == torch.bfloat16
    _build.LAUNCHES["fused_fvp_bf16_plain" if bf16 else
                    "fused_fvp_plain"] += 1
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if bf16
           else (lambda x: x))
    obs, hs, ws = rnd(obs.float()), [rnd(h.float()) for h in hs], \
        [rnd(w.float()) for w in ws]
    L = len(hs)
    dims = [obs.shape[1]] + [w.shape[1] for w in ws]
    offs, _ = _layout(dims)
    deriv = _ACT_DERIV[activation]
    ds = [deriv(h) for h in hs]

    def tangent(k):
        b_off, w_off = offs[k]
        d_in, d_out = dims[k], dims[k + 1]
        return (rnd(v[w_off:w_off + d_in * d_out].view(d_in, d_out)),
                v[b_off:b_off + d_out])

    V0, vb0 = tangent(0)
    dh = rnd(ds[0] * (matmul(obs, V0) + vb0))
    for k in range(1, L):
        Vk, vbk = tangent(k)
        dh = rnd(ds[k] * (matmul(hs[k - 1], Vk) + matmul(dh, ws[k]) + vbk))
    VL, vbL = tangent(L)
    d_mean = matmul(dh, ws[L]) + matmul(hs[L - 1], VL) + vbL
    c32 = d_mean * wn[:, None] * m[None, :]
    c = rnd(c32)

    cots = [None] * (L + 1)
    cots[L] = (c32.sum(0), matmul(hs[L - 1].T, c))
    ch = matmul(c, ws[L].T)
    for k in range(L - 1, 0, -1):
        g32 = ds[k] * ch
        g = rnd(g32)
        cots[k] = (g32.sum(0), matmul(hs[k - 1].T, g))
        ch = matmul(g, ws[k].T)
    g32 = ds[0] * ch
    cots[0] = (g32.sum(0), matmul(obs.T, rnd(g32)))
    net = torch.cat([t for cb, cw in cots for t in (cb, cw.reshape(-1))])
    return net + damping * v[dims[-1]:]


def _check_cuda(name: str, t: torch.Tensor, shape,
                dtype=torch.float32) -> None:
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(
            f"{name}: expected a {dtype} CUDA tensor, got {t.dtype} on "
            f"{t.device}"
        )
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {tuple(shape)}, got "
            f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _padded(t: torch.Tensor, multiple: int = 4) -> torch.Tensor:
    """A copy of the 2-D ``t`` whose row stride is a multiple of
    ``multiple`` values (4 f32 or 8 bf16: 16 bytes), so the kernels' tile
    copies can move 16 bytes at a time; the extra columns are zeros."""
    rows, cols = t.shape
    out = torch.zeros(rows, _cdiv(cols, multiple) * multiple,
                      device=t.device, dtype=t.dtype)
    out[:, :cols] = t
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it already starts on a 16-byte boundary with a row
    stride of a multiple of 4 floats, else :func:`_padded`."""
    if t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0:
        return t
    return _padded(t)


def _scratch(rows: int, cols: int, device) -> torch.Tensor:
    return torch.empty(rows, _cdiv(cols, 4) * 4, device=device)


class _CudaPlan:
    """Everything of the kernel launch that does not depend on ``v``,
    prepared once per operator build: checked inputs, 16-byte-aligned
    copies of the fixed weights and of their transposes (and of ``obs`` and
    ``h_k`` where their widths are not multiples of 4), the aligned buffers
    the tangent blocks of ``v`` are unpacked into, the per-row scratch, the
    split-K partials and the launch arguments."""

    def __init__(self, obs, hs, ws, wn, m, coef, damping: torch.Tensor,
                 activation: str):
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
        _check_cuda("wn", wn, (B,))
        _check_cuda("m", m, (A,))
        if B < 1:
            raise ValueError("fused FVP needs at least one row")
        if L + 1 > _MAX_LAYERS:
            raise ValueError(
                f"fused FVP covers at most {_MAX_LAYERS} layers, got {L + 1}"
            )
        dev = obs.device
        self.B, self.L, self.dims, self.offs = B, L, dims, offs
        self.total, self.A = total, A
        obs, hs = _aligned(obs), [_aligned(h) for h in hs]
        self.obs, self.hs, self.wn, self.m, self.coef = obs, hs, wn, m, coef
        self.damping, self.act = damping, _ACT_CODE[activation]
        # fixed weights: (in, out) for the tangent sweep, (out, in) for the
        # backward sweep, both with 16-byte rows (k >= 1; W_0 is not read)
        self.wf = [None] + [_padded(ws[k]) for k in range(1, L + 1)]
        self.wt = [None] + [_padded(ws[k].t()) for k in range(1, L + 1)]
        # the tangent blocks V_k of v, unpacked per matvec into aligned
        # (in, out) buffers whose padding stays zero
        n_l = L + 1
        self.vpad = [torch.zeros(dims[k], _cdiv(dims[k + 1], 4) * 4,
                                 device=dev) for k in range(n_l)]
        self._unpack_arrays = (
            (ctypes.c_void_p * n_l)(*[t.data_ptr() for t in self.vpad]),
            (ctypes.c_longlong * n_l)(*[offs[k][1] for k in range(n_l)]),
            (ctypes.c_int * n_l)(*dims[:-1]),
            (ctypes.c_int * n_l)(*dims[1:]),
            (ctypes.c_int * n_l)(*[t.stride(0) for t in self.vpad]),
        )
        self._unpack_ptrs = [ctypes.addressof(a) for a in self._unpack_arrays]
        # per-row scratch: tangents, then (in place) the cotangents g_k; c
        self.bufs = [_scratch(B, dims[k + 1], dev) for k in range(L)]
        self.c = _scratch(B, A, dev)
        # phase B: one launch over every layer's tiles, split-K sized to
        # fill the card once
        self.P = total - A
        kins = (ctypes.c_int * n_l)(*dims[:-1])
        outs = (ctypes.c_int * n_l)(*dims[1:])
        per_sm = ctypes.c_int(0)
        n_tiles = _build.kernel("trpo_fvp_wgrad_tiles", _TILES_ARGTYPES)(
            n_l, ctypes.addressof(kins), ctypes.addressof(outs),
            ctypes.addressof(per_sm))
        if n_tiles < 1:
            raise RuntimeError("fused FVP: no occupancy for the weight-"
                               "gradient kernel")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slots = per_sm.value * sms
        splits = max(1, min(round(slots / n_tiles), _cdiv(B, _BK)))
        self.rows_per_split = _cdiv(_cdiv(B, splits), _BK) * _BK
        self.splits = _cdiv(B, self.rows_per_split)
        self.partial = torch.empty(self.splits, self.P, device=dev)
        a_ops = [obs] + list(hs)
        g_ops = list(self.bufs) + [self.c]
        self._wgrad_arrays = (
            (ctypes.c_void_p * n_l)(*[t.data_ptr() for t in a_ops]),
            (ctypes.c_int * n_l)(*[t.stride(0) for t in a_ops]),
            kins,
            (ctypes.c_void_p * n_l)(*[t.data_ptr() for t in g_ops]),
            (ctypes.c_int * n_l)(*[t.stride(0) for t in g_ops]),
            outs,
            (ctypes.c_int * n_l)(*[offs[k][0] - A for k in range(n_l)]),
        )
        self._wgrad_ptrs = [ctypes.addressof(a) for a in self._wgrad_arrays]

    def run(self, v: torch.Tensor) -> torch.Tensor:
        """The full flat ``(F + λI)v`` on the current stream: the tangent
        unpack, ``2L + 1`` sweeps, the weight gradients and the reduce; one
        output allocation."""
        _check_cuda("v", v, (self.total,))
        sweep = _build.kernel("trpo_fvp_sweep", _SWEEP_ARGTYPES)
        wgrad = _build.kernel("trpo_fvp_wgrad", _WGRAD_ARGTYPES)
        reduce = _build.kernel("trpo_fvp_reduce", _REDUCE_ARGTYPES)
        unpack = _build.kernel("trpo_fvp_unpack", _UNPACK_ARGTYPES)
        stream = _build.stream_of(v)
        B, L, dims, offs = self.B, self.L, self.dims, self.offs
        hs, bufs, c = self.hs, self.bufs, self.c
        vp = v.data_ptr()
        f32 = 4  # bytes

        def run_sweep(N, a1, K1, b1, ldb1, a2, K2, b2, bias, epi, H, out):
            err = sweep(
                B, N, a1.data_ptr(), a1.stride(0), K1, b1,
                ldb1, a2.data_ptr() if a2 is not None else None,
                a2.stride(0) if a2 is not None else 0, K2,
                b2.data_ptr() if b2 is not None else None,
                b2.stride(0) if b2 is not None else 0, bias, epi, self.act,
                H.data_ptr() if H is not None else None,
                H.stride(0) if H is not None else 0,
                self.wn.data_ptr(), self.m.data_ptr(), out.data_ptr(),
                out.stride(0), stream,
            )
            _build.check("trpo_fvp_sweep", err)

        def tangent(k):  # (V_k pointer, its row stride, b_k pointer)
            return (self.vpad[k].data_ptr(), self.vpad[k].stride(0),
                    vp + f32 * offs[k][0])

        err = unpack(L + 1, vp, *self._unpack_ptrs, stream)
        _build.check("trpo_fvp_unpack", err)
        # ---- phase A: row-parallel sweeps ------------------------------
        V0, ld0, vb0 = tangent(0)
        run_sweep(dims[1], self.obs, dims[0], V0, ld0, None, 0, None, vb0,
                  _EPI_DERIV, hs[0], bufs[0])
        for k in range(1, L):
            Vk, ldk, vbk = tangent(k)
            run_sweep(dims[k + 1], hs[k - 1], dims[k], Vk, ldk, bufs[k - 1],
                      dims[k], self.wf[k], vbk, _EPI_DERIV, hs[k], bufs[k])
        VL, ldL, vbL = tangent(L)
        run_sweep(self.A, hs[L - 1], dims[L], VL, ldL, bufs[L - 1], dims[L],
                  self.wf[L], vbL, _EPI_FISHER, None, c)
        # backward dgrad chain; g_k overwrites the spent tangent buffer k
        run_sweep(dims[L], c, self.A, self.wt[L].data_ptr(),
                  self.wt[L].stride(0), None, 0, None, None, _EPI_DERIV,
                  hs[L - 1], bufs[L - 1])
        for k in range(L - 1, 0, -1):
            run_sweep(dims[k], bufs[k], dims[k + 1], self.wt[k].data_ptr(),
                      self.wt[k].stride(0), None, 0, None, None, _EPI_DERIV,
                      hs[k - 1], bufs[k - 1])

        # ---- phase B: every layer's weight gradients, then the reduce --
        err = wgrad(L + 1, *self._wgrad_ptrs, B, self.rows_per_split,
                    self.splits, self.partial.data_ptr(), self.P, stream)
        _build.check("trpo_fvp_wgrad", err)
        out = torch.empty(self.total, device=v.device)
        err = reduce(self.A, self.P, self.splits, self.partial.data_ptr(), vp,
                     self.coef.data_ptr(), self.damping.data_ptr(),
                     out.data_ptr(), stream)
        _build.check("trpo_fvp_reduce", err)
        _build.LAUNCHES["fused_fvp"] += 1
        return out


class _CudaPlanBF16:
    """K1-bf16's launch plan, prepared once per operator build: 8-aligned
    bf16 copies of ``obs``, the ``h_k`` and the fixed weights (``W_k`` for
    the backward sweeps, ``W_kᵀ`` for the tangent sweeps), the bf16 buffers
    the weight tangents of ``v`` are unpacked into (transposed), the f32
    per-row scratch (``dh``, then ``g32``; ``c32``), the split-K partials
    and the launch arguments."""

    def __init__(self, obs, hs, ws, wn, m, coef, damping: torch.Tensor,
                 activation: str):
        L = len(hs)
        B = obs.shape[0]
        dims = [obs.shape[1]] + [w.shape[1] for w in ws]
        offs, total = _layout(dims)
        A = dims[-1]
        _check_cuda("obs", obs, (B, dims[0]), torch.bfloat16)
        for k in range(L):
            _check_cuda(f"h[{k}]", hs[k], (B, dims[k + 1]), torch.bfloat16)
        for k in range(L + 1):
            _check_cuda(f"w[{k}]", ws[k], (dims[k], dims[k + 1]),
                        torch.bfloat16)
        _check_cuda("wn", wn, (B,))
        _check_cuda("m", m, (A,))
        if B < 1:
            raise ValueError("fused FVP needs at least one row")
        if L + 1 > _MAX_LAYERS:
            raise ValueError(
                f"fused FVP covers at most {_MAX_LAYERS} layers, got {L + 1}"
            )
        dev = obs.device
        self.B, self.L, self.dims, self.offs = B, L, dims, offs
        self.total, self.A = total, A
        self.obs = _padded(obs, 8)
        self.hs = [_padded(h, 8) for h in hs]
        self.wn, self.m, self.coef, self.damping = wn, m, coef, damping
        self.act = _ACT_CODE[activation]
        # (out, in) for the tangent sweeps, (in, out) for the backward ones
        self.wt = [None] + [_padded(ws[k].t(), 8) for k in range(1, L + 1)]
        self.wf = [None] + [_padded(ws[k], 8) for k in range(1, L + 1)]
        n_l = L + 1
        self.vt = [torch.zeros(dims[k + 1], _cdiv(dims[k], 8) * 8,
                               device=dev, dtype=torch.bfloat16)
                   for k in range(n_l)]
        self._unpack_arrays = (
            (ctypes.c_void_p * n_l)(*[t.data_ptr() for t in self.vt]),
            (ctypes.c_longlong * n_l)(*[offs[k][1] for k in range(n_l)]),
            (ctypes.c_int * n_l)(*dims[:-1]),
            (ctypes.c_int * n_l)(*dims[1:]),
            (ctypes.c_int * n_l)(*[t.stride(0) for t in self.vt]),
        )
        self._unpack_ptrs = [ctypes.addressof(a) for a in self._unpack_arrays]
        self.bufs = [torch.zeros(B, _cdiv(dims[k + 1], 8) * 8, device=dev)
                     for k in range(L)]
        self.c = torch.zeros(B, _cdiv(A, 8) * 8, device=dev)
        self.P = total - A
        n_tiles = sum(_cdiv(dims[k], _BM16) * _cdiv(dims[k + 1], _BM16)
                      for k in range(n_l))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # about eight weight-gradient blocks per SM: each block's k-loop is
        # latency-bound, so the more of them wait at once the better
        splits = max(1, min(_cdiv(8 * sms, n_tiles), _cdiv(B, _BK)))
        self.rows_per_split = _cdiv(_cdiv(B, splits), _BK) * _BK
        self.splits = _cdiv(B, self.rows_per_split)
        self.partial = torch.empty(self.splits, self.P, device=dev)
        a_ops = [self.obs] + list(self.hs)
        g_ops = list(self.bufs) + [self.c]
        self._wgrad_arrays = (
            (ctypes.c_void_p * n_l)(*[t.data_ptr() for t in a_ops]),
            (ctypes.c_int * n_l)(*[t.stride(0) for t in a_ops]),
            (ctypes.c_int * n_l)(*dims[:-1]),
            (ctypes.c_void_p * n_l)(*[t.data_ptr() for t in g_ops]),
            (ctypes.c_int * n_l)(*[t.stride(0) for t in g_ops]),
            (ctypes.c_int * n_l)(*dims[1:]),
            (ctypes.c_int * n_l)(*[offs[k][0] - A for k in range(n_l)]),
        )
        self._wgrad_ptrs = [ctypes.addressof(a) for a in self._wgrad_arrays]

    def run(self, v: torch.Tensor) -> torch.Tensor:
        """The full flat ``(F + λI)v`` on the current stream: the tangent
        unpack, ``2L + 1`` sweeps, the weight and bias gradients and the
        reduce; one output allocation."""
        _check_cuda("v", v, (self.total,))
        sweep = _build.kernel("trpo_fvp16_sweep", _SWEEP16_ARGTYPES)
        wgrad = _build.kernel("trpo_fvp16_wgrad", _WGRAD16_ARGTYPES)
        unpack = _build.kernel("trpo_fvp16_unpack", _UNPACK_ARGTYPES)
        reduce = _build.kernel("trpo_fvp_reduce", _REDUCE_ARGTYPES)
        stream = _build.stream_of(v)
        B, L, dims, offs = self.B, self.L, self.dims, self.offs
        hs, bufs, c = self.hs, self.bufs, self.c
        vp = v.data_ptr()
        f32 = 4  # bytes

        def run_sweep(N, a1, K1, b1, a2, K2, b2, bias, epi, H, out):
            err = sweep(
                B, N, a1.data_ptr(), int(a1.dtype == torch.float32),
                a1.stride(0), K1, b1.data_ptr(), b1.stride(0),
                a2.data_ptr() if a2 is not None else None,
                a2.stride(0) if a2 is not None else 0, K2,
                b2.data_ptr() if b2 is not None else None,
                b2.stride(0) if b2 is not None else 0, bias, epi, self.act,
                H.data_ptr() if H is not None else None,
                H.stride(0) if H is not None else 0,
                self.wn.data_ptr(), self.m.data_ptr(), out.data_ptr(),
                out.stride(0), stream,
            )
            _build.check("trpo_fvp16_sweep", err)

        def vb(k):
            return vp + f32 * offs[k][0]

        err = unpack(L + 1, vp, *self._unpack_ptrs, stream)
        _build.check("trpo_fvp16_unpack", err)
        # ---- phase A: row-parallel sweeps ------------------------------
        run_sweep(dims[1], self.obs, dims[0], self.vt[0], None, 0, None,
                  vb(0), _EPI_DERIV, hs[0], bufs[0])
        for k in range(1, L):
            run_sweep(dims[k + 1], hs[k - 1], dims[k], self.vt[k],
                      bufs[k - 1], dims[k], self.wt[k], vb(k), _EPI_DERIV,
                      hs[k], bufs[k])
        run_sweep(self.A, hs[L - 1], dims[L], self.vt[L], bufs[L - 1],
                  dims[L], self.wt[L], vb(L), _EPI_FISHER, None, c)
        # backward dgrad chain; g_k overwrites the spent tangent buffer k
        run_sweep(dims[L], c, self.A, self.wf[L], None, 0, None, None,
                  _EPI_DERIV, hs[L - 1], bufs[L - 1])
        for k in range(L - 1, 0, -1):
            run_sweep(dims[k], bufs[k], dims[k + 1], self.wf[k], None, 0,
                      None, None, _EPI_DERIV, hs[k - 1], bufs[k - 1])

        # ---- phase B: weight and bias gradients, then the reduce -------
        err = wgrad(L + 1, *self._wgrad_ptrs, B, self.rows_per_split,
                    self.splits, self.partial.data_ptr(), self.P, stream)
        _build.check("trpo_fvp16_wgrad", err)
        out = torch.empty(self.total, device=v.device)
        err = reduce(self.A, self.P, self.splits, self.partial.data_ptr(), vp,
                     self.coef.data_ptr(), self.damping.data_ptr(),
                     out.data_ptr(), stream)
        _build.check("trpo_fvp_reduce", err)
        _build.LAUNCHES["fused_fvp_bf16"] += 1
        return out


def _bf16_forward(obs, layers, act_fn):
    """The bf16 torso forward, ``act(h @ w + b)`` in bf16 at every layer:
    bf16 operands multiplied in f32 and rounded once, then the bias add
    and the activation in bf16 (each rounds)."""
    bf = torch.bfloat16
    h, hs = obs.to(bf), []
    for layer in layers[:-1]:
        z = (h.float() @ layer["w"].to(bf).float()).to(bf)
        h = act_fn(z + layer["b"].to(bf))
        hs.append(h.contiguous())
    return hs


class FusedGaussianMLPFVP:
    """``v ↦ (F + λI)v`` over the policy tree ``{"net", "log_std"}``
    (``__call__``) or its flat vector (:meth:`flat`). Setup — the forward
    activations, the row weights, ``e^{-2σ}`` — runs once here, outside
    the CG loop. ``compute_dtype`` is float32 (K1) or bfloat16
    (K1-bf16)."""

    def __init__(self, net_params: Any, obs: torch.Tensor,
                 weight: torch.Tensor, log_std: torch.Tensor,
                 damping, activation: str = "tanh",
                 compute_dtype=torch.float32):
        if activation not in _ACT_DERIV:
            raise ValueError(
                f"fused FVP supports activations {sorted(_ACT_DERIV)}, "
                f"got {activation!r}"
            )
        if not fused_fvp_supported(activation, net_params):
            raise ValueError(
                "fused FVP needs a plain MLP with at least one hidden layer"
            )
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                "fused FVP computes in float32 or bfloat16, got "
                f"{compute_dtype}"
            )
        bf16 = compute_dtype == torch.bfloat16
        layers = net_params["layers"]
        with torch.no_grad():
            obs = obs.reshape(obs.shape[0], -1).float().contiguous()
            act_fn = _ACT_FN[activation]
            if bf16:
                self.ws = [layer["w"].detach().to(torch.bfloat16).contiguous()
                           for layer in layers]
                hs = _bf16_forward(obs, layers, act_fn)
                obs = obs.to(torch.bfloat16).contiguous()
            else:
                self.ws = [layer["w"].detach().float().contiguous()
                           for layer in layers]
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
            self.damping = torch.as_tensor(
                damping, dtype=torch.float32, device=obs.device).reshape(())
            self.sigma_coef = 2.0 * self.sum_wn + self.damping
        self.obs, self.hs = obs, hs
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.act_dim = self.ws[-1].shape[1]
        self._plan = None
        if obs.device.type == "cuda":
            plan = _CudaPlanBF16 if bf16 else _CudaPlan
            with torch.no_grad():
                self._plan = plan(obs, hs, self.ws, self.wn, self.m,
                                  self.sigma_coef.reshape(1), self.damping,
                                  activation)
        elif obs.device.type != "cpu":
            raise ValueError(f"no fused FVP for device {obs.device}")

    def flat(self, v: torch.Tensor) -> torch.Tensor:
        """``(F + λI)v`` on the flat vector: the CUDA kernel when the
        operator was built on CUDA tensors, the plain version on CPU."""
        v = v.float().contiguous()
        if self._plan is not None:
            return self._plan.run(v)
        return self.plain(v)

    def plain(self, v: torch.Tensor) -> torch.Tensor:
        """The plain version of :meth:`flat`, on any device."""
        net = fused_fvp_net_plain(self.obs, self.hs, self.ws, v, self.wn,
                                  self.m, self.damping, self.activation,
                                  compute_dtype=self.compute_dtype)
        return torch.cat([self.sigma_coef * v[:self.act_dim], net])

    def __call__(self, v: Any) -> Any:
        flat, unravel = flatten_params(v)
        return unravel(self.flat(flat))


def make_fused_gaussian_mlp_fvp(net_params: Any, obs: torch.Tensor,
                                weight: torch.Tensor, log_std: torch.Tensor,
                                damping, *, activation: str = "tanh",
                                compute_dtype=torch.float32
                                ) -> FusedGaussianMLPFVP:
    """Build ``v ↦ (F + λI)v`` for the plain-MLP Gaussian policy: the tree
    in, the tree out (``{"net": ..., "log_std": ...}``). ``damping`` is a
    float or a device scalar; ``compute_dtype=torch.bfloat16`` builds
    K1-bf16."""
    return FusedGaussianMLPFVP(net_params, obs, weight, log_std, damping,
                               activation, compute_dtype)
