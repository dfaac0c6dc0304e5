"""The segmented reverse affine scan ``y_t = x_t + c_t·y_{t+1}``, ``y_T = 0``
(counterpart: ``trpo_tpu/ops/pallas_scan.py``).

Both return/advantage computations reduce to this recurrence over
time-major ``(T, N)`` f32 tensors (``ops/returns.py``).

Kernel: ``trpo_torch/csrc/reverse_scan.cu`` replaces
``reverse_affine_scan_pallas`` (``trpo_tpu/ops/pallas_scan.py:75``). It is
memory-bound in bytes (12 bytes and two flops per element: 0.18 µs for the
0.6 MB of the training shape on an H100), so what a call costs is latency:
the launch and its chain of dependent steps. It is a chunked parallel scan
over the affine maps ``(c, x)``: a block owns 32 columns and splits time
into 16 chunks, each thread composes its chunk's map from registers, the
chunk maps are folded through shared memory, and each thread re-walks its
chunk with its incoming carry. Loads and stores coalesce along N; ragged T
and N are masked.

:func:`reverse_affine_scan` launches the kernel for a CUDA tensor and runs
the plain version, :func:`reverse_affine_scan_plain`, for a CPU tensor. There
is no other path: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from trpo_torch.ops import _build

__all__ = ["reverse_affine_scan", "reverse_affine_scan_plain"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _check_inputs(coeffs: torch.Tensor, x: torch.Tensor) -> None:
    if x.ndim != 2 or coeffs.shape != x.shape:
        raise ValueError(
            f"expected matching (T, N) tensors, got {tuple(coeffs.shape)} "
            f"and {tuple(x.shape)}"
        )
    if x.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError(
            f"expected float32, got {coeffs.dtype} and {x.dtype}"
        )
    if x.device != coeffs.device:
        raise ValueError(f"tensors on {coeffs.device} and {x.device}")


def reverse_affine_scan_plain(coeffs: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """The plain version: the reverse loop over ``t`` on tensors."""
    _check_inputs(coeffs, x)
    _build.LAUNCHES["reverse_scan_plain"] += 1
    y = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        carry = x[t] + coeffs[t] * carry
        y[t] = carry
    return y


def _reverse_affine_scan_cuda(coeffs: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    _check_inputs(coeffs, x)
    if not coeffs.is_contiguous():
        coeffs = coeffs.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    T, N = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _build.kernel("trpo_reverse_affine_scan", _ARGTYPES)
    err = fn(coeffs.data_ptr(), x.data_ptr(), y.data_ptr(), T, N,
             _build.stream_of(x))
    _build.check("trpo_reverse_affine_scan", err)
    _build.LAUNCHES["reverse_scan"] += 1
    return y


def reverse_affine_scan(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Single-pass ``y_t = x_t + c_t·y_{t+1}`` over ``(T, N)`` f32 tensors:
    the CUDA kernel on a CUDA tensor, the plain loop on a CPU tensor."""
    if x.device.type == "cuda":
        return _reverse_affine_scan_cuda(coeffs, x)
    if x.device.type == "cpu":
        return reverse_affine_scan_plain(coeffs, x)
    raise ValueError(f"no reverse affine scan for device {x.device}")
