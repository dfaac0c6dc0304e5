"""trpo_torch — the PyTorch/CUDA port of trpo_tpu for one NVIDIA H100.

The package mirrors ``trpo_tpu``'s layout, one module per counterpart, and
imports nothing of JAX or of ``trpo_tpu``. Its hand-written Hopper kernels
live in ``csrc/``: the fused Gauss-Newton FVP in f32 and at bf16
(``ops/fused_fvp.py``) and the reverse affine scan
(``ops/reverse_scan.py``). Each has a plain PyTorch version beside it,
used for CPU tensors.
"""

from trpo_torch.config import PRESETS, TRPOConfig, get_preset  # noqa: F401

__version__ = "0.1.0"
