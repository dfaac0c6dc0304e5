"""Text helpers of the serving control plane: Prometheus label escaping
and sample formatting, and RFC-valid JSON.

Counterparts: ``_esc``, ``_fmt`` and ``_json_safe`` of
``trpo_tpu/obs/server.py``, copied (the port imports nothing of the
reference package, even where a module of it is pure Python).
"""

from __future__ import annotations

import math

__all__ = ["_esc", "_fmt", "_json_safe"]


def _esc(label) -> str:
    """One Prometheus label value, escaped."""
    return (
        str(label)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    """One Prometheus sample value as text (NaN/±Inf are legal)."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _json_safe(obj):
    """RFC-valid JSON: nonfinite floats become null (``json.dumps`` would
    emit bare ``NaN``/``Infinity`` tokens that strict parsers reject)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj

