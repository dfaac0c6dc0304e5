"""Training metrics and the per-iteration stats log (counterpart:
``trpo_tpu/utils/metrics.py``).

``StatsLogger`` prints the padded two-column stats block per iteration and
appends one JSON object per iteration to an optional JSONL file, each row
written by one ``write`` and flushed; a crash-cut final line is repaired
when the file is opened (:func:`repair_jsonl_tail`). With ``bus`` (an
``obs.events.EventBus``, also assignable after construction: that is how
``agent.learn`` attaches a ``Telemetry``'s bus to a caller's logger) each
row is re-emitted as an ``iteration`` event, so the training log and the
telemetry stream share one schema.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional

import torch

__all__ = ["StatsLogger", "explained_variance", "quantile_nearest_rank",
           "repair_jsonl_tail"]


def explained_variance(ypred: torch.Tensor, y: torch.Tensor,
                       weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``1 − Var(y − ŷ)/Var(y)`` over weighted samples; NaN when
    ``Var(y) = 0``."""
    ypred = ypred.float().reshape(-1)
    y = y.float().reshape(-1)
    weight = torch.ones_like(y) if weight is None else \
        weight.float().reshape(-1)
    wsum = torch.clamp(weight.sum(), min=1.0)

    def wvar(v):
        m = torch.sum(v * weight) / wsum
        return torch.sum((v - m) ** 2 * weight) / wsum

    return 1.0 - wvar(y - ypred) / wvar(y)


def quantile_nearest_rank(vals, q: float):
    """Nearest-rank quantile (no interpolation) of ``vals``: the value at
    rank ``min(n − 1, ⌊q·n⌋)`` of the sorted values; None when empty."""
    vals = sorted(vals)
    if not vals:
        return None
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def repair_jsonl_tail(path: str) -> int:
    """Truncate a partial (crash-cut) final line so the file ends at a
    record boundary; returns the bytes removed (0 when the file is absent,
    empty or already ends in a newline)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb+") as f:
        f.seek(size - 1)
        if f.read(1) == b"\n":
            return 0
        # scan backward in windows for the last record boundary, so a
        # partial tail longer than one window does not cut the whole file
        pos, window = size, 1 << 20
        keep = 0  # no newline anywhere: the file is one partial line
        while pos > 0:
            start = max(0, pos - window)
            f.seek(start)
            nl = f.read(pos - start).rfind(b"\n")
            if nl >= 0:
                keep = start + nl + 1
                break
            pos = start
        f.truncate(keep)
        return size - keep


class StatsLogger:
    """Aligned console stats and an optional JSONL stream."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 stream: Optional[IO] = None, bus=None):
        # None: resolve sys.stdout at each log() call, so a stdout swapped
        # later (pytest capture, redirection) is the one written to
        self.stream = stream
        self.bus = bus
        self._jsonl: Optional[IO] = None
        if jsonl_path:
            repair_jsonl_tail(jsonl_path)
            self._jsonl = open(jsonl_path, "a")
        self.start_time = time.time()

    def log(self, iteration: int, stats: dict) -> None:
        stream = self.stream if self.stream is not None else sys.stdout
        print(f"\n-------- Iteration {iteration} ----------", file=stream)
        for k, v in stats.items():
            if isinstance(v, float):
                v = f"{v:.6g}"
            print(f"{str(k):<40} {v}", file=stream)
        if self._jsonl is not None:
            self._jsonl.write(
                json.dumps({"iteration": iteration, **stats}) + "\n")
            self._jsonl.flush()
        if self.bus is not None:
            self.bus.emit("iteration", iteration=int(iteration),
                          stats=dict(stats))

    def elapsed_minutes(self) -> float:
        """Wall-clock minutes since the logger was made."""
        return (time.time() - self.start_time) / 60.0

    def close(self) -> None:
        """Close the JSONL stream; idempotent."""
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
