"""What the program's own spans and counters recorded over the traced
stretch, for the readers that time a stage of the update from inside.

While a profiler records, the program (``trpo_torch/utils/timers.span``)
counts every span it opens by name (``ops/_build.SPAN_COUNTS``), counts
the host's reads of a CUDA value by site (``ops/_build.HOST_READS``) and
keeps each device-timed span's CUDA events (``ops/_build.SPANS``). The
harness clears them with ``_build.reset_launches()`` as the stretch
opens, and the stretch ends on a synchronized device, so every event has
completed when a reader runs. An update is one ``trpo/grad_and_surrogate``
span.
"""

from __future__ import annotations

import collections
from types import SimpleNamespace


def stretch():
    """``SimpleNamespace(updates, counts, host_reads, device_ms)`` with
    ``device_ms`` each device-timed span's times by name, in ms; None
    where the program keeps no spans (one older than them), where the
    stretch recorded no device-timed span (a CPU run) or no update, or
    where the buffer dropped spans past its cap."""
    from trpo_torch.ops import _build

    buf = getattr(_build, "SPANS", None)
    if buf is None or not buf.records or buf.dropped:
        return None
    counts = dict(_build.SPAN_COUNTS)
    updates = counts.get("trpo/grad_and_surrogate", 0)
    if updates == 0:
        return None
    device_ms = collections.defaultdict(list)
    for rec in buf.records:
        device_ms[rec.name].append(rec.device_ms())
    return SimpleNamespace(updates=updates, counts=counts,
                           host_reads=dict(_build.HOST_READS),
                           device_ms=dict(device_ms))
