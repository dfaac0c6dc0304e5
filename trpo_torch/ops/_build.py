"""Build, load and count the port's hand-written CUDA kernels.

Every ``trpo_torch/csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together, and linked into
ONE shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, from the repository's sources only, into
``build/trpo_torch_kernels/<hash of the sources and flags>/`` at the
repository root (``.gitignore`` lists ``build/``). A failed build raises
with the compiler's output; nothing falls back.

``LAUNCHES`` counts launches per wrapper name: a kernel wrapper adds one
where it launches its kernel, a plain version adds one under
``"<name>_plain"`` where it runs. A caller that wants to show a run went
through the kernels resets it, runs, and reads it.

Beside it, what ``utils/timers.span`` and ``utils/timers.host_read``
record while a profiler records on the calling thread (and only then):
``SPAN_COUNTS``, the spans opened, by name; ``HOST_READS``, the host's
reads of a CUDA value, by site; ``SPANS``, the device-timed spans with
their CUDA events, up to ``SPAN_CAP`` of them; ``TALLIES``, host values
kept by name (``utils/timers.tally``), up to ``SPAN_CAP`` a name.
:func:`reset_launches` clears all of them: one reset for every counter
of the program.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence

import torch

from trpo_torch.obs import recompile

__all__ = ["HOST_READS", "LAUNCHES", "SPANS", "SPAN_CAP", "SPAN_COUNTS",
           "SpanRecord", "TALLIES", "build", "check", "kernel",
           "reset_launches", "stream_of"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "trpo_torch_kernels"
LIB_NAME = "libtrpo_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
SPAN_COUNTS: collections.Counter = collections.Counter()
HOST_READS: collections.Counter = collections.Counter()
TALLIES: collections.defaultdict = collections.defaultdict(list)
# device-timed spans kept at most: a 3 s traced stretch of the flagship's
# updates keeps about 1,200; a profiled training run that never resets
# stops keeping them here (and counts each one dropped)
SPAN_CAP = 1 << 16


class SpanRecord(NamedTuple):
    """One device-timed span: its name, the innermost span open around it
    on its thread (None at the top), and the CUDA events recorded on the
    current stream at its edges."""
    name: str
    parent: Optional[str]
    start: "torch.cuda.Event"
    end: "torch.cuda.Event"

    def device_ms(self) -> float:
        """The device time between the span's edges; the events must have
        completed (synchronize first)."""
        return self.start.elapsed_time(self.end)


class SpanBuffer:
    """The device-timed spans, kept in order up to ``SPAN_CAP``; each one
    past it is counted in ``dropped``."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.dropped = 0

    def add(self, record: SpanRecord) -> None:
        if len(self.records) < SPAN_CAP:
            self.records.append(record)
        else:
            self.dropped += 1

    def clear(self) -> None:
        self.records.clear()
        self.dropped = 0


SPANS = SpanBuffer()

_lock = threading.Lock()
_lib = None
_fns: dict = {}


def reset_launches() -> None:
    """Clear the launch counts, the span and host-read counts, the span
    buffer and the tallies."""
    LAUNCHES.clear()
    SPAN_COUNTS.clear()
    HOST_READS.clear()
    SPANS.clear()
    TALLIES.clear()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the trpo_torch CUDA kernels cannot be built"
        )
    return found


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact source set is built already;
    returns the library path. Writes the compiler's output (``-Xptxas -v``:
    registers, shared memory, spills per kernel) to ``build.log`` beside
    the library."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / f"build.{tag}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(log)
        )
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp)]
        + [str(obj) for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    os.replace(out_dir / f"build.{tag}.log", out_dir / "build.log")
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    recompile.notify(f"build:{LIB_NAME}", time.perf_counter() - t0)
    return lib_path


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the built library, with its argument
    types declared (pointers and the stream as ``c_void_p``). Every entry
    point returns the ``cudaError_t`` of its launch."""
    global _lib
    with _lock:
        if name not in _fns:
            if _lib is None:
                _lib = ctypes.CDLL(str(build()))
            fn = getattr(_lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"CUDA launch of {name} failed: cudaError_t {err}"
        )


def stream_of(tensor) -> int:
    """The current CUDA stream of ``tensor``'s device, as a raw handle."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
