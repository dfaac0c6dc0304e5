"""Build the batched C++ env stepper for the port (counterpart: the build
half of ``trpo_tpu/envs/native.py``).

The source, ``native/vec_env.cpp``, is shared with the reference and read
as it is. The port compiles its own copy with ``g++`` and the flags of
``native/Makefile`` (``-O3 -mtune=native -fPIC -shared -fopenmp -Wall``:
``-mtune`` tunes, it gates no instruction set, so the library is safe to
cache) into ``build/trpo_torch_native/<hash of source and flags>/`` at
the repository root, which ``.gitignore`` lists. It never writes into
``native/``. The compile runs under a file lock, into a temporary name
that is renamed into place, so a concurrent process loads either nothing
or the whole library. The compiler is called directly (no ``make``): the
first of ``$CXX``, ``g++`` and ``c++`` on ``PATH`` that builds an OpenMP
probe with these flags (a machine may set ``CXX`` to a compiler without
its OpenMP runtime); with none, or when the library's own compile fails,
it raises with the compilers' output.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from trpo_torch.obs import recompile

__all__ = ["BUILD_ROOT", "FLAGS", "SOURCE", "build", "compiler_info"]

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "vec_env.cpp"
BUILD_ROOT = _REPO / "build" / "trpo_torch_native"
FLAGS = ("-O3", "-mtune=native", "-fPIC", "-shared", "-fopenmp", "-Wall")
LIB_NAME = "libtrpo_native.so"
_lock = threading.Lock()


_PROBE = """#include <omp.h>
#ifndef _OPENMP
#error "no OpenMP"
#endif
extern "C" int trpo_probe() { return omp_get_max_threads(); }
"""
_chosen: dict = {}


def _candidates() -> tuple:
    names = [os.environ.get("CXX"), "g++", "c++"]
    found = []
    for name in names:
        path = shutil.which(name) if name else None
        if path and path not in found:
            found.append(path)
    return tuple(found)


def _cxx() -> str:
    """The first candidate compiler that builds the OpenMP probe with
    :data:`FLAGS` (cached per candidate list)."""
    cands = _candidates()
    if cands in _chosen:
        return _chosen[cands]
    if not cands:
        raise RuntimeError(
            "native env library unavailable: no C++ compiler ($CXX, g++ or "
            "c++) on PATH")
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.cpp"
        src.write_text(_PROBE)
        for cxx in cands:
            proc = subprocess.run(
                [cxx, *FLAGS, "-o", str(Path(tmp) / "probe.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode == 0:
                _chosen[cands] = cxx
                return cxx
            failures.append(f"{cxx} (exit {proc.returncode}):\n"
                            f"{proc.stdout}")
    raise RuntimeError(
        "native env library unavailable: no C++ compiler builds with "
        f"{' '.join(FLAGS)} (OpenMP):\n" + "\n".join(failures))


def _digest(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx,) + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build(root: Path = None) -> Path:
    """The library's path, compiled first unless this source and these
    flags are built already under ``root`` (default :data:`BUILD_ROOT`)."""
    root = BUILD_ROOT if root is None else Path(root)
    cxx = _cxx()
    out_dir = root / _digest(cxx)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    with _lock:
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / ".lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if lib.exists():  # another process built it while we waited
                return lib
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            (out_dir / "build.log").write_text(proc.stdout)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"native env library unavailable: {cxx} exited "
                    f"{proc.returncode} on {SOURCE}:\n{proc.stdout}"
                )
            os.replace(tmp, lib)
            recompile.notify(f"build:{LIB_NAME}", time.perf_counter() - t0)
    return lib


def compiler_info() -> dict:
    """The chosen compiler (it built the OpenMP probe) and its version
    line, for the smoke's build lines."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    return {"cxx": cxx,
            "version": version.stdout.splitlines()[0] if version.stdout
            else "?"}
