"""Build the package's native sources at first use; load them with ctypes.

CUDA kernels (``csrc/<name>.cu``) build with nvcc (:func:`load`); the host
C++ of the KV-transfer data plane (``csrc/<name>.cpp``) builds with g++
(:func:`load_host`).

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so a
build is one nvcc call of a few seconds. The shared library lands in
``csrc/.build/<name>-<hash>.so``, where the hash covers the source, every
header of ``csrc/`` (``*.cuh``, which the sources include) and the flags: a
changed source or header rebuilds, an unchanged one is reused. Concurrent
builders race benignly (each writes a temp file, then renames atomically).

A failed build raises :class:`BuildError` carrying nvcc's output — there is no
silent fallback to a plain version.

:func:`set_cache_dir` points the cache elsewhere before any library loads
(the serve CLI's ``--compile-cache-dir``, which a pool's warm start passes to
every relaunch): a process given a directory that holds the ``.so`` files of
the same sources and flags loads them and runs no compiler. ``compiles``
counts the compiler runs of this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / ".build"  # the library cache; set_cache_dir() moves it
# sm_90a (not sm_90): keeps wgmma/setmaxnreg available to the kernels.
# -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)


# g++ flags of the host libraries: the reference's (llmd_tpu/native/build.py).
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall", "-Werror")


class BuildError(RuntimeError):
    """The compiler is missing or refused a source."""


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # build + load wall time in this process (0 build if cached)
    log: str  # nvcc's output when this process compiled the source, else ""


_LOADED: dict[str, Built] = {}
compiles = 0  # compiler runs in this process
_LOCK = threading.Lock()  # guards _LOCKS
_LOCKS: dict[str, threading.Lock] = {}  # one per source: builds run in parallel


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                     "toolkit is needed to build the kernels")


def set_cache_dir(path: "str | os.PathLike") -> Path:
    """Build into and load from ``path`` (created if need be). Refused once a
    library is loaded: that one came from the old cache."""
    global BUILD_DIR
    with _LOCK:
        if _LOADED:
            raise RuntimeError(f"set_cache_dir: {sorted(_LOADED)} already loaded "
                               f"from {BUILD_DIR}")
        BUILD_DIR = Path(path).resolve()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` (else ``.cpp``) builds to in the cache."""
    src = CSRC / f"{name}.cu"
    if src.exists():
        return _library_path(BUILD_DIR, name, src, NVCC_FLAGS)
    return _library_path(BUILD_DIR, name, CSRC / f"{name}.cpp", HOST_FLAGS)


def _library_path(build_dir: Path, name: str, src: Path, flags: tuple) -> Path:
    return build_dir / f"{name}-{digest(src, flags)}.so"


def digest(src: Path, flags: tuple = NVCC_FLAGS) -> str:
    """The build's cache key: ``src``, every header beside it (by name and
    bytes, in name order) and the compiler flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` with nvcc if needed and dlopen it (once per
    process). Different sources build concurrently when loaded from several
    threads."""
    return _load(name, CSRC / f"{name}.cu", lambda: nvcc_path(), NVCC_FLAGS)


def load_host(name: str) -> Built:
    """Compile the host library ``csrc/<name>.cpp`` with g++ if needed and
    dlopen it (once per process); :class:`BuildError` if that fails."""
    return _load(name, CSRC / f"{name}.cpp", lambda: "g++", HOST_FLAGS)


def _load(name: str, src: Path, compiler: Callable[[], str], flags: tuple) -> Built:
    global compiles
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
        build_dir = BUILD_DIR
    with lock:
        if name in _LOADED:
            return _LOADED[name]
        out = _library_path(build_dir, name, src, flags)
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            try:
                cmd = [compiler(), *flags, str(src), "-o", tmp]
                with _LOCK:
                    compiles += 1
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            except (OSError, subprocess.TimeoutExpired, BuildError) as e:
                os.unlink(tmp)
                raise BuildError(f"the compiler could not run for {src}: {e}") from e
            if proc.returncode != 0:
                os.unlink(tmp)
                raise BuildError(f"{cmd[0]} failed (rc={proc.returncode}) for {src}:\n"
                                 f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            log = proc.stdout + proc.stderr
        built = Built(ctypes.CDLL(str(out)), out, time.perf_counter() - t0, log)
        _LOADED[name] = built
        return built
