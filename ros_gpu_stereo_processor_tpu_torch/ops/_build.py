"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of the package (which
may include the ``csrc/*.cuh`` headers), one process per source, all
started together, and links the objects into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), which
``ctypes`` loads.  The library goes into the package's ``build/`` directory
(git-ignored), under a name keyed by a hash of the sources, the headers and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  Only the sources in the package are compiled.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launches;
:class:`Kernel` raises when that is not 0.  Nothing here falls back: a
missing ``nvcc``, a failed build or a refused launch raises.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no
multiply-add is contracted into an FMA — the kernels reproduce the plain
PyTorch versions' float32 rounding step by step.  Never ``--use_fast_math``.

Launch counts under CUDA graphs (utils/graphs.py): a wrapper called while
its thread captures a graph enqueues nothing that runs, so inside
:func:`recording` it adds its launch to the recording instead of to
``launches``; the graph adds the recorded launches to the counters on every
replay (:func:`add_launches`), when the kernels do run.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Counter, Dict, Iterator, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_registry: Dict[str, "Kernel"] = {}
_capture = threading.local()   # .launches: the recording of this thread's capture


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> List[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstereo_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: List[subprocess.Popen], cmds: List[List[str]], verbose: bool) -> None:
    """Wait for every process; raise with the output of the first failure."""
    outs = [p.communicate() for p in procs]
    for p, cmd, (so, se) in zip(procs, cmds, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{so}\n{se}")
        if verbose and (so or se):
            print(so + se)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one nvcc per source, all started together, then one link.  Returns the
    library's path; raises ``RuntimeError`` with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private directory and name, then rename: a concurrent
    # build never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        if verbose:
            compile_flags += ["-Xptxas", "-v"]
        cmds, objs = [], []
        for src in _sources():
            obj = os.path.join(work, src.stem + ".o")
            cmds.append([_nvcc(), *compile_flags, "-c", str(src), "-o", obj])
            objs.append(obj)
        _run([subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for c in cmds], cmds, verbose)
        tmp = os.path.join(work, "lib.so")
        link = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]
        _run([subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)], [link], verbose)
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


class Kernel:
    """One C entry point of the kernel library, with a launch counter.

    ``launches`` is a plain integer that goes up by one each time the
    kernel is launched, and nowhere else: by the wrapper, or by the replay
    of a graph that captured it (never at capture); ``chip_smoke.py``
    zeroes it before a run and reads it after, to show the run went
    through the kernel.  ``argtypes`` are the ctypes of the C parameters
    (the stream, last, is added here)."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None
        _registry[symbol] = self

    def __call__(self, *args) -> None:
        import torch

        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        recorded = getattr(_capture, "launches", None)
        if recorded is None:
            self.launches += 1
        else:
            recorded[self.symbol] += 1


def kernels() -> Dict[str, Kernel]:
    """Every kernel wrapper of the port, by C symbol."""
    return dict(_registry)


def reset_launch_counts() -> None:
    for k in _registry.values():
        k.launches = 0


@contextlib.contextmanager
def recording() -> Iterator[Counter[str]]:
    """Launches by this thread's wrappers go into the yielded counter (by C
    symbol) instead of their ``launches``: a graph capture."""
    prev = getattr(_capture, "launches", None)
    _capture.launches = collections.Counter()
    try:
        yield _capture.launches
    finally:
        _capture.launches = prev


def add_launches(recorded: Counter[str]) -> None:
    """Add a graph's recorded launches to the counters: one replay."""
    for symbol, n in recorded.items():
        _registry[symbol].launches += n


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ``c_void_p``."""
    return ctypes.c_void_p(t.data_ptr())
