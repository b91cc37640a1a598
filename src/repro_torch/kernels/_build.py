"""Build and load the CUDA kernels under ``kernels/csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

and loaded with ``ctypes``.  The output goes to ``kernels/_build/`` (listed
in ``.gitignore``), keyed by a hash of the source, the shared headers and
the flags, so an edited source is rebuilt and an unchanged one is not.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.  Nothing here runs at import time.

Serving runs several threads (the async engine's scheduler, a writer
refining the index) that may each make a kernel's first call: one lock
serialises the build and the load, so a source is compiled once, into one
temporary file, and loaded once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_OUT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# re-entrant: library() builds through build_all() under it
_lock = threading.RLock()


def sources() -> list[str]:
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _OUT / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> float:
    """Compile every missing library in parallel; returns wall seconds.
    The ptxas report of each build is kept beside it as ``<lib>.log``."""
    with _lock:
        return _build_missing(names)


def _build_missing(names: list[str] | None) -> float:
    t0 = time.perf_counter()
    todo = [(n, _target(n)) for n in (names or sources())]
    todo = [(n, t) for n, t in todo if not t.exists()]
    if not todo:
        return time.perf_counter() - t0
    _OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, target in todo:
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)          # another thread may have loaded it
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all([name])
            lib = ctypes.CDLL(str(target))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list):
    """A C entry point of ``csrc/<name>.cu`` with its argument types set."""
    fn = _fns.get((name, symbol))
    if fn is None:
        lib = library(name)
        with _lock:
            fn = _fns.get((name, symbol))
            if fn is None:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[(name, symbol)] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library(name).repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
