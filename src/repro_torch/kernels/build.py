"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Each source in ``repro_torch/csrc/*.cu`` has a plain C interface and
compiles with ``nvcc`` alone (no PyTorch headers) into its own shared
library under ``build/kernels/`` at the root of the checkout. The file name
carries a hash of the sources, so an edited kernel is rebuilt and a stale
library is never loaded. :func:`build` starts one ``nvcc`` per source, all
at once; :func:`load` builds on first use, under one lock, so threads that
load a library together (the sharded executor's replicas) run one
``nvcc`` and never share its temporary file.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into a
``RuntimeError``. Nothing here runs at import time, so the CPU tests
import every kernel module on a machine without ``nvcc``.

This is the port's compile layer: a library made ready in this process
(compiled by :func:`build`, or loaded from disk on first use) calls every
hook added with :func:`add_compile_hook` with its source name, once per
library file. ``repro_torch.core.compilelog`` counts those calls.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Iterable, Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "SOURCES", "PROBES", "NVCC_FLAGS",
           "TOOLKIT_NVCC", "nvcc_path", "library_path", "build", "load",
           "check", "add_compile_hook", "remove_compile_hook", "ready"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("msbfs_step", "pairwise_popcount", "path_join", "ell_spmm",
           "flash_attention")
# not kernels of any path: the throughput probes that chip_smoke.py times
# for peak rates, and the other designs of kernels that probes/*.py time
# against the port's (built with the kernels, so that every source is
# compiled on each run)
PROBES = ("peak_probe", "msbfs_step_designs", "path_join_designs")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")


# source name -> the library file made ready in this process, and the
# callables told of each new one (core/compilelog.py installs one)
_READY: dict[str, Path] = {}
_HOOKS: list[Callable[[str], None]] = []
_READY_LOCK = threading.Lock()


def add_compile_hook(hook: Callable[[str], None]) -> None:
    """Call ``hook(name)`` whenever a library is made ready from now on."""
    with _READY_LOCK:
        if hook not in _HOOKS:
            _HOOKS.append(hook)


def remove_compile_hook(hook: Callable[[str], None]) -> None:
    with _READY_LOCK:
        if hook in _HOOKS:
            _HOOKS.remove(hook)


def ready() -> dict[str, Path]:
    """The libraries made ready in this process: source name -> file."""
    with _READY_LOCK:
        return dict(_READY)


def _made_ready(name: str, path: Path) -> None:
    """Record that ``path`` (the library of source ``name``) is ready; a
    file already recorded for that name (built, then loaded) is not a
    second compile, a new file of the same name (an edited source) is."""
    with _READY_LOCK:
        if _READY.get(name) == path:
            return
        _READY[name] = path
        hooks = list(_HOOKS)
    for hook in hooks:
        hook(name)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location. Raises where there is none (the CPU-only test machines)."""
    found = shutil.which("nvcc")
    if found is None and TOOLKIT_NVCC.exists():
        found = str(TOOLKIT_NVCC)
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (CPU tensors use the plain versions)")
    return found


def _inputs(name: str) -> list[Path]:
    return [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh"))


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives, keyed by a hash of its
    source, the shared headers and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _inputs(name):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.

    Returns ``{name: {"seconds": s, "log": ptxas report}}`` for the
    libraries compiled by this call. Raises ``RuntimeError`` with the
    compiler's output if any build fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    report, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))   # atomic: no half-written .so
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        _made_ready(name, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


_LOAD_LOCK = threading.Lock()
# id(library) -> (library, the signature sets declared on it): a wrapper
# loads its library on every launch, and declaring argument types again
# costs about 12 us of host time for five functions
_DECLARED: dict = {}


@functools.lru_cache(maxsize=None)
def _cdll(name: str) -> ctypes.CDLL:
    build([name])
    path = library_path(name)
    lib = ctypes.CDLL(str(path))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _made_ready(name, path)
    return lib


def load(name: str, signatures: dict[str, Sequence]) -> ctypes.CDLL:
    """The library of source ``name`` (built on first use) with the
    argument types of its exported functions declared; every function
    returns an ``int`` CUDA error code."""
    key = tuple(signatures)
    with _LOAD_LOCK:
        lib = _cdll(name)
        held, declared = _DECLARED.get(id(lib), (None, set()))
        if held is not lib:
            declared = set()
            _DECLARED[id(lib)] = (lib, declared)
        if key not in declared:
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            declared.add(key)
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.error_string(code).decode()})")
