"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
``sm_90a`` into ``build/kernels/lib<name>.so`` at the root of the
checkout (a directory ``.gitignore`` lists) on first use, and ``load``
opens the library with ctypes.  A library older than its source, or than
a shared header ``csrc/*.cuh``, is rebuilt.  ``build`` starts one
``nvcc`` per stale source, all at once, so a script that needs every
kernel pays for the slowest build only.  A host C++ source
(``csrc/<name>.cpp``) is built the same way with ``g++`` and opened with
``load_host``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("dot_scores", "bpr_epoch", "gmf_epoch", "mlp_epoch", "rows_epoch",
           "cml_epoch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit on the machine that has the GPU")


def paths(name: str) -> tuple[str, str, str]:
    """(source, library, compiler log) of kernel source ``name``."""
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"),
            os.path.join(BUILD_DIR, f"{name}.log"))


def _stale(name: str) -> bool:
    src, lib, _ = paths(name)
    if not os.path.exists(lib):
        return True
    inputs = [src, *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return os.path.getmtime(lib) < max(map(os.path.getmtime, inputs))


def build(names=SOURCES) -> None:
    """Compile every stale source in ``names``, all ``nvcc`` processes at
    once.  Raises with the compiler's log if any fails; the log (with
    ``-Xptxas -v`` register and spill counts) stays in ``BUILD_DIR``."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    try:
        for name in todo:
            src, lib, log = paths(name)
            tmp = f"{lib}.{os.getpid()}.tmp"
            with open(log, "w") as f:
                procs.append((name, tmp, lib, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                    stdout=f, stderr=subprocess.STDOUT)))
        failed = []
        for name, tmp, lib, log, p in procs:
            if p.wait() == 0:
                os.replace(tmp, lib)   # atomic: no reader sees half a file
            else:
                with open(log) as f:
                    failed.append(f"{name}:\n{f.read()}")
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if stale."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(paths(name)[1])
        return _libs[name]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of host source ``csrc/<name>.cpp``, built with
    ``g++`` into ``BUILD_DIR`` if missing or older than its source.
    Raises with the compiler's output if the build fails."""
    src = os.path.join(CSRC, f"{name}.cpp")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _lock:
        if name not in _libs:
            if (not os.path.exists(lib)
                    or os.path.getmtime(lib) < os.path.getmtime(src)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                done = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, src],
                                      capture_output=True, text=True)
                if done.returncode:
                    raise RuntimeError(f"g++ failed for {name}:\n"
                                       f"{done.stdout}{done.stderr}")
                os.replace(tmp, lib)   # atomic: no reader sees half a file
            _libs[name] = ctypes.CDLL(lib)
        return _libs[name]
