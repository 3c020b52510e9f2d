"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles, on first use, to an object file — one
nvcc per source, all started together — and the objects link into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), written to ``_build/`` inside the package (gitignored) and
rebuilt when a source, or a header (``csrc/*.cuh``) the sources share, is
newer than it. The same idiom as the JAX package's
``data/native_loader.py``: build with a subprocess, load with ``ctypes``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
There is no fallback: a missing nvcc, a failed build or a failed load raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
LIB_NAME = "liblvg_kernels.so"

# Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Shared memory one block may use on Hopper (dynamic, above 48 KB only after
# cudaFuncSetAttribute, which each entry point does).
SMEM_PER_BLOCK = 227 * 1024
# Where nvcc is looked for after $PATH.
NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)

_LOCK = threading.Lock()
_LIB = None
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
# Filled by the build that produced the loaded library (empty when an
# up-to-date library was reused): nvcc's ``-Xptxas -v`` report and seconds.
build_info: Dict[str, object] = {"log": "", "seconds": None}


def find_nvcc() -> str:
    """Path of nvcc: ``$PATH``, then ``$CUDA_HOME/bin``, then the default
    toolkit location. Raises ``RuntimeError`` if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cands = list(NVCC_CANDIDATES)
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for cand in cands:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on $PATH, in $CUDA_HOME/bin and at "
        f"{', '.join(NVCC_CANDIDATES)}): the port's CUDA kernels are built "
        f"from {CSRC_DIR} on first use and have no fallback")


def sources() -> Sequence[Path]:
    """The CUDA sources the library is built from."""
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> Sequence[Path]:
    """The headers the sources include: not compiled on their own, but a
    change to one makes the library stale."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``_build/liblvg_kernels.so`` unless a
    library exists that is no older than every source and header. Returns
    its path."""
    srcs = sources()
    lib = BUILD_DIR / LIB_NAME
    if (not force and lib.exists()
            and all(lib.stat().st_mtime >= s.stat().st_mtime for s in [*srcs, *headers()])):
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    failed = [(src, proc.returncode, log)
              for src, proc, log in zip(srcs, procs, logs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(("link", link.returncode, link.stdout + link.stderr))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src} (exit {rc}):\n{log}" for src, rc, log in failed))
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    build_info.update(log="".join(logs), seconds=seconds)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.lvg_cuda_error_string.restype = ctypes.c_char_p
            lib.lvg_cuda_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


def kernel(name: str, argtypes: Sequence[type]) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the kernel library, typed: pointers and
    the stream as ``c_void_p`` (a bare int would be cut to 32 bits),
    returning a ``cudaError_t`` as ``int``."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().lvg_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")
