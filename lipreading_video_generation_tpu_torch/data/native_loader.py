"""ctypes bindings for the port's native prefetch loader.

Port of ``lipreading_video_generation_tpu/data/native_loader.py``: the C++
thread pool of ``csrc/prefetch_loader.cpp`` reads fixed-size records, one
file each, into a bounded ring while the trainer computes, and this module
hands them out as numpy arrays. The library is built with ``g++`` on first
use (and again when the source is newer) into the package's gitignored
``_build/libprefetch.so``: to a file tagged by the process id, then
``os.replace``, so processes that build at once never load half a library
(the same idiom as ``ops/_build.py`` for the CUDA kernels).

``native_available()`` is False only where there is no C++ compiler (and no
library built already); a compiler that fails raises, so a broken build is
never taken for a machine without one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC = _PKG_DIR / "csrc" / "prefetch_loader.cpp"
BUILD_DIR = _PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libprefetch.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB = None
# Filled by the build that produced the loaded library (empty when an
# up-to-date library was reused): the compiler and seconds.
build_info: Dict[str, object] = {"compiler": None, "seconds": None}


def find_compiler() -> Optional[str]:
    """Path of ``g++`` (or ``c++``) on ``$PATH``, or None."""
    return shutil.which("g++") or shutil.which("c++")


def _fresh() -> bool:
    return LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SRC.stat().st_mtime


def build(force: bool = False) -> Path:
    """Compile ``csrc/prefetch_loader.cpp`` into ``_build/libprefetch.so``
    unless a library no older than the source exists. Returns its path;
    raises ``RuntimeError`` without a compiler or when it fails."""
    if not force and _fresh():
        return LIB_PATH
    cxx = find_compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++) on $PATH to build {SRC}")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SRC} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)   # atomic: a concurrent loader never sees half a file
    build_info.update(compiler=cxx, seconds=time.perf_counter() - t0)
    return LIB_PATH


def _lib() -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.pl_create.restype = ctypes.c_void_p
            lib.pl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                      ctypes.c_size_t, ctypes.c_int, ctypes.c_int]
            lib.pl_next.restype = ctypes.c_int
            lib.pl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                                    ctypes.c_int]
            lib.pl_destroy.restype = None
            lib.pl_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the native route can run here: False without a C++ compiler
    and without a built library; otherwise the library is built and loaded
    (a failed build raises)."""
    if find_compiler() is None and not _fresh():
        return False
    _lib()
    return True


def write_record_file(path: str, array: np.ndarray) -> None:
    """Write one fixed-shape record (raw bytes, C order)."""
    np.ascontiguousarray(array).tofile(path)


class NativePrefetchLoader:
    """Iterate the records of ``paths`` as (file index, array), read ahead
    into a ring of ``capacity`` records by ``num_threads`` C++ threads.
    With more than one thread the order is the order reads finish. A read
    that fails raises ``IOError``; ``timeout_ms`` without a record ends the
    stream, as the end of the files does."""

    def __init__(self, paths: Sequence[str], record_shape: Tuple[int, ...], dtype=np.uint8,
                 capacity: int = 8, num_threads: int = 2, timeout_ms: int = 60000):
        self.paths = list(paths)
        self.shape = tuple(record_shape)
        self.dtype = np.dtype(dtype)
        self.record_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self.timeout_ms = timeout_ms
        self._lib = _lib()
        # the C side copies the strings; this array only has to live for the call
        arr = (ctypes.c_char_p * len(self.paths))(*[os.fsencode(p) for p in self.paths])
        self._handle = self._lib.pl_create(arr, len(self.paths), self.record_bytes, capacity,
                                           num_threads)
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        buf = np.empty(self.record_bytes, np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        while True:
            idx = self._lib.pl_next(self._handle, ptr, self.timeout_ms)
            if idx == -1:
                break
            if idx < -1:
                raise IOError(f"failed to read record {-2 - idx}: {self.paths[-2 - idx]!r}")
            yield idx, buf.view(self.dtype).reshape(self.shape).copy()

    def close(self) -> None:
        if not self._closed:
            self._lib.pl_destroy(self._handle)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown may have torn ctypes down
            pass
