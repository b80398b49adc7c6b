"""ctypes binding to the native host runtime (native/kitti_reader.cpp).

Brings the shared library up to date on first use (g++ via
native/Makefile, a no-op when it is current); falls back cleanly to
pure-numpy readers when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libmld_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            if not _LIB_PATH.exists():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.mld_png_unfilter  # an out-of-date build lacks it
        except (OSError, AttributeError):
            _build_failed = True
            return None
        lib.mld_read_velodyne.restype = ctypes.c_int64
        lib.mld_read_velodyne.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.mld_loader_create.restype = ctypes.c_void_p
        lib.mld_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.mld_loader_next.restype = ctypes.c_int64
        lib.mld_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.mld_loader_destroy.restype = None
        lib.mld_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.mld_png_unfilter.restype = ctypes.c_int64
        lib.mld_png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_velodyne_native(path: str, max_points: int) -> tuple[np.ndarray, int]:
    """Read one velodyne .bin into a padded [max_points, 4] array.
    Returns (xyzi, n_points).  Raises if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.zeros((max_points, 4), dtype=np.float32)
    n = lib.mld_read_velodyne(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_points)
    if n < 0:
        raise FileNotFoundError(path)
    return out, int(n)


def png_unfilter_native(rows: np.ndarray) -> np.ndarray:
    """[H, W + 1] uint8 scanlines (filter byte first) → [H, W] uint8
    pixels.  Raises if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    h, w = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, w), np.uint8)
    if lib.mld_png_unfilter(rows.ctypes.data, h, w, out.ctypes.data) != 0:
        raise ValueError("unknown PNG filter type")
    return out


class NativeScanLoader:
    """Ordered prefetching loader over a list of velodyne files."""

    def __init__(self, paths: list[str], max_points: int,
                 depth: int = 4, threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._max_points = max_points
        blob = b"".join(p.encode() + b"\0" for p in paths)
        self._handle = lib.mld_loader_create(
            blob, len(paths), max_points, depth, threads)
        self._n = len(paths)
        self._consumed = 0

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, int]:
        if self._handle is None or self._consumed >= self._n:
            raise StopIteration
        out = np.empty((self._max_points, 4), dtype=np.float32)
        n = self._lib.mld_loader_next(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n == -2:
            raise StopIteration
        self._consumed += 1
        if n < 0:
            raise IOError(f"read error at scan {self._consumed - 1}")
        return out, int(n)

    def close(self):
        if self._handle is not None:
            self._lib.mld_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
