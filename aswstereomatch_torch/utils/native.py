"""ctypes bindings for the native host codec, ``native/stereoio.cpp``.

The counterpart of ``aswstereomatch_tpu.utils.native``, with its functions
and signatures: PNM / PFM / PNG decode and encode, and the bad-delta / EPE
reductions, in a zero-dependency C++ library (zlib aside).  This is a host
codec, not a device path.

The library is compiled from the repository's ``native/stereoio.cpp`` at
first use, with the flags of ``native/Makefile`` (``g++ -O3 -std=c++17
-fPIC -shared ... -lz``), into ``_native_build/<key>/`` beside this file
(listed in .gitignore), keyed by a hash of the source, the compiler and
the flags.  Concurrent first users (test workers, processes) each compile into
a private directory and the first to finish publishes with an atomic
rename.  ``available()`` is False when no compiler or no zlib is found
(``build_error()`` then holds the compiler's words); the pure-Python PNM /
PFM paths of ``utils/io.py`` and ``utils/evaluate.py`` are the alternative.
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
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "stereoio.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_native_build"
LIB_NAME = "libstereoio.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _build_key() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([_cxx(), *CXX_FLAGS]).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Path of the compiled library for the current source, compiling it
    first if needed; raises ``OSError`` (compiler missing) or
    ``subprocess.CalledProcessError`` (compile failed)."""
    final = BUILD_ROOT / _build_key()
    lib = final / LIB_NAME
    if lib.exists():
        return lib
    tmp = BUILD_ROOT / f".tmp-{os.getpid()}-{threading.get_ident()}-{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    try:
        subprocess.run(
            [_cxx(), *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE), "-lz"],
            check=True, capture_output=True, text=True, timeout=300,
        )
        try:
            os.replace(tmp, final)
        except OSError:
            if not lib.exists():  # not a lost race with another compile
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sio_pnm_header.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 3
    lib.sio_read_pnm.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.sio_write_pgm.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.sio_pfm_header.argtypes = lib.sio_pnm_header.argtypes
    lib.sio_read_pfm.argtypes = lib.sio_read_pnm.argtypes
    lib.sio_png_header.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 4
    lib.sio_read_png.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    for name in ("sio_write_png_gray8", "sio_write_png_rgb8",
                 "sio_write_png_gray16"):
        getattr(lib, name).argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
    for name in ("sio_pnm_header", "sio_read_pnm", "sio_write_pgm", "sio_pfm_header",
                 "sio_read_pfm", "sio_png_header", "sio_read_png", "sio_write_png_gray8",
                 "sio_write_png_rgb8", "sio_write_png_gray16"):
        getattr(lib, name).restype = ctypes.c_int
    lib.sio_bad_delta.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_float,
    ]
    lib.sio_bad_delta.restype = ctypes.c_double
    lib.sio_epe.argtypes = lib.sio_bad_delta.argtypes[:4]
    lib.sio_epe.restype = ctypes.c_double
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Compile (once per source) and load the library once per process;
    None when it cannot be built or loaded."""
    global _lib, _tried, _error
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(str(library_path())))
            except subprocess.CalledProcessError as e:
                _error = f"{' '.join(e.cmd)} failed ({e.returncode}):\n{e.stderr}"
            except (OSError, subprocess.TimeoutExpired) as e:
                _error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's words), else None."""
    _load()
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native stereoio library unavailable (needs g++ and zlib: "
            f"{_error}); pure-Python fallbacks live in utils.io / utils.evaluate"
        )
    return lib


def _read(header, read, path: str, bit_depth: bool = False) -> np.ndarray:
    h, w, c, bd = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    dims = [ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)]
    rc = header(path.encode(), *dims, *([ctypes.byref(bd)] if bit_depth else []))
    if rc:
        raise IOError(f"{header.__name__}({path}) -> {rc}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = read(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise IOError(f"{read.__name__}({path}) -> {rc}")
    return out[..., 0] if c.value == 1 else out


def read_pnm(path: str) -> np.ndarray:
    """Native PNM decode -> float32 (H,W) or (H,W,3) on the [0,255] grid."""
    lib = _require()
    return _read(lib.sio_pnm_header, lib.sio_read_pnm, path)


def read_pfm(path: str) -> np.ndarray:
    lib = _require()
    return _read(lib.sio_pfm_header, lib.sio_read_pfm, path)


def read_png(path: str) -> np.ndarray:
    """Native PNG decode (8/16-bit gray/RGB, alpha dropped) -> float32.

    8-bit samples come back on [0,255]; 16-bit on the raw [0,65535] grid
    (KITTI-convention scaling is the caller's job — same contract as PNM).
    """
    lib = _require()
    return _read(lib.sio_png_header, lib.sio_read_png, path, bit_depth=True)


def write_png(path: str, img: np.ndarray, bit_depth: int = 8) -> None:
    """Native PNG encode: float32 (H,W) gray (8- or 16-bit) or (H,W,3) RGB."""
    lib = _require()
    arr = np.ascontiguousarray(img, dtype=np.float32)
    if arr.ndim == 3 and arr.shape[2] == 3:
        if bit_depth != 8:
            raise ValueError("RGB PNG encode supports bit_depth=8 only")
        fn = lib.sio_write_png_rgb8
    elif arr.ndim == 2:
        fn = lib.sio_write_png_gray16 if bit_depth == 16 else lib.sio_write_png_gray8
    else:
        raise ValueError(f"unsupported image shape {arr.shape}")
    rc = fn(path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
            arr.shape[0], arr.shape[1])
    if rc:
        raise IOError(f"png encode({path}) -> {rc}")


def write_pgm(path: str, img: np.ndarray) -> None:
    lib = _require()
    arr = np.ascontiguousarray(img, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError(f"PGM encode takes an (H, W) image, got shape {arr.shape}")
    rc = lib.sio_write_pgm(
        path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
        arr.shape[0], arr.shape[1],
    )
    if rc:
        raise IOError(f"sio_write_pgm({path}) -> {rc}")


def _pair(a: np.ndarray, b: np.ndarray, valid: Optional[np.ndarray]):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if b.size != a.size:
        raise ValueError(f"size mismatch: {a.shape} vs {b.shape}")
    v = None if valid is None else np.ascontiguousarray(valid, np.uint8)
    if v is not None and v.size != a.size:
        raise ValueError(f"valid mask {v.shape} does not match {a.shape}")
    return a, b, v


def _ptr(arr: Optional[np.ndarray]):
    return None if arr is None else arr.ctypes.data_as(ctypes.c_void_p)


def bad_delta(
    a: np.ndarray, b: np.ndarray, delta: float, valid: Optional[np.ndarray] = None
) -> float:
    lib = _require()
    a, b, v = _pair(a, b, valid)
    return float(lib.sio_bad_delta(_ptr(a), _ptr(b), _ptr(v), a.size, delta))


def epe(a: np.ndarray, b: np.ndarray, valid: Optional[np.ndarray] = None) -> float:
    lib = _require()
    a, b, v = _pair(a, b, valid)
    return float(lib.sio_epe(_ptr(a), _ptr(b), _ptr(v), a.size))
