"""Image / disparity I/O and ground-truth scaling.

A NumPy copy of ``aswstereomatch_tpu.utils.io`` (that package cannot be
imported without jax); tests/test_torch_host_io.py holds its reads and
writes equal to the reference's, byte for byte.  Pure-Python/NumPy
decoders for PGM/PPM and PFM (the Middlebury formats); PNG through the
port's native codec (``utils/native.py``, built from ``native/stereoio.cpp``
at first use), cv2 only as a last resort.

Ground-truth conventions:
  - Middlebury 2001/2003 8-bit GT is stored scaled: Tsukuba x16, Venus x8,
    Teddy/Cones x4 -> divide by the scale to get float disparity.
  - KITTI GT is uint16 PNG scaled by 256 -> divide by 256; 0 means invalid.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np

GT_SCALES = {
    "tsukuba": 16.0,
    "venus": 8.0,
    "teddy": 4.0,
    "cones": 4.0,
    "kitti": 256.0,
}


def _try_cv2():
    try:
        import cv2  # noqa: F401

        return cv2
    except Exception:  # pragma: no cover
        return None


# ---------------------------------------------------------------------------
# PNM (PGM / PPM) — pure NumPy
# ---------------------------------------------------------------------------

def read_pnm(path: str) -> np.ndarray:
    """Read binary PGM (P5) / PPM (P6). Returns float32 (H,W) or (H,W,3) in [0,255]."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, whitespace/comments, width, height, maxval.
    tokens = []
    pos = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[pos:])
        if m is None:
            raise ValueError(f"bad PNM header in {path}")
        tok = m.group(1)
        pos += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    pos += 1  # single whitespace after maxval
    if magic == b"P5":
        ch = 1
    elif magic == b"P6":
        ch = 3
    else:
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    arr = np.frombuffer(data, dtype=dtype, count=w * h * ch, offset=pos)
    arr = arr.reshape(h, w, ch) if ch == 3 else arr.reshape(h, w)
    return arr.astype(np.float32)


def write_pgm(path: str, img: np.ndarray) -> None:
    arr = np.clip(np.round(img), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr.tobytes())


# ---------------------------------------------------------------------------
# PFM — Middlebury 2005+ float disparity format
# ---------------------------------------------------------------------------

def read_pfm(path: str) -> np.ndarray:
    """Read PFM; returns float32 (H,W) or (H,W,3), top row first."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"Pf", b"PF"):
            raise ValueError(f"not a PFM file: {path}")
        ch = 3 if magic == b"PF" else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4")
        data = data[: w * h * ch].reshape(h, w, ch) if ch == 3 else data[
            : w * h
        ].reshape(h, w)
        # PFM scanlines are bottom-to-top.
        return np.ascontiguousarray(data[::-1]).astype(np.float32)


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.float32)
    ch = 1 if img.ndim == 2 else img.shape[2]
    with open(path, "wb") as f:
        f.write(b"Pf\n" if ch == 1 else b"PF\n")
        f.write(b"%d %d\n" % (img.shape[1], img.shape[0]))
        f.write(b"-1.0\n")  # little-endian
        f.write(np.ascontiguousarray(img[::-1]).tobytes())


# ---------------------------------------------------------------------------
# Generic front door
# ---------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    """Read an image as float32 RGB (H,W,3) or gray (H,W) in [0,255]."""
    if not os.path.exists(path):
        # Checked up front: the native decoder reports I/O failure as
        # IOError, which the fallback chain would otherwise misreport as
        # "codec missing" when cv2 is absent.
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        return read_pnm(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".png":
        # Native zero-dependency decoder (8/16-bit gray/RGB incl. KITTI
        # uint16 ground truth); cv2 only as a fallback for exotic variants
        # (palette, interlace).
        from . import native

        if native.available():
            try:
                return native.read_png(path)
            except IOError:
                pass  # unsupported variant -> try cv2
    cv2 = _try_cv2()
    if cv2 is None:
        raise RuntimeError(
            f"reading {ext} requires the native codec (g++ and zlib) or "
            "cv2, or use PGM/PPM/PFM"
        )
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img.astype(np.float32)


def read_gt_disparity(path: str, dataset: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a ground-truth disparity map.

    Returns (disparity float32, valid-mask bool).  ``dataset`` selects the
    scale convention (see GT_SCALES); for KITTI, 0 marks invalid pixels.
    """
    raw = read_image(path)
    if raw.ndim == 3:
        raw = raw[..., 0]
    scale = GT_SCALES.get(dataset.lower())
    if scale is None:
        raise KeyError(f"unknown dataset {dataset!r}; known: {sorted(GT_SCALES)}")
    disp = raw / scale
    valid = raw > 0 if dataset.lower() == "kitti" else np.isfinite(disp)
    return disp.astype(np.float32), valid


def save_disparity_png(path: str, disp: np.ndarray, max_disparity: int) -> None:
    """Save a disparity map as an 8-bit visualization PNG (or PGM fallback)."""
    vis = np.clip(disp / max(max_disparity - 1, 1) * 255.0, 0, 255)
    if path.lower().endswith(".png"):
        from . import native

        if native.available():
            native.write_png(path, vis)
            return
        cv2 = _try_cv2()
        if cv2 is not None:
            cv2.imwrite(path, vis.astype(np.uint8))
            return
    write_pgm(os.path.splitext(path)[0] + ".pgm", vis)


def save_disparity_gt_png(path: str, disp: np.ndarray) -> None:
    """Save a disparity map as KITTI-convention uint16 PNG (disp*256; 0 =
    invalid) via the native encoder — round-trips through
    ``read_gt_disparity(path, "kitti")``."""
    from . import native

    native.write_png(path, np.asarray(disp, np.float32) * 256.0, bit_depth=16)
