"""ctypes bindings for the native C++ image decoder (``native/loader.cpp``).

The port binds the same source as the JAX package's ``data/native.py``.
On first use it is built with ``g++`` into ``build/native/`` at the root of
the checkout (the file name carries a hash of the source, so an edited
source is rebuilt; the library is written under a temporary name and
renamed, so processes building at once never load a half-written file).
It exposes:

- ``decode_jpeg_rgb(path, h, w)``    -> uint8 (h, w, 3), DCT-scaled decode
- ``decode_png_mask(path, h, w)``    -> int32 (h, w), nearest resize
- ``mask_class_histogram(path, C)``  -> int64 (C,), native-resolution counts

This is a host decoder, not a device kernel.  ``available()`` is False
when ``g++``, libjpeg or libpng is missing (or ``UDA_TPU_NO_NATIVE`` is
set), and callers then decode with cv2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "loader.cpp"
BUILD_DIR = _ROOT / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build(src: Path) -> Optional[Path]:
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libuda_loader_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(src),
           "-o", tmp, "-ljpeg", "-lpng", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        print(f"native loader build failed ({e}); decoding with cv2. {detail[:400]!r}")
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("UDA_TPU_NO_NATIVE") or not _SRC.exists():
        return None
    path = _build(_SRC)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        print(f"native loader dlopen failed: {e}")
        return None
    lib.uda_decode_jpeg_rgb.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int]
    lib.uda_decode_jpeg_rgb.restype = ctypes.c_int
    lib.uda_decode_png_mask.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int]
    lib.uda_decode_png_mask.restype = ctypes.c_int
    lib.uda_mask_class_histogram.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                             ctypes.c_int]
    lib.uda_mask_class_histogram.restype = ctypes.c_longlong
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def decode_jpeg_rgb(path: str, h: int, w: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.uda_decode_jpeg_rgb(str(path).encode(), out.ctypes.data, h, w)
    return out if rc == 0 else None


def decode_png_mask(path: str, h: int, w: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w), dtype=np.int32)
    rc = lib.uda_decode_png_mask(str(path).encode(), out.ctypes.data, h, w)
    return out if rc == 0 else None


def mask_class_histogram(path: str, num_classes: int):
    """(int64 counts of the values 0..num_classes-1, pixel total) of one PNG
    mask at its own resolution, or None when it cannot be decoded."""
    lib = _load()
    if lib is None:
        return None
    counts = np.zeros(num_classes, dtype=np.int64)
    total = lib.uda_mask_class_histogram(str(path).encode(), counts.ctypes.data,
                                         num_classes)
    return (counts, int(total)) if total >= 0 else None
