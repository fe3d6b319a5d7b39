"""ctypes bridge to the native decode library (native/decode.cc; the port's
copy of the JAX package's data/native.py).

The loaders keep one process and move the decode+resize hot loop to C++:
libpng decode and Pillow's bilinear resize, bit for bit. The library is
compiled from `native/decode.cc` on first use with the system g++ (plain
`-shared` + ctypes) into `build/native/` at the root of the checkout
(listed in .gitignore), named by a hash of the source, the host CPU's
feature flags (it is built with -march=native) and the ABI version, so
an edited source or another host rebuilds. Without a compiler or libpng
the build fails, the library is unavailable, and the callers decode each
file with PIL: the JAX package's own fallback, the same pixels.

Exactness: the native path returns byte-identical pixels to
`PIL.Image.open().convert("RGB").resize(..., BILINEAR)` for 8-bit
RGB/gray/palette PNGs, and REFUSES anything else (alpha, 16-bit) with a
per-file status the callers turn into a PIL decode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "decode.cc"
BUILD_DIR = _PKG.parent / "build" / "native"
_ABI = 2

_lib: ctypes.CDLL | None = None
_lib_checked = False
_lib_lock = threading.Lock()


def _machine_tag() -> str:
    """A hash of the host CPU's feature flags: a -march=native build from
    one host may not run on another that shares the checkout."""
    try:
        flags = next(
            line
            for line in Path("/proc/cpuinfo").read_text().splitlines()
            if line.startswith(("flags", "Features"))
        )
        return hashlib.sha256(flags.encode()).hexdigest()[:8]
    except (OSError, StopIteration):
        import platform

        return platform.machine() or "unknown"


def library_path() -> Path:
    src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmmrnative-{src_hash}-{_machine_tag()}-abi{_ABI}.so"


def _build(so_path: Path) -> bool:
    """Compile decode.cc -> so_path. Atomic install; safe under races."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(
        dir=so_path.parent, suffix=".so", delete=False
    ) as tmp:
        tmp_path = Path(tmp.name)
    base = [
        "g++", "-O3", "-fPIC", "-shared", str(_SRC),
        "-o", str(tmp_path), "-lpng", "-lz", "-pthread",
    ]
    for cmd in (base[:2] + ["-march=native"] + base[2:], base):
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            break
        if r.returncode == 0:
            os.replace(tmp_path, so_path)
            return True
    tmp_path.unlink(missing_ok=True)
    return False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    with _lib_lock:
        if _lib_checked:  # loader threads race here on first decode
            return _lib
        _lib = _load_locked()
        _lib_checked = True
        return _lib


def _load_locked() -> ctypes.CDLL | None:
    so_path = library_path()
    if not so_path.exists() and not _build(so_path):
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
        if lib.mmr_native_abi_version() != _ABI:
            return None
    except (OSError, AttributeError):
        return None
    lib.mmr_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mmr_decode_resize.restype = ctypes.c_int
    lib.mmr_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mmr_decode_resize_batch.restype = ctypes.c_int
    lib.mmr_encode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.mmr_encode_png.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True if the native library is loaded (built on demand)."""
    return _load() is not None


def decode_image_native(path: str, size: int) -> np.ndarray | None:
    """PNG -> uint8 (size, size, 3), byte-identical to the PIL path.

    None = library unavailable OR this file needs PIL (alpha/16-bit/
    non-PNG/decode error) — the caller must fall back.
    """
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.mmr_decode_resize(
        os.fsencode(path), size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


def save_png(arr: np.ndarray, path: str | Path, compress_level: int = 6) -> None:
    """Write an (H, W, 3) uint8 array as a PNG: the native libpng encoder
    when the library is available (the GIL released for the whole deflate),
    PIL otherwise. PNG is lossless, so the pixels read back the same
    whichever encoder wrote the file; only the container bytes differ."""
    lib = _load()
    if (
        lib is not None
        and arr.ndim == 3
        and arr.shape[2] == 3
        and arr.dtype == np.uint8
    ):
        a = np.ascontiguousarray(arr)
        rc = lib.mmr_encode_png(
            os.fsencode(str(path)),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(a.shape[1]), int(a.shape[0]), int(compress_level),
        )
        if rc == 0:
            return
    from PIL import Image

    Image.fromarray(arr).save(path)


def decode_batch_native(
    paths: list[str], size: int, threads: int = 8
) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode+resize many PNGs in parallel C++ threads (GIL released for
    the whole batch — one ctypes call).

    Returns (out (n,S,S,3) uint8, ok (n,) bool); rows with ok=False were
    refused/failed and must be filled by the PIL fallback. None = library
    unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.empty(n, np.uint8)
    if n == 0:
        return out, np.ones(0, bool)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.mmr_decode_resize_batch(
        arr, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(threads),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out, status == 0
