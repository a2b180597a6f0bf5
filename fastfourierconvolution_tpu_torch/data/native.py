"""The native batcher (``native/ffc_batcher.cpp``) through ctypes, the JAX
package's ``data/native.py``: a multithreaded gather + ``x * (1/127.5) - 1``
normalisation (+ horizontal flip) of uint8 images into float32, and an
xorshift Fisher-Yates shuffle.

The library is ``native/libffc_batcher.so`` where that file exists and
loads (``make -C native`` writes it). Otherwise the port builds
``native/ffc_batcher.cpp`` with the Makefile's flags into
``fastfourierconvolution_tpu_torch/_build/`` (the file name carries a hash
of the source and the flags, so a build is reused until either changes),
never into ``native/``. Where no library loads, the compiler's message is
printed once to stderr and ``gather_normalize`` and ``shuffle_indices``
return None: the loader then takes its numpy path, as the JAX loader does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCE = NATIVE_DIR / "ffc_batcher.cpp"
PREBUILT = NATIVE_DIR / "libffc_batcher.so"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS and link flag
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_path: Optional[Path] = None
_tried = False


def built_path() -> Path:
    """Where the port builds the library: ``_build/`` under a name that
    carries the hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libffc_batcher-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the source into :func:`built_path` (atomically: a temporary
    file renamed) unless it is there; raises RuntimeError with the
    compiler's message on failure."""
    out = built_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.ffc_gather_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ffc_gather_normalize.restype = None
    lib.ffc_shuffle_indices.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
    lib.ffc_shuffle_indices.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, found or built at the first call; None where
    neither works (the reason printed to stderr once)."""
    global _lib, _path, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        errors = []
        if PREBUILT.exists():
            try:
                _lib, _path = _load(PREBUILT), PREBUILT
                return _lib
            except OSError as e:
                errors.append(f"{PREBUILT}: {e}")
        try:
            path = _build()
            _lib, _path = _load(path), path
        except (OSError, RuntimeError) as e:
            errors.append(str(e))
            print("WARNING: the native batcher is unavailable, the loader normalises with "
                  "numpy:\n" + "\n".join(errors), file=sys.stderr)
        return _lib


def library_path() -> Optional[Path]:
    """The file the library was loaded from (None where none loads)."""
    get_lib()
    return _path


def available() -> bool:
    return get_lib() is not None


def gather_normalize(images: np.ndarray, indices: np.ndarray, hflip: bool = False,
                     n_threads: int = 0) -> Optional[np.ndarray]:
    """``images[indices] * float32(1/127.5) - 1`` as (B, H, W, C) float32,
    each image flipped left to right with ``hflip``, on ``n_threads``
    threads (0: the hardware's); None where the library is unavailable.
    ``images`` must be a C-contiguous (N, H, W, C) uint8 array and every
    index within [0, N); anything else raises ValueError."""
    if not isinstance(images, np.ndarray) or images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images must be a (N, H, W, C) uint8 array, got "
                         f"{getattr(images, 'dtype', type(images))} of shape "
                         f"{getattr(images, 'shape', None)}")
    if not images.flags["C_CONTIGUOUS"]:
        raise ValueError("images must be C-contiguous")
    idx = np.asarray(indices)
    if idx.ndim != 1 or not (idx.dtype.kind in "iu" or idx.size == 0):
        raise ValueError(f"indices must be a 1-d integer array, got {idx.dtype} of shape "
                         f"{idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= images.shape[0]):
        raise ValueError(f"indices must lie in [0, {images.shape[0]}), got "
                         f"[{idx.min()}, {idx.max()}]")
    if int(n_threads) < 0:
        raise ValueError(f"n_threads must be 0 or more, got {n_threads}")
    lib = get_lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _, h, w, c = images.shape
    out = np.empty((idx.shape[0], h, w, c), np.float32)
    lib.ffc_gather_normalize(images.ctypes.data, idx.ctypes.data, idx.shape[0], h, w, c,
                             out.ctypes.data, 1 if hflip else 0, int(n_threads))
    return out


def loader_threads(out_bytes: int) -> int:
    """The threads ``DataLoader`` asks for a batch of ``out_bytes`` float32
    bytes: one per 4 MiB, at least 1, at most the cores this process may
    use. The library starts its threads per call, and a thread's start
    costs about what one thread normalises of 4 MiB (0.3 ms on the H100
    machine's host, ``chip_smoke.py`` phase 33); the count does not change
    the bits."""
    return max(1, min(len(os.sched_getaffinity(0)), int(out_bytes) >> 22))


def shuffle_indices(n: int, seed: int) -> Optional[np.ndarray]:
    """A permutation of ``range(n)`` (int64) by the library's xorshift
    Fisher-Yates shuffle from ``seed`` (an unsigned 64-bit integer); None
    where the library is unavailable."""
    if int(n) < 0:
        raise ValueError(f"n must be 0 or more, got {n}")
    if not 0 <= int(seed) < 2 ** 64:
        raise ValueError(f"seed must be an unsigned 64-bit integer, got {seed}")
    lib = get_lib()
    if lib is None:
        return None
    idx = np.arange(int(n), dtype=np.int64)
    lib.ffc_shuffle_indices(idx.ctypes.data, int(n), int(seed))
    return idx
