"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own, by one ``nvcc`` process,
into a shared library with a plain C interface; all the processes are
started together. Only sources inside the package go into a build. A
library's file name carries a hash of its source, of every ``csrc/*.cuh``
header and of the flags, so a changed source or header builds anew and an
unchanged one is reused. Building happens at
the first use of a kernel, never at import, so the CPU-only tests can
import every module. ``launch`` calls an entry point on PyTorch's current
stream; every kernel wrapper of the port goes through it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.

    Returns {source stem: library path}. The compiler's output (ptxas
    register and shared-memory report included) is kept beside each
    library as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {stem: _library_path(src) for stem, src in sources().items()}
    jobs = []
    for stem, src in sources().items():
        out = libs[stem]
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, out, tmp, proc))
    failures = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        Path(str(out) + ".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return libs


@functools.cache
def _libraries() -> Dict[str, ctypes.CDLL]:
    return {stem: ctypes.CDLL(str(path)) for stem, path in build_all().items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building all
    sources at the first call)."""
    return _libraries()[stem]


def launch(entry, index: int, *args) -> int:
    """Calls the C entry point ``entry`` with ``args`` and, last, the raw
    current stream of CUDA device ``index`` (``tensor.get_device()`` of an
    operand); returns its cudaError_t. Enters ``torch.cuda.device`` only
    when ``index`` is not the current device, since the kernel launches on
    the current one. An operand on the card means CUDA is initialised, so
    the current device is read without ``torch.cuda``'s Python layer."""
    if index == torch._C._cuda_getDevice():
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
