"""Properties of the port package that hold on any host."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from fastfourierconvolution_tpu_torch import (
    FFCGenerator,
    GANTrainer,
    Generator,
    SNConvDiscriminator,
)
from fastfourierconvolution_tpu_torch.ops import _build
from fastfourierconvolution_tpu_torch.utils.policy import resolve_device


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports with jax and the JAX package left
    out of sys.modules."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import fastfourierconvolution_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'fastfourierconvolution_tpu'\n"
        "             or n.startswith('fastfourierconvolution_tpu.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator.from_preset(32)
    g = FFCGenerator(z_size=8, ngf=4, mg=2, channel_mults=(2, 1))
    d = SNConvDiscriminator(ladder=((4, 4, 2),), head_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GANTrainer(g, d, z_size=8, fused_dis_batch=True)


def test_library_key_covers_every_header(tmp_path, monkeypatch):
    """A library's file name changes when its source or any csrc header
    changes, so an edited header never reuses a stale build; it stays the
    same when nothing changed."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    first = _build._library_path(src)
    assert _build._library_path(src) == first
    header.write_text("// v2\n")
    second = _build._library_path(src)
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build._library_path(src) != second
    src.write_text('#include "common.cuh"\n// edited\n')
    assert len({first, second, _build._library_path(src)}) == 3
