"""Properties of the port package that hold on any host."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from fastfourierconvolution_tpu_torch import Generator
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
