"""A cache of constant tensors that tracing does not fill or read.

The port builds a few small constant tensors (DFT factor matrices,
bilinear weights) once per shape, dtype and device and hands the same
tensor to every caller: a captured CUDA graph reads the tensor the eager
step before the capture built, and nothing writes to it. While
``torch.export`` traces a forward, the tensors are fake; cached then,
they would be handed to every later eager caller in the process. So
under a fake mode the tensor is built anew for the trace and the cache
is left alone.
"""

from __future__ import annotations

import functools

import torch


def tracing() -> bool:
    """True while a fake mode is active (``torch.export`` tracing)."""
    return torch._guards.detect_fake_mode() is not None


def tensor_cache(build):
    """``build(*key) -> tensor`` cached per key outside tracing, built anew
    (and not cached) while :func:`tracing`."""
    cached = functools.lru_cache(maxsize=None)(build)

    @functools.wraps(build)
    def get(*key):
        return build(*key) if tracing() else cached(*key)

    get.cache_clear = cached.cache_clear
    return get
