"""Rematerialised model applies: the JAX package's ``jax.checkpoint`` of a
differentiated apply (JAX ``GANTrainer._maybe_remat``), for modules with
side effects.

:func:`checkpointed` runs a function under
``torch.utils.checkpoint.checkpoint`` (non-reentrant): the forward keeps
only what the policy saves, and the backward runs the function again to
get the rest. ``"full"`` saves only the function's inputs; ``"dots"``
also keeps the outputs of the convolutions and matrix products computed
with gradients on (``DOT_OPS``, the ops of
``jax.checkpoint_policies.dots_saveable``) and recomputes everything
else. It is a selective checkpoint built on two dispatch modes
(``_KeepDots``, ``_ReplayDots``) rather than torch's
``create_selective_checkpoint_contexts``, which raises where a region is
recomputed twice, as the gradient penalty's double backward through D
recomputes D's. A kept output is handed to the first recompute and
dropped there (the recomputed graph holds it from then on as long as its
backward needs it); a later recompute of the region computes the
products again.
A custom autograd Function is opaque to that policy: the FourierUnit
training op and the packed BN + GELU op run their forward with gradients
off, so ``"dots"`` keeps nothing computed inside them (on the CPU, their
plain versions' products included), and the recompute runs their forward
again, launching their forward kernels, to rebuild what they save for
their backward.

A model forward has side effects that a second run must not repeat, and
values that a second run must not draw anew:

- BatchNorm running statistics (every ``layers.update_running_``): not
  updated in a recompute (:func:`recomputing`);
- a spectral-normed layer's ``u``: the first run stashes the ``u`` it
  starts from (:func:`stash`) and the recompute runs the same power
  iteration from that stash, so both runs normalise by the same sigma;
  only the first run stores the new ``u``;
- random draws (the generator's noise, input noise): the first run
  records each draw (:func:`recorded`) and the recompute replays them in
  order, so it touches no ``torch.Generator``.

So ``preserve_rng_state`` stays off: the models draw only from the
trainer's own generators, which it would not cover, and it would read
and set the default generators' state inside a captured CUDA graph. A
recompute runs the same aten ops in the same order as the first run
(``_ReplayDots`` finds the kept outputs by that order) but for the
skipped statistics updates and draws, none of which it keeps. No step of
it reads a value to the host, so a captured step can recompute.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as _checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

MODES = (None, "none", "dots", "full")

# The ops whose outputs "dots" keeps: convolutions and matrix products, as
# seen below autograd (conv2d and conv_transpose2d reach ``convolution``;
# matmul, einsum and linear reach the products).
DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("convolution", "mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv")
)


class _Tape:
    """The values of one checkpointed call's first run, replayed in order
    by its recomputes."""

    def __init__(self):
        self.values = []
        self.replaying = False
        self.pos = 0


_state = threading.local()


def _tape() -> Optional[_Tape]:
    return getattr(_state, "tape", None)


def recomputing() -> bool:
    """Whether the running forward is a recompute of a checkpointed call."""
    tape = _tape()
    return tape is not None and tape.replaying


def recorded(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()``, except in a recompute, which gets the tensor that the
    first run's ``make()`` gave at the same point."""
    tape = _tape()
    if tape is None:
        return make()
    if tape.replaying:
        value = tape.values[tape.pos]
        tape.pos += 1
        return value
    value = make()
    tape.values.append(value)
    return value


def stash(t: torch.Tensor) -> torch.Tensor:
    """``t`` outside a checkpointed call; inside one, a copy of the value
    ``t`` held when the first run reached this point (a buffer the forward
    goes on to update)."""
    if _tape() is None:
        return t
    return recorded(lambda: t.detach().clone())


def _kept(op) -> bool:
    """Whether "dots" keeps the output of ``op``: a product computed with
    gradients on (a recompute runs with them on as its first run did)."""
    return op in DOT_OPS and torch.is_grad_enabled()


def _alias(t):
    """A new tensor on ``t``'s storage, with no autograd history of its own
    (as torch's selective checkpoint stores and returns its outputs)."""
    if not isinstance(t, torch.Tensor):
        return t
    with torch._C._SetExcludeDispatchKeyGuard(torch._C.DispatchKey.ADInplaceOrView, False):
        return t.detach()


class _KeepDots(TorchDispatchMode):
    """The first run: keeps the products' outputs, in call order."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _kept(func):
            self.kept.append(tree_map(_alias, out))
        return out


class _ReplayDots(TorchDispatchMode):
    """A recompute: each product gets the first run's output at the same
    position, once; where that output was handed out already (a second
    recompute) the product runs again. Every other op runs."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept, self.pos = kept, 0

    def __enter__(self):
        self.pos = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _kept(func):
            return func(*args, **(kwargs or {}))
        out, self.kept[self.pos] = self.kept[self.pos], None
        self.pos += 1
        return func(*args, **(kwargs or {})) if out is None else out


def _contexts(mode: str):
    if mode == "dots":
        kept = []
        return _KeepDots(kept), _ReplayDots(kept)
    return _checkpoint.noop_context_fn()


def checkpointed(mode: Optional[str], fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, rematerialised per ``mode`` (None or
    "none": run as it is)."""
    if mode not in MODES:
        raise ValueError(f"remat must be one of {MODES}, got {mode!r}")
    if mode in (None, "none"):
        return fn(*args, **kwargs)
    tape = _Tape()

    def run(*a, **k):
        outer = _tape()
        _state.tape, tape.pos = tape, 0
        try:
            return fn(*a, **k)
        finally:
            _state.tape = outer
            tape.replaying = True  # every later run is a recompute

    return _checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(_contexts, mode), **kwargs,
    )
