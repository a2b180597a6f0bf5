"""Checkpoint / resume, the JAX package's ``train/checkpoint.py``.

Step-tagged files ``{prefix}_{step}_steps.pt`` in one directory, each the
``torch.save`` of a :meth:`GANTrainer.state_dict` (models, optimizer
moments, learning-rate schedules and counts, random generators, step);
``get_latest_checkpoint`` finds the newest of one prefix family by its
step; writes are atomic (tempfile + ``os.replace``) with the mode the
umask gives; ``save_checkpoint`` prunes the family to its newest ``keep``
files. The JAX package writes flax msgpack ``.ckpt`` files, so neither
package picks up the other's.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Optional

import torch

SUFFIX = ".pt"


def _family_pattern(prefix: str) -> re.Pattern:
    """Match only ``{prefix}_{N}_steps.pt``: discovery and pruning never
    cross prefix families that share a directory."""
    return re.compile(rf"^{re.escape(prefix)}_(\d+)_steps{re.escape(SUFFIX)}$")


def checkpoint_path(directory: str, step: int, prefix: str = "ckpt") -> str:
    return os.path.join(directory, f"{prefix}_{step}_steps{SUFFIX}")


def get_latest_checkpoint(directory: str, prefix: str = "ckpt") -> Optional[str]:
    """Newest checkpoint file of the ``prefix`` family by step number, or
    None."""
    if not os.path.isdir(directory):
        return None
    pat = _family_pattern(prefix)
    best_step, best_path = -1, None
    for name in os.listdir(directory):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best_path = os.path.join(directory, name)
    return best_path


def save_checkpoint(trainer, directory: str, step: int, prefix: str = "ckpt",
                    keep: int = 3) -> str:
    """Save ``trainer.state_dict()`` to ``{directory}/{prefix}_{step}_steps.pt``
    atomically; prune the family to the newest ``keep`` files by step
    (the file just written too, if ``keep`` newer ones exist)."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step, prefix)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(trainer.state_dict(), f)
        # mkstemp creates 0600; give the file the mode a plain open would
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    if keep > 0:
        pat = _family_pattern(prefix)
        stamped = sorted(
            (int(pat.match(n).group(1)), n) for n in os.listdir(directory) if pat.match(n)
        )
        for _, name in stamped[:-keep]:
            os.unlink(os.path.join(directory, name))
    return path


def restore_checkpoint(trainer, path: str):
    """Load ``path`` into ``trainer`` (``GANTrainer.load_state_dict``, which
    copies into the live tensors); returns (trainer, step). A JAX ``.ckpt``
    file raises."""
    if not path.endswith(SUFFIX):
        raise ValueError(f"{path} is no {SUFFIX} checkpoint of the port; reading the JAX "
                         f"package's .ckpt files is not ported yet (ROADMAP queue 1 item 6)")
    # on the host: the generator states must stay CPU byte tensors, and
    # load_state_dict copies everything else onto the trainer's device
    state = torch.load(path, map_location="cpu", weights_only=True)
    trainer.load_state_dict(state)
    return trainer, trainer.step


def restore_latest(trainer, directory: str, prefix: str = "ckpt"):
    """Resume from the newest checkpoint in ``directory``; returns
    (trainer, step), or (trainer, 0) untouched when there is none."""
    path = get_latest_checkpoint(directory, prefix)
    if path is None:
        return trainer, 0
    return restore_checkpoint(trainer, path)
