"""Checkpoint / resume, the JAX package's ``train/checkpoint.py``.

Step-tagged files ``{prefix}_{step}_steps.pt`` in one directory, each the
``torch.save`` of a :meth:`GANTrainer.state_dict` (models, optimizer
moments, learning-rate schedules and counts, random generators, step);
writes are atomic (tempfile + ``os.replace``) with the mode the umask
gives; ``save_checkpoint`` prunes the family's ``.pt`` files to its newest
``keep``.

The port also reads the JAX package's ``{prefix}_{step}_steps.ckpt``
files, the flax msgpack of its ``GANState`` (``train/flax_msgpack.py``
decodes them, with no JAX and no msgpack package): ``get_latest_checkpoint``
takes the newest file of the family across both suffixes, the ``.pt`` one
where a step has both, and ``restore_checkpoint`` picks the reader by the
suffix. The port writes, and prunes, ``.pt`` files alone: a ``.ckpt`` file
is never deleted.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Mapping, Optional

import numpy as np
import torch

from . import flax_msgpack

SUFFIX = ".pt"
JAX_SUFFIX = ".ckpt"
# the suffixes the port reads, the preferred one first where a step has both
_READ = (SUFFIX, JAX_SUFFIX)


def _family_pattern(prefix: str, suffixes=(SUFFIX,)) -> re.Pattern:
    """Match only ``{prefix}_{N}_steps`` with one of ``suffixes``: discovery
    and pruning never cross prefix families that share a directory."""
    alternatives = "|".join(re.escape(s) for s in suffixes)
    return re.compile(rf"^{re.escape(prefix)}_(\d+)_steps({alternatives})$")


def checkpoint_path(directory: str, step: int, prefix: str = "ckpt") -> str:
    return os.path.join(directory, f"{prefix}_{step}_steps{SUFFIX}")


def get_latest_checkpoint(directory: str, prefix: str = "ckpt") -> Optional[str]:
    """Newest checkpoint file of the ``prefix`` family by step number, ``.pt``
    or ``.ckpt`` (``.pt`` at an equal step), or None."""
    if not os.path.isdir(directory):
        return None
    pat = _family_pattern(prefix, _READ)
    best, best_path = None, None
    for name in os.listdir(directory):
        m = pat.match(name)
        if m:
            rank = (int(m.group(1)), -_READ.index(m.group(2)))
            if best is None or rank > best:
                best, best_path = rank, os.path.join(directory, name)
    return best_path


def save_checkpoint(trainer, directory: str, step: int, prefix: str = "ckpt",
                    keep: int = 3) -> str:
    """Save ``trainer.state_dict()`` to ``{directory}/{prefix}_{step}_steps.pt``
    atomically; prune the family's ``.pt`` files to the newest ``keep`` by
    step (the file just written too, if ``keep`` newer ones exist)."""
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
    copies into the live tensors): a port ``.pt`` file, or a JAX ``.ckpt``
    file through :func:`jax_trainer_state`. Returns (trainer, step)."""
    if path.endswith(JAX_SUFFIX):
        state = jax_trainer_state(trainer, flax_msgpack.read(path))
    elif path.endswith(SUFFIX):
        # on the host: the generator states must stay CPU byte tensors, and
        # load_state_dict copies everything else onto the trainer's device
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"{path}: a checkpoint ends in {SUFFIX} (the port's) or "
                         f"{JAX_SUFFIX} (the JAX package's)")
    trainer.load_state_dict(state)
    return trainer, trainer.step


def restore_latest(trainer, directory: str, prefix: str = "ckpt"):
    """Resume from the newest checkpoint in ``directory``; returns
    (trainer, step), or (trainer, 0) untouched when there is none."""
    path = get_latest_checkpoint(directory, prefix)
    if path is None:
        return trainer, 0
    return restore_checkpoint(trainer, path)


# -- the JAX package's GANState --------------------------------------------------------

_NET_KEYS = {"params", "batch_stats", "spectral", "opt_state"}
_ADAM_KEYS = {"count", "mu", "nu"}


def jax_trainer_state(trainer, tree: Mapping) -> dict:
    """:meth:`GANTrainer.state_dict`'s layout for the state dict of a JAX
    ``GANState`` (``{"step", "g", "d", "rng"}``, each net ``{"params",
    "batch_stats", "spectral", "opt_state"}``), with whole tensors as
    ``load_state_dict`` takes them:

    - each model's variables through ``bridge.jax_to_state_dict``;
    - the optax Adam entry of each ``opt_state`` chain (the one with
      ``count``, ``mu`` and ``nu``) to torch's per-parameter ``step``,
      ``exp_avg`` and ``exp_avg_sq``, the moments through the parameters'
      converters (``bridge.jax_params_to_state_dict``); AdamW's chain holds
      one more entry, the decayed weights', which is empty;
    - the schedule entry's ``count`` (``{"count"}`` alone) to the
      :class:`LinearDecay` count, and ``lr`` to what ``advance`` set for the
      last update (D's count runs ``num_dis_updates`` times per step, as
      the JAX trainer's does);
    - ``step`` to the host step and, where D takes the training progress
      (``d_progress_arg``), to its step count.

    ``rng`` has no counterpart: the trainer keeps its own generators'
    states (those its ``seed`` gave, or the ones it has advanced to), so a
    resumed run draws other latents and noise than a JAX resume would.
    A tree that does not match the trainer's models or optimizers raises
    KeyError or ValueError naming the leaf or the entry."""
    from ..bridge import jax_params_to_state_dict, jax_to_state_dict
    from ..nn.ffc import whole_fourier_units

    _want_keys(tree, {"step", "g", "d", "rng"}, "the checkpoint")
    step = int(np.asarray(tree["step"]))
    # D's progress counts the steps where D reads it (the JAX trainer reads
    # state.step), as the port's own step does
    progress = float(step) if trainer.d_progress_arg else 0.0
    state = {"step": step, "step_count": torch.tensor(progress),
             "z_generator": trainer.z_generator.get_state(),
             "noise_generator": trainer.noise_generator.get_state()}
    # under tensor parallelism the models' shapes are the whole mixes'
    with whole_fourier_units(trainer.g), whole_fourier_units(trainer.d):
        for side, model, opt, schedule in (("g", trainer.g, trainer.g_opt, trainer.g_lr),
                                           ("d", trainer.d, trainer.d_opt, trainer.d_lr)):
            net = tree[side]
            _want_keys(net, _NET_KEYS, side)
            state[side] = jax_to_state_dict(model, net["params"], net["batch_stats"],
                                            net["spectral"])
            adam, count = _optax_entries(net["opt_state"], side,
                                         decayed=isinstance(opt, torch.optim.AdamW))
            mu = jax_params_to_state_dict(model, adam["mu"])
            nu = jax_params_to_state_dict(model, adam["nu"])
            updates = torch.tensor(float(np.asarray(adam["count"])))
            state[f"{side}_opt"] = [{"step": updates, "exp_avg": mu[name],
                                     "exp_avg_sq": nu[name]} for name in mu]
            state[f"{side}_lr"] = _schedule_state(schedule, int(np.asarray(count)))
    return state


def _want_keys(tree, keys, where: str) -> None:
    if not isinstance(tree, Mapping) or set(tree) != keys:
        got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
        raise KeyError(f"{where}: want the entries {sorted(keys)}, the file has {got}")


def _optax_entries(opt_state, side: str, decayed: bool):
    """(the Adam entry, the schedule's count) of an optax ``chain`` state:
    Adam's ``{count, mu, nu}``, the schedule's ``{count}`` and, with
    ``decayed`` (AdamW), the decayed weights' empty entry, in any order."""
    where = f"{side}/opt_state"
    if not isinstance(opt_state, Mapping):
        raise ValueError(f"{where}: want an optax chain's entries, the file has "
                         f"{type(opt_state).__name__}")
    kinds = {"adam": [], "schedule": [], "empty": []}
    for key, entry in opt_state.items():
        keys = set(entry) if isinstance(entry, Mapping) else None
        kind = ("adam" if keys == _ADAM_KEYS else "schedule" if keys == {"count"}
                else "empty" if keys == set() or entry is None else None)
        if kind is None:
            raise ValueError(f"{where}/{key}: an optimizer entry the port does not take "
                             f"({sorted(keys) if keys is not None else type(entry).__name__})")
        kinds[kind].append(entry)
    want = {"adam": 1, "schedule": 1, "empty": 1 if decayed else 0}
    got = {k: len(v) for k, v in kinds.items()}
    if got != want:
        raise ValueError(f"{where}: the trainer's {'AdamW' if decayed else 'Adam'} wants "
                         f"entries {want}, the file has {got}")
    return kinds["adam"][0], kinds["schedule"][0]["count"]


def _schedule_state(schedule, count: int) -> dict:
    """A :class:`LinearDecay`'s ``lr`` and count after ``count`` updates:
    ``lr`` as ``advance`` set it for the last one (the base rate before
    any)."""
    done = torch.tensor(float(count))
    if count == 0:
        lr = torch.full((), schedule.base)
    else:
        lr = torch.clamp_min(1.0 - (done - 1.0) / schedule.total, 0.0) * schedule.base
    return {"lr": lr, "count": done}
