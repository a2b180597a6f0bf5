"""``GANTrainer.state_dict`` / ``load_state_dict`` and ``train/checkpoint.py``
(CPU, f32; the JAX package's checkpoint module for the file rules).

- Four steps straight equal two steps, a save, a fresh trainer of another
  seed, a restore and two more steps: every parameter, buffer, moment,
  learning rate, count and generator state, the host step and the losses,
  bit for bit; the trainer's options that keep more state (the cDCGAN
  discriminator's progress, Adam) too.
- A restore copies into the live tensors: every ``data_ptr`` is kept and
  the optimizers read the schedules' ``lr`` tensors; a trainer that never
  stepped gets its moments created; a state of other models raises.
- The file rules are the JAX module's: ``{prefix}_{N}_steps`` discovery
  within one family, pruning to the newest ``keep``, atomic writes with the
  umask's mode, ``(trainer, 0)`` where no checkpoint exists; the JAX
  package's discovery never picks up the port's ``.pt`` files, and the
  port's picks up the JAX ``.ckpt`` files as the JAX package's does
  (``tests/test_torch_jax_checkpoint.py`` reads them).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.train.checkpoint as jckpt
from fastfourierconvolution_tpu_torch import (
    CondDCGANDiscriminator,
    CondDCGANGenerator,
    FFCGenerator,
    GANTrainer,
    SNConvDiscriminator,
)
from fastfourierconvolution_tpu_torch.train import checkpoint as ckpt

Z = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, where torch's
    thread pool only adds contention with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(kind):
    if kind == "cond_dcgan":  # D takes labels, noise and training progress
        return (CondDCGANGenerator(nz=Z, nc=1, ngf=16, num_classes=3),  # 16px
                CondDCGANDiscriminator(nc=1, ndf=16, num_classes=3, use_noise=True))
    return (FFCGenerator(z_size=Z, ngf=8, mg=2, channel_mults=(2, 1)),  # 8px
            SNConvDiscriminator(ladder=((8, 3, 1), (8, 4, 2)), head_size=4))


SETTINGS = {
    "adamw": ("ffc", dict()),
    "adam-d-first": ("ffc", dict(optimizer="adam", update_order="d_first", num_dis_updates=2)),
    "cond_dcgan": ("cond_dcgan", dict(loss="bce", optimizer="adam", conditional=True,
                                      num_classes=3, d_progress_arg=True)),
}


def _trainer(name, seed=0):
    kind, options = SETTINGS[name]
    g, d = _pair(kind)
    return GANTrainer(g, d, z_size=Z, total_steps=10, device="cpu", seed=seed, **options)


def _batch(name, i):
    size, channels = (16, 1) if name == "cond_dcgan" else (8, 3)
    g = torch.Generator().manual_seed(100 + i)
    real = torch.rand(2, size, size, channels, generator=g) * 2 - 1
    labels = torch.randint(0, 3, (2,), generator=g) if name == "cond_dcgan" else None
    return real, labels


def _leaves(trainer):
    """{name: value} of ``trainer.state_dict()``, nested dicts and lists
    flattened; the tensors the live ones (the generator states copies)."""
    flat = {}

    def walk(prefix, value):
        if isinstance(value, dict):
            for k, v in value.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(value, list):
            for i, v in enumerate(value):
                walk(f"{prefix}[{i}]", v)
        else:
            flat[prefix] = value

    walk("", trainer.state_dict())
    return flat


def _state(trainer):
    """{name: tensor} of the whole trainer state, the host step included."""
    return {k: torch.as_tensor(v).clone() for k, v in _leaves(trainer).items()}


def _pointers(trainer):
    return {k: v.data_ptr() for k, v in _leaves(trainer).items()
            if isinstance(v, torch.Tensor) and not k.endswith("generator")}


def assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert not differ, differ[:8]


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_save_restore_continues_bit_for_bit(name, tmp_path):
    straight = _trainer(name)
    losses = [straight.update_step(*_batch(name, i)) for i in range(4)]

    first = _trainer(name)
    for i in range(2):
        first.update_step(*_batch(name, i))
    path = ckpt.save_checkpoint(first, str(tmp_path), first.step)
    assert os.path.basename(path) == "ckpt_2_steps.pt"

    resumed = _trainer(name, seed=7)  # other weights and streams
    pointers = {k: v.data_ptr() for k, v in resumed.g.state_dict().items()}
    lr = resumed.g_opt.param_groups[0]["lr"], resumed.d_opt.param_groups[0]["lr"]
    _, step = ckpt.restore_latest(resumed, str(tmp_path))
    assert step == resumed.step == 2
    assert_same_state(resumed, first)
    assert {k: v.data_ptr() for k, v in resumed.g.state_dict().items()} == pointers
    assert lr[0] is resumed.g_opt.param_groups[0]["lr"] is resumed.g_lr.lr
    assert lr[1] is resumed.d_opt.param_groups[0]["lr"] is resumed.d_lr.lr
    after = [resumed.update_step(*_batch(name, i)) for i in range(2, 4)]
    for want, got in zip(losses[2:], after):
        assert all(torch.equal(want[k], got[k]) for k in want)
    assert_same_state(resumed, straight)


def test_a_restore_keeps_every_tensor_in_place(tmp_path):
    source = _trainer("adamw")
    for i in range(3):
        source.update_step(*_batch("adamw", i))
    ckpt.save_checkpoint(source, str(tmp_path), 3)
    into = _trainer("adamw", seed=3)
    into.update_step(*_batch("adamw", 5))  # the moments exist
    before = _pointers(into)
    ckpt.restore_latest(into, str(tmp_path))
    assert _pointers(into) == before
    assert_same_state(into, source)


def test_a_restore_into_a_fresh_trainer_creates_the_moments(tmp_path):
    source = _trainer("adamw")
    source.update_step(*_batch("adamw", 0))
    ckpt.save_checkpoint(source, str(tmp_path), 1)
    fresh = _trainer("adamw", seed=1)
    assert not fresh.g_opt.state
    ckpt.restore_latest(fresh, str(tmp_path))
    assert_same_state(fresh, source)
    assert all(s["step"].device.type == "cpu" for s in fresh.g_opt.state.values())
    a, b = source.update_step(*_batch("adamw", 1)), fresh.update_step(*_batch("adamw", 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    # a trainer saved before its first step restores with no moments
    ckpt.save_checkpoint(_trainer("adamw", seed=2), str(tmp_path / "early"), 0)
    again = _trainer("adamw")
    ckpt.restore_checkpoint(again, ckpt.get_latest_checkpoint(str(tmp_path / "early")))
    assert not again.g_opt.state and again.step == 0


def test_a_state_of_other_models_raises(tmp_path):
    ckpt.save_checkpoint(_trainer("adamw"), str(tmp_path), 1)
    other = _trainer("cond_dcgan")
    with pytest.raises(RuntimeError):
        ckpt.restore_latest(other, str(tmp_path))
    # a JAX package's .ckpt file whose tree is no GANState of these models
    jckpt.save_checkpoint({"step": np.int32(1), "g": {}, "d": {}, "rng": np.zeros(2, np.uint32)},
                          str(tmp_path / "jax"), 1)
    with pytest.raises(KeyError, match="want the entries"):
        ckpt.restore_checkpoint(other, str(tmp_path / "jax" / "ckpt_1_steps.ckpt"))


class _Stub:
    def __init__(self, value):
        self.value = value

    def state_dict(self):
        return {"value": torch.tensor(self.value)}


def test_families_and_pruning_follow_the_jax_rules(tmp_path):
    """The same sequence of saves leaves the same step numbers in each
    family as the JAX module, files of another family untouched."""
    ours, theirs = tmp_path / "torch", tmp_path / "jax"
    saves = [("ckpt", 5, 3), ("ckpt", 10, 3), ("netG", 7, 2), ("ckpt", 15, 3), ("ckpt", 2, 3),
             ("ckpt", 20, 3), ("netG", 9, 2), ("netG", 11, 2), ("ckpt", 25, 0)]
    for prefix, step, keep in saves:
        ckpt.save_checkpoint(_Stub(step), str(ours), step, prefix=prefix, keep=keep)
        jckpt.save_checkpoint({"step": np.int32(step)}, str(theirs), step, prefix=prefix,
                              keep=keep)
    listing = lambda d, suffix: sorted(n[: -len(suffix)] for n in os.listdir(d))
    assert listing(ours, ".pt") == listing(theirs, ".ckpt")
    for prefix in ("ckpt", "netG"):
        got = ckpt.get_latest_checkpoint(str(ours), prefix)
        want = jckpt.get_latest_checkpoint(str(theirs), prefix)
        assert os.path.basename(got)[:-3] == os.path.basename(want)[:-5]
    # the JAX package's discovery does not see the port's files; the port's
    # sees the JAX package's and picks the same one
    assert ckpt.get_latest_checkpoint(str(theirs)) == jckpt.get_latest_checkpoint(str(theirs))
    assert jckpt.get_latest_checkpoint(str(ours)) is None
    assert ckpt.get_latest_checkpoint(str(tmp_path / "absent")) is None
    # a step that shares a prefix's digits is no member of another family
    ckpt.save_checkpoint(_Stub(1), str(ours), 99, prefix="ckpt_1")
    assert ckpt.get_latest_checkpoint(str(ours), "ckpt").endswith("ckpt_25_steps.pt")
    trainer = _trainer("adamw")
    assert ckpt.restore_latest(trainer, str(tmp_path / "absent")) == (trainer, 0)


def test_writes_are_atomic_with_the_umask_mode(tmp_path):
    old = os.umask(0o027)
    try:
        path = ckpt.save_checkpoint(_Stub(3), str(tmp_path), 3)
    finally:
        os.umask(old)
    assert os.stat(path).st_mode & 0o777 == 0o640
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3_steps.pt"]  # no temporary left

    class Failing:
        def state_dict(self):
            raise OSError("disk full")

    with pytest.raises(OSError):
        ckpt.save_checkpoint(Failing(), str(tmp_path), 4)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3_steps.pt"]
