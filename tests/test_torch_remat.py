"""``GANTrainer(remat=...)``: rematerialised model applies (CPU, f32).

Against the JAX trainer with the same ``remat``: two steps of the narrow
pairs of ``tests/test_torch_train_options.py`` in lockstep, at its bars
(``check_lockstep``), with the SN discriminator, with wgan-gp against
``FFCDiscriminator`` (the penalty's double backward through a
rematerialised D, FourierUnits included) and with the aw-method's separate
real and fake passes. JAX holds its remat to its own step without remat
(JAX ``tests/test_train_step.py``).

Against the port's own step without remat, from deep copies of one
trainer with the noise left on: after two steps the losses, every
parameter and buffer (BN running statistics, ``u``), the optimizer
moments and both random generators' states are the same bits. A recompute
that updated the statistics again, stored ``u`` again, iterated from the
stored ``u`` or drew the noise again would move one of them. Then the
mechanism: the recompute runs (the FourierUnit training op's forward runs
again in the backward), "dots" keeps the convolutions' outputs (none
recomputed in the backward) and "full" keeps none.
"""

from __future__ import annotations

import copy

import pytest
import torch

import fastfourierconvolution_tpu_torch.nn.ffc as tffc
import fastfourierconvolution_tpu_torch.models.conditional as tcond
from fastfourierconvolution_tpu_torch import (
    FFCDiscriminator,
    FFCGenerator,
    GANTrainer,
    SNConvDiscriminator,
)
from fastfourierconvolution_tpu_torch.nn import remat
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_train_options import check_lockstep
from test_torch_train_step import _fast_gelu

MODES = ["dots", "full"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps run many small ops, where torch's
    thread pool only adds contention with the other test workers (the
    wgan-gp pairs ran about 100x slower beside five busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", MODES)
def test_remat_in_lockstep_with_jax(mode, monkeypatch):
    """The tuple pair against the SN ladder, fused D pass."""
    check_lockstep(dict(remat=mode, fused_dis_batch=True), monkeypatch)


def test_remat_wgan_gp_with_an_ffc_discriminator_in_lockstep_with_jax(monkeypatch):
    """wgan-gp against ``FFCDiscriminator`` under "dots": the penalty
    differentiates the rematerialised D twice, so its region is recomputed
    twice, from the kept products the first time and computing them again
    the second."""
    check_lockstep(dict(loss="wgan-gp", optimizer="adam", fused_dis_batch=False, remat="dots"),
                   monkeypatch, d_kind="ffc")


def test_remat_aw_method_in_lockstep_with_jax(monkeypatch):
    """The aw-method's real pass and its fake pass (from D's buffers at the
    start of the update) each rematerialised, "full"."""
    check_lockstep(dict(aw_method=True, remat="full"), monkeypatch)


# --- against the port's own step without remat -------------------------------------

Z = 8


def _pair(kind):
    """(G, D, trainer options, resolution) of a small pair that draws noise."""
    if kind == "ffc-d-gp":
        return (FFCGenerator(z_size=Z, ngf=8, mg=4, channel_mults=(4, 2, 1)), FFCDiscriminator(),
                dict(loss="wgan-gp", optimizer="adam", update_order="d_first",
                     num_dis_updates=2), 32)
    if kind == "packed":
        g = FFCGenerator(z_size=Z, ngf=4, ratio_g=0.5, mg=2, channel_mults=(4, 2, 1),
                         packed=True)
        return g, SNConvDiscriminator(ladder=((8, 3, 1), (8, 4, 2)), head_size=8), {}, 16
    if kind == "cond-noise":
        g = tcond.CondDCGANGenerator(nz=Z, nc=1, ngf=16, num_classes=3)
        d = tcond.CondDCGANDiscriminator(nc=1, ndf=16, num_classes=3, use_noise=True)
        return g, d, dict(conditional=True, num_classes=3, loss="bce", d_progress_arg=True), 16
    if kind == "cond-sn":
        g = tcond.CondDCGANGenerator(nz=Z, nc=1, ngf=32, num_classes=3)
        d = tcond.FFCCondDCGANDiscriminator(nc=1, ndf=32, num_classes=3, use_sn=True,
                                            use_noise=True)
        return g, d, dict(conditional=True, num_classes=3, loss="bce"), 32
    g = FFCGenerator(z_size=Z, ngf=8, mg=2, channel_mults=(2, 1))
    d = SNConvDiscriminator(ladder=((8, 3, 1), (8, 4, 2)), head_size=4)
    return g, d, dict(aw_method=kind == "aw", fused_dis_batch=kind == "fused"), 8


def _everything(trainer):
    moments = [v for opt in (trainer.g_opt, trainer.d_opt) for s in opt.state.values()
               for v in s.values()]
    return {**{f"g.{k}": v for k, v in trainer.g.state_dict().items()},
            **{f"d.{k}": v for k, v in trainer.d.state_dict().items()},
            **{f"moment{i}": v for i, v in enumerate(moments)},
            "z_generator": trainer.z_generator.get_state(),
            "noise_generator": trainer.noise_generator.get_state()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["fused", "aw", "ffc-d-gp", "packed", "cond-noise", "cond-sn"])
def test_remat_step_is_the_step_without_remat(kind, mode):
    """Two steps (``update_steps``) with remat and without, from copies of
    one trainer: the same bits in the losses and in everything the step
    changes. The packed pair runs the fused BN + GELU op (tanh GELU), the
    conditional pairs draw D's input noise and the spectral-normed all-FFC
    cDCGAN discriminator advances seven ``u``."""
    g, d, options, res = _pair(kind)
    base = GANTrainer(g, d, z_size=Z, total_steps=20, device="cpu", dtype="f32", seed=3,
                      **options)
    k = 2
    reals = torch.rand(k, 4, res, res, 1 if kind.startswith("cond") else 3,
                       generator=torch.Generator().manual_seed(0)) * 2 - 1
    labels = torch.tensor([[0, 1, 2, 1], [2, 2, 0, 1]]) if kind.startswith("cond") else None
    plain, ours = copy.deepcopy(base), copy.deepcopy(base)
    ours.remat = mode
    with _fast_gelu(kind == "packed"):
        out_plain = plain.update_steps(reals, labels)
        out_ours = ours.update_steps(reals, labels)
    for key in out_plain:
        assert torch.equal(out_ours[key], out_plain[key]), key
    before, want, got = _everything(base), _everything(plain), _everything(ours)
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    moved = [n for n in want if n.endswith((".u", "running_mean")) and
             not torch.equal(want[n], before[n])]
    assert moved, "the step moved no running statistic and no u"
    assert not torch.equal(want["noise_generator"], before["noise_generator"])


class _CountConvolutions(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def _g_phase_counts(mode, monkeypatch):
    """(FourierUnit training-op forwards, convolutions run inside the
    backward) of one G loss and its gradients."""
    calls = []
    op = tffc.fourier_unit_train
    monkeypatch.setattr(tffc, "fourier_unit_train", lambda *a: calls.append(1) or op(*a))
    g, d, options, res = _pair("fused")
    trainer = GANTrainer(g, d, z_size=Z, total_steps=20, device="cpu", dtype="f32", remat=mode,
                         **options)
    fake = remat.checkpointed(trainer.remat, trainer.g, *trainer._g_args(torch.randn(4, Z), None))
    loss = trainer.gen_loss(trainer._d(fake, None))
    forwards = len(calls)
    with _CountConvolutions() as counter:
        torch.autograd.grad(loss, list(trainer.g.parameters()))
    return forwards, len(calls) - forwards, counter.n


@pytest.mark.parametrize("mode", [None, "dots", "full"], ids=["none", "dots", "full"])
def test_remat_recomputes_what_its_policy_does_not_keep(mode, monkeypatch):
    """G's one FourierUnit runs its training op once in the forward and,
    with remat, once more in the backward's recompute; in that recompute
    "full" runs G's and D's convolutions again and "dots" none of them
    (the backward's own convolutions are ``convolution_backward``)."""
    forwards, recomputed, convolutions = _g_phase_counts(mode, monkeypatch)
    assert forwards == 1
    assert recomputed == (0 if mode is None else 1)
    if mode == "full":
        assert convolutions > 0
    else:
        assert convolutions == 0


def test_bad_remat_value_raises():
    g, d, _, _ = _pair("fused")
    with pytest.raises(ValueError, match="unknown remat"):
        GANTrainer(g, d, z_size=Z, device="cpu", remat="offload")
    with pytest.raises(ValueError, match="remat must be one of"):
        remat.checkpointed("everything", lambda x: x, torch.zeros(1))
