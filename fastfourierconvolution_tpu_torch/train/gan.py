"""GAN training: one global step, and K of them as one captured CUDA graph.

``GANTrainer.update_step`` is the JAX package's ``GANTrainer.update_step``,
keyword for keyword with the same defaults:

- the G phase: a generator forward in training mode (batch-statistic BN,
  noise), a discriminator forward on the fakes (its spectral-norm ``u``
  and any BN statistics advance), the generator's gradients over its own
  parameters only, an optimizer step;
- the D phase, ``num_dis_updates`` times: a generator forward in training
  mode without a graph (its running statistics advance again), D on the
  fakes and on the reals (one forward on ``cat([fake, real])`` with
  ``fused_dis_batch``, else the fake pass and then the real pass, which
  starts from the ``u`` and statistics the fake pass left), D's gradients
  over its parameters, an optimizer step;
- ``update_order`` "g_first" (the G phase, then the D phase) or
  "d_first";
- ``conditional``: the step takes labels (B,), which reach G and D in
  both phases (twice over in the fused D pass); ``d_progress_arg``: D
  also takes the training progress, step / total_steps, an f32 tensor
  computed from a step count on the device.

Losses: hinge, bce, wgan, and wgan-gp (wgan plus ``gp_lambda`` times the
gradient penalty on interpolates, from D's state at the start of its
update, storing nothing). The aw-method replaces D's gradient by the
aw-weighted sum of the real and fake passes' gradients (each pass from
D's state at the start of its update; the real pass's state updates are
kept). AdamW (weight decay 0.01) or Adam, eps 1e-8 outside the square
root as in optax, with lr(t) = lr * max(1 - t/total, 0) at update t; D's
schedule runs over ``total_steps * num_dis_updates`` updates.

``update_steps`` runs K steps. On the card the step is a CUDA graph: the
first call for a real-batch shape runs one step eagerly (it creates the
optimizer moments and every kernel's first-call state) and captures the
step; every later step replays it. Everything the step changes is updated
in place (parameters, moments, BN statistics, ``u``, the learning rates
and their update counts, which live on the device), and both random
generators are registered with the graph, so replayed and eager steps can
be interleaved and continue the same random streams.

Latents and noise come from two ``torch.Generator``s on the trainer's
device, seeded at construction; the noise generator also feeds D's input
noise, where D has any. Parameters, BN statistics and ``u`` stay f32;
activations run in the trainer's compute dtype.

``remat`` ("dots" or "full"; None or "none" for neither) rematerialises
the differentiated model applies, as the JAX trainer's ``_maybe_remat``
does: G inside the G loss, D inside both loss closures (the gradient
penalty's pass and the aw-method's separate passes included), not the D
phase's gradient-free G forward. ``nn/remat.py`` says how (non-reentrant
``torch.utils.checkpoint``, which "dots" makes selective) and how a
recompute leaves the BN statistics, ``u`` and the noise generators as the
step without remat leaves them.

``generate`` samples G in eval mode (running statistics, no noise), as
the JAX trainer's ``generate`` does.

Data parallelism (``parallel``): in a process group every process steps
on its slice of the global batch and the step is the global batch's, as
under the JAX trainer's sharded jit. The trainer copies rank 0's G and D
into every process when it is made; the statistics of every BN and
FourierUnit are the global batch's; the latents, the noise maps and the
gradient penalty's weights are drawn for the global batch (every process
from the same generator state) and each process keeps its rows, D's fused
pass per half (its ``segments=2``); each phase's loss and gradients are
averaged over the processes in one bucketed all-reduce before the
optimizer step (with the aw-method, both passes' gradients, and the
logits gathered). Parameters, optimizer moments, ``u`` and running
statistics then stay equal in every process. ``update_steps`` captures
the collectives in its CUDA graph under NCCL; under gloo, whose
collectives run on the host, it raises.

Tensor parallelism (``parallel``, a dp x tp grid of N = D·T processes):
the trainer slices every FourierUnit of G and D whose channels T divides to
the process's out-channel slice (``nn.ffc.shard_fourier_units_``) after the
copy from rank 0; the batch, its statistics, sums and draws are split over
the dp group only (tp peers hold the same rows), and the phases' gradients
are averaged over the dp group: a sliced mix's over the peers with the
same slice, everything else (which every tp peer computes whole, with the
same bits) likewise. ``state_dict`` gathers the sliced mixes and their
optimizer moments over the tp group, so a checkpoint holds whole tensors
and is the same file at any T; ``load_state_dict`` takes the process's
slice of each. ``generate`` runs G on the whole mixes, gathered at the
call (``nn.ffc.whole_fourier_units``): every process of a tp group makes
the call.

``state_dict`` holds the whole trainer state (``train/checkpoint.py``
saves it); ``load_state_dict`` copies a saved state into the live
tensors, so a captured step replays on the restored state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .. import parallel
from ..models.ffc_gan import to_uint8
from ..nn import remat as remat_mod
from ..nn.ffc import shard_fourier_units_, whole_fourier_units
from ..ops.fourier_unit import out_columns
from ..utils.policy import default_dtype, resolve_device, resolve_dtype
from . import losses as L

WEIGHT_DECAY = 0.01
ADAM_EPS = 1e-8

LOSS_PAIRS = {
    "hinge": (L.hinge_loss_gen, L.hinge_loss_dis),
    "bce": (L.bce_loss_gen, L.bce_loss_dis),
    "wgan": (L.wgan_loss_gen, L.wgan_loss_dis),
    "wgan-gp": (L.wgan_loss_gen, L.wgan_loss_dis),
}
# D's loss as a real term and a fake term, for the aw-method's two passes.
LOSS_SPLIT = {
    "hinge": (lambda real: torch.relu(1.0 - real.float()).mean(),
              lambda fake: torch.relu(1.0 + fake.float()).mean()),
    "bce": (lambda real: L.bce_loss(real, 1.0), lambda fake: L.bce_loss(fake, 0.0)),
    "wgan": (lambda real: -real.float().mean(), lambda fake: fake.float().mean()),
}
UPDATE_ORDERS = ("g_first", "d_first")


class LinearDecay:
    """lr(t) = base * max(1 - t/total, 0) in a 0-d f32 tensor that the
    optimizer reads, with the update count t on the same device.
    :meth:`advance` sets lr(t) for the coming update and counts it."""

    def __init__(self, lr: torch.Tensor, base: float, total: int):
        self.lr, self.base, self.total = lr, base, total
        self.count = torch.zeros((), device=lr.device)

    def advance(self) -> None:
        with torch.no_grad():
            self.lr.copy_(torch.clamp_min(1.0 - self.count / self.total, 0.0) * self.base)
            self.count.add_(1.0)


def make_optimizer(params, device: torch.device, lr: float = 2e-4,
                   total_steps: int = 100_000, b1: float = 0.5, b2: float = 0.999,
                   kind: str = "adamw"):
    """(optimizer, its :class:`LinearDecay`): ``kind`` "adamw" (weight decay
    0.01) or "adam", eps 1e-8, the learning rate a device tensor. On the
    card the optimizer is capturable, so a CUDA graph can replay its
    step."""
    lr_t = torch.full((), lr, device=device)
    common = dict(lr=lr_t, betas=(b1, b2), eps=ADAM_EPS, capturable=device.type == "cuda")
    if kind == "adamw":
        opt = torch.optim.AdamW(params, weight_decay=WEIGHT_DECAY, **common)
    elif kind == "adam":
        opt = torch.optim.Adam(params, **common)
    else:
        raise ValueError(f"unknown optimizer {kind!r}; want 'adamw' or 'adam'")
    return opt, LinearDecay(opt.param_groups[0]["lr"], lr, total_steps)


class GANTrainer:
    """Trains ``g_model`` and ``d_model`` in place on ``device`` (``cuda``
    unless told otherwise); the compute dtype defaults to bf16 on the card
    and f32 on the CPU. The keywords are the JAX ``GANTrainer``'s, with its
    defaults; ``seed`` seeds the latent and noise generators."""

    def __init__(
        self, g_model: nn.Module, d_model: nn.Module, *, z_size: int = 128,
        lr: float = 2e-4, total_steps: int = 100_000, num_dis_updates: int = 1,
        loss: str = "hinge", optimizer: str = "adamw", b1: float = 0.5, b2: float = 0.999,
        conditional: bool = False, num_classes: int = 0, d_lr: Optional[float] = None,
        fused_dis_batch: bool = False, gp_lambda: float = 10.0, aw_method: bool = False,
        update_order: str = "g_first", aw_alpha1: float = 0.5, aw_alpha2: float = 0.75,
        aw_delta: float = 0.05, aw_epsilon: float = 0.05, remat: Optional[str] = None,
        d_progress_arg: bool = False, seed: int = 0, device="cuda", dtype=None,
    ):
        if remat not in remat_mod.MODES:
            raise ValueError(f"unknown remat {remat!r}; want one of {remat_mod.MODES}")
        if loss not in LOSS_PAIRS:
            raise ValueError(f"unknown loss {loss!r}; want one of {sorted(LOSS_PAIRS)}")
        if update_order not in UPDATE_ORDERS:
            raise ValueError(f"unknown update order {update_order!r}; want one of {UPDATE_ORDERS}")
        if num_dis_updates < 1:
            raise ValueError(f"num_dis_updates must be at least 1, got {num_dis_updates}")
        if aw_method and loss not in LOSS_SPLIT:
            raise ValueError(f"the aw-method takes the losses {sorted(LOSS_SPLIT)}, not {loss!r}")
        if aw_method and fused_dis_batch:
            raise ValueError("the aw-method needs separate real and fake D passes")
        if aw_method and not aw_alpha1 < aw_alpha2:
            raise ValueError(f"aw_alpha1 ({aw_alpha1}) must be smaller than aw_alpha2 ({aw_alpha2})")
        self.use_gp = loss == "wgan-gp"
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else resolve_dtype(dtype)
        self.conditional = conditional
        self.d_progress_arg, self.total_steps = d_progress_arg, total_steps
        self.z_size = z_size
        self.num_dis_updates = num_dis_updates
        self.loss_name = loss
        self.gen_loss, self.dis_loss = LOSS_PAIRS[loss]
        self.fused_dis_batch = fused_dis_batch
        self.gp_lambda = gp_lambda
        self.aw_method = aw_method
        self.aw_params = (aw_alpha1, aw_alpha2, aw_delta, aw_epsilon)
        self.update_order = update_order
        self.remat = remat
        self.g = g_model.to(self.device).train()
        self.d = d_model.to(self.device).train()
        parallel.broadcast_module_(self.g)
        parallel.broadcast_module_(self.d)
        # the parameter names of the FourierUnit mixes sliced over the tp
        # group, by model
        self._mix_keys = {
            side: {f"{name}.mix_kernel"
                   for name in shard_fourier_units_(m, parallel.tp_index(), parallel.tp_count())}
            for side, m in (("g", self.g), ("d", self.d))}
        self.g_opt, self.g_lr = make_optimizer(
            self.g.parameters(), self.device, lr, total_steps, b1, b2, optimizer)
        self.d_opt, self.d_lr = make_optimizer(
            self.d.parameters(), self.device, d_lr or lr, total_steps * num_dis_updates, b1, b2,
            optimizer)
        self.z_generator = torch.Generator(self.device).manual_seed(seed)
        self.noise_generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.step = 0
        # with d_progress_arg, the global step count on the device, which
        # D's progress reads
        self.step_count = torch.zeros((), device=self.device)
        self._graphs: Dict[tuple, _StepGraph] = {}

    def _latents(self, b: int) -> torch.Tensor:
        return parallel.global_draw(
            lambda shape: torch.randn(shape, generator=self.z_generator, device=self.device),
            (b, self.z_size))

    # -- the two phases ------------------------------------------------------------

    def _g_args(self, z: torch.Tensor, labels: Optional[torch.Tensor]):
        """G's arguments: the latents, the compute dtype, the noise generator
        and, for a conditional pair, the labels."""
        args = (z, self.dtype, self.noise_generator)
        return args + (labels,) if self.conditional else args

    def _d_args(self, x: torch.Tensor, labels: Optional[torch.Tensor], segments: int = 1):
        """D's positional and keyword arguments on ``x``: a conditional D
        takes the labels and the noise generator, and ``segments`` where x
        is the fused pass's ``cat([fake, real])`` (its input noise is drawn
        per half in a process group); with ``d_progress_arg`` the progress,
        step / total_steps on the device."""
        args, kwargs = (x, self.dtype), {}
        if self.conditional:
            args += (labels, self.noise_generator)
            if segments != 1:
                kwargs["segments"] = segments
        if self.d_progress_arg:
            kwargs["progress"] = self.step_count / self.total_steps
        return args, kwargs

    def _d(self, x: torch.Tensor, labels: Optional[torch.Tensor],
           segments: int = 1) -> torch.Tensor:
        """A differentiated training forward of D, rematerialised per
        ``remat``."""
        args, kwargs = self._d_args(x, labels, segments)
        return remat_mod.checkpointed(self.remat, self.d, *args, **kwargs)

    def g_loss_and_grads(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None):
        """The G phase's loss and the generator's gradients (one tensor per
        parameter, in ``g_model.parameters()`` order; under a process group
        the global batch's, averaged over the processes). Advances G's
        running statistics and D's ``u`` and statistics, as the phase
        does."""
        params = list(self.g.parameters())
        fake = remat_mod.checkpointed(self.remat, self.g, *self._g_args(z, labels))
        loss = self.gen_loss(self._d(fake, labels))
        return _averaged(loss.detach(), torch.autograd.grad(loss, params))

    def d_loss_and_grads(self, real: torch.Tensor, z: torch.Tensor,
                         labels: Optional[torch.Tensor] = None):
        """One D update's loss and D's gradients (in ``d_model.parameters()``
        order; under a process group the global batch's, averaged over the
        processes) on ``real`` (B, C, H, W) f32 and fakes from ``z`` (and
        ``labels``, which the reals share). Advances G's running statistics
        and D's ``u`` and statistics, as the update does."""
        with torch.no_grad():
            fake = self.g(*self._g_args(z, labels))
        params = list(self.d.parameters())
        real_dt = real.to(self.dtype)
        # D's buffers at the start of the update, for the passes that start
        # from there and store nothing
        start = ({k: v.clone() for k, v in self.d.named_buffers()}
                 if self.use_gp or self.aw_method else None)
        if self.aw_method:
            real_term, fake_term = LOSS_SPLIT[self.loss_name]
            fake_logits = self._d_from(start, fake, labels)
            real_logits = self._d(real_dt, labels)
            loss_r, loss_f = real_term(real_logits), fake_term(fake_logits)
            # the weighting reads the global batch's gradients and logits
            n = len(params)
            loss, grads = _averaged(
                (loss_r + loss_f).detach(),
                [*torch.autograd.grad(loss_r, params), *torch.autograd.grad(loss_f, params)])
            grads, _, _ = L.aw_combine(
                grads[:n], grads[n:], parallel.all_gather_rows(real_logits.detach()),
                parallel.all_gather_rows(fake_logits.detach()), *self.aw_params,
            )
            return loss, grads
        if self.fused_dis_batch:
            both = None if labels is None else torch.cat([labels, labels])
            fake_logits, real_logits = self._d(torch.cat([fake, real_dt]), both, 2).chunk(2)
        else:
            fake_logits = self._d(fake, labels)
            real_logits = self._d(real_dt, labels)
        loss = self.dis_loss(fake_logits, real_logits)
        if self.use_gp:
            loss = loss + self.gp_lambda * L.gradient_penalty(
                lambda x: self._d_from(start, x, labels), real, fake, self.noise_generator)
        return _averaged(loss.detach(), torch.autograd.grad(loss, params))

    def _d_from(self, buffers, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """A differentiated training forward of D with its buffers (``u``,
        BN statistics) taken from ``buffers``, whose tensors receive the
        forward's updates in place of D's own; rematerialised per
        ``remat``."""
        args, kwargs = self._d_args(x, labels)
        return remat_mod.checkpointed(self.remat, torch.func.functional_call, self.d, buffers,
                                      args, kwargs)

    @staticmethod
    def _apply(model: nn.Module, opt, schedule: LinearDecay, grads) -> None:
        for p, grad in zip(model.parameters(), grads):
            p.grad = grad
        schedule.advance()
        opt.step()

    def _g_phase(self, b: int, z: Optional[torch.Tensor],
                 labels: Optional[torch.Tensor]) -> torch.Tensor:
        loss, grads = self.g_loss_and_grads(self._latents(b) if z is None else z, labels)
        self._apply(self.g, self.g_opt, self.g_lr, grads)
        return loss

    def _d_phase(self, real: torch.Tensor, zs: Optional[torch.Tensor],
                 labels: Optional[torch.Tensor]) -> torch.Tensor:
        for i in range(self.num_dis_updates):
            z = self._latents(real.shape[0]) if zs is None else zs[i]
            loss, grads = self.d_loss_and_grads(real, z, labels)
            self._apply(self.d, self.d_opt, self.d_lr, grads)
        return loss

    def _step(self, real: torch.Tensor, labels: Optional[torch.Tensor],
              zs: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One global step on ``real`` (B, H, W, C) f32 and ``labels`` (B,)
        on the device; moves no host value, so a CUDA graph can capture
        it.

        The backward runs on the calling thread. Autograd numbers a graph's
        nodes with a counter per thread and runs the ready node with the
        highest number first; on the card it runs a backward on a thread of
        its own, which numbers the nodes it creates (a gradient penalty's
        graph of gradients, a remat recompute) from its own counter. The
        two counters' gap depends on what the process ran before, so a
        process's first step ran some nodes in another order than later
        steps and summed a gradient's parts in another order."""
        b = real.shape[0]
        real = real.permute(0, 3, 1, 2).contiguous()
        z_g, z_d = (None, None) if zs is None else (zs[0], zs[1:])
        with torch.autograd.set_multithreading_enabled(False):
            if self.update_order == "d_first":
                loss_d = self._d_phase(real, z_d, labels)
                loss_g = self._g_phase(b, z_g, labels)
            else:
                loss_g = self._g_phase(b, z_g, labels)
                loss_d = self._d_phase(real, z_d, labels)
        if self.d_progress_arg:
            with torch.no_grad():
                self.step_count.add_(1.0)
        return {"loss_g": loss_g, "loss_d": loss_d}

    def _labels(self, labels, shape) -> Optional[torch.Tensor]:
        """``labels`` as int64 on the device, checked against ``shape``;
        required by a conditional trainer, refused by another."""
        if not self.conditional:
            if labels is not None:
                raise ValueError("labels are for a conditional trainer")
            return None
        if labels is None:
            raise ValueError("a conditional trainer needs labels")
        labels = torch.as_tensor(labels).to(self.device, torch.int64)
        if tuple(labels.shape) != tuple(shape):
            raise ValueError(f"labels must be {tuple(shape)}, got {tuple(labels.shape)}")
        return labels

    # -- entry points --------------------------------------------------------------

    def update_step(self, real, labels=None, zs=None) -> Dict[str, torch.Tensor]:
        """One generator update and ``num_dis_updates`` discriminator
        updates, in ``update_order``. ``real``: (B, H, W, C) images in
        [-1, 1] (NHWC, as the JAX package takes them); ``labels``: (B,)
        class labels of a conditional trainer, shared by the reals and the
        fakes; ``zs`` (optional, (1 + num_dis_updates, B, z_size)) replaces
        the latent draws: zs[0] feeds the G phase, zs[1:] the D updates.
        Returns the losses (the last D update's) as f32 scalars on the
        device."""
        real = torch.as_tensor(real, dtype=torch.float32).to(self.device)
        if real.dim() != 4:
            raise ValueError(f"real must be (B, H, W, C), got {tuple(real.shape)}")
        labels = self._labels(labels, real.shape[:1])
        if zs is not None:
            zs = torch.as_tensor(zs, dtype=torch.float32).to(self.device)
            want = (1 + self.num_dis_updates, real.shape[0], self.z_size)
            if tuple(zs.shape) != want:
                raise ValueError(f"zs must be {want}, got {tuple(zs.shape)}")
        out = self._step(real, labels, zs)
        self.step += 1
        return out

    def update_steps(self, reals, labels=None) -> Dict[str, torch.Tensor]:
        """K steps on ``reals`` (K, B, H, W, C) and, for a conditional
        trainer, ``labels`` (K, B), the latents drawn; returns
        ``{"loss_g": (K,), "loss_d": (K,)}`` on the device without waiting
        for it. On the CPU K calls of :meth:`update_step`; on the card the
        step's CUDA graph replayed once per step: the first call for a
        batch shape runs its first step eagerly (``step`` counts it) and
        captures the step. A capture or launch that fails raises; nothing
        reruns a step eagerly in its place."""
        reals = torch.as_tensor(reals, dtype=torch.float32)
        if reals.dim() != 5:
            raise ValueError(f"reals must be (K, B, H, W, C), got {tuple(reals.shape)}")
        labels = self._labels(labels, reals.shape[:2])
        if self.device.type == "cuda" and parallel.backend() == "gloo":
            raise ValueError("update_steps captures the step with its collectives as a CUDA "
                             "graph, and the gloo backend runs its collectives on the host: "
                             "under gloo take update_step, one step a call")
        if self.device.type != "cuda":
            outs = [self.update_step(real, None if labels is None else labels[i])
                    for i, real in enumerate(reals)]
            return {k: torch.stack([o[k] for o in outs]) for k in ("loss_g", "loss_d")}
        reals = reals.to(self.device)
        out = {k: torch.empty(reals.shape[0], device=self.device) for k in ("loss_g", "loss_d")}
        key = tuple(reals.shape[1:])
        batch = lambda i: (reals[i], None if labels is None else labels[i])
        first = 0
        if key not in self._graphs:
            # The eager first step creates the optimizer moments, the
            # kernels' builds, shared-memory limits and tables, and the
            # cuBLAS/cuDNN state of the capture stream, outside the capture.
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for k, v in self._step(*batch(0), None).items():
                    out[k][0].copy_(v)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            self.step += 1
            self._graphs[key] = _StepGraph(self, *batch(0), stream)
            first = 1
        graph = self._graphs[key]
        for i in range(first, reals.shape[0]):
            graph.replay(*batch(i), out, i)
            self.step += 1
        return out

    # -- checkpoint state ----------------------------------------------------------

    def state_dict(self) -> dict:
        """Everything a step reads and changes: G's and D's parameters and
        buffers (BN statistics, spectral-norm ``u``), both optimizers'
        moments and ``step`` counts (per parameter, in ``parameters()``
        order; empty before the first step), both learning-rate schedules'
        ``lr`` and update count, D's progress count (``step_count``), the
        host ``step``, and both random generators' states. The tensors are
        the live ones, as ``nn.Module.state_dict`` gives them: save them or
        clone them before the next step. Under tensor parallelism the
        sliced mixes and their moments are gathered whole (a collective of
        the tp group: every peer calls it)."""
        return self._map_slices({
            "g": self.g.state_dict(),
            "d": self.d.state_dict(),
            "g_opt": _optimizer_state(self.g_opt),
            "d_opt": _optimizer_state(self.d_opt),
            "g_lr": {"lr": self.g_lr.lr, "count": self.g_lr.count},
            "d_lr": {"lr": self.d_lr.lr, "count": self.d_lr.count},
            "step_count": self.step_count,
            "step": self.step,
            "z_generator": self.z_generator.get_state(),
            "noise_generator": self.noise_generator.get_state(),
        }, parallel.tp_gather_channels)

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` by copying it into the trainer's own
        tensors: every parameter, buffer, moment, learning rate and count
        keeps its storage, and the optimizers keep reading the schedules'
        ``lr`` tensors, so a step captured as a CUDA graph replays on the
        restored state. Where no step has run yet, the optimizer moments
        are created first. The generators take the saved states in place,
        so a replay continues the restored streams. Raises on a state
        whose tensors do not match this trainer's models. Under tensor
        parallelism each sliced mix and its moments take the process's
        slice of the whole tensors saved."""
        state = self._map_slices(dict(state), _slice)
        with torch.no_grad():
            self.g.load_state_dict(state["g"])
            self.d.load_state_dict(state["d"])
            _load_optimizer(self.g_opt, state["g_opt"])
            _load_optimizer(self.d_opt, state["d_opt"])
            for schedule, saved in ((self.g_lr, state["g_lr"]), (self.d_lr, state["d_lr"])):
                schedule.lr.copy_(saved["lr"])
                schedule.count.copy_(saved["count"])
            self.step_count.copy_(state["step_count"])
        self.z_generator.set_state(state["z_generator"])
        self.noise_generator.set_state(state["noise_generator"])
        self.step = int(state["step"])

    def generate(self, z, labels=None, uint8: bool = False) -> torch.Tensor:
        """Samples of G in eval mode (BN running statistics, no noise):
        (B, z_size) latents and, for a conditional trainer, (B,) labels ->
        (B, H, W, C) NHWC images on the device, floats in the compute dtype
        or, with ``uint8``, the uint8 contract of ``to_uint8``. Runs under
        ``torch.no_grad`` and leaves G's training flag as it found it;
        nothing a step reads changes."""
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)
        if z.dim() != 2 or z.shape[1] != self.z_size:
            raise ValueError(f"z must be (B, {self.z_size}), got {tuple(z.shape)}")
        labels = self._labels(labels, z.shape[:1])
        was_training = self.g.training
        self.g.eval()
        try:
            with torch.no_grad(), whole_fourier_units(self.g):
                out = self.g(*self._g_args(z, labels)).permute(0, 2, 3, 1)
        finally:
            self.g.train(was_training)
        return (to_uint8(out) if uint8 else out).contiguous()

    # -- tensor parallelism: whole tensors in a state, slices in the trainer ---------

    def whole(self, side: str, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t``, shaped like parameter ``name`` of ``side`` ("g" or "d"):
        its value, gradient or a moment, gathered whole over the tp group
        where that parameter is a sliced mix (a collective of the group);
        ``t`` itself elsewhere."""
        return parallel.tp_gather_channels(t) if name in self._mix_keys[side] else t

    def _map_slices(self, state: dict, fn) -> dict:
        """``state`` (:meth:`state_dict`'s layout) with ``fn`` applied to
        every sliced mix and to its optimizer moments."""
        for side, model in (("g", self.g), ("d", self.d)):
            keys = self._mix_keys[side]
            if not keys:
                continue
            state[side] = {k: fn(v) if k in keys else v for k, v in state[side].items()}
            state[f"{side}_opt"] = [
                {k: fn(v) if name in keys and v.dim() == 2 else v for k, v in entries.items()}
                for (name, _), entries in zip(model.named_parameters(), state[f"{side}_opt"],
                                              strict=True)]
        return state


def _slice(whole: torch.Tensor) -> torch.Tensor:
    """This process's out-channel slice of a whole (2C, 2C) mix (or of its
    moments)."""
    return whole[:, out_columns(whole.shape[0] // 2, parallel.tp_index(), parallel.tp_count())]


def _averaged(loss: torch.Tensor, grads):
    """``(loss, grads)`` averaged over the processes of a group, in one
    all-reduce (``parallel.average_``); as they are without one."""
    loss, *grads = parallel.average_([loss.reshape(1), *grads])
    return loss.reshape(()), tuple(grads)


def _optimizer_state(opt: torch.optim.Optimizer) -> list:
    """One dict of state tensors per parameter of the single group (empty
    before the first step)."""
    return [dict(opt.state.get(p, {})) for p in opt.param_groups[0]["params"]]


def _load_optimizer(opt: torch.optim.Optimizer, saved) -> None:
    """Copy per-parameter optimizer state (``saved``: one dict per
    parameter of the single group) into ``opt``'s state tensors, creating
    them (zeros where torch's own first step would) where none exist."""
    group = opt.param_groups[0]
    if len(saved) != len(group["params"]):
        raise ValueError(f"optimizer state for {len(saved)} parameters, the optimizer has "
                         f"{len(group['params'])}")
    for p, entries in zip(group["params"], saved):
        state = opt.state.get(p, {})
        if entries and not state:
            # a capturable optimizer keeps its step counts on the device
            cpu_step = not group["capturable"]
            state = {k: torch.zeros_like(v, device="cpu" if k == "step" and cpu_step
                                         else p.device)
                     for k, v in entries.items()}
            opt.state[p] = state
        if set(state) != set(entries):
            raise ValueError(f"optimizer state keys {sorted(entries)}, want {sorted(state)}")
        for k, v in entries.items():
            if state[k].shape != v.shape:
                raise ValueError(f"optimizer state {k}: shape {tuple(v.shape)}, want "
                                 f"{tuple(state[k].shape)}")
            state[k].copy_(v)


class _StepGraph:
    """One training step of a trainer captured as a CUDA graph on
    ``stream``, for one real-batch shape: static input buffers (the reals
    and any labels), the captured step and its loss outputs. Capturing
    records the step and runs nothing."""

    def __init__(self, trainer: GANTrainer, real: torch.Tensor,
                 labels: Optional[torch.Tensor], stream: torch.cuda.Stream):
        self.real = real.clone()
        self.labels = None if labels is None else labels.clone()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(real.device):
            self.graph.register_generator_state(trainer.z_generator)
            self.graph.register_generator_state(trainer.noise_generator)
        with torch.cuda.graph(self.graph, stream=stream):
            self.losses = trainer._step(self.real, self.labels, None)

    def replay(self, real: torch.Tensor, labels: Optional[torch.Tensor],
               out: Dict[str, torch.Tensor], i: int) -> None:
        self.real.copy_(real)
        if labels is not None:
            self.labels.copy_(labels)
        self.graph.replay()
        for k, v in self.losses.items():
            out[k][i].copy_(v)
