"""The cases of ``tests/test_torch_parallel.py``, run either in one process
without a group (the reference, in the test's own process) or as one
process of a gloo group on the CPU:

    python tests/torch_parallel_worker.py SPEC.json

SPEC holds the case, the rank, the process count, the tensor-parallel
width (``tp``, 1 unless given), the group's ``init_method`` and the paths
of its inputs and of its output (a ``torch.save`` of the case's result).
Each process takes its dp rows of the global batch
(``parallel.shard_full_batch``) and returns what the test compares:
statistics and sums, gradients summed over the processes, or the losses
and the state after each training step (whole tensors under tp:
``GANTrainer.state_dict`` gathers the sliced mixes). This module imports no
JAX, so the worker processes start quickly.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fastfourierconvolution_tpu_torch import (  # noqa: E402
    FFCDiscriminator,
    FFCGenerator,
    GANTrainer,
    SNConvDiscriminator,
    parallel,
)
from fastfourierconvolution_tpu_torch.models import ffc_gan  # noqa: E402
from fastfourierconvolution_tpu_torch.nn import layers  # noqa: E402
from fastfourierconvolution_tpu_torch.ops import bn_act as ba  # noqa: E402
from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu  # noqa: E402
from fastfourierconvolution_tpu_torch.train import losses as tlosses  # noqa: E402
from fastfourierconvolution_tpu_torch.train.checkpoint import restore_checkpoint  # noqa: E402

# The JAX multi-process test's pair (tests/test_multihost.py), 8px.
MULTIHOST_G = dict(z_size=32, ngf=16, ratio_g=0.25, mg=2, channel_mults=(4, 2))
MULTIHOST_D = dict(ladder=((16, 3, 1), (16, 4, 2), (32, 4, 2)), head_size=2)
# The packed pair of tests/test_torch_train_step.py (the 128px preset's
# ladder, narrow: 64px, every block through the fused packed BN + GELU op
# with the noise fold under the tanh GELU).
PACKED_G = dict(z_size=16, ngf=8, ratio_g=0.5, mg=2, channel_mults=(4, 2, 1, 1, 1))
PACKED_D = dict(ladder=((8, 3, 1), (16, 4, 2), (16, 4, 2), (16, 4, 2)), head_size=8)
GLOBAL_BATCH, STEPS = 8, 3
# The pairs made here from seeds: resolution and the seed of the real
# batches (see the wgan-gp note in tests/test_torch_parallel.py).
SEEDED = {"multihost": (8, 7), "gp": (8, 2), "packed": (64, 7)}


def _rows(t):
    return parallel.shard_full_batch(t)


def _tensor(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _summed(grads):
    """Parameter gradients summed over the processes (each holds its share
    of the global batch's gradient)."""
    return [parallel.sum_over_processes(g.detach()) for g in grads]


def ops_case(spec):
    """The statistics and the backward sums of the FourierUnit op (per-item
    and staged plain versions), of the fused packed BN and of BatchNorm on
    this process's rows of one seeded global batch, and the training ops'
    gradients (x's rows, the parameters' summed over the processes)."""
    rng = np.random.default_rng(0)
    b, c, h, w = GLOBAL_BATCH, 4, 8, 8
    x = rng.normal(size=(b, c, h, w)).astype(np.float32)
    gy = rng.normal(size=(b, c, h, w)).astype(np.float32)
    kernel = (rng.normal(size=(2 * c, 2 * c)) * 0.3).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=2 * c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=2 * c)).astype(np.float32)
    xl, gyl = _tensor(_rows(x)), _tensor(_rows(gy))
    k, sc, bi = _tensor(kernel), _tensor(scale), _tensor(bias)
    out = {}
    bmean, bvar = fu.fu_train_stats(xl, k)
    out["fu_train_stats"] = torch.stack([bmean, bvar])
    out["fu_bwd_stats"] = torch.stack(fu.fu_bwd_stats(xl, k, sc, bi, bmean, bvar, gyl))
    z, g = fu.fu_spectrum(xl, gyl)
    out["fu_mix_stats"] = torch.stack(fu.fu_mix_stats(z, k))
    out["fu_bwd_stats_mix"] = torch.stack(fu.fu_bwd_stats_mix(z, g, k, sc, bi, bmean, bvar))

    xr, kr, sr, br = _tensor(_rows(x), True), _tensor(kernel, True), _tensor(scale, True), \
        _tensor(bias, True)
    y, _, _ = fu.fourier_unit_train(xr, kr, sr, br)
    grads = torch.autograd.grad((y * gyl).sum(), (xr, kr, sr, br))
    out["fu_train_y"], out["fu_train_gx"] = y.detach(), grads[0]
    out["fu_train_gparams"] = _summed(grads[1:])

    cp = 2 * c  # a packed map, noise fold on, the tanh GELU
    xp = _tensor(_rows(rng.normal(size=(b, cp, h, w)).astype(np.float32) * 1.5 + 0.3), True)
    gp = _tensor(_rows(rng.normal(size=(b, cp, h, w)).astype(np.float32)))
    n_l, n_g = (_tensor(_rows(rng.normal(size=(b, 1, h, w)).astype(np.float32)), True)
                for _ in range(2))
    sp, bp, wp = (_tensor((rng.normal(size=cp) * s + o).astype(np.float32), True)
                  for s, o in ((0.1, 1.0), (0.1, 0.0), (0.3, 0.0)))
    pm, pv = ba.bn_stats(xp.detach())
    out["bn_stats"] = torch.stack([pm, pv])
    out["bn_bwd_reduce"] = torch.stack(ba.bn_bwd_reduce(xp.detach(), gp, pm, pv, sp.detach(),
                                                        bp.detach(), n_l.detach(),
                                                        n_g.detach(), c))
    o, _, _ = ba.packed_bn_gelu_noise(xp, sp, bp, wp, n_l, n_g, c)
    grads = torch.autograd.grad((o * gp).sum(), (xp, n_l, n_g, sp, bp, wp))
    out["packed_out"], out["packed_grad_rows"] = o.detach(), list(grads[:3])
    out["packed_gparams"] = _summed(grads[3:])

    bn = layers.BatchNorm(cp)
    bn.reset_parameters(torch.Generator().manual_seed(3))
    xb = _tensor(_rows(rng.normal(size=(b, cp, h, w)).astype(np.float32)), True)
    yb = bn(xb)
    grads = torch.autograd.grad((yb * gp).sum(), [xb, *bn.parameters()])
    out["bn_y"], out["bn_gx"] = yb.detach(), grads[0]
    out["bn_gparams"] = _summed(grads[1:])
    out["bn_running"] = torch.stack([bn.running_mean, bn.running_var])
    return out


def _no_noise(x, generator):
    b, _, h, w = x.shape
    return torch.zeros((b, 1, h, w), dtype=x.dtype, device=x.device)


@contextlib.contextmanager
def _fast_gelu(on: bool):
    old = layers._FAST_GELU
    if on:
        layers.set_fast_gelu(True)
    try:
        yield
    finally:
        layers._FAST_GELU = old


# The wgan-gp pair: the sngan preset's pairing (FFCDiscriminator, wgan-gp,
# Adam, separate real and fake D passes).
GP_D = dict(mg=1)
GP_OPTIONS = dict(z_size=32, loss="wgan-gp", optimizer="adam")


def _pair(spec):
    """(G, D, trainer keywords, packed) of the step case's pair: made from
    seeds, or (``spec["inputs"]``) from the JAX trainer's init
    (``tests/test_torch_parallel_jax.py``)."""
    pair = spec["pair"]
    if "inputs" in spec:
        init = torch.load(spec["inputs"], weights_only=True)
        g = FFCGenerator(**init["g_cfg"], packed=init["packed"])
        d = (FFCDiscriminator(**init["d_cfg"]) if init["d_kind"] == "ffc" else
             SNConvDiscriminator(**init["d_cfg"]))
        g.load_state_dict(init["g"])
        d.load_state_dict(init["d"])
        return g, d, init["options"], init["packed"]
    if pair == "packed":
        g = FFCGenerator(**PACKED_G, packed=True, generator=torch.Generator().manual_seed(0))
        d = SNConvDiscriminator(**PACKED_D, generator=torch.Generator().manual_seed(1))
        return g, d, dict(z_size=16, fused_dis_batch=True), True
    g = FFCGenerator(**MULTIHOST_G, generator=torch.Generator().manual_seed(0))
    if pair == "gp":
        return g, FFCDiscriminator(**GP_D, generator=torch.Generator().manual_seed(1)), \
            GP_OPTIONS, False
    d = SNConvDiscriminator(**MULTIHOST_D, generator=torch.Generator().manual_seed(1))
    return g, d, dict(z_size=32, fused_dis_batch=True), False


def step_case(spec):
    """``STEPS`` ``update_step`` calls on this process's rows of the
    global batches: (the losses, G's and D's state dicts) after each, and
    the gradients the first step took (``first_moments``: Adam's first
    moments after it over 1 - b1, by parameter). A
    pair from the JAX trainer's init takes its data's latents, with
    NoiseInjection neutralised and the gradient penalty's weights given
    (``spec["data"]``), as the JAX lockstep tests do."""
    g, d, kw, packed = _pair(spec)
    if "data" not in spec:
        res, seed = SEEDED[spec["pair"]]
        rng = np.random.default_rng(seed)
        reals = rng.uniform(-1, 1, size=(STEPS, GLOBAL_BATCH, res, res, 3)).astype(np.float32)
        zs = None
    else:
        data = np.load(spec["data"])
        reals, zs = data["reals"], data["zs"]
    with contextlib.ExitStack() as stack:
        stack.enter_context(_fast_gelu(packed))
        if zs is not None:  # the pairs held against JAX
            stack.enter_context(_patched(ffc_gan, "draw_noise", _no_noise))
            if "gp_eps" in data:
                eps = torch.from_numpy(_rows(data["gp_eps"]))
                stack.enter_context(_patched(tlosses, "interpolation_weights",
                                             lambda real, generator: eps))
        # the first step's G and D gradients, from a copy of the pair on the
        # first batch (Adam's step hides a gradient's scale)
        twin = GANTrainer(*[copy.deepcopy(m) for m in (g, d)], total_steps=100, device="cpu",
                          dtype="f32", **kw)
        z = twin._latents(reals.shape[1] // parallel.dp_count())
        real = torch.from_numpy(_rows(reals[0])).permute(0, 3, 1, 2).contiguous()
        grads = {"g": twin.g_loss_and_grads(z)[1], "d": twin.d_loss_and_grads(real, z)[1]}
        trainer = GANTrainer(g, d, total_steps=100, device="cpu", dtype="f32", **kw)
        names = {side: [n for n, _ in m.named_parameters()] for side, m in (("g", g), ("d", d))}
        out = {"losses": [], "states": [],
               "params": [f"{side}.{n}" for side in names for n in names[side]],
               "grads": {f"{side}.{n}": twin.whole(side, n, grad)
                         for side in names for n, grad in zip(names[side], grads[side])}}
        for k in range(len(reals)):
            z = None if zs is None else [_rows(zz) for zz in zs[k]]
            losses = trainer.update_step(_rows(reals[k]), zs=None if z is None else np.stack(z))
            out["losses"].append([losses["loss_g"].item(), losses["loss_d"].item()])
            out["states"].append(_states(trainer))
            if k == 0:
                state = trainer.state_dict()
                out["first_moments"] = {
                    f"{side}.{n}": e["exp_avg"] / (1 - opt.param_groups[0]["betas"][0])
                    for side, opt in (("g", trainer.g_opt), ("d", trainer.d_opt))
                    for n, e in zip(names[side], state[f"{side}_opt"])}
    return out


def _states(trainer):
    """G's and D's whole state dicts (``GANTrainer.state_dict``), cloned."""
    state = trainer.state_dict()
    return {f"{side}.{n}": t.clone() for side in ("g", "d") for n, t in state[side].items()}


def ckpt_case(spec):
    """From ``spec["restore"]`` (a checkpoint of the port, ``.pt``, or of the
    JAX package, ``.ckpt``: ``train.checkpoint.restore_checkpoint``) or from
    the pair's init: a
    trainer takes the data's steps ``spec["steps"]`` (a range), returns the
    losses and states after each, and saves its state at the end to
    ``spec["save"]`` (rank 0 writes, every process gathers)."""
    g, d, kw, _ = _pair(spec)
    data = np.load(spec["data"])
    with _patched(ffc_gan, "draw_noise", _no_noise):
        trainer = GANTrainer(g, d, total_steps=100, device="cpu", dtype="f32", **kw)
        if spec.get("restore"):
            restore_checkpoint(trainer, spec["restore"])
        out = {"losses": [], "states": []}
        for k in range(*spec["steps"]):
            z = np.stack([_rows(zz) for zz in data["zs"][k]])
            losses = trainer.update_step(_rows(data["reals"][k]), zs=z)
            out["losses"].append([losses["loss_g"].item(), losses["loss_d"].item()])
            out["states"].append(_states(trainer))
        if spec.get("save"):
            state = trainer.state_dict()
            if parallel.process_index() == 0:
                torch.save(state, spec["save"])
    return out


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def metrics_case(spec):
    """ISC, FID and KID (the weights-free InceptionV3) of a stand-in
    generative model (latents through a seeded projection) against a seeded
    shapes set, 20 samples in batches of 8 (the last one padded), each
    process generating and extracting its rows of every batch in a group;
    then the same call again, the real set's features from the cache
    (``spec["cache"]``)."""
    from fastfourierconvolution_tpu_torch.data.datasets import ShapesDataset
    from fastfourierconvolution_tpu_torch.eval import (
        GenerativeModel,
        calculate_metrics,
        register_dataset,
    )

    proj = torch.randn(16, 32 * 32 * 3, generator=torch.Generator().manual_seed(4))

    def apply(z):
        return ((torch.tanh(z @ proj).reshape(-1, 32, 32, 3) + 1) * 127.5).to(torch.uint8)

    register_dataset("dp-real", lambda: ShapesDataset(n=20, size=32, seed=1).images)
    kw = dict(isc=True, fid=True, kid=True, isc_splits=2, kid_subsets=4, kid_subset_size=8,
              batch_size=8, input1_model_num_samples=20, device="cpu",
              cache_dir=spec["cache"])
    gm = GenerativeModel(apply=apply, z_size=16, device="cpu")
    return {"first": calculate_metrics(gm, "dp-real", **kw),
            "again": calculate_metrics(gm, "dp-real", **kw)}


def fu_module_case(spec):
    """A FourierUnit module of 8 channels sliced over the tp group (none
    without a group) on this process's rows of one seeded batch, in
    training mode, in eval mode (seeded running statistics) and
    class-conditional (3 classes, training): y, x's gradient, the
    parameters' gradients (a sliced mix's gathered whole) and the running
    statistics after the pass."""
    from fastfourierconvolution_tpu_torch.nn.ffc import FourierUnit, shard_fourier_units_

    rng = np.random.default_rng(5)
    b, c = GLOBAL_BATCH, 8
    x = rng.normal(size=(b, c, 8, 8)).astype(np.float32)
    gy = rng.normal(size=(b, c, 8, 8)).astype(np.float32)
    labels = torch.from_numpy(_rows(rng.integers(0, 3, size=b)))
    out = {}
    for name, classes, training in (("train", 0, True), ("eval", 0, False), ("cond", 3, True)):
        unit = FourierUnit(c, classes)
        unit.reset_parameters(torch.Generator().manual_seed(6))
        stats = unit.bn if classes else unit
        if classes:
            unit.bn.reset_parameters(torch.Generator().manual_seed(9))
        with torch.no_grad():
            stats.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(7))
            stats.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(8))
        unit.train(training)
        sliced = shard_fourier_units_(unit, parallel.tp_index(), parallel.tp_count())
        xr = _tensor(_rows(x), True)
        y = unit(xr, labels) if classes else unit(xr)
        params = [p for _, p in unit.named_parameters()]
        grads = torch.autograd.grad((y * _tensor(_rows(gy))).sum(), [xr, *params])
        whole = {n: parallel.tp_gather_channels(g) if sliced and n == "mix_kernel" else g
                 for (n, _), g in zip(unit.named_parameters(), grads[1:])}
        out[name] = {"y": y.detach(), "gx": grads[0], **{f"grad {n}": g for n, g in whole.items()},
                     "running": torch.stack([stats.running_mean, stats.running_var])}
    return out


CASES = {"ops": ops_case, "step": step_case, "metrics": metrics_case, "ckpt": ckpt_case,
         "fu_module": fu_module_case}


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    parallel.initialize("cpu", spec["init"], spec["world"], spec["rank"], tp=spec.get("tp", 1))
    try:
        torch.save(CASES[spec["case"]](spec), spec["out"])
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
