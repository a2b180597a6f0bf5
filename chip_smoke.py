#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA source of the port (one nvcc per source, in parallel);
3. the FourierUnit forward kernel against its plain PyTorch version at the
   shapes the 32px generator gives it at batch 64, in f32 (TF32 off) and
   bf16, with kernel and plain times and the clustered per-item design
   (ranks per item, blocks, shared memory per rank, registers and spills
   from ptxas); the torch.fft-vs-factor-form gap is printed as information
   (cuFFT's C2R makes no promise for the non-Hermitian spectrum the
   FourierUnit inverts);
4. serve the full-width 32px generator in bf16 (seeded weights, BN
   running statistics calibrated on a seeded batch): 8 requests of batch
   64, then batch 1 and batch 7, with the kernel's launch counts (in all
   and by FourierUnit map) set to 0 before them and read after them;
   then batch-64 requests back to back for a few seconds for the served
   img/s; one request is held against the same weights run through the
   plain op;
5. the training kernels (batch statistics, backward statistics, backward
   apply) against their plain versions at the same shapes, in f32 and
   bf16, every output, with kernel, profiler-device and plain times, the
   bound and each kernel's clustered design as in phase 3; the
   batch reduction behind them (``fu_reduce``) at every
   partial-sum shape of the 32px step and an odd column count, against
   f64, the public wrapper and the callers' entry giving the same bits on
   two launches, with its host µs per call beside ``torch.sum``'s;
6. train the full-width 32px generator against the SN discriminator in
   bf16 at batch 64 (seeded weights and data; bench.py's setting: fused D
   pass, hinge, AdamW): warm-up steps, each with exact kernel launches per
   FourierUnit map, then steps back to back for a few seconds for the step
   time, with every count set to 0 before the steps and read after them;
   then ``update_steps`` with bench.py's K (16 at 32px, 4 at 128px), the
   step as a CUDA graph: its first call (one eager step and the capture,
   which count their launches; replays count none) with exact launches,
   then calls back to back for a few seconds; eager and graph each with
   wall ms per step, profiler device ms per step and idle share, and the
   profiler's device events per eager and per replayed step, which must
   agree; losses finite at every step;
7. one f32 step (TF32 off, deterministic algorithms) with the kernels
   against the same step with the plain ops patched in: every generator
   gradient, then the losses of 3 steps;
8. the fused packed BN + tanh-GELU (+ noise) kernels against their plain
   versions at the five packed maps of the 128px generator at batch 64,
   with and without the noise fold, in f32 and bf16, every output, with
   kernel, profiler-device, plain and library times and the bound; every
   kernel also on a map whose planes are no multiple of 16 bytes, two
   launches giving the same bits; ``bn_stats`` and ``bn_bwd_reduce`` in one
   launch each (no ``fu_reduce``), ``bn_stats`` with its host µs per call
   beside ``torch.var_mean``'s; the apply's grid against the blocks the
   card holds at once;
9. the FourierUnit kernels at the 128px generator's four maps, whose
   items exceed a block's shared memory, checked as in phases 3 and 5:
   the forward, the statistics, the backward sums and the backward apply
   run there as the staged kernels (``fourier_unit.kernel_design``; the
   eval forward at (64,64,16,16) per item), each stage of which is also
   held against its plain version and timed, and so are the training
   op's staged forward and backward, which share one spectrum between
   their statistics stage and their apply stage; every wrapper, stage and
   composition gives the same bits on two launches; and ``fu_reduce`` at
   every partial-sum shape of the 128px step, as in phase 5;
10. train the full-width 128px generator, in packed-branch mode, against
    its SN discriminator in bf16 at batch 64: warm-up steps with exact
    launches per step by FourierUnit map and by packed BN map, then steps
    back to back for a few seconds, with every count set to 0 before the
    steps and read after them, then the step as a CUDA graph, as in phase
    6; losses finite at every step;
11. one f32 step of the 128px pair at batch 8 with the tanh-form GELU
    forced (so the fused BN op runs), kernels against plain ops, as in
    phase 7;
12. f32 graph parity (TF32 off, deterministic algorithms): from one
    state, 4 replayed steps (``update_steps``) against 4 eager
    ``update_step`` calls of the 32px pair in bench.py's setting, in the
    JAX ``sagan`` preset's train settings (wgan-gp, Adam 0/0.9, lr 1e-4, D
    lr 4e-4, 5 D updates, D first, separate passes) and with the
    aw-method: losses, parameters, BN statistics, ``u``, optimizer moments,
    learning rates and generator states, the same bits or within phase 7's
    bars with the largest gap printed;
13. the ``sngan`` pair, the 32px generator against ``FFCDiscriminator``
    (Adam, separate real and fake D passes): the FourierUnit kernels at
    D's map that the generator has not, (64,32,8,8), checked as in phases
    3 and 5; bf16 training at batch 64 as in phase 6, with exact launches
    per FourierUnit map of G and D; one f32 step against the plain ops, G's
    gradients (phase 7's bar) and D's (phase 11's, see ``D_GRAD_TOL``) and
    the losses of 2 steps, as in phase 7;
14. the ``fgan_cond32`` pair, ``FFCCondGenerator.for_preset("cifar32")``
    against ``CondSNDiscriminator(32)`` (fused D pass, hinge, AdamW, 10
    classes, seeded labels): bf16 training at batch 64 as in phase 6, with
    labels through ``update_steps`` (K = 16, a replay's events then one
    more, the labels' copy in); serving with ``generate(z, labels,
    uint8=True)``: exact launches per request, img/s, one request against
    the plain op, the trainer's state unmoved; one f32 step against the
    plain ops as in phase 7;
15. the ``fgan_cond48`` generator's FourierUnit maps, (64,16,24,24) and
    (64,8,48,48), checked as in phases 3 and 5, every kernel clustered per
    item (at 48x48 the statistics, the backward sums and the backward apply
    fit only on clusters of 2 ranks or more), with each 48x48 training
    kernel's ranks, device ms, bound and times its bound printed beside the
    workspace design's readings there; the four workspace kernels (forward,
    statistics, backward sums, backward apply) at the 96px generator's map
    at batch 8, (8,8,96,96), checked the same way (no main path runs
    them); bf16 training of the ``fgan_cond48`` pair (``stl48`` against
    ``CondSNDiscriminator(48)``) as in phase 6;
16. wgan-gp on the sngan pair, whose gradient penalty takes D's
    FourierUnits' double backward: exact launches per f32 step (D's maps 4
    training forwards and 5 kernel backwards: the penalty's first-order
    backward and the backward through its forward), one f32 step against
    the plain ops (G's gradients at phase 7's bar, D's at phase 13's, the
    loss), and 4 replayed f32 steps against 4 eager ones, the same bits;
17. the eval-mode FourierUnit's gradients (gx, gK, gscale, gbias) from the
    backward kernels (the apply with zero sums) against the plain version
    in f64 at (64,16,16,16) and (64,8,48,48), f32, one launch of each;
18. the ``sagan`` preset at full width, built by the port's
    ``zoo.build_models(make_config("sagan"))`` (conv_dim 64, z 128, 32px)
    and trained with the trainer keywords the JAX CLI derives from the
    config (wgan-gp, Adam 0/0.9, lr 1e-4, D lr 4e-4, 5 D updates, D first,
    separate D passes): bf16 at batch 64, eager steps and ``update_steps``
    (K = 16) as in phase 6, with every FourierUnit and BN kernel's launch
    count 0 (these models run none); one ``generate(z, uint8=True)`` request
    through the wrapper; 4 replayed f32 steps against 4 eager ones as in
    phase 12 (self-attention's double backward under the gradient penalty
    inside a captured graph);
19. the ``resnet32`` preset (SNGAN-ResNet, ngf 256, ndf 128; hinge, AdamW
    0/0.9, separate D passes), the same readings and gates;
20. the DCGAN family at its published widths (ngf = ndf 64), bce:
    ``DCGANGenerator`` (z 100) against ``DCGANDiscriminator`` at 64px
    (separate D passes), and ``AttnConvGenerator`` (z 128, mg 8) against
    ``SNDCGANDiscriminator`` at 64px (fused D pass), the same readings and
    gates (``SNDCGANDiscriminator`` takes 64px only: four stride-2 convs
    and a 4x4 head; mg 8 puts the generator's attention on its 64x64 map);
21. a check that every kernel was launched on the main path (phases 4, 6,
    10, 13, 14 and 15), a ``{"wrapper_calls": [...]}`` JSON line (the staged
    wrapper and training-op calls, all their stages together), a
    ``{"kernels": [...]}`` JSON line, then the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, where CUDA is absent.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from unittest import mock

SEED = 0
BATCH = 64
N_REQUESTS = 8
# (B, C, H, W) of the 32px generator's two FourierUnits at batch 64, serving
# and training: block1's g2g on 16x16 maps, block2's on 32x32.
FU_SHAPES = [(BATCH, 16, 16, 16), (BATCH, 8, 32, 32)]
# The 128px generator at batch 64 (ngf 128, ratio 0.5, mults 4, 2, 1, 1, 1):
# the packed map of each of its five blocks, which the fused BN + GELU op
# normalises, and the maps of its four FourierUnits (blocks 1-4), all larger
# than a block's shared memory takes.
PACKED_SHAPES = [(BATCH, 512, 8, 8), (BATCH, 256, 16, 16), (BATCH, 128, 32, 32),
                 (BATCH, 128, 64, 64), (BATCH, 128, 128, 128)]
FU128_SHAPES = [(BATCH, 64, 16, 16), (BATCH, 32, 32, 32), (BATCH, 32, 64, 64),
                (BATCH, 32, 128, 128)]
# FFCDiscriminator at 32px, batch 64: the FourierUnits of block1 (the
# generator's block1 map too) and block2.
D_FU_SHAPES = [(BATCH, 16, 16, 16), (BATCH, 32, 8, 8)]
# The fgan_cond48 generator (stl48: dense stem, mg 6) at batch 64: block1's
# g2g on 24x24 maps, block2's on 48x48, where the one-block plan of the
# statistics and the backward exceeds shared memory and the clustered
# kernels run on 2 ranks per item (``fourier_unit.kernel_design``).
FU48_SHAPES = [(BATCH, 16, 24, 24), (BATCH, 8, 48, 48)]
# Device ms a launch of the workspace statistics, backward sums and
# backward apply at (64,8,48,48) in bf16, the lowest and highest of three
# runs of phase 15 while that map ran them (H100 80GB HBM3, 700 W): printed
# beside the clustered kernels' readings there.
WORKSPACE_48_MS = {"fu_train_stats": (0.1697, 0.1727), "fu_bwd_stats": (0.3217, 0.3229),
                   "fu_bwd_apply": (0.5299, 0.5451)}
# The 96px generator's 96x96 map at batch 8, which no cluster plan fits
# and the staged kernels do not take: the per-item workspace kernels.
WORKSPACE_SHAPES = [(8, 8, 96, 96)]
# The eval-mode gradient's maps (phase 17).
EVAL_GRAD_SHAPES = [(BATCH, 16, 16, 16), (BATCH, 8, 48, 48)]
NUM_CLASSES = 10
# rel-max = max|kernel - reference| / max|reference|. Every FourierUnit
# kernel's reference is its plain version evaluated in f64 on the same
# inputs: they compute in f32, and a plain version run in the working dtype
# is no sharper a yardstick. In bf16 it rounds every stage; in f32 as in
# bf16, one ReLU mask element whose pre-activation lies within rounding of
# 0 can flip, and one flip moved gbias by 1.2e-2 and gx by 4.9e-2 of their maxima
# (H100 80GB HBM3, 700 W, at these shapes). That gap is printed as
# information. The larger maps hold so many elements that some always sit
# that close to 0, so the backward kernels' biases are moved per channel
# to leave a margin around 0 (``relu_margin_bias``), which keeps these bars.
FU_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Fused BN + GELU kernels. f32: every output rel-max against the plain
# version in f64. bf16: out, dx, dn_l and dn_g within BN_BF16_ULPS bf16 ulps
# at the output's magnitude of the plain version on the same bf16 inputs
# (both compute in f32 and round once; an f32 difference of one ulp can
# move a rounding by one bf16 ulp); the sums (statistics, S1-S3) rel-max
# against f64, the backward's from the op's own u (rounded to bf16 from
# f32: rounded from f64 instead, it lands in the other bf16 neighbour now
# and then, which moved S1 by 1.5e-5 at (64,512,8,8); H100 80GB HBM3,
# 700 W).
BN_REL_TOL = 1e-5
BN_BF16_ULPS = 2
# Whole-request uint8 agreement, kernel vs plain op on the same weights.
# f32: both sides agree to ~1e-6, so only a truncation boundary can flip a
# level. bf16: the plain op rounds to bf16 after every stage where the
# kernel keeps f32, and the difference passes through two more blocks.
U8_MAX_LEVELS = {"float32": 1, "bfloat16": 16}
U8_MEAN_LEVELS = {"float32": 0.01, "bfloat16": 1.0}
# Published H100 SXM peaks (dense, 700 W): HBM bytes/s, and FLOP/s for the
# operands' type (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# Served requests and training steps timed back to back for the
# throughput readings.
TIMED_SECONDS = 2.0
# The training paths: bench.py's 32px and 128px pairs, the sngan pair (with
# wgan-gp: "sngan-gp"), the fgan_cond32 and fgan_cond48 pairs, and the
# comparator pairs built by the port's zoo (``ZOO_CONFIGS``).
RESOLUTION = {32: 32, 128: 128, "sngan": 32, "sngan-gp": 32, "cond32": 32, "cond48": 48,
              "sagan": 32, "resnet32": 32, "dcgan64": 64, "attn64": 64}
CONDITIONAL = ("cond32", "cond48")
WARMUP_STEPS = {32: 3, 128: 2, "sngan": 3, "cond32": 3, "cond48": 2, "sagan": 3,
                "resnet32": 3, "dcgan64": 3, "attn64": 3}
# Steps per update_steps call: bench.py's K (bench.py:180-250).
STEPS_PER_CALL = {32: 16, 128: 4, "sngan": 16, "cond32": 16, "cond48": 16, "sagan": 16,
                  "resnet32": 16, "dcgan64": 16, "attn64": 16}
# The comparator paths: (JAX preset, overrides) of a config that the port's
# zoo.build_models turns into the pair. The DCGAN pairs have no preset: the
# zoo's names at 64px (SNDCGANDiscriminator takes 64px only, so the
# attention generator runs at mg 8), the published widths (ngf = ndf 64, the
# DCGAN generator's z 100), bce for their sigmoid heads.
ZOO_CONFIGS = {
    "sagan": ("sagan", {}),
    "resnet32": ("resnet32", {}),
    "dcgan64": (None, {"model.generator": "dcgan", "model.discriminator": "dcgan",
                       "data.image_size": 64, "model.z_size": 100, "train.loss": "bce"}),
    "attn64": (None, {"model.generator": "attn_dcgan", "model.discriminator": "sn_dcgan",
                      "data.image_size": 64, "model.mg": 8, "train.loss": "bce"}),
}
# f32 training step, kernels vs plain ops, under deterministic algorithms
# so that the kernels are the only difference: every generator gradient
# (rel-max per tensor) and the losses of the steps (absolute). This
# model's f32 gradients amplify rounding about 1e4-fold: two runs of the
# same code under cuDNN's default algorithms differed by up to 4.9e-3
# rel-max, and the kernels sat 1.2e-3 from the plain ops under
# deterministic ones (32px, H100 80GB HBM3, 700 W; the phase prints both
# each time), so the gradient bar sits above that floor and far below what
# a wrong kernel gives (order 1). The 128px pair's floor is higher: 6.9e-3
# and 1.3e-2 in two runs, with the kernels 1.0e-2 from the plain ops (batch
# 8, same card): five blocks, and FourierUnit maps where many
# pre-activations sit within rounding of the ReLU's kink, whose side moves
# a backward sum discretely.
STEP_GRAD_TOL = {32: 1e-2, 128: 5e-2, "sngan": 1e-2, "sngan-gp": 1e-2, "cond32": 1e-2}
# The sngan pair's discriminator gradients (phase 13) take the 128px bar:
# their floor, the kernel path against itself, was 1.21e-2 rel-max
# (d.block2.ffc.convl2g.weight), and the kernels sat at the same gap from
# the plain ops under deterministic algorithms (H100 80GB HBM3, 700 W).
D_GRAD_TOL = 5e-2
STEP_LOSS_TOL = 1e-3
# The wgan-gp D loss is mostly 10x the penalty (28.6 at init, batch 64),
# which is computed from D's input gradients; those carry the f32 gradients'
# amplified rounding (D's gradients 2.9e-3 rel-max, 2.5e-4 rel-norm from the
# plain ops; its floor, the kernel path against itself, 2.4e-6 and 4.8e-3
# rel-max in two runs; H100 80GB HBM3, 700 W), so that path's losses are
# held to STEP_LOSS_TOL relative to their size: the gap was 1.29e-2 on 28.63
# (4.5e-4) in both runs.
RELATIVE_LOSS_PATHS = ("sngan-gp",)
# (batch, steps) of the f32 comparison by path.
PLAIN_RUNS = {32: (BATCH, 3), 128: (8, 1), "sngan": (BATCH, 1), "sngan-gp": (BATCH, 1),
              "cond32": (BATCH, 1)}
SOURCE = "fastfourierconvolution_tpu_torch/csrc/"
TPU_FU = "fastfourierconvolution_tpu/ops/pallas/fourier_unit.py:"
TPU_BN = "fastfourierconvolution_tpu/ops/pallas/bn_act.py:"
# kernel -> (source, the pallas_call lines it replaces)
KERNELS = {
    "fourier_unit_fwd": ("fourier_unit_fwd.cu", TPU_FU + "657,1124,1405"),
    "fu_train_stats": ("fourier_unit_train.cu", TPU_FU + "622,1088,1363"),
    "fu_bwd_stats": ("fourier_unit_train.cu", TPU_FU + "753,1222,1500"),
    "fu_bwd_apply": ("fourier_unit_train.cu", TPU_FU + "806,1275,1562"),
    # the staged design of the forward, the statistics, the backward sums
    # and the backward apply
    "fu_spectrum": ("fourier_unit_staged.cu",
                    TPU_FU + "657,1124,1405,622,1088,1363,753,1222,1500,806,1275,1562"),
    "fu_mix_apply": ("fourier_unit_staged.cu", TPU_FU + "657,1124,1405"),
    "fu_mix_stats": ("fourier_unit_staged.cu", TPU_FU + "622,1088,1363"),
    "fu_bwd_stats_mix": ("fourier_unit_staged.cu", TPU_FU + "753,1222,1500"),
    "fu_inverse": ("fourier_unit_staged.cu", TPU_FU + "657,1124,1405,806,1275,1562"),
    "fu_bwd_mix": ("fourier_unit_staged.cu", TPU_FU + "806,1275,1562"),
    # the VMEM-scratch accumulation across the TPU kernels' sequential grid
    "fu_reduce": ("fourier_unit_train.cu", TPU_FU + "609-620,740-747,789-797"),
    "bn_stats": ("bn_act.cu", TPU_BN + "164"),
    "bn_gelu_apply": ("bn_act.cu", TPU_BN + "197,406"),
    "bn_bwd_reduce": ("bn_act.cu", TPU_BN + "241,457"),
    "bn_bwd_dx": ("bn_act.cu", TPU_BN + "274,506"),
}
# Launches per training forward and per backward of one FourierUnit map, by
# the design that ``fourier_unit.kernel_design`` picks for the statistics
# ("stats"; the backward apply always takes the same, and the forward is
# staged only where they are). Per item: the statistics kernel and the
# forward kernel in each forward, the backward statistics and apply kernels
# in each backward. Staged: each forward one spectrum, the statistics
# stage, the apply stage and the inverse; each backward one two-map
# spectrum, the backward-sums stage, the backward mix and the inverse.
PASS_LAUNCHES = {
    "per_item": ({"fu_train_stats": 1, "fourier_unit_fwd": 1},
                 {"fu_bwd_stats": 1, "fu_bwd_apply": 1}),
    "staged": ({"fu_spectrum": 1, "fu_mix_stats": 1, "fu_mix_apply": 1, "fu_inverse": 1},
               {"fu_spectrum": 1, "fu_bwd_stats_mix": 1, "fu_bwd_mix": 1, "fu_inverse": 1}),
}
# The stage kernels one call launches in the staged design: the wrappers,
# and the training op's staged forward and backward (``train_forward``,
# ``train_backward``: ``fourier_unit._train_forward_staged`` and
# ``_train_backward_staged``).
STAGED_CALL = {"fourier_unit_fwd": ("fu_spectrum", "fu_mix_apply", "fu_inverse"),
               "fu_train_stats": ("fu_spectrum", "fu_mix_stats", "fu_reduce"),
               "fu_bwd_stats": ("fu_spectrum", "fu_bwd_stats_mix", "fu_reduce"),
               "fu_bwd_apply": ("fu_spectrum", "fu_bwd_mix", "fu_inverse", "fu_reduce"),
               "train_forward": ("fu_spectrum", "fu_mix_stats", "fu_reduce", "fu_mix_apply",
                                 "fu_inverse"),
               "train_backward": ("fu_spectrum", "fu_bwd_stats_mix", "fu_reduce", "fu_bwd_mix",
                                  "fu_reduce", "fu_inverse")}
# Per packed BN map and step: the fused op's two forwards and its backward.
BN_STEP_LAUNCHES = {"bn_stats": 2, "bn_gelu_apply": 2, "bn_bwd_reduce": 1, "bn_bwd_dx": 1}


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0].strip()


def fu_inputs(shape, dtype, device, seed):
    import torch

    b, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    kernel = torch.randn(2 * c, 2 * c, generator=g) * 0.2
    scale = torch.randn(2 * c, generator=g).abs() + 0.5
    bias = torch.randn(2 * c, generator=g) * 0.1
    mean = torch.randn(2 * c, generator=g) * 0.1
    var = torch.randn(2 * c, generator=g).abs() + 0.5
    return (x.to(device, dtype), kernel.to(device, dtype),
            *(t.to(device) for t in (scale, bias, mean, var)))


def fu_work(kernel, shape, itemsize, maps=1):
    """(bytes, FLOPs) a FourierUnit kernel's function needs at ``shape``:
    each input read once and each output written once (maps in the model
    dtype, the (2C,) vectors and gK in f32, K in the model dtype, the
    staged kernels' spectra in f32); FFT-sized transforms (5 N log2 N per
    complex length-N transform, half that for a real one), each (2C, 2C)
    product over the spectrum, and the elementwise BN work. ``maps``: the
    maps one ``fu_spectrum`` launch transforms. For ``fu_reduce``
    ``shape`` is the (rows, cols) of its f32 partial sums."""
    if kernel == "fu_reduce":
        rows, cols = shape
        return (rows + 1) * cols * 4, rows * cols
    b, c, h, w = shape
    c2, s = 2 * c, h * (w // 2 + 1)
    n_map = b * c * h * w * itemsize
    k_bytes, vec = c2 * c2 * itemsize, c2 * 4
    dft = 2.5 * w * math.log2(w) * c * h + 5 * h * math.log2(h) * c * (w // 2 + 1)
    mix = 2 * c2 * c2 * s
    spec = b * c2 * s * 4
    nbytes, per_item = {
        "fu_spectrum": (maps * (n_map + spec), maps * dft),
        "fu_mix_apply": (2 * spec + k_bytes + 4 * vec, mix + 6 * c2 * s),
        "fu_mix_stats": (spec + k_bytes + 2 * vec, mix + 3 * c2 * s),
        "fu_bwd_stats_mix": (2 * spec + k_bytes + 6 * vec, mix + 8 * c2 * s),
        "fu_inverse": (spec + n_map, dft),
        "fu_bwd_mix": (3 * spec + k_bytes + 6 * vec + c2 * c2 * 4, 3 * mix + 12 * c2 * s),
        "fourier_unit_fwd": (2 * n_map + k_bytes + 4 * vec, 2 * dft + mix + 6 * c2 * s),
        "fu_train_stats": (n_map + k_bytes + 2 * vec, dft + mix + 3 * c2 * s),
        "fu_bwd_stats": (2 * n_map + k_bytes + 6 * vec, 2 * dft + mix + 8 * c2 * s),
        "fu_bwd_apply": (3 * n_map + k_bytes + 6 * vec + c2 * c2 * 4,
                         3 * dft + 3 * mix + 12 * c2 * s),
        # the training op: forward x -> (y, bmean, bvar), m computed once;
        # backward (x, gy) -> (gx, gK, gscale, gbias)
        "train_forward": (2 * n_map + k_bytes + 4 * vec, 2 * dft + mix + 9 * c2 * s),
        "train_backward": (3 * n_map + k_bytes + 6 * vec + c2 * c2 * 4,
                           3 * dft + 3 * mix + 20 * c2 * s),
    }[kernel]
    return int(nbytes), int(b * per_item)


def bn_work(kernel, shape, itemsize, noise):
    """(bytes, FLOPs) a fused BN + GELU kernel's function needs at the
    packed map ``shape``: each map read once and written once (x, g, out,
    dx in the model dtype, the (B, 1, H, W) noise maps and their cotangents
    with ``noise``), the (C,) f32 vectors; f32 operations per element,
    tanh counted as one: stats 3, apply 14, reduce 22, dx 24, and 2 more
    each with the noise fold."""
    b, c, h, w = shape
    n, rows, vec = b * c * h * w, b * h * w, c * 4
    maps = 2 * rows * itemsize if noise else 0
    nbytes, ops = {
        "bn_stats": (n * itemsize + 2 * vec, 3),
        "bn_gelu_apply": (2 * n * itemsize + 4 * vec + (maps + vec if noise else 0), 14),
        "bn_bwd_reduce": (2 * n * itemsize + 4 * vec + maps + (3 if noise else 2) * vec, 22),
        "bn_bwd_dx": (3 * n * itemsize + 8 * vec + (maps + vec if noise else 0), 24),
    }[kernel]
    return int(nbytes), (ops + (2 if noise and kernel != "bn_stats" else 0)) * n


def bound(kernel, shape, itemsize, dtype_name, noise=False, maps=1):
    """(bound ms, "bytes" or "operations", bytes, FLOPs). The BN kernels
    compute in f32 whatever the map's dtype."""
    if kernel.startswith("bn_"):
        nbytes, flops = bn_work(kernel, shape, itemsize, noise)
        dtype_name = "float32"
    elif kernel in ("fu_mix_apply", "fu_mix_stats", "fu_bwd_stats_mix", "fu_inverse",
                    "fu_bwd_mix"):  # f32 spectra in
        nbytes, flops = fu_work(kernel, shape, itemsize)
        dtype_name = "float32"
    else:
        nbytes, flops = fu_work(kernel, shape, itemsize, maps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOP_PER_S[dtype_name] * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes, flops


def kernel_row(name, shape, dtype_name, **numbers):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": SOURCE + source,
            "replaces": replaces, "shape": list(shape), "dtype": dtype_name, **numbers}


def rel_max(out, ref):
    """(rel-max, max-abs) of ``out`` against ``ref``, in f32."""
    err = (out.float() - ref.float()).abs().max().item()
    return err / ref.float().abs().max().item(), err


def bf16_ulps(out, ref):
    """max|out - ref| in bf16 ulps at ref's magnitude, 2^(floor(log2
    max|ref|) - 7)."""
    ulp = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    return (out.float() - ref.float()).abs().max().item() / ulp


def time_ms(fn):
    """Mean ms per call over back-to-back calls (CUDA events), after two
    warm-up calls: as many calls as fit 300 ms by one timed call, at least
    3 and at most 200."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(200, max(3, 300.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=100):
    """Host µs per call of ``fn``: the time to enqueue ``iters`` calls back to
    back, without waiting for the card (each call's launches queue behind the
    others'), after five warm-up calls."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_events(fn, iters, attempts=3):
    """torch.profiler's device-side events (kernels, copies) over ``iters``
    calls of ``fn``: [(name, total ms, launches)]. A window in which the
    profiler recorded no device event at all is profiled again, up to
    ``attempts`` windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = profiled_device_events(prof)
        if events:
            return events
        log(f"  info: the profiler recorded no device event in a window of {iters} calls")
    return []


def profiled_device_events(prof):
    """[(name, total ms, launches)] of a finished profile's device-side
    events."""
    from torch.autograd import DeviceType

    events = []
    for evt in prof.key_averages():
        # a GPU user annotation (the optimizer's step range) spans kernels
        # that are counted on their own
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0)
        events.append((evt.key, t / 1000.0, evt.count))
    return events


def device_breakdown(fn, iters=10, top=8):
    """Device time per call of ``fn`` from torch.profiler, counting only
    device-side events: (total ms, launches, the ``top`` of them by device
    time as (name, ms, launches))."""
    rows = [(key, t / iters, n // iters) for key, t, n in device_events(fn, iters)]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top]


def kernel_device_ms(fn, symbols, iters, attempts=3):
    """Profiler device ms per call of ``fn`` that launches each kernel whose
    name holds one of ``symbols`` once (a symbol listed twice counts
    twice): the sum over the symbols of the device ms per launch the
    profiler recorded. The profiler can miss the first launches of a
    window, and now and then a whole window (three windows in a row on an
    H100 80GB HBM3, 700 W): then a window twice as long is profiled, up to
    ``attempts`` windows, and None (not measured) is returned if a symbol
    is never recorded."""
    symbols = (symbols,) if isinstance(symbols, str) else symbols
    for attempt in range(attempts):
        events = device_events(fn, iters << attempt)
        per_launch = {}
        for symbol in set(symbols):
            hits = [(t, n) for key, t, n in events if symbol in key]
            launches = sum(n for _, n in hits)
            if launches:
                per_launch[symbol] = sum(t for t, _ in hits) / launches
        if len(per_launch) == len(set(symbols)):
            return sum(per_launch[s] for s in symbols)
        log(f"  info: the profiler recorded no launch of {sorted(set(symbols) - set(per_launch))}"
            f" in a window of {iters << attempt} calls")
    return None


def fmt_ms(ms):
    """A profiler reading for the log: ms to 4 places, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f}"


def call_device_ms(fn, iters):
    """Profiler device ms per call of ``fn``, every device event counted."""
    return sum(t for _, t, _ in device_events(fn, iters)) / iters


def staged(wrapper, shape):
    """Whether ``wrapper`` ("forward", "bwd_apply" or "stats") runs
    ``shape``'s map as the staged kernels on this card."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    return fu.kernel_design(wrapper, *shape[1:], limit) == fu.STAGED


def ptxas_report():
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from the ``-Xptxas=-v`` logs of the built libraries."""
    import re

    from fastfourierconvolution_tpu_torch.ops import _build

    report, name, spills = {}, None, (0, 0)
    for log_path in sorted(_build.BUILD_DIR.glob("*.so.log")):
        for line in log_path.read_text().splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                name, spills = m.group(1), (0, 0)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = (int(m.group(1)), int(m.group(2)))
            elif (m := re.search(r"Used (\d+) registers", line)) and name:
                report[name] = (int(m.group(1)),) + spills
    return report


# The wrappers whose per-item design runs a clustered kernel: the wrapper's
# name in kernel_design, the kernel's plan in _item_rank_floats, its symbol.
ITEM_KERNELS = {"fourier_unit_fwd": ("forward", "forward", "fu_item_fwd_kernel"),
                "fu_train_stats": ("stats", "train_stats", "fu_item_train_stats_kernel"),
                "fu_bwd_stats": ("stats", "bwd_stats", "fu_item_bwd_stats_kernel"),
                "fu_bwd_apply": ("bwd_apply", "bwd_apply", "fu_item_bwd_apply_kernel")}


def item_kernel_line(name, shape, dtype_name):
    """The clustered per-item kernel's launch by ``name``'s wrapper at
    ``shape`` as text: its ranks per item (``fourier_unit.item_design``),
    blocks, shared memory per rank, and registers and spills from ptxas.
    Returns (text, ranks)."""
    import re

    import torch

    from fastfourierconvolution_tpu_torch.ops import _build
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    b, c, h, w = shape
    _, plan, symbol = ITEM_KERNELS[name]
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    ranks = fu.item_design(b, c, h, w, limit)
    smem = fu._item_rank_floats(plan, c, h, w, ranks) * 4
    threads = re.search(r"kItemThreads = (\d+)",
                        (_build.CSRC_DIR / "fourier_unit_item.cuh").read_text()).group(1)
    tag = "IfE" if dtype_name == "float32" else "bfloat16"
    regs = [v for k, v in ptxas_report().items() if symbol in k and tag in k]
    ptxas = (f"{regs[0][0]} registers, {regs[0][1]}/{regs[0][2]} bytes spill stores/loads"
             if regs else "ptxas report not found")
    return (f"design: {ranks} ranks per item, {b * ranks} blocks of {threads} threads, "
            f"{smem} B shared memory per rank; {symbol} {ptxas}"), ranks


def item_symbol(name, shape):
    """The clustered per-item kernel that ``name``'s wrapper launches at
    ``shape``, or None where it launches another (workspace, staged)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    if name not in ITEM_KERNELS:
        return None
    wrapper, _, symbol = ITEM_KERNELS[name]
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    return symbol if fu.kernel_design(wrapper, *shape[1:], limit) == fu.SHARED else None


def same_bits(fn):
    """Whether two calls of ``fn`` give the same bits in every output."""
    import torch

    first, again = as_tuple(fn()), as_tuple(fn())
    return all(torch.equal(a, b) for a, b in zip(first, again))


def check_fourier_unit(device, shapes, phase):
    """Phases 3 and 9 (forward): the wrapper against its plain version in
    f64, two launches giving the same bits, and its times. Returns the bf16
    rows of the per-item kernel for the kernels line and the bf16 rows of
    the wrapper calls that ran as the staged kernels."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier as F
    from fastfourierconvolution_tpu_torch.ops.fourier_unit import (
        EPS,
        fourier_unit_forward,
        fourier_unit_forward_plain,
    )

    rows, calls = [], []
    for shape in shapes:
        is_staged = staged("forward", shape)
        item = item_symbol("fourier_unit_fwd", shape)
        symbols = ([f"{k}_kernel" for k in STAGED_CALL["fourier_unit_fwd"]] if is_staged
                   else item or "fourier_unit_fwd_kernel")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = fu_inputs(shape, dtype, device, SEED)
            y = fourier_unit_forward(*args)
            torch.cuda.synchronize()
            ref = fourier_unit_forward_plain(*(a.double() for a in args))
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"kernel {shape} {name}: non-finite output")
            rel, abs_err = rel_max(y, ref)
            bits = same_bits(lambda: fourier_unit_forward(*args))
            ms = time_ms(lambda: fourier_unit_forward(*args))
            plain_ms = time_ms(lambda: fourier_unit_forward_plain(*args))
            dev_ms = kernel_device_ms(lambda: fourier_unit_forward(*args), symbols,
                                      iters=10 if ms < 1 else 3)
            bound_ms, bound_by, nbytes, flops = bound(
                "fourier_unit_fwd", shape, y.element_size(), name
            )
            design, ranks = (item_kernel_line("fourier_unit_fwd", shape, name) if item
                             else ("", None))
            log(
                f"fourier_unit_fwd {shape} {name} ({'staged' if is_staged else 'per-item'}):"
                f" rel-max {rel:.3e} against the plain version in f64 (tol "
                f"{FU_REL_TOL[name]:g}), max-abs {abs_err:.3e}, same bits on two launches "
                f"{bits}; {ms:.4f} ms/call (profiler device {fmt_ms(dev_ms)} ms per call), plain "
                f"{plain_ms:.4f} ms/call, bound {bound_ms:.5f} ms ({nbytes} B, {flops} FLOP)"
                + (f"; {design}" if design else "")
            )
            if not rel <= FU_REL_TOL[name]:
                raise AssertionError(
                    f"kernel {shape} {name}: rel-max {rel} > {FU_REL_TOL[name]}"
                )
            if not bits:
                raise AssertionError(f"kernel {shape} {name}: two launches differ")
            if dtype == torch.float32:
                x, kernel, scale, bias, mean, var = args
                c = shape[1]
                f_r, f_i = F.rfft2_ortho_fft(x)
                m = torch.einsum("bjuv,jd->bduv", torch.cat([f_r, f_i], 1), kernel)
                col = lambda t: t[:, None, None]
                r = torch.relu((m - col(mean)) * torch.rsqrt(col(var) + EPS)
                               * col(scale) + col(bias))
                y_fft = F.irfft2_ortho_fft(r[:, :c], r[:, c:], shape[2:])
                gap = (y_fft - ref.float()).abs().max().item()
                log(f"  info: torch.fft (cuFFT) vs factor form, max-abs {gap:.3e}"
                    f" (rel {gap / ref.abs().max().item():.3e})")
            else:
                numbers = dict(phase=phase, max_abs_err=abs_err, ms=ms, device_ms=dev_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                if ranks:
                    numbers["ranks"] = ranks
                if is_staged:
                    calls.append(call_row("fourier_unit_fwd", shape, name, **numbers))
                else:
                    rows.append(kernel_row("fourier_unit_fwd", shape, name, library_ms=None,
                                           **numbers))
    return rows, calls


def bwd_inputs(shape, dtype, device, seed):
    """(x, kernel, scale, bias, mean, var, gy, gscale, gbias) for the
    backward at ``shape``: the statistics and backward sums from the plain
    versions in f64, rounded to f32, and biases that keep every
    pre-activation clear of the ReLU's kink (``relu_margin_bias``)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    x, kernel, scale, bias, _, _ = fu_inputs(shape, dtype, device, seed)
    gy = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1)).to(device, dtype)
    f64 = lambda args: [a.double() for a in args]
    mean, var = (t.float() for t in fu.fu_train_stats_plain(*f64((x, kernel))))
    bias, margin = fu.relu_margin_bias(x, kernel, scale, bias, mean, var)
    log(f"  {shape} {str(dtype)[6:]}: every pre-activation at least {margin:.2e} from 0")
    bwd = (x, kernel, scale, bias, mean, var, gy)
    gscale, gbias = (t.float() for t in fu.fu_bwd_stats_plain(*f64(bwd)))
    return bwd + (gscale, gbias)


def train_cases(shape, dtype, device, seed):
    """[(name, wrapper, plain version, arguments, output names)] for the
    training kernels at ``shape`` (inputs from ``bwd_inputs``) and, where
    the statistics are staged, for the training op's staged forward and
    backward against the plain train forward and backward."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    args = bwd_inputs(shape, dtype, device, seed)
    cases = [
        ("fu_train_stats", fu.fu_train_stats, fu.fu_train_stats_plain, args[:2],
         ("bmean", "bvar")),
        ("fu_bwd_stats", fu.fu_bwd_stats, fu.fu_bwd_stats_plain, args[:7], ("gscale", "gbias")),
        ("fu_bwd_apply", fu.fu_bwd_apply, fu.fu_bwd_apply_plain, args, ("gx", "gK")),
    ]
    if staged("stats", shape):
        cases += [
            ("train_forward", fu._train_forward_staged, fu.fourier_unit_train_plain, args[:4],
             ("y", "bmean", "bvar")),
            ("train_backward", fu._train_backward_staged,
             lambda *a: fu.fourier_unit_backward_plain(*a)[:4], args[:7],
             ("gx", "gK", "gscale", "gbias")),
        ]
    return cases


def stage_cases(shape, dtype, device):
    """[(name, maps, call, timed call, plain call, f64 reference, output
    names, library call or None)] for the staged kernels that the training
    op (and, where it is staged, the eval forward) runs at ``shape``'s map;
    each stage's input spectrum comes from the kernel before it.
    ``fu_bwd_mix`` writes gz over its G: its checked call takes a fresh
    copy, its timed call a scratch one."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    w = shape[3]
    f64 = lambda args: [a.double() if isinstance(a, torch.Tensor) else a for a in args]
    cases, inverse_of = [], None
    if staged("stats", shape):
        x, kernel, scale, bias, mean, var = fu_inputs(shape, dtype, device, SEED)
        mix = (fu.fu_spectrum(x)[0], kernel, scale, bias, mean, var)
        spectrum = lambda: fu.fu_spectrum(x)
        cases += [
            ("fu_spectrum", 1, spectrum, spectrum, lambda: fu.fu_spectrum_plain(x),
             lambda: fu.fu_spectrum_plain(x.double()), ("z",),
             lambda: torch.fft.rfft2(x.float(), norm="ortho")),
            ("fu_mix_stats", 1, lambda: fu.fu_mix_stats(*mix[:2]),
             lambda: fu.fu_mix_stats(*mix[:2]), lambda: fu.fu_mix_stats_plain(*mix[:2]),
             lambda: fu.fu_mix_stats_plain(*f64(mix[:2])), ("bmean", "bvar"), None),
            ("fu_mix_apply", 1, lambda: fu.fu_mix_apply(*mix), lambda: fu.fu_mix_apply(*mix),
             lambda: fu.fu_mix_apply_plain(*mix), lambda: fu.fu_mix_apply_plain(*f64(mix)),
             ("r",), None),
        ]
        inverse_of = fu.fu_mix_apply(*mix)
    if staged("bwd_apply", shape):
        xb, kb, sb, bb, mb, vb, gy, gsc, gbi = bwd_inputs(shape, dtype, device, SEED)
        z, g = fu.fu_spectrum(xb, gy)
        rest = (kb, sb, bb, mb, vb, gsc, gbi)
        scratch = g.clone()
        spectra = lambda: fu.fu_spectrum(xb, gy)
        sums = lambda: fu.fu_bwd_stats_mix(z, g, *rest[:5])
        cases += [
            ("fu_spectrum", 2, spectra, spectra, lambda: fu.fu_spectrum_plain(xb, gy),
             lambda: fu.fu_spectrum_plain(xb.double(), gy.double()), ("z|G",), None),
            ("fu_bwd_stats_mix", 1, sums, sums, lambda: fu.fu_bwd_stats_mix_plain(z, g, *rest[:5]),
             lambda: fu.fu_bwd_stats_mix_plain(*f64((z, g) + rest[:5])), ("gscale", "gbias"),
             None),
            ("fu_bwd_mix", 1, lambda: fu.fu_bwd_mix(z, g.clone(), *rest),
             lambda: fu.fu_bwd_mix(z, scratch, *rest),
             lambda: fu.fu_bwd_mix_plain(z, g, *rest),
             lambda: fu.fu_bwd_mix_plain(*f64((z, g) + rest)), ("gz", "gK"), None),
        ]
        if inverse_of is None:
            inverse_of = fu.fu_bwd_mix(z, g.clone(), *rest)[0]
    if inverse_of is not None:
        inverse = lambda: fu.fu_inverse(inverse_of, dtype, w)
        cases.append(
            ("fu_inverse", 1, inverse, inverse, lambda: fu.fu_inverse_plain(inverse_of, dtype, w),
             lambda: fu.fu_inverse_plain(inverse_of.double(), torch.float64, w), ("y",), None))
    return cases


def check_stages(device, shapes, phase):
    """Phase 9: each staged kernel against its plain version in f64 on the
    same inputs, two launches giving the same bits, its times and its
    bound; returns the bf16 rows for the kernels line."""
    import torch

    rows = []
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            itemsize = torch.empty((), dtype=dtype).element_size()
            for name, maps, call, timed, plain, ref64, out_names, library in stage_cases(
                    shape, dtype, device):
                outs = as_tuple(call())
                torch.cuda.synchronize()
                refs = as_tuple(ref64())
                if not all(torch.isfinite(o.float()).all() for o in outs):
                    raise AssertionError(f"{name} {shape} {dname}: non-finite output")
                errs = {o: rel_max(out, ref) for o, out, ref in zip(out_names, outs, refs)}
                bits = same_bits(call)
                ms = time_ms(timed)
                plain_ms = time_ms(plain)
                dev_ms = kernel_device_ms(timed, f"{name}_kernel", iters=10 if ms < 1 else 3)
                library_ms = library_dev_ms = None
                if library is not None:
                    library_ms = time_ms(library)
                    library_dev_ms = call_device_ms(library, iters=10)
                bound_ms, bound_by, nbytes, flops = bound(name, shape, itemsize, dname, maps=maps)
                log(f"{name} {shape} {dname}, {maps} map(s): " + ", ".join(
                    f"{o} rel-max {r:.3e} (max-abs {a:.3e})" for o, (r, a) in errs.items())
                    + f" (tol {FU_REL_TOL[dname]:g}, against the plain version in f64), same "
                    f"bits on two launches {bits}; kernel {ms:.4f} ms/call (profiler device "
                    f"{fmt_ms(dev_ms)} ms), plain {plain_ms:.4f} ms/call, library {library_ms} "
                    f"ms/call (profiler device {library_dev_ms}), bound {bound_ms:.5f} ms "
                    f"({bound_by}; {nbytes} B, {flops} FLOP)")
                bad = {o: r for o, (r, _) in errs.items() if not r <= FU_REL_TOL[dname]}
                if bad or not bits:
                    raise AssertionError(f"{name} {shape} {dname}: rel-max {bad}, same bits {bits}")
                if dtype == torch.bfloat16:
                    rows.append(kernel_row(
                        name, shape, dname, phase=phase, maps=maps,
                        max_abs_err=max(a for _, a in errs.values()),
                        rel_max={o: r for o, (r, _) in errs.items()}, ms=ms, device_ms=dev_ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms, library_device_ms=library_dev_ms,
                    ))
    return rows


def call_row(name, shape, dtype_name, **numbers):
    """A row of the wrapper_calls line: a call that launches the stage
    kernels of ``STAGED_CALL[name]``, all its stages together."""
    return {"name": name, "stages": list(STAGED_CALL[name]), "shape": list(shape),
            "dtype": dtype_name, **numbers}


def check_train_kernels(device, shapes, phase):
    """Phases 5 and 9 (training kernels): each wrapper, and on staged maps
    the training op's staged forward and backward, against its plain
    version in f64, two launches giving the same bits, and its times.
    Returns the bf16 rows (and the reduction's f32 rows) for the kernels
    line, and the bf16 rows of the calls that ran as the staged kernels."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    rows, calls = [], []
    for shape in shapes:
        is_staged = staged("stats", shape)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            for name, kern, plain, args, out_names in train_cases(shape, dtype, device, SEED):
                outs = kern(*args)
                torch.cuda.synchronize()
                refs = plain(*(a.double() for a in args))
                errs = {o: rel_max(out, ref) for o, out, ref in zip(out_names, outs, refs)}
                if not all(torch.isfinite(out.float()).all() for out in outs):
                    raise AssertionError(f"{name} {shape} {dname}: non-finite output")
                call_staged = is_staged and name in STAGED_CALL
                item = item_symbol(name, shape)
                symbols = ([f"{k}_kernel" for k in STAGED_CALL[name]] if call_staged
                           else item or f"{name}_kernel")
                bits = same_bits(lambda: kern(*args))
                ms = time_ms(lambda: kern(*args))
                plain_ms = time_ms(lambda: plain(*args))
                dev_ms = kernel_device_ms(lambda: kern(*args), symbols,
                                          iters=10 if ms < 1 else 3)
                bound_ms, bound_by, nbytes, flops = bound(name, shape, args[0].element_size(), dname)
                log(f"{name} {shape} {dname}{' (staged)' if call_staged else ''}: " + ", ".join(
                    f"{o} rel-max {r:.3e} (max-abs {a:.3e})" for o, (r, a) in errs.items())
                    + f" (tol {FU_REL_TOL[dname]:g}, against the plain version in f64), same "
                    f"bits on two launches {bits}; kernel {ms:.4f} ms/call with its reduction "
                    f"(profiler device {fmt_ms(dev_ms)} ms{' per call, all stages' if call_staged else ''}"
                    f"), plain {plain_ms:.4f} ms/call, bound "
                    f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B, {flops} FLOP)")
                design, ranks = item_kernel_line(name, shape, dname) if item else ("", None)
                if design:
                    log(f"  {design}")
                gaps = {o: rel_max(p, r)[0] for o, p, r in zip(out_names, plain(*args), refs)}
                log(f"  info: plain version in {dname} vs f64, rel-max " + ", ".join(
                    f"{o} {g:.3e}" for o, g in gaps.items()))
                if dtype == torch.bfloat16:
                    numbers = dict(phase=phase, max_abs_err=max(a for _, a in errs.values()),
                                   rel_max={o: r for o, (r, _) in errs.items()}, ms=ms,
                                   device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
                    if ranks:
                        numbers["ranks"] = ranks
                    if call_staged:
                        calls.append(call_row(name, shape, dname, **numbers))
                    else:
                        rows.append(kernel_row(name, shape, dname, library_ms=None, **numbers))
                bad = {o: r for o, (r, _) in errs.items() if not r <= FU_REL_TOL[dname]}
                if bad or not bits:
                    raise AssertionError(f"{name} {shape} {dname}: rel-max {bad}, same bits {bits}")
    return rows, calls


def reduce_cases(fu_shapes):
    """[(rows, cols, count)] of ``fu_reduce`` on a training step's main path:
    per FourierUnit map the statistics' (rows, 4C) with the mean/variance
    epilogue, the backward sums' (rows, 4C) and gK's (rows, 4C^2), a row
    per item or per run of tiles (B * chunks) after the staged stages."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    cases = []
    for shape in fu_shapes:
        b, c, h, w = shape
        n_rows = b * fu.staged_chunks(b, h, w) if staged("stats", shape) else b
        cases += [(n_rows, 4 * c, b * h * (w // 2 + 1)), (n_rows, 4 * c, 0),
                  (n_rows, 4 * c * c, 0)]
    # one case per kernel work: the epilogue's count only scales its result
    unique = {}
    for n_rows, cols, count in cases:
        unique.setdefault((n_rows, cols, count > 0), (n_rows, cols, count))
    return list(unique.values())


# A column count no main-path shape has: odd, so the scalar loads.
REDUCE_ODD = (37, 1001, 0)


def check_reduce(device, cases, phase):
    """Phases 5 and 9 (the batch reduction): ``fu_reduce`` at every
    (rows, cols, count) of ``cases`` against its plain version in f64, the
    public wrapper and the callers' entry (``fourier_unit._reduce``) giving
    the same bits on two launches each, with its times beside one
    ``torch.sum`` call's (plain sums) and its host µs per call beside
    ``torch.sum``'s. Returns the rows for the kernels line (not the odd
    case's, which the main path never runs)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    g = torch.Generator().manual_seed(SEED)
    rows = []
    for n_rows, cols, count in cases:
        partial = torch.randn(n_rows, cols, generator=g).to(device)
        before = fu.fu_reduce.launches
        out, lean = fu.fu_reduce(partial, count), fu._reduce(partial, count)
        torch.cuda.synchronize()
        if fu.fu_reduce.launches != before + 2:
            raise AssertionError(f"fu_reduce ({n_rows}, {cols}): not one launch per call")
        ref = fu.fu_reduce_plain(partial.double(), count)
        rel, err = rel_max(out, ref)
        bits = (torch.equal(out, lean) and same_bits(lambda: fu.fu_reduce(partial, count))
                and same_bits(lambda: fu._reduce(partial, count)))
        entry = lambda: fu._reduce(partial, count)
        ms, public_ms, plain_ms = (time_ms(entry), time_ms(lambda: fu.fu_reduce(partial, count)),
                                   time_ms(lambda: fu.fu_reduce_plain(partial, count)))
        host = host_us(entry)
        dev_ms = kernel_device_ms(entry, "fu_reduce_kernel", iters=10)
        library_ms = library_dev_ms = library_host = None
        if count == 0:
            library = lambda: torch.sum(partial, 0)
            library_ms, library_host = time_ms(library), host_us(library)
            library_dev_ms = call_device_ms(library, iters=10)
        bound_ms, bound_by, nbytes, flops = bound("fu_reduce", (n_rows, cols), 4, "float32")
        vec, cluster = fu.reduce_design(n_rows, cols, count > 0)
        log(f"fu_reduce ({n_rows}, {cols}) count {count} (vec {vec}, cluster {cluster}): rel-max "
            f"{rel:.3e} (max-abs {err:.3e}, against an f64 sum; tol {FU_REL_TOL['float32']:g}), "
            f"same bits on two launches of each entry {bits}; callers' entry {ms:.4f} ms/call, "
            f"{host:.1f} us host/call (profiler device {fmt_ms(dev_ms)} ms), public wrapper "
            f"{public_ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound {bound_ms:.6f} ms "
            f"({bound_by})")
        if count == 0:
            log(f"  torch.sum {library_ms:.4f} ms/call, {library_host:.1f} us host/call "
                f"(profiler device {library_dev_ms:.4f} ms); fu_reduce per call <= torch.sum: "
                f"{ms <= library_ms}, device <= torch.sum: "
                f"{dev_ms is not None and dev_ms <= library_dev_ms}")
        if not rel <= FU_REL_TOL["float32"] or not bits:
            raise AssertionError(f"fu_reduce ({n_rows}, {cols}): rel-max {rel}, same bits {bits}")
        if (n_rows, cols, count) != REDUCE_ODD:
            rows.append(kernel_row(
                "fu_reduce", (n_rows, cols), "float32", phase=phase, count=count, vec=vec,
                cluster=cluster, max_abs_err=err, ms=ms, host_us=host, public_ms=public_ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, library_host_us=library_host,
                library_device_ms=library_dev_ms,
            ))
    return rows


def bn_inputs(shape, dtype, device, seed):
    """Seeded maps (x, n_l, n_g, g) in ``dtype`` and f32 vectors (scale,
    bias, w, g_mean, g_var) for a packed map, drawn on the card."""
    import torch

    b, c, h, w = shape
    g = torch.Generator(device).manual_seed(seed)
    randn = lambda *size: torch.randn(size, generator=g, device=device)
    maps = (randn(*shape) * 1.5 + 0.3, randn(b, 1, h, w), randn(b, 1, h, w), randn(*shape))
    vecs = (torch.rand(c, generator=g, device=device) + 0.5, randn(c) * 0.2, randn(c) * 0.3,
            randn(c), randn(c))
    return [t.to(dtype) for t in maps], list(vecs)


def bn_cases(shape, dtype, device):
    """{case: (kernel, noise, wrapper call, its reference in f64, the plain
    version's call on the same inputs, whether its outputs are sums)} for
    the fused BN + GELU kernels at ``shape``, with and without the noise
    fold (cl = C/2). The later passes take the f64 statistics and sums,
    rounded to f32; the backward sums' f64 reference keeps the op's own
    (f32, then rounded to the dtype) u, whose bf16 rounding an f64 u would
    move across a boundary now and then."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba

    (x, n_l, n_g, gy), (scale, bias, w, g_mean, g_var) = bn_inputs(shape, dtype, device, SEED)
    cl = shape[1] // 2
    d64 = lambda args: [a.double() if isinstance(a, torch.Tensor) else a for a in args]
    stats64 = ba.bn_stats_plain(x.double())
    mean, var = (t.float() for t in stats64)
    cases = {"bn_stats": ("bn_stats", False, lambda: ba.bn_stats(x), lambda: stats64,
                          lambda: ba.bn_stats_plain(x), True)}
    for noise in (False, True):
        suffix = "+noise" if noise else ""
        apply_args = (x, mean, var, scale, bias) + ((w, n_l, n_g, cl) if noise else ())
        reduce_args = (x, gy, mean, var, scale, bias) + ((n_l, n_g, cl) if noise else ())
        sums64 = ba.bn_bwd_reduce_plain(*reduce_args, sum_dtype=torch.float64)
        s1, s2 = (t.float() for t in sums64[:2])
        dx_args = (x, gy, mean, var, scale, bias, s1, s2, g_mean, g_var) + (
            (w, cl) if noise else ())
        for name, wrapper, plain, args, sums in (
            ("bn_gelu_apply", ba.bn_gelu_apply, ba.bn_gelu_apply_plain, apply_args, False),
            ("bn_bwd_reduce", ba.bn_bwd_reduce, ba.bn_bwd_reduce_plain, reduce_args, True),
            ("bn_bwd_dx", ba.bn_bwd_dx, ba.bn_bwd_dx_plain, dx_args, False),
        ):
            ref = (lambda s=sums64: s) if sums else (lambda p=plain, a=args: p(*d64(a)))
            cases[name + suffix] = (name, noise, lambda f=wrapper, a=args: f(*a), ref,
                                    lambda p=plain, a=args: p(*a), sums)
    return x, cases


def as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


# A map whose planes are no multiple of 16 bytes in bf16: the element-wise
# loads of bn_stats, bn_gelu_apply and bn_bwd_reduce (checked, not in the
# kernels line).
STATS_TAIL_SHAPE = (BATCH, 192, 10, 10)


def bn_design(name, noise, shape, x):
    """(the launch that ``name``'s wrapper picks for ``x``, as text; False
    where the apply's grid holds less than one full wave of the blocks the
    card holds at once, by the occupancy calculator's count for the built
    kernel)."""
    from fastfourierconvolution_tpu_torch.ops import bn_act as ba

    b, c, h, w = shape
    if name == "bn_gelu_apply":
        vec, tile, group = ba.apply_design(b, c, h * w, x.element_size())
        grid = ba.apply_blocks(b, c, h * w, x.element_size(), vec, tile, group)
        per_sm = ba.apply_blocks_per_sm(x.dtype, noise, vec, tile)
        wave = 132 * per_sm
        full = per_sm > 0 and grid[0] * grid[1] >= wave
        return (f"{'16-byte' if vec else 'element-wise'} units, blocks of {tile}, groups of "
                f"{group}: grid {grid[0]} x {grid[1]} = {grid[0] * grid[1]} blocks, the card "
                f"holds {per_sm} per SM ({wave} on 132 SMs): full wave {full}"), full
    if name in ("bn_stats", "bn_bwd_reduce"):
        design = ba.stats_design if name == "bn_stats" else ba.bwd_reduce_design
        vec, cluster = design(b, c, h * w, x.element_size())
        return (f"one launch, {'16-byte' if vec else 'element-wise'} loads, clusters of "
                f"{cluster}"), True
    return "a row per thread, grid.y 2", True


def check_bn_act(device):
    """Phase 8; returns the bf16 rows for the kernels line."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    rows = []
    for shape in PACKED_SHAPES + [STATS_TAIL_SHAPE]:
        tail = shape == STATS_TAIL_SHAPE
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            x, cases = bn_cases(shape, dtype, device)
            for case, (name, noise, kern, ref64, plain, sums) in cases.items():
                wrapper = getattr(ba, name)
                before = (wrapper.launches, fu.fu_reduce.launches)
                outs = as_tuple(kern())
                torch.cuda.synchronize()
                if (wrapper.launches, fu.fu_reduce.launches) != (before[0] + 1, before[1]):
                    raise AssertionError(f"{case} {shape} {dname}: not one launch per call, "
                                         f"or a fu_reduce launch")
                refs = as_tuple(ref64())
                if not all(torch.isfinite(o.float()).all() for o in outs):
                    raise AssertionError(f"{case} {shape} {dname}: non-finite output")
                if sums or dtype == torch.float32:
                    errs = [rel_max(o, r)[0] for o, r in zip(outs, refs)]
                    what, tol = "rel-max against f64", BN_REL_TOL
                else:
                    errs = [bf16_ulps(o, r) for o, r in zip(outs, as_tuple(plain()))]
                    what, tol = "bf16 ulps against the plain version", BN_BF16_ULPS
                max_abs = max((o.float() - r.float()).abs().max().item()
                              for o, r in zip(outs, refs))
                line = f"{case} {shape} {dname}: {what} " + ", ".join(
                    f"{e:.3e}" for e in errs) + f" (tol {tol:g}), max-abs vs f64 {max_abs:.3e}"
                bits = same_bits(kern)
                design, full_wave = bn_design(name, noise, shape, x)
                line += f"; {design}; same bits on two launches {bits}"
                if dtype == torch.bfloat16 and not tail:
                    ms = time_ms(kern)
                    plain_ms = time_ms(plain)
                    dev_ms = kernel_device_ms(kern, f"{name}_kernel", iters=10)
                    library_ms = library_dev_ms = host = library_host = None
                    if name == "bn_stats":
                        library = lambda: torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
                        library_ms, library_host = time_ms(library), host_us(library)
                        library_dev_ms = call_device_ms(library, iters=10)
                        host = host_us(kern)
                    bound_ms, bound_by, nbytes, flops = bound(name, shape, x.element_size(),
                                                              dname, noise)
                    line += (f"; kernel {ms:.4f} ms/call (profiler device {fmt_ms(dev_ms)} ms), "
                             f"plain {plain_ms:.4f} ms/call, torch.var_mean {library_ms} "
                             f"ms/call (profiler device {library_dev_ms} ms), bound "
                             f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B, {flops} FLOP)")
                    if name == "bn_stats":
                        line += (f"; host {host:.1f} us/call, torch.var_mean {library_host:.1f} "
                                 f"us/call; per call <= torch.var_mean: {ms <= library_ms}")
                    rows.append(kernel_row(
                        name, shape, dname, phase="training-128px", noise=noise,
                        max_abs_err=max_abs, ms=ms, host_us=host, device_ms=dev_ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms, library_host_us=library_host,
                        library_device_ms=library_dev_ms,
                    ))
                log(line)
                if not all(e <= tol for e in errs) or not bits or not full_wave:
                    raise AssertionError(f"{case} {shape} {dname}: {what} {errs} > {tol}, "
                                         f"two launches differ or the grid misses a wave")
    return rows


def calibrate_running_stats(model, z):
    """Set every BatchNorm's and FourierUnit's running statistics to the
    f32 batch statistics of its input on ``z``, layer by layer."""
    import torch

    from fastfourierconvolution_tpu_torch.nn.ffc import FourierUnit
    from fastfourierconvolution_tpu_torch.nn.layers import BatchNorm
    from fastfourierconvolution_tpu_torch.ops.fourier import rfft2_ortho

    def set_stats(mod, v):
        mod.running_mean.copy_(v.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(v.var(dim=(0, 2, 3), unbiased=False))

    def bn_hook(mod, args):
        set_stats(mod, args[0].float())

    def fu_hook(mod, args):
        f_r, f_i = rfft2_ortho(args[0].float())
        z_spec = torch.cat([f_r, f_i], dim=1)
        set_stats(mod, torch.einsum("bjuv,jd->bduv", z_spec, mod.mix_kernel.float()))

    hooks = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(bn_hook))
        elif isinstance(m, FourierUnit):
            hooks.append(m.register_forward_pre_hook(fu_hook))
    try:
        with torch.no_grad():
            model(z, torch.float32)
    finally:
        for h in hooks:
            h.remove()


def serve(device, card):
    """Phase 4; returns the kernel's launches by (C, H, W) over the served
    requests."""
    import torch

    from fastfourierconvolution_tpu_torch import Generator
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu_module
    from fastfourierconvolution_tpu_torch.ops.fourier_unit import (
        fourier_unit_forward,
        fourier_unit_forward_plain,
    )

    server = Generator.from_preset(
        32, generator=torch.Generator().manual_seed(SEED), device=device, dtype="bf16"
    )
    g = torch.Generator().manual_seed(SEED + 1)
    calibrate_running_stats(server.model, torch.randn(256, 128, generator=g).to(device))
    requests = [torch.randn(BATCH, 128, generator=g) for _ in range(N_REQUESTS)]
    requests += [torch.randn(1, 128, generator=g), torch.randn(7, 128, generator=g)]
    server.generate(requests[0])  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()

    fourier_unit_forward.launches = 0
    fourier_unit_forward.launches_by_map.clear()
    images, per_request = [], []
    for z in requests:
        before = fourier_unit_forward.launches
        images.append(server.generate(z))
        per_request.append(fourier_unit_forward.launches - before)
    torch.cuda.synchronize()
    launches = fourier_unit_forward.launches
    by_map = dict(fourier_unit_forward.launches_by_map)

    for z, im in zip(requests, images):
        if im.shape != (z.shape[0], 32, 32, 3) or im.dtype != torch.uint8:
            raise AssertionError(f"request gave {tuple(im.shape)} {im.dtype}")
    if per_request != [2] * len(requests) or launches != 2 * len(requests):
        raise AssertionError(f"kernel launches per request {per_request}")
    if by_map != {tuple(s[1:]): len(requests) for s in FU_SHAPES}:
        raise AssertionError(f"kernel launches by map {by_map}")
    spread = images[0].float().std().item()
    if not spread > 5.0:
        raise AssertionError(f"images are flat (std {spread:.2f} levels)")
    floats = server.generate(requests[0], uint8=False)
    if not torch.isfinite(floats.float()).all():
        raise AssertionError("non-finite generator output")
    # Throughput: batch-64 requests back to back for TIMED_SECONDS of
    # host clock, synchronised at the end.
    z = requests[0]
    n_timed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TIMED_SECONDS:
        for _ in range(20):
            server.generate(z)
        n_timed += 20
        torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    img_s = n_timed * BATCH / timed_s
    wall_ms = timed_s / n_timed * 1e3
    busy_ms, n_launch, top = device_breakdown(lambda: server.generate(requests[0]))
    log(f"batch-{BATCH} request: {wall_ms:.3f} ms wall (unprofiled), device busy "
        f"{busy_ms:.3f} ms in {n_launch} device launches (profiler), idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for name, ms, count in top:
        log(f"  device {ms:.4f} ms in {count} launches: {name[:90]}")
    log(f"served {len(requests)} requests ({N_REQUESTS} x {BATCH}, 1, 7): "
        f"{launches} kernel launches, per request {per_request}; image std "
        f"{spread:.1f} levels")
    log(f"served {by_map} kernel launches by (C, H, W)")
    log(f"throughput: {img_s:.1f} img/s at batch {BATCH}, bf16 "
        f"({n_timed} requests, {n_timed * BATCH} images in {timed_s:.3f} s, "
        f"host clock; {card})")

    for dtype in ("bfloat16", "float32"):
        server.dtype = getattr(torch, dtype)
        kern = server.generate(requests[0]).int()
        with mock.patch.object(fu_module, "fourier_unit_forward", fourier_unit_forward_plain):
            plain = server.generate(requests[0]).int()
        diff = (kern - plain).abs().float()
        log(f"request vs plain op, {dtype}: max {int(diff.max())} levels, "
            f"mean {diff.mean().item():.4f} (bars {U8_MAX_LEVELS[dtype]}, "
            f"{U8_MEAN_LEVELS[dtype]})")
        if diff.max() > U8_MAX_LEVELS[dtype] or diff.mean() > U8_MEAN_LEVELS[dtype]:
            raise AssertionError(f"served images differ from the plain op ({dtype})")
    server.dtype = torch.bfloat16
    return by_map


def serve_generate(device, card, trainer):
    """Phase 14 (serving): ``trainer.generate(z, labels, uint8=True)`` on
    the trained fgan_cond32 generator in eval mode: 8 requests of batch 64
    with exact launches (the eval forward kernel twice a request, no other
    FourierUnit kernel), the trainer's state unmoved, img/s over
    back-to-back requests, and one request against the plain op in bf16 and
    f32. Returns the forward kernel's launches by map."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    g = torch.Generator().manual_seed(SEED + 30)
    zs = [torch.randn(BATCH, 128, generator=g).to(device) for _ in range(N_REQUESTS)]
    labels = label_batch(device, SEED + 30, "cond32", (N_REQUESTS, BATCH))
    state = {k: v.clone() for k, v in trainer.g.state_dict().items()}
    trainer.generate(zs[0], labels[0], uint8=True)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    images = [trainer.generate(z, y, uint8=True) for z, y in zip(zs, labels)]
    torch.cuda.synchronize()
    counts = {k: v for k, v in counts_by_map().items() if v}
    want = {"fourier_unit_fwd": {tuple(s[1:]): N_REQUESTS for s in FU_SHAPES}}
    if counts != want:
        raise AssertionError(f"generate's kernel launches {counts}, expected {want}")
    for im in images:
        if im.shape != (BATCH, 32, 32, 3) or im.dtype != torch.uint8:
            raise AssertionError(f"generate gave {tuple(im.shape)} {im.dtype}")
    spread = images[0].float().std().item()
    if not spread > 5.0:
        raise AssertionError(f"generated images are flat (std {spread:.2f} levels)")
    moved = [k for k, v in trainer.g.state_dict().items() if not torch.equal(v, state[k])]
    if moved or not trainer.g.training:
        raise AssertionError(f"generate moved G's state {moved[:4]} or its training flag")
    n_timed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TIMED_SECONDS:
        for _ in range(20):
            trainer.generate(zs[0], labels[0], uint8=True)
        n_timed += 20
        torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    busy_ms, n_launch, _ = device_breakdown(lambda: trainer.generate(zs[0], labels[0],
                                                                     uint8=True))
    wall_ms = timed_s / n_timed * 1e3
    log(f"cond32 generate(z, labels, uint8=True), batch {BATCH}, bf16: {n_timed * BATCH / timed_s:.1f} "
        f"img/s ({n_timed} requests in {timed_s:.3f} s, host clock), {wall_ms:.3f} ms wall a "
        f"request, device busy {busy_ms:.3f} ms in {n_launch} device launches (profiler), "
        f"idle share {1 - busy_ms / wall_ms:.3f}; image std {spread:.1f} levels; launches {counts}; "
        f"{card}")
    for dtype in ("bfloat16", "float32"):
        trainer.dtype = getattr(torch, dtype)
        kern = trainer.generate(zs[0], labels[0], uint8=True).int()
        with mock.patch.object(fu, "fourier_unit_forward", fu.fourier_unit_forward_plain):
            plain = trainer.generate(zs[0], labels[0], uint8=True).int()
        diff = (kern - plain).abs().float()
        log(f"cond32 request vs plain op, {dtype}: max {int(diff.max())} levels, mean "
            f"{diff.mean().item():.4f} (bars {U8_MAX_LEVELS[dtype]}, {U8_MEAN_LEVELS[dtype]})")
        if diff.max() > U8_MAX_LEVELS[dtype] or diff.mean() > U8_MEAN_LEVELS[dtype]:
            raise AssertionError(f"generated images differ from the plain op ({dtype})")
    trainer.dtype = torch.bfloat16
    return want["fourier_unit_fwd"]


def eval_gradients(device):
    """Phase 17: the gradients of an eval-mode FourierUnit (the op
    ``fourier_unit_eval``, running statistics) in x, K, scale and bias from
    the backward kernels (``fu_bwd_stats``, then ``fu_bwd_apply`` with zero
    sums) against ``fourier_unit_backward_plain(..., train=False)`` in f64,
    f32, each within ``FU_REL_TOL``; one launch of each kernel per
    backward."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    for shape in EVAL_GRAD_SHAPES:
        x, kernel, scale, bias, mean, var = fu_inputs(shape, torch.float32, device, SEED + 5)
        bias, margin = fu.relu_margin_bias(x, kernel, scale, bias, mean, var)
        gy = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 6)).to(device)
        leaves = [t.clone().requires_grad_() for t in (x, kernel, scale, bias)]
        y = fu.fourier_unit_eval(*leaves, mean, var)
        zero_counts()
        outs = torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
        counts = {k: v for k, v in counts_by_map().items() if v}
        key = tuple(shape[1:])
        if counts.get("fu_bwd_stats") != {key: 1} or counts.get("fu_bwd_apply") != {key: 1}:
            raise AssertionError(f"eval backward {shape}: kernel launches {counts}")
        refs = fu.fourier_unit_backward_plain(
            *(t.double() for t in (x, kernel, scale, bias, mean, var, gy)), train=False)
        errs = {n: rel_max(o, r) for n, o, r in zip(("gx", "gK", "gscale", "gbias"), outs, refs)}
        log(f"eval-mode FourierUnit gradients {shape} f32 ({fu._design('bwd_apply', x)} "
            f"backward apply; pre-activations at least {margin:.2e} from 0): " + ", ".join(
                f"{n} rel-max {r:.3e} (max-abs {a:.3e})" for n, (r, a) in errs.items())
            + f" (tol {FU_REL_TOL['float32']:g}, against the plain version in f64); launches "
            f"{counts}")
        if not all(r <= FU_REL_TOL["float32"] for r, _ in errs.values()):
            raise AssertionError(f"eval-mode gradients {shape}: {errs}")


def against_workspace(rows):
    """Logs each clustered training kernel's bf16 reading at (64,8,48,48)
    (``rows`` of ``check_train_kernels``) beside ``WORKSPACE_48_MS``."""
    for row in rows:
        if tuple(row["shape"]) != FU48_SHAPES[1] or row["name"] not in WORKSPACE_48_MS:
            continue
        lo, hi = WORKSPACE_48_MS[row["name"]]
        dev, bound_ms = row["device_ms"], row["bound_ms"]
        times = "not measured" if dev is None else f"{dev / bound_ms:.0f}x"
        log(f"{row['name']} {FU48_SHAPES[1]} bf16, clustered: {row['ranks']} ranks per item, "
            f"profiler device {fmt_ms(dev)} ms a launch, bound {bound_ms:.5f} ms, {times} its "
            f"bound; the workspace design {lo:.4f}-{hi:.4f} ms ({lo / bound_ms:.0f}-"
            f"{hi / bound_ms:.0f}x); faster: {dev is not None and dev < lo}")


def check_workspace_kernels(device):
    """The four per-item workspace kernels at ``WORKSPACE_SHAPES``, where
    ``kernel_design`` picks them for every wrapper, checked as in phases 3
    and 5. Returns their bf16 rows for the kernels line."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for shape in WORKSPACE_SHAPES:
        designs = {w: fu.kernel_design(w, *shape[1:], limit) for w in ("forward", "stats",
                                                                       "bwd_apply")}
        if set(designs.values()) != {fu.WORKSPACE}:
            raise AssertionError(f"{shape}: not the workspace design: {designs}")
    rows, _ = check_fourier_unit(device, WORKSPACE_SHAPES, "workspace-96px")
    train_rows, _ = check_train_kernels(device, WORKSPACE_SHAPES, "workspace-96px")
    return rows + train_rows


def launch_wrappers():
    """{kernel name: its wrapper}; each wrapper counts its launches."""
    from fastfourierconvolution_tpu_torch.ops import bn_act as ba
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    return {"fu_train_stats": fu.fu_train_stats, "fourier_unit_fwd": fu.fourier_unit_forward,
            "fu_bwd_stats": fu.fu_bwd_stats, "fu_bwd_apply": fu.fu_bwd_apply,
            "fu_spectrum": fu.fu_spectrum, "fu_mix_apply": fu.fu_mix_apply,
            "fu_mix_stats": fu.fu_mix_stats, "fu_bwd_stats_mix": fu.fu_bwd_stats_mix,
            "fu_inverse": fu.fu_inverse, "fu_bwd_mix": fu.fu_bwd_mix,
            "fu_reduce": fu.fu_reduce, "bn_stats": ba.bn_stats,
            "bn_gelu_apply": ba.bn_gelu_apply, "bn_bwd_reduce": ba.bn_bwd_reduce,
            "bn_bwd_dx": ba.bn_bwd_dx}


# path -> ([(FourierUnit map, training forwards, backwards) per step],
# packed BN maps). A generator map: the G phase's forward and the D phase's,
# one backward. A map of FFCDiscriminator (separate real and fake passes):
# the G phase's pass on the fakes and the D update's two passes, each with
# its backward (the G phase's gives G's gradient through D).
# With wgan-gp, a map of D adds the penalty's pass on the interpolates: a
# forward, its backward under create_graph and the backward through that
# forward when the penalty is differentiated.
STEP_MAPS = {32: ([(s, 2, 1) for s in FU_SHAPES], []),
             128: ([(s, 2, 1) for s in FU128_SHAPES], PACKED_SHAPES),
             "sngan": ([(s, 2, 1) for s in FU_SHAPES] + [(s, 3, 3) for s in D_FU_SHAPES], []),
             "sngan-gp": ([(s, 2, 1) for s in FU_SHAPES] + [(s, 4, 5) for s in D_FU_SHAPES], []),
             "cond32": ([(s, 2, 1) for s in FU_SHAPES], []),
             "cond48": ([(s, 2, 1) for s in FU48_SHAPES], []),
             **{path: ([], []) for path in ZOO_CONFIGS}}


def expected_launches(path, n_steps):
    """{kernel: {map or partial shape: launches}} for ``n_steps`` training
    steps of ``path``; maps of G and D with the same (C, H, W) add up."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    fu_maps, bn_shapes = STEP_MAPS[path]
    want = {k: collections.Counter() for k in launch_wrappers()}
    for shape, forwards, backwards in fu_maps:
        b, c, h, w = shape
        is_staged = staged("stats", shape)
        per_forward, per_backward = PASS_LAUNCHES["staged" if is_staged else "per_item"]
        for k, per in per_forward.items():
            want[k][(c, h, w)] += per * forwards * n_steps
        for k, per in per_backward.items():
            want[k][(c, h, w)] += per * backwards * n_steps
        # a statistics reduction per forward and a backward-sums reduction
        # per backward on (rows, 4C), a gK reduction per backward on
        # (rows, 4C^2): a row per item, or per run of tiles (B * chunks)
        # after the staged mix stages
        rows = b * fu.staged_chunks(b, h, w) if is_staged else b
        want["fu_reduce"][(rows, 4 * c)] += (forwards + backwards) * n_steps
        want["fu_reduce"][(rows, 4 * c * c)] += backwards * n_steps
    for b, c, h, w in bn_shapes:
        for k, per in BN_STEP_LAUNCHES.items():
            want[k][(c, h, w)] += per * n_steps
    return {k: dict(v) for k, v in want.items()}


def counts_by_map():
    return {k: dict(w.launches_by_map) for k, w in launch_wrappers().items()}


def zero_counts():
    for w in launch_wrappers().values():
        w.launches = 0
        w.launches_by_map.clear()


def zoo_config(path):
    """The port's config of a comparator path (``ZOO_CONFIGS``)."""
    from fastfourierconvolution_tpu_torch import make_config

    preset, overrides = ZOO_CONFIGS[path]
    return make_config(preset, **overrides)


def trainer_keywords(cfg):
    """The ``GANTrainer`` keywords the JAX CLI derives from a config
    (``cli.py:137-165``): D's fused pass only for the BN-free SN
    discriminators and without the aw-method, D's progress only for the
    library cDCGAN discriminator."""
    m, t = cfg.model, cfg.train
    return dict(z_size=m.z_size, lr=t.lr, d_lr=t.d_lr, total_steps=t.num_total_steps,
                num_dis_updates=t.num_dis_updates, loss=t.loss, optimizer=t.optimizer,
                b1=t.beta1, b2=t.beta2, conditional=m.conditional, num_classes=m.num_classes,
                fused_dis_batch=(m.discriminator in ("sn_conv", "cond_sn_conv", "sn_dcgan")
                                 and not t.aw_method),
                gp_lambda=t.gp_lambda, aw_method=t.aw_method, update_order=t.update_order,
                remat=t.remat, d_progress_arg=m.discriminator == "cond_dcgan")


def make_trainer(device, dtype, path, **options):
    """``path``'s pair with seeded weights: the preset generator of its
    resolution against the SN discriminator in bench.py's setting (fused D
    pass, hinge, AdamW), or, for "sngan", against ``FFCDiscriminator`` with
    Adam and separate D passes (the JAX ``sngan`` preset; "sngan-gp" with
    wgan-gp), or, for "cond32" and "cond48", the JAX ``fgan_cond32`` and
    ``fgan_cond48`` pairs (``FFCCondGenerator`` presets cifar32 and stl48
    against ``CondSNDiscriminator``, fused D pass, hinge, AdamW, 10
    classes), or, for a comparator path, the pair ``zoo.build_models``
    builds from its config (the models' default seeds), with the keywords
    the JAX CLI derives from it; ``options`` override the trainer's
    keywords."""
    import torch

    from fastfourierconvolution_tpu_torch import (
        CondSNDiscriminator,
        FFCCondGenerator,
        FFCDiscriminator,
        FFCGenerator,
        GANTrainer,
        SNConvDiscriminator,
    )

    if path in ZOO_CONFIGS:
        from fastfourierconvolution_tpu_torch import build_models

        cfg = zoo_config(path)
        g, d = build_models(cfg)
        setting = trainer_keywords(cfg)
        setting.update(options)
        return GANTrainer(g, d, seed=SEED, device=device, dtype=dtype, **setting)
    resolution = RESOLUTION[path]
    g_seed = torch.Generator().manual_seed(SEED)
    d_seed = torch.Generator().manual_seed(SEED + 1)
    if path in CONDITIONAL:
        g = FFCCondGenerator.for_preset({32: "cifar32", 48: "stl48"}[resolution],
                                        num_classes=NUM_CLASSES, generator=g_seed)
        d = CondSNDiscriminator(num_classes=NUM_CLASSES, resolution=resolution,
                                generator=d_seed)
        setting = dict(fused_dis_batch=True, conditional=True, num_classes=NUM_CLASSES)
        setting.update(options)
        return GANTrainer(g, d, seed=SEED, device=device, dtype=dtype, **setting)
    g = FFCGenerator.for_resolution(resolution, generator=g_seed)
    if path in ("sngan", "sngan-gp"):
        d = FFCDiscriminator(mg=resolution // 8, generator=d_seed)
        setting = dict(optimizer="adam", loss="wgan-gp" if path == "sngan-gp" else "hinge")
    else:
        d = SNConvDiscriminator.for_resolution(resolution, generator=d_seed)
        setting = dict(fused_dis_batch=True)
    setting.update(options)
    return GANTrainer(g, d, seed=SEED, device=device, dtype=dtype, **setting)


def real_batch(device, seed, resolution, batch=BATCH):
    """A seeded (B, R, R, 3) batch in [-1, 1], NHWC."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return (torch.rand(batch, resolution, resolution, 3, generator=g) * 2 - 1).to(device)


def label_batch(device, seed, path, shape=(BATCH,)):
    """Seeded class labels of ``shape`` for a conditional path, else None."""
    import torch

    if path not in CONDITIONAL:
        return None
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, NUM_CLASSES, shape, generator=g).to(device)


# Device events a replayed step adds to the eager step's: the replay's
# copies of the batch in and of the two losses out (on a conditional path
# one more, the labels' copy in), and the seed and the offset that each
# replay writes for each of the trainer's generators that the step draws
# from: the latents' always, the noise generator where G injects noise, D
# takes input noise or the gradient penalty draws its weights (the resnet32
# step, which draws no noise, added 2 writes, not 4; H100 80GB HBM3, 700 W).
REPLAY_COPIES = 3


def replay_extra_events(path, draws_noise):
    return REPLAY_COPIES + (path in CONDITIONAL) + 2 * (1 + draws_noise)


def step_events(fn, steps_per_call, iters):
    """(device ms, device events by name) per step of ``fn``'s calls, from
    the profiler over ``iters`` calls after one call that the trace runs
    and drops (the profiler can lose the first launches of a window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters, repeat=1)) as prof:
        for _ in range(iters + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    events = profiled_device_events(prof)
    per = iters * steps_per_call
    by_name = collections.Counter()
    for key, _, n in events:
        by_name[key] += n / per
    return sum(t for _, t, _ in events) / per, by_name


def launch_parity(trainer, real, reals, labels, labels_k, extra, attempts=6):
    """The profiler's device events per eager step and per replayed step,
    which must differ by ``extra``; a window whose counts disagree (the
    profiler can lose events: it lost some in 3 windows in a row, at the
    eager and at the replayed step, in 2 of 4 runs of one call on an H100
    80GB HBM3, 700 W) is profiled again, up to ``attempts`` times. The
    replayed window is one call of K steps. Returns (eager ms, eager
    events, graph ms, graph events, the names whose counts differ)."""
    k = reals.shape[0]
    for _ in range(attempts):
        eager_ms, eager = step_events(lambda: trainer.update_step(real, labels), 1, 3)
        graph_ms, graph = step_events(lambda: trainer.update_steps(reals, labels_k), k, 1)
        n_eager, n_graph = sum(eager.values()), sum(graph.values())
        differ = {key[:60]: (round(eager.get(key, 0), 2), round(graph.get(key, 0), 2))
                  for key in set(eager) | set(graph)
                  if abs(eager.get(key, 0) - graph.get(key, 0)) > 1e-9}
        if abs(n_graph - extra - n_eager) < 1e-9:
            return eager_ms, n_eager, graph_ms, n_graph, differ
        log(f"  info: eager step {n_eager:.2f} device events, replayed step {n_graph:.2f}: "
            f"profiled again")
    raise AssertionError(f"a replayed step's device events ({n_graph}) are not the eager "
                         f"step's ({n_eager}) + {extra}: {differ}")


def train(device, card, path):
    """Phases 6, 10, 13-15 and 18-20: eager steps, then ``update_steps``
    (see the module docstring); returns the trainer, the launches by map
    and kernel over the eager steps, and the replayed step's profiler
    device ms."""
    import torch

    resolution = RESOLUTION[path]
    trainer = make_trainer(device, "bf16", path)
    real = real_batch(device, SEED + 2, resolution)
    labels = label_batch(device, SEED + 2, path)
    warmup = WARMUP_STEPS[path]
    sync_every = 10 if resolution == 32 else 2
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = []
    noise_state = trainer.noise_generator.get_state()
    for i in range(warmup):
        before = counts_by_map()
        losses.append(trainer.update_step(real, labels))
        torch.cuda.synchronize()
        step = {k: {m: n - before[k].get(m, 0) for m, n in v.items()}
                for k, v in counts_by_map().items()}
        if step != expected_launches(path, 1):
            raise AssertionError(f"kernel launches in step {i}: {step}")
    n_timed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TIMED_SECONDS:
        for _ in range(sync_every):
            losses.append(trainer.update_step(real, labels))
        n_timed += sync_every
        torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    counts = counts_by_map()
    n_steps = warmup + n_timed
    if counts != expected_launches(path, n_steps):
        raise AssertionError(f"kernel launches over {n_steps} steps: {counts}")
    launches = {k: w.launches for k, w in launch_wrappers().items()}
    values = torch.stack([torch.stack([l["loss_g"], l["loss_d"]]) for l in losses])
    if not torch.isfinite(values).all():
        raise AssertionError("non-finite training loss")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = timed_s / n_timed * 1e3
    # 2 profiled steps where a step is long or holds thousands of launches
    busy_ms, n_launch, top = device_breakdown(
        lambda: trainer.update_step(real, labels),
        iters=2 if resolution > 48 or path in ZOO_CONFIGS else 5, top=12)
    log(f"{path} training step, batch {BATCH}, bf16, eager: {step_ms:.3f} ms wall "
        f"(unprofiled, {n_timed} steps in {timed_s:.3f} s, host clock), "
        f"{BATCH / step_ms * 1e3:.1f} img/s; device busy {busy_ms:.3f} ms in {n_launch} "
        f"device launches (profiler), idle share {1 - busy_ms / step_ms:.3f}; peak "
        f"memory {peak_gb:.2f} GB; {card}")
    for name, ms, count in top:
        log(f"  device {ms:.4f} ms in {count} launches: {name[:90]}")
    log(f"trained {n_steps} steps ({warmup} warm-up, each checked): losses "
        f"finite, last loss_g {values[-1, 0].item():.4f} loss_d {values[-1, 1].item():.4f}")
    log(f"trained: kernel launches {launches}; by map {counts}")

    # The step as a CUDA graph: the first call runs one step eagerly and
    # captures the step, whose launches the wrappers count; replays count
    # none.
    k = STEPS_PER_CALL[path]
    reals = torch.stack([real_batch(device, SEED + 10 + i, resolution) for i in range(k)])
    labels_k = label_batch(device, SEED + 10, path, (k, BATCH))
    zero_counts()
    t0 = time.perf_counter()
    graph_losses = [trainer.update_steps(reals, labels_k)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    captured = counts_by_map()
    if captured != expected_launches(path, 2):
        raise AssertionError(f"kernel launches of the first update_steps call (one eager "
                             f"step and the capture): {captured}")
    n_calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TIMED_SECONDS:
        graph_losses.append(trainer.update_steps(reals, labels_k))
        n_calls += 1
        torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    if counts_by_map() != captured:
        raise AssertionError("update_steps replays moved the kernels' launch counts")
    values = torch.stack([torch.stack([l["loss_g"], l["loss_d"]]) for l in graph_losses])
    if not torch.isfinite(values).all():
        raise AssertionError("non-finite training loss in update_steps")
    graph_ms = timed_s / (n_calls * k) * 1e3
    draws_noise = not torch.equal(noise_state, trainer.noise_generator.get_state())
    extra = replay_extra_events(path, draws_noise)
    eager_dev, n_eager, graph_dev, n_graph, differ = launch_parity(trainer, real, reals, labels,
                                                                   labels_k, extra)
    log(f"{path} training step as a CUDA graph (update_steps, K={k}), batch {BATCH}, bf16: "
        f"{graph_ms:.3f} ms wall per step (unprofiled, {n_calls} calls of {k} steps in "
        f"{timed_s:.3f} s, host clock; the first call, with its eager step and the capture, "
        f"{first_s:.3f} s), {BATCH / graph_ms * 1e3:.1f} img/s; device busy {graph_dev:.3f} ms "
        f"per step (profiler), idle share {1 - graph_dev / graph_ms:.3f}; eager step beside it: "
        f"{step_ms:.3f} ms wall, {eager_dev:.3f} ms device, idle share "
        f"{1 - eager_dev / step_ms:.3f}; {card}")
    log(f"  device events per step (profiler): eager {n_eager:.2f}, replayed {n_graph:.2f} = "
        f"eager + {extra} (the replay's {extra - 2 * (1 + draws_noise)} copies and 2 writes "
        f"for each of the {1 + draws_noise} generators the step draws from); "
        f"by name where they differ (eager, replayed): {differ}")
    log(f"  launches counted at the first update_steps call (one eager step, the capture): "
        f"{captured}; unmoved by {n_calls * k} replayed steps")
    return trainer, counts, graph_dev


# FFCDiscriminator's convolution biases in blocks 1-3, and the conditional
# generator's two ConvT stem biases, feed BatchNorm, which subtracts them
# again: their gradient is 0 up to rounding, so a relative gap says nothing
# there; their largest gradient is printed instead.
FREE_BIAS = re.compile(r"d\.block[1-3]\.ffc\.conv(l2l|l2g|g2l)\.bias|g\.(label|input)_conv\.bias")


def grad_gap(grads_a, grads_b, names, side="g."):
    """(worst rel-max, its tensor, worst rel-norm) over the tensors of one
    model (names starting with ``side``) but ``FREE_BIAS``'s."""
    worst, where, worst_norm = 0.0, "", 0.0
    for name, a, b in zip(names, grads_a, grads_b):
        if not name.startswith(side) or FREE_BIAS.fullmatch(name):
            continue
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst_norm = max(worst_norm, (a - b).norm().item() / max(b.norm().item(), 1e-30))
        if rel > worst:
            worst, where = rel, name
    return worst, where, worst_norm


def train_vs_plain(device, path):
    """Phases 7, 11, 13, 14 and 16: f32 steps with the kernels against the
    plain ops: the G phase's gradients (and for the sngan pairs a D
    update's), then the losses of a few steps. At 128px the tanh-form GELU
    is forced, so the generator's packed blocks take the fused BN + GELU op
    (and its kernels) in f32 too. With wgan-gp ("sngan-gp") the kernel
    step's launches are counted against ``expected_launches``."""
    import torch

    from fastfourierconvolution_tpu_torch.nn import layers
    from fastfourierconvolution_tpu_torch.ops import bn_act as ba
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    def plain_ops():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.multiple(
            fu, fu_train_stats=fu.fu_train_stats_plain,
            fourier_unit_forward=fu.fourier_unit_forward_plain,
            fu_bwd_stats=fu.fu_bwd_stats_plain, fu_bwd_apply=fu.fu_bwd_apply_plain,
            _train_forward_staged=fu.fourier_unit_train_plain,
            _train_backward_staged=lambda *a: fu.fourier_unit_backward_plain(*a)[:4]))
        stack.enter_context(mock.patch.multiple(
            ba, bn_stats=ba.bn_stats_plain, bn_gelu_apply=ba.bn_gelu_apply_plain,
            bn_bwd_reduce=ba.bn_bwd_reduce_plain, bn_bwd_dx=ba.bn_bwd_dx_plain))
        return stack

    resolution = RESOLUTION[path]
    batch, steps = PLAIN_RUNS[path]
    g = torch.Generator().manual_seed(SEED + 3)
    zs = torch.randn(steps, 2, batch, 128, generator=g).to(device)
    real = real_batch(device, SEED + 4, resolution, batch)
    labels = label_batch(device, SEED + 4, path, (batch,))
    with_d = path in ("sngan", "sngan-gp")

    def grads(plain):
        trainer = make_trainer(device, "f32", path)
        names = [f"g.{n}" for n, _ in trainer.g.named_parameters()]
        with plain_ops() if plain else contextlib.nullcontext():
            out = list(trainer.g_loss_and_grads(zs[0, 0], labels)[1])
            if with_d:
                names += [f"d.{n}" for n, _ in trainer.d.named_parameters()]
                out += trainer.d_loss_and_grads(real.permute(0, 3, 1, 2).contiguous(),
                                                zs[0, 1], labels)[1]
        return names, out

    layers.set_fast_gelu(True if resolution >= 128 else "policy")
    try:
        names, floor_a = grads(plain=False)
        floor_b = grads(plain=False)[1]
        floor = grad_gap(floor_a, floor_b, names)
        torch.use_deterministic_algorithms(True)
        _, grads_k = grads(plain=False)
        before = {k: w.launches for k, w in launch_wrappers().items()}
        _, grads_p = grads(plain=True)
        if {k: w.launches for k, w in launch_wrappers().items()} != before:
            raise AssertionError("the plain-op step launched a kernel")
        worst, where, worst_norm = grad_gap(grads_k, grads_p, names)
        log(f"{path} f32 step at batch {batch}, kernels vs plain ops (deterministic "
            f"algorithms): {sum(n.startswith('g.') for n in names)} generator gradients, worst "
            f"rel-max {worst:.3e} ({where}), worst rel-norm {worst_norm:.3e} (tol "
            f"{STEP_GRAD_TOL[path]:g} rel-max); "
            f"floor: the kernel path against itself under cuDNN's default algorithms, worst "
            f"rel-max {floor[0]:.3e} ({floor[1]}), rel-norm {floor[2]:.3e}")
        if path in CONDITIONAL:
            log(f"  the stems' BN-fed ConvT biases (gradient 0 up to rounding, left out): largest "
                f"gradient {max(a.abs().max().item() for n, a in zip(names, grads_k) if FREE_BIAS.fullmatch(n)):.2e}")
        if not worst <= STEP_GRAD_TOL[path]:
            raise AssertionError(f"f32 gradient of {where}: rel-max {worst} vs the plain ops")
        if with_d:
            d_worst, d_where, d_norm = grad_gap(grads_k, grads_p, names, "d.")
            d_floor = grad_gap(floor_a, floor_b, names, "d.")
            largest = lambda pick: max(a.abs().max().item() for n, a in zip(names, grads_k)
                                       if pick(n))
            log(f"  {sum(n.startswith('d.') for n in names)} discriminator gradients: worst "
                f"rel-max {d_worst:.3e} ({d_where}), worst rel-norm {d_norm:.3e} (tol "
                f"{D_GRAD_TOL:g} rel-max); floor {d_floor[0]:.3e} ({d_floor[1]}), rel-norm "
                f"{d_floor[2]:.3e}; D's BN-fed biases (gradient 0 up to rounding, left out): "
                f"largest gradient {largest(FREE_BIAS.fullmatch):.2e}, D's largest "
                f"{largest(lambda n: n.startswith('d.')):.2e}")
            if not d_worst <= D_GRAD_TOL:
                raise AssertionError(f"f32 gradient of {d_where}: rel-max {d_worst} vs the "
                                     f"plain ops")

        kern = make_trainer(device, "f32", path)
        plain = make_trainer(device, "f32", path)
        for i in range(steps):
            zero_counts()
            lk = kern.update_step(real, labels, zs=zs[i])
            torch.cuda.synchronize()
            if path == "sngan-gp":
                counts = counts_by_map()
                log(f"  f32 step {i} with the gradient penalty, kernel launches by map: {counts}")
                if counts != expected_launches(path, 1):
                    raise AssertionError(f"wgan-gp step launches {counts}, expected "
                                         f"{expected_launches(path, 1)}")
            with plain_ops():
                lp = plain.update_step(real, labels, zs=zs[i])
            diffs = {k: abs(lk[k].item() - lp[k].item()) for k in lk}
            tols = {k: STEP_LOSS_TOL * (max(1.0, abs(lp[k].item()))
                                        if path in RELATIVE_LOSS_PATHS else 1.0) for k in lk}
            log(f"  f32 step {i}: kernels {({k: round(v.item(), 6) for k, v in lk.items()})}, "
                f"plain ops {({k: round(v.item(), 6) for k, v in lp.items()})}, |diff| "
                f"{({k: f'{d:.2e}' for k, d in diffs.items()})} (tol "
                f"{({k: f'{t:.2e}' for k, t in tols.items()})})")
            if not all(d <= tols[k] for k, d in diffs.items()):
                raise AssertionError(f"f32 losses at step {i} differ from the plain ops: {diffs}")
    finally:
        torch.use_deterministic_algorithms(False)
        layers.set_fast_gelu("policy")


# Phase 12: the 32px pair's trainer options whose replayed steps are held
# against eager ones: bench.py's setting, the JAX sagan preset's train
# settings (utils/config.py) and the aw-method.
PARITY_OPTIONS = {
    "bench": dict(),
    "sagan": dict(loss="wgan-gp", optimizer="adam", b1=0.0, b2=0.9, lr=1e-4, d_lr=4e-4,
                  num_dis_updates=5, update_order="d_first", fused_dis_batch=False),
    "aw-method": dict(aw_method=True, fused_dis_batch=False),
}
PARITY_STEPS = 4


def trainer_state(trainer):
    """{name: tensor} of everything a step changes: parameters and buffers
    (BN statistics, u), the optimizer moments and update counts, the
    learning rates and their counts, the two generators' states."""
    state = {f"g.{k}": v for k, v in trainer.g.state_dict().items()}
    state.update({f"d.{k}": v for k, v in trainer.d.state_dict().items()})
    for side, opt, model in (("g", trainer.g_opt, trainer.g), ("d", trainer.d_opt, trainer.d)):
        for name, p in model.named_parameters():
            state.update({f"{side}.{name}.{k}": v for k, v in opt.state[p].items()})
    for side, schedule in (("g", trainer.g_lr), ("d", trainer.d_lr)):
        state[f"{side}.lr"], state[f"{side}.count"] = schedule.lr, schedule.count
    state["z_generator"] = trainer.z_generator.get_state()
    state["noise_generator"] = trainer.noise_generator.get_state()
    return state


def graph_parity(device, path=32, options_by_name=PARITY_OPTIONS):
    """Phases 12, 16 and 18-20: for each of ``options_by_name``, two f32 trainers
    of ``path`` from the same seeds (TF32 off, deterministic algorithms):
    ``update_steps`` over ``PARITY_STEPS`` batches against as many
    ``update_step`` calls. The same bits are expected; where they differ
    the largest gaps are printed and must sit within phase 7's bars (losses
    1e-3, rel-max 1e-2 per tensor; the generators' states exactly)."""
    import torch

    reals = torch.stack([real_batch(device, SEED + 20 + i, RESOLUTION[path])
                         for i in range(PARITY_STEPS)])
    labels = label_batch(device, SEED + 20, path, (PARITY_STEPS, BATCH))
    batch = lambda i: None if labels is None else labels[i]
    torch.use_deterministic_algorithms(True)
    try:
        for name, options in options_by_name.items():
            graph, eager = (make_trainer(device, "f32", path, **options) for _ in range(2))
            out = graph.update_steps(reals, labels)
            ref = [eager.update_step(r, batch(i)) for i, r in enumerate(reals)]
            torch.cuda.synchronize()
            loss_gap = max((out[k] - torch.stack([r[k] for r in ref])).abs().max().item()
                           for k in out)
            a, b = trainer_state(graph), trainer_state(eager)
            differ = sorted(k for k in b if not torch.equal(a[k], b[k]))
            gaps = {k: (a[k].double() - b[k].double()).abs().max().item()
                    / max(b[k].double().abs().max().item(), 1e-30)
                    for k in differ if not k.endswith("generator")}
            worst = max(gaps.items(), key=lambda kv: kv[1], default=("", 0.0))
            log(f"graph parity, {path} {name} ({options or 'the path setting'}): {PARITY_STEPS} replayed "
                f"steps against {PARITY_STEPS} eager steps, f32: losses max |diff| "
                f"{loss_gap:.3e} (tol {STEP_LOSS_TOL:g}); {len(b)} state tensors, the same bits "
                f"in {len(b) - len(differ)}; largest rel-max gap {worst[1]:.3e} {worst[0]} (tol "
                f"{STEP_GRAD_TOL[32]:g}); steps taken {graph.step} and {eager.step}")
            if (loss_gap > STEP_LOSS_TOL or worst[1] > STEP_GRAD_TOL[32]
                    or any(k.endswith("generator") for k in differ)
                    or graph.step != eager.step):
                raise AssertionError(f"graph parity, {name}: replayed steps differ: {differ[:8]}")
    finally:
        torch.use_deterministic_algorithms(False)


def step_flops(fn):
    """The FLOPs of the matmuls and convolutions ``fn`` runs (forward,
    backward and double backward alike), by ``torch.utils.flop_counter``'s
    formulas, counted in a dispatch mode of its own: ``FlopCounterMode``
    tracks modules with hooks that refuse ``autograd.grad`` on a leaf (the
    gradient penalty's)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                Count.total += formula(*args, **kwargs, out_val=out)
            return out

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.total


def comparator(device, card, path):
    """Phases 18-20: ``path``'s pair built by the port's zoo from its config
    (``ZOO_CONFIGS``): bf16 training as in phase 6, every FourierUnit and BN
    kernel's launches 0 in every step and at the capture; the step's
    matmul and convolution FLOPs (``step_flops`` over one eager step) as a
    share of the card's bf16 peak at the replayed step's
    device time; one ``generate(z, uint8=True)`` request (and one of
    floats) through the models' wrappers, G's state unmoved; then phase
    12's f32 graph parity, 4 replayed steps against 4 eager ones."""
    import torch

    cfg = zoo_config(path)
    trainer, counts, graph_dev = train(device, card, path)
    launched = {k: v for k, v in counts.items() if v}
    if launched:
        raise AssertionError(f"{path}: hand-written kernels launched: {launched}")
    sizes = {side: sum(p.numel() for p in m.parameters())
             for side, m in (("G", trainer.g), ("D", trainer.d))}
    real = real_batch(device, SEED + 2, RESOLUTION[path])
    flop = step_flops(lambda: trainer.update_step(real))
    share = flop / (graph_dev * 1e-3) / PEAK_FLOP_PER_S["bfloat16"]
    log(f"{path}: {cfg.model.generator} G ({sizes['G']:,} parameters) against "
        f"{cfg.model.discriminator} D ({sizes['D']:,}), {trainer.loss_name}, "
        f"{trainer.num_dis_updates} D update(s), {trainer.update_order}, fused D pass "
        f"{trainer.fused_dis_batch}; no FourierUnit or BN kernel launched; step "
        f"{flop / 1e9:.2f} GFLOP in matmuls and convolutions (flop_counter, one eager step), "
        f"{share:.4f} of {PEAK_FLOP_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s at the replayed "
        f"step's {graph_dev:.3f} device ms; {card}")

    z = torch.randn(BATCH, trainer.z_size, generator=torch.Generator().manual_seed(SEED + 30))
    z = z.to(device)
    state = {k: v.clone() for k, v in trainer.g.state_dict().items()}
    trainer.generate(z, uint8=True)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    images = trainer.generate(z, uint8=True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    floats = trainer.generate(z)
    torch.cuda.synchronize()
    r = RESOLUTION[path]
    if images.shape != (BATCH, r, r, 3) or images.dtype != torch.uint8:
        raise AssertionError(f"generate gave {tuple(images.shape)} {images.dtype}")
    if not torch.isfinite(floats).all():
        raise AssertionError("generate gave non-finite images")
    moved = [k for k, v in trainer.g.state_dict().items() if not torch.equal(v, state[k])]
    if moved or not trainer.g.training or any(counts_by_map().values()):
        raise AssertionError(f"generate moved G's state {moved[:4]}, its training flag or a "
                             f"kernel count")
    log(f"{path} generate(z, uint8=True), batch {BATCH}, bf16: one request {wall_ms:.3f} ms wall "
        f"(host clock, after one warm-up); uint8 (B, {r}, {r}, 3), image std "
        f"{images.float().std().item():.2f} levels; G's state unmoved; {card}")
    del trainer
    graph_parity(device, path, {ZOO_CONFIGS[path][0] or path: {}})


def with_launches(rows, counts):
    """The rows with their kernel's launches by map (by partial shape for
    the reduction) from a training run's counts. ``fu_spectrum``'s count
    covers both of its forms: the backward's two-map launches are one per
    ``fu_bwd_mix`` launch, the rest are the forward's."""
    for row in rows:
        key = tuple(row["shape"]) if row["name"] == "fu_reduce" else tuple(row["shape"][1:])
        row["launches"] = counts[row["name"]].get(key, 0)
        if row["name"] == "fu_spectrum":
            two_map = counts["fu_bwd_mix"].get(key, 0)
            row["launches"] = two_map if row["maps"] == 2 else row["launches"] - two_map
    return rows


def with_calls(calls, counts):
    """The staged calls' rows with their calls per map in a training run:
    one ``fu_mix_stats`` launch per training forward, one
    ``fu_bwd_stats_mix`` launch per training backward. The training step
    calls none of the wrappers on a staged map (0)."""
    first_stage = {"train_forward": "fu_mix_stats", "train_backward": "fu_bwd_stats_mix"}
    for row in calls:
        stage = first_stage.get(row["name"])
        row["calls"] = counts[stage].get(tuple(row["shape"][1:]), 0) if stage else 0
    return calls


def check_main_path_launches(counts_by_run):
    """Raises unless every kernel was launched at least once over the main
    path's runs ({run: {kernel: {map or shape: launches}}})."""
    totals = {k: sum(sum(run.get(k, {}).values()) for run in counts_by_run.values())
              for k in KERNELS}
    idle = sorted(k for k, n in totals.items() if n == 0)
    log(f"main-path launches by kernel over {sorted(counts_by_run)}: {totals}")
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from fastfourierconvolution_tpu_torch.ops import _build

    device = torch.device("cuda")
    # cuBLAS reads this when it first starts; the deterministic algorithms
    # of phases 7 and 11 need it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for path in libs.values():
        build_log = path.with_name(path.name + ".log")
        if build_log.exists():
            for line in build_log.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log("  ptxas:", line.strip())

    def phase(name):
        log(f"--- {name} ({time.perf_counter() - t0:.1f} s)")

    phase("3: FourierUnit forward kernel, 32px maps")
    rows, calls = check_fourier_unit(device, FU_SHAPES, "serving")
    phase("4: serving, 32px")
    by_map = serve(device, card)
    for row in rows:
        row["launches"] = by_map[tuple(row["shape"][1:])]
    phase("5: FourierUnit training kernels, 32px maps")
    train_rows, train_calls = check_train_kernels(device, FU_SHAPES, "training")
    train_rows += check_reduce(device, reduce_cases(FU_SHAPES) + [REDUCE_ODD], "training")
    calls += train_calls
    phase("6: training, 32px")
    _, counts_32, _ = train(device, card, 32)
    rows += with_launches(train_rows, counts_32)
    phase("7: f32 step, 32px")
    train_vs_plain(device, 32)
    phase("8: fused BN + GELU kernels, 128px packed maps")
    # the kernels line lists the noise-fold variants, which the 128px step runs
    rows_128 = [r for r in check_bn_act(device) if r["noise"] or r["name"] == "bn_stats"]
    phase("9: FourierUnit kernels, 128px maps (staged forward, statistics and backward)")
    fwd_rows, calls_128 = check_fourier_unit(device, FU128_SHAPES, "training-128px")
    rows_128 += fwd_rows + check_stages(device, FU128_SHAPES, "training-128px")
    train_rows, train_calls = check_train_kernels(device, FU128_SHAPES, "training-128px")
    rows_128 += train_rows + check_reduce(device, reduce_cases(FU128_SHAPES), "training-128px")
    calls_128 += train_calls
    phase("10: packed training, 128px")
    _, counts, _ = train(device, card, 128)
    rows += with_launches(rows_128, counts)
    calls += with_calls(calls_128, counts)
    phase("11: f32 step, 128px")
    train_vs_plain(device, 128)
    phase("12: f32 graph parity, 32px")
    graph_parity(device)
    phase("13: the sngan pair, 32px (FFCDiscriminator)")
    new_maps = [s for s in D_FU_SHAPES if s not in FU_SHAPES]
    rows_sngan, calls_sngan = check_fourier_unit(device, new_maps, "training-sngan")
    train_rows, train_calls = check_train_kernels(device, new_maps, "training-sngan")
    rows_sngan += train_rows + check_reduce(device, reduce_cases(new_maps), "training-sngan")
    calls_sngan += train_calls
    _, counts_sngan, _ = train(device, card, "sngan")
    rows += with_launches(rows_sngan, counts_sngan)
    calls += with_calls(calls_sngan, counts_sngan)
    train_vs_plain(device, "sngan")
    phase("14: the fgan_cond32 pair (conditional), 32px: training, generate, f32 step")
    trainer_c32, counts_c32, _ = train(device, card, "cond32")
    by_map_c32 = serve_generate(device, card, trainer_c32)
    del trainer_c32
    train_vs_plain(device, "cond32")
    phase("15: the fgan_cond48 pair: FourierUnit kernels at its maps, the workspace kernels "
          "at 96x96, training")
    rows_48, calls_48 = check_fourier_unit(device, FU48_SHAPES, "training-cond48")
    train_rows, train_calls = check_train_kernels(device, FU48_SHAPES, "training-cond48")
    against_workspace(train_rows)
    rows_48 += train_rows + check_reduce(device, reduce_cases(FU48_SHAPES), "training-cond48")
    rows_48 += check_workspace_kernels(device)
    calls_48 += train_calls
    _, counts_c48, _ = train(device, card, "cond48")
    rows += with_launches(rows_48, counts_c48)
    calls += with_calls(calls_48, counts_c48)
    phase("16: wgan-gp on the sngan pair (the FourierUnit's double backward)")
    train_vs_plain(device, "sngan-gp")
    graph_parity(device, "sngan-gp", {"wgan-gp": {}})
    phase("17: eval-mode FourierUnit gradients")
    eval_gradients(device)
    phase("18: the sagan preset (SAGAN pair through the zoo), 32px")
    comparator(device, card, "sagan")
    phase("19: the resnet32 preset (SNGAN-ResNet pair through the zoo), 32px")
    comparator(device, card, "resnet32")
    phase("20: the DCGAN family at 64px (DCGAN pair; attention generator against SN-DCGAN D)")
    comparator(device, card, "dcgan64")
    comparator(device, card, "attn64")
    phase("21: result")
    check_main_path_launches({"serving-32px": {"fourier_unit_fwd": by_map},
                              "training-32px": counts_32, "training-128px": counts,
                              "training-sngan": counts_sngan, "training-cond32": counts_c32,
                              "serving-cond32": {"fourier_unit_fwd": by_map_c32},
                              "training-cond48": counts_c48})
    log(json.dumps({"wrapper_calls": calls}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
