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
   then batch-64 requests back to back for half a second for the served
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
   FourierUnit map, then steps back to back for half a second for the step
   time, with every count set to 0 before the steps and read after them;
   then ``update_steps`` with bench.py's K (16 at 32px, 4 at 128px), the
   step as a CUDA graph: its first call (one eager step and the capture,
   which count their launches; replays count none) with exact launches,
   then calls back to back for half a second; eager and graph each with
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
   beside ``torch.var_mean``'s; the apply's and the dx kernel's grids
   against the blocks the card holds at once;
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
    back to back for half a second, with every count set to 0 before the
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
    workspace design's readings there; bf16 training of the
    ``fgan_cond48`` pair (``stl48`` against ``CondSNDiscriminator(48)``) as
    in phase 6; the 96px generator's 96x96 map at batch 8 and 64,
    (8,8,96,96) and (64,8,96,96), where every wrapper runs the staged
    kernels with dense DFT transforms, checked as in phase 9 (the dense
    ``fu_spectrum`` and ``fu_inverse``, every stage and the training op's
    staged forward and backward), each wrapper's device ms a call at batch
    8 beside the workspace design's there; the
    four workspace kernels at a map only they take, (8,12,64,64), checked
    as in phases 3 and 5 (no main path runs them); the 96px pair,
    ``FFCGenerator.for_resolution(96)`` against
    ``SNConvDiscriminator.for_resolution(96)``, trained in bf16 at batch 64
    as in phase 6 (2 checked eager steps, ``update_steps`` with K = 4), 4
    replayed f32 steps against 4 eager ones as in phase 12, and an f32 step
    against the plain ops as in phase 7 (each part's seconds printed); the
    256px generator's 256x256 map at batch 8 and 64, (8,32,256,256) and
    (64,32,256,256), where every wrapper runs the staged kernels with each
    plane split over a cluster of two blocks, checked as in phase 9 (the
    split ``fu_spectrum`` and ``fu_inverse`` beside ``torch.fft.rfft2`` /
    ``irfft2``, every stage, the training op's staged forward and
    backward; timed at batch 64 only), each wrapper's device ms a call
    there beside the workspace design's; the fused BN kernels at its new packed map
    (64,128,256,256) as in phase 8; the 256px pair,
    ``FFCGenerator.for_resolution(256)`` (packed) against
    ``SNConvDiscriminator.for_resolution(256)``, trained in bf16 at batch 64
    as in phase 6 (``update_steps`` with K = 4, no workspace launch), a
    batch-64 uint8 request served through ``generate`` with exact launches,
    4 replayed f32 steps against 4 eager ones (batch 16) and an f32 step
    against the plain ops (batch 8);
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
21. the training CLI, ``python -m fastfourierconvolution_tpu_torch.cli``,
    in child processes at full width, batch 64, bf16, on the shapes
    dataset, in-loop metrics off (phase 28 has them), K = 16 steps per
    ``update_steps`` call
    (``CLI_COMMON``), each child's kernel launches counted and held to the
    eager step and capture of its first call plus its sample grids:
    ``fgan32`` trained 96 steps with checkpoints (every file and logged
    loss checked), trained again to 144 (it must resume from 96), sampled;
    in process, a trainer restored from a checkpoint into a captured step
    equals the saved one bit for bit with every tensor's address kept, and
    in f32 under deterministic algorithms 16 replayed steps after a save
    and again after a restore give the same bits; the CLI's wall ms per
    step between epoch boundaries beside phase 6's replayed step, and the
    data path's share of it (loader, stack, host-to-device copy,
    normalisation, which must give the host's bits);
22. ``fgan_cond32`` through the CLI, the class count inferred from the
    data (3): 32 steps, then ``sample`` with class-stratified labels (run
    beside phase 26's child processes, after phase 25);
23. ``fgan64``'s staged FourierUnit map (64,8,64,64): its kernels checked
    as in phase 9, an eager step of the CLI's pair with exact launches per
    map (the kernels line's launches for these rows, per step), eager and
    replayed step times; 32 steps through the CLI (beside phase 26);
24. the FFC layer options: the FourierUnit kernels at the local Fourier
    units' maps (half the size of the 32px and 128px FourierUnit maps,
    the same channels; each map's ``kernel_design`` printed) and at the
    spectral-normed cDCGAN discriminator's maps, checked as in phases 3,
    5 and 9 where no earlier phase checks them; the 32px generator's two
    SpectralTransform blocks (tuple path) and the 128px generator's five
    packed blocks with biases, each with ``enable_lfu``, in bf16 at batch
    64 (a training pass and an eval forward, exact launches per map, the
    outputs against the plain ops', timed with both) and in f32 against
    the plain ops (outputs and gradients), at phase 5's bars; at
    (64,256,4,4) and (64,128,16,16) the sliced statistics, backward sums
    and backward apply timed against the workspace kernels at the same map;
    ``FFCCondDCGANDiscriminator(use_sn=True)`` at its JAX defaults trained
    against the ``train_cond`` generator, eagerly (exact launches: at
    (256,4,4) the statistics and both backward kernels once per
    out-channel slice) and replayed (wall and device ms a replayed step,
    beside the workspace design's wall ms);
25. ``remat`` none, dots and full on fgan32 and fgan128 (bench.py's
    setting): an eager step's launches (G's forward kernels a third time
    per step under remat) and peak memory, the captured step's memory
    pool, the replayed step's wall and device ms; 4 replayed f32 steps with
    remat against 4 without, the same bits expected;
26. a process's first run of a configuration against its second, in
    fresh child processes side by side (``first_run_child``; the CLI runs
    of phases 22, 23, 29, 30 and 31e beside them: child processes that
    time nothing): sagan's replayed f32 step
    and replayed wgan-gp on the sngan pair under remat "dots", each run a
    new trainer from the same seeds under deterministic algorithms, every
    aten op's output bits recorded by a ``TorchDispatchMode``; the first op
    where the order of the ops or their bits part is printed with its call
    site and autograd node; the port's runs must give the same bits, and
    sagan with the backward on autograd's device thread (as the trainer
    ran it before it moved to the calling thread) is printed beside them; eager bf16 steps of the 32px and sngan
    pairs with the backward on the calling thread against autograd's
    device thread, in alternating windows;
27. the InceptionV3 extractor with a seeded torch-fidelity-layout state
    dict on the card against the same module on the CPU (f32, TF32 off),
    every tap on 64 images, its ms per image at batch 64 and 128; then
    ``calculate_metrics`` ISC, FID and KID, weights-free and with the
    seeded weights file, on the card against the CPU;
28. ``fgan32`` through the CLI with its preset's metrics (ISC and FID, and
    beside it with KID), weights-free, on its 10,000 samples, two epochs of one
    chunk, with best-metric checkpoints: the metrics logged, one checkpoint
    in ``best/``, no failed eval, exact launches (the eval's 157 generate
    requests an epoch); eval seconds, generate ms per request and
    extraction ms per image, and the eval's share of a 5,000-step epoch;
29. the serving export: the 32px generator (bf16 and f32), fgan128's
    packed generator and fgan_cond32's conditional one, seeded, their
    running statistics calibrated as in phase 4, exported on the card
    (``serving.export_generator``; no launch while tracing) and served in a
    child process that imports torch, numpy and the port's ``serving``
    and no JAX module, at batch 1, 64 and 157: the in-process
    ``generate``'s images within phase 4's bars, the same bits on a second
    call, exactly one forward kernel (its three stages on a staged map) per
    FourierUnit map and request; ms per batch-64 request beside the
    in-process ``generate``'s, and the host µs per ``fourier_unit_eval``
    call through the registered op and as before it; through the CLI
    (beside phase 26): ``export`` of phase 21's fgan32 run directory,
    ``sample --exported``, ``fidelity`` ISC and FID of the artifact and of
    the run directory against the shapes set (weights-free, the same
    latents, within ``FIDELITY_TOL`` of each other), and ``export
    --torch_checkpoint`` of a seeded reference-layout ``.pth``, whose
    artifact is held here against the converted model's ``generate``;
30. the rest of the metric pipeline: the VGG16 (fc2, fc2_relu), LPIPS
    (resize 64), ``clip-vit-b-32``, ``clip-rn50`` and ``dinov2-vit-s-14``
    extractors at their official sizes with seeded weights, on the card
    against the same module on the CPU (f32, TF32 off) within 1e-3, two
    calls giving the same bits, with ms per image and the share of the f32
    peak; PRC under the default extractors (the dual split: InceptionV3
    for ISC and FID, VGG16 for PRC) of the fgan32 generator (bf16) on the
    card, with exact eval-forward launches (one per map and request in
    each half of the split); PPL of the fgan32 generator (bf16, batch 64,
    2,048 samples) with exact launches (two per map and batch), the same
    bits on a second call, LPIPS on the card against the CPU on one
    batch's image pairs within 1e-4 relative each, and PPL's seconds per
    10,000 samples; through the CLI (beside phase 26): fgan32 ``train`` with
    ``eval.prc`` and ``eval.ppl``, and ``fidelity -r -p`` of its run
    directory and of phase 29's fgan32 artifact against the shapes set,
    every metric key present and finite, exact launches;
31. data parallelism (``parallel``), every process a child process of
    this one with the CUDA libraries built here: (a) fgan32 and (b)
    fgan128 (bf16, global batch 64) as two processes of one gloo group on
    the card, 32 rows each, against one process at 64: the statistics
    wrappers' outputs at every map gathered from the processes (within
    ``DP_FU_TOL`` and ``DP_BN_TOL``; which of them have one process's
    bits is printed), the first step's averaged G and D gradients, each
    parameter's within ``DP_GRAD_TOL`` of one process's in f32 (and
    fgan32's with ``parallel.param_share`` taken out, a control that must
    fail the bar; the bf16 gaps printed), 3 (2) eager bf16 steps with the
    processes' states the same bits after every step, the losses within
    ``DP_LOSS_TOL`` of one process's, exact launches and collectives per
    step, step ms per process, the host ms in
    ``torch.distributed`` calls, the bytes per step and the ms per
    all-gather of each partial-sum shape; (c) a group of one process over
    NCCL: fgan32's f32 ``update_steps`` with the collectives captured in
    the step's graph, the bits of the same calls without a group, and two
    replays of one call the same bits; (d) fgan32 over NCCL across two
    cards where the machine has them (else printed as not run), as (a),
    then phase 12's graph parity in the group (f32 ``update_steps`` with
    the NCCL collectives in the graph against as many eager steps); (e)
    the CLI's fgan32 ``train`` as two processes (gloo on the card), 4
    steps and a resume to 6, rank 0 alone printing and writing, exact
    launches (run beside phase 26);
32. tensor parallelism (``train.tp``): (a) in one process with no
    group, the FourierUnit kernels on out-channel slices: the four
    wrappers (and on staged maps the four mix stages on the spectra of x
    and of gy's slice) at ``TP_SHAPES`` (per item, staged and workspace
    designs as ``kernel_design`` decides on the slice's plans) for T of 2
    and 4 and every slice t, f32 and bf16, each against its sliced plain
    version in f64 (``FU_REL_TOL``) with the same bits on two launches,
    T = 1 giving the whole kernel's bits, and slice 0's bf16 times beside
    the whole kernel's, the plain version's and the bound on the slice's
    work; (b) fgan32 as dp 1 x tp 2 child processes on the one card
    (gloo) against one process: the first step's f32 gradients (gathered
    whole) within ``DP_GRAD_TOL`` per parameter (a control that does not
    sum x's gradient over the tp group must fail it), 2 eager bf16 steps
    with the losses within ``DP_LOSS_TOL``, the processes' whole states
    (``GANTrainer.state_dict``) the same bits, exact launches on the
    slices' maps and exact collectives per step, the tp gathers and sums
    included, and the step ms;
33. a JAX run directory: a full-width fgan32 ``ckpt_32_steps.ckpt`` in the
    JAX package's flax-msgpack layout, packed here (``flax_pack``, with
    seeded values) from the committed manifest of its tree
    (``tools/fgan32_jax_ckpt_manifest.json``, written with JAX by
    ``tools/jax_ckpt_manifest.py``): the decoder's MB/s, the restore's
    wall time into a bf16 trainer, every restored tensor the same bits as
    its bridged value, the optimizer state on the card and capturable, the
    restored step's exact launches as phase 6's (``jax-ckpt``); in f32 from
    the same restore the generator gradients and a step's losses against
    the plain ops (phase 7's bars) and 4 replayed steps against eager ones
    (phase 12's rule); ``cli train`` resuming the directory at step 32 in a
    child process (``.pt`` files written beside the ``.ckpt``, which stays)
    and ``sample`` drawing from it, with exact launches; the native batcher
    built into ``_build/`` with g++, its gather + normalise (plain and
    flipped) the same bits as numpy's ``x * float32(1/127.5) - 1`` on a
    64-image batch, its ms per batch beside numpy's, its shuffle a
    permutation;
34. a check that every kernel was launched on the main path (phases 4, 6,
    10, 13, 14, 15, the CLI runs, phases 24-25, 28-33), a
    ``{"wrapper_calls": [...]}`` JSON line (the staged wrapper and training-op calls, all their stages
    together), a ``{"kernels": [...]}`` JSON line, then the
    ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, where CUDA is absent.

``python3 chip_smoke.py 96`` runs phase 15's 96px part alone (after the
build: the staged kernels at 96x96, the workspace kernels, the 96px pair
trained), ``python3 chip_smoke.py 256`` its 256px part (the split planes,
the 256px pair trained and served); ``python3 chip_smoke.py 31`` runs phase 31 alone (after the build),
``python3 chip_smoke.py 31d`` its part (d) alone with the one-process run
it is held against (it needs two cards), and ``python3 chip_smoke.py 32``
phase 32 alone, and ``python3 chip_smoke.py 32d`` (four cards) fgan32 as
dp 2 x tp 2 processes over NCCL against one process, then the graph
parity of ``update_steps`` with the tp collectives captured, in the
group; ``python3 chip_smoke.py 33`` runs phase 33 alone, ``python3
chip_smoke.py 8`` phase 8 alone (the fused BN + GELU kernels at the 128px
packed maps).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
# The fgan64 generator's third FourierUnit map (block3's g2g), which the
# staged kernels take (2C = 16); its first two are FU_SHAPES.
FU64_SHAPES = [(BATCH, 8, 64, 64)]
# Device ms a launch of the workspace statistics, backward sums and
# backward apply at (64,8,48,48) in bf16, the lowest and highest of three
# runs of phase 15 while that map ran them (H100 80GB HBM3, 700 W): printed
# beside the clustered kernels' readings there.
WORKSPACE_48_MS = {"fu_train_stats": (0.1697, 0.1727), "fu_bwd_stats": (0.3217, 0.3229),
                   "fu_bwd_apply": (0.5299, 0.5451)}
# The 96px generator (``FFCGenerator.for_resolution(96)``: blocks 1-3 on
# 24x24, 48x48 and 96x96) at batch 64: its maps, and its 96x96 map, which no
# cluster plan fits and the staged kernels take with dense DFT transforms (96
# is no power of two), at batch 8 and at the trained batch (the batch sets
# how ``staged_chunks`` splits the mix stages' tiles).
FU96_SHAPES = [(BATCH, 16, 24, 24), (BATCH, 8, 48, 48), (BATCH, 8, 96, 96)]
DENSE_SHAPES = [(8, 8, 96, 96), (BATCH, 8, 96, 96)]
# Device ms a launch of the workspace forward, statistics, backward sums and
# backward apply at WORKSPACE_96_SHAPE in bf16 while that map ran them, the
# lowest and highest of two runs (H100 80GB HBM3, 700 W): printed beside the
# staged design's readings there.
WORKSPACE_96_SHAPE = (8, 8, 96, 96)
WORKSPACE_96_MS = {"fourier_unit_fwd": (3.0224, 3.0381), "fu_train_stats": (1.3145, 1.3223),
                   "fu_bwd_stats": (2.5507, 2.5567), "fu_bwd_apply": (4.9072, 4.9541)}
# A map that no design but the per-item workspace takes (2C = 24 is no width
# of the staged mix stages; no cluster's plan holds its 64x64 item or a
# slice of it): the workspace kernels.
WORKSPACE_SHAPES = [(8, 12, 64, 64)]
# The 256px generator (``FFCGenerator.for_resolution(256)``: ngf 128, ratio
# 0.5, mg 4, mults 4, 2, 1, 1, 1, 1) at batch 64: the 128px generator's four
# FourierUnit maps and its sixth block's (64,32,256,256), whose 266,240 B
# plane one block cannot hold, so ``fu_spectrum`` and ``fu_inverse`` split
# each plane over a cluster of two blocks (``fourier_unit.plane_ranks``);
# its packed maps, the 128px generator's five and (64,128,256,256). The
# split planes are checked at batch 8 and at the trained batch (the batch
# sets how ``staged_chunks`` splits the mix stages' tiles).
FU256_SHAPES = FU128_SHAPES + [(BATCH, 32, 256, 256)]
PACKED256_SHAPES = PACKED_SHAPES + [(BATCH, 128, 256, 256)]
SPLIT_SHAPES = [(8, 32, 256, 256), (BATCH, 32, 256, 256)]
# Device ms a call of the workspace forward, statistics, backward sums and
# backward apply at (64,32,256,256) in bf16, one launch each after one to
# warm up, read by ``tools/fu_map_ms.py`` on the commit before the split
# planes took the map (H100 80GB HBM3, 700.00 W): printed beside the split
# design's readings there.
WORKSPACE_256_MS = {"fourier_unit_fwd": 405.5918, "fu_train_stats": 284.0355,
                    "fu_bwd_stats": 485.7159, "fu_bwd_apply": 599.4917}
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
# throughput readings (1.0 s until the 256px part joined phase 15: halved
# to keep the script within its limit on the slowest machines).
TIMED_SECONDS = 0.5
# The training paths: bench.py's 32px and 128px pairs, the sngan pair (with
# wgan-gp: "sngan-gp"), the fgan_cond32 and fgan_cond48 pairs, and the
# comparator pairs built by the port's zoo (``ZOO_CONFIGS``).
RESOLUTION = {32: 32, 128: 128, 96: 96, 256: 256, "sngan": 32, "sngan-gp": 32, "cond32": 32, "cond48": 48,
              "sagan": 32, "resnet32": 32, "dcgan64": 64, "attn64": 64}
CONDITIONAL = ("cond32", "cond48")
WARMUP_STEPS = {32: 3, 128: 2, 96: 2, 256: 2, "sngan": 3, "cond32": 3, "cond48": 2, "sagan": 3,
                "resnet32": 3, "dcgan64": 3, "attn64": 3}
# Steps per update_steps call: bench.py's K (bench.py:180-250).
STEPS_PER_CALL = {32: 16, 128: 4, 96: 4, 256: 4, "sngan": 16, "cond32": 16, "cond48": 16, "sagan": 16,
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
STEP_GRAD_TOL = {32: 1e-2, 128: 5e-2, 96: 1e-2, 256: 1e-2, "sngan": 1e-2, "sngan-gp": 1e-2,
                 "cond32": 1e-2}
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
PLAIN_RUNS = {32: (BATCH, 3), 128: (8, 1), 96: (8, 1), 256: (8, 1), "sngan": (BATCH, 1),
              "sngan-gp": (BATCH, 1), "cond32": (BATCH, 1)}
# The batch of phase 12's replayed-against-eager f32 steps where it is not
# BATCH: two f32 trainers of the 256px pair, one with its captured graph,
# at a batch that leaves the card room.
PARITY_BATCH = {256: 16}
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
# in each backward; sliced, the same, but each of the statistics, backward
# statistics and apply kernels T times, once per out-channel slice
# (``SLICED_KERNELS``, counted under the slice's map). Staged: each forward
# one spectrum, the statistics stage, the apply stage and the inverse; each
# backward one two-map spectrum, the backward-sums stage, the backward mix
# and the inverse.
PASS_LAUNCHES = {
    "per_item": ({"fu_train_stats": 1, "fourier_unit_fwd": 1},
                 {"fu_bwd_stats": 1, "fu_bwd_apply": 1}),
    "staged": ({"fu_spectrum": 1, "fu_mix_stats": 1, "fu_mix_apply": 1, "fu_inverse": 1},
               {"fu_spectrum": 1, "fu_bwd_stats_mix": 1, "fu_bwd_mix": 1, "fu_inverse": 1}),
}
SLICED_KERNELS = ("fu_train_stats", "fu_bwd_stats", "fu_bwd_apply")
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


# Phase 26 runs child processes side by side from threads; a line is
# written whole.
_LOG_LOCK = threading.Lock()


def log(*parts):
    with _LOG_LOCK:
        sys.stdout.write(" ".join(str(p) for p in parts) + "\n")
        sys.stdout.flush()


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


def fu_work(kernel, shape, itemsize, maps=1, co=None):
    """(bytes, FLOPs) a FourierUnit kernel's function needs at ``shape``:
    each input read once and each output written once (maps in the model
    dtype, the (2C,) vectors and gK in f32, K in the model dtype, the
    staged kernels' spectra in f32); FFT-sized transforms (5 N log2 N per
    complex length-N transform, half that for a real one), each (2C, 2C)
    product over the spectrum, and the elementwise BN work. ``maps``: the
    maps one ``fu_spectrum`` launch transforms. ``co``: on an out-channel
    slice (phase 32) the mix's Co out-channels: K (2C, 2Co), the (2Co,)
    vectors, y, gy and the spectra of the output side Co channels. For
    ``fu_reduce`` ``shape`` is the (rows, cols) of its f32 partial sums."""
    if kernel == "fu_reduce":
        rows, cols = shape
        return (rows + 1) * cols * 4, rows * cols
    b, c, h, w = shape
    co = c if co is None else co
    c2, co2, s = 2 * c, 2 * co, h * (w // 2 + 1)
    n_map, n_out = b * c * h * w * itemsize, b * co * h * w * itemsize
    k_bytes, vec = c2 * co2 * itemsize, co2 * 4
    dft_of = lambda n: 2.5 * w * math.log2(w) * n * h + 5 * h * math.log2(h) * n * (w // 2 + 1)
    dft, dft_out = dft_of(c), dft_of(co)
    mix = 2 * c2 * co2 * s
    spec, spec_out = b * c2 * s * 4, b * co2 * s * 4
    nbytes, per_item = {
        "fu_spectrum": (maps * (n_map + spec), maps * dft),
        "fu_mix_apply": (spec + spec_out + k_bytes + 4 * vec, mix + 6 * co2 * s),
        "fu_mix_stats": (spec + k_bytes + 2 * vec, mix + 3 * co2 * s),
        "fu_bwd_stats_mix": (spec + spec_out + k_bytes + 6 * vec, mix + 8 * co2 * s),
        "fu_inverse": (spec + n_map, dft),
        "fu_bwd_mix": (2 * spec + spec_out + k_bytes + 6 * vec + c2 * co2 * 4,
                       3 * mix + 12 * co2 * s),
        "fourier_unit_fwd": (n_map + n_out + k_bytes + 4 * vec, dft + dft_out + mix + 6 * co2 * s),
        "fu_train_stats": (n_map + k_bytes + 2 * vec, dft + mix + 3 * co2 * s),
        "fu_bwd_stats": (n_map + n_out + k_bytes + 6 * vec, dft + dft_out + mix + 8 * co2 * s),
        "fu_bwd_apply": (2 * n_map + n_out + k_bytes + 6 * vec + c2 * co2 * 4,
                         2 * dft + dft_out + 3 * mix + 12 * co2 * s),
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


def bound(kernel, shape, itemsize, dtype_name, noise=False, maps=1, co=None):
    """(bound ms, "bytes" or "operations", bytes, FLOPs). The BN kernels
    compute in f32 whatever the map's dtype."""
    if kernel.startswith("bn_"):
        nbytes, flops = bn_work(kernel, shape, itemsize, noise)
        dtype_name = "float32"
    elif kernel in ("fu_mix_apply", "fu_mix_stats", "fu_bwd_stats_mix", "fu_inverse",
                    "fu_bwd_mix"):  # f32 spectra in
        nbytes, flops = fu_work(kernel, shape, itemsize, co=co)
        dtype_name = "float32"
    else:
        nbytes, flops = fu_work(kernel, shape, itemsize, maps, co)
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


def bf16_times(dtype, kern, plain, symbols):
    """(ms a call, plain ms a call, profiler device ms a call) of a
    FourierUnit check in bf16, the kernels line's dtype; (None, None, None)
    in f32, whose run checks the numbers only."""
    import torch

    if dtype != torch.bfloat16:
        return None, None, None
    ms = time_ms(kern)
    return ms, time_ms(plain), kernel_device_ms(kern, symbols, iters=10 if ms < 1 else 3)


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


def stage_symbol(name, shape):
    """The profiler's symbol of stage kernel ``name`` (or ``fu_reduce``) at
    ``shape``: the transforms' dense form on planes that are no power of
    two, their split form on planes that ``fourier_unit.plane_ranks``
    spreads over two blocks (``csrc/fourier_unit_staged.cu``)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    if name in ("fu_spectrum", "fu_inverse"):
        h, w = shape[2:]
        if not fu.radix2_plane(h, w):
            return f"{name}_dense_kernel"
        limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
        if fu.plane_ranks(h, w, limit) == 2:
            return f"{name}_split_kernel"
    return f"{name}_kernel"


def slices(shape):
    """T, the out-channel slices on which the statistics and the backward
    apply run ``shape``'s map on this card (``fourier_unit.kernel_design``
    "sliced"; the clustered kernels on each slice in turn), else 1."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    if fu.kernel_design("stats", *shape[1:], limit) != fu.SLICED:
        return 1
    return fu.slice_count(*shape[1:], limit)


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
    t = 1 if name == "fourier_unit_fwd" else slices(shape)
    ranks = fu.item_design(b, c, h, w, limit, c // t)
    smem = fu._item_rank_floats(plan, c, h, w, ranks, c // t) * 4
    threads = re.search(r"kItemThreads = (\d+)",
                        (_build.CSRC_DIR / "fourier_unit_item.cuh").read_text()).group(1)
    tag = "IfE" if dtype_name == "float32" else "bfloat16"
    regs = [v for k, v in ptxas_report().items() if symbol in k and tag in k]
    ptxas = (f"{regs[0][0]} registers, {regs[0][1]}/{regs[0][2]} bytes spill stores/loads"
             if regs else "ptxas report not found")
    sliced = f"{t} out-channel slices of {c // t} in series, each " if t > 1 else ""
    return (f"design: {sliced}{ranks} ranks per item, {b * ranks} blocks of {threads} threads, "
            f"{smem} B shared memory per rank; {symbol} {ptxas}"), ranks


def item_symbol(name, shape):
    """The clustered per-item kernel that ``name``'s wrapper launches at
    ``shape`` (on its own map or on each of its out-channel slices), or None
    where it launches another (workspace, staged)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    if name not in ITEM_KERNELS:
        return None
    wrapper, _, symbol = ITEM_KERNELS[name]
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    design = fu.kernel_design(wrapper, *shape[1:], limit)
    return symbol if design in (fu.SHARED, fu.SLICED) else None


def same_bits(fn):
    """Whether two calls of ``fn`` give the same bits in every output."""
    import torch

    first, again = as_tuple(fn()), as_tuple(fn())
    return all(torch.equal(a, b) for a, b in zip(first, again))


def check_fourier_unit(device, shapes, phase, timed=True):
    """Phases 3 and 9 (forward): the wrapper against its plain version in
    f64, two launches giving the same bits, and its times. Returns the bf16
    rows of the per-item kernel for the kernels line and the bf16 rows of
    the wrapper calls that ran as the staged kernels (none and no times
    where not ``timed``: a map checked only)."""
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
        symbols = ([stage_symbol(k, shape) for k in STAGED_CALL["fourier_unit_fwd"]]
                   if is_staged else item or "fourier_unit_fwd_kernel")
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
            ms, plain_ms, dev_ms = bf16_times(dtype, lambda: fourier_unit_forward(*args),
                                              lambda: fourier_unit_forward_plain(*args),
                                              symbols) if timed else (None, None, None)
            bound_ms, bound_by, nbytes, flops = bound(
                "fourier_unit_fwd", shape, y.element_size(), name
            )
            design, ranks = (item_kernel_line("fourier_unit_fwd", shape, name) if item
                             else ("", None))
            log(
                f"fourier_unit_fwd {shape} {name} ({'staged' if is_staged else 'per-item'}):"
                f" rel-max {rel:.3e} against the plain version in f64 (tol "
                f"{FU_REL_TOL[name]:g}), max-abs {abs_err:.3e}, same bits on two launches "
                f"{bits}; {fmt_ms(ms)} ms/call (profiler device {fmt_ms(dev_ms)} ms per call), "
                f"plain {fmt_ms(plain_ms)} ms/call, bound {bound_ms:.5f} ms ({nbytes} B, {flops} "
                f"FLOP)"
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
            elif timed:
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
        # the library's yardstick: irfft2 of the same complex spectrum (with
        # the half-spectrum weights, which fu_inverse leaves out)
        c = inverse_of.shape[1] // 2
        as_complex = torch.complex(inverse_of[:, :c], inverse_of[:, c:])
        cases.append(
            ("fu_inverse", 1, inverse, inverse, lambda: fu.fu_inverse_plain(inverse_of, dtype, w),
             lambda: fu.fu_inverse_plain(inverse_of.double(), torch.float64, w), ("y",),
             lambda: torch.fft.irfft2(as_complex, s=shape[2:], norm="ortho")))
    return cases


def check_stages(device, shapes, phase, timed=True):
    """Phase 9: each staged kernel against its plain version in f64 on the
    same inputs, two launches giving the same bits, its times and its
    bound; returns the bf16 rows for the kernels line (none and no times
    where not ``timed``)."""
    import torch

    rows = []
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            itemsize = torch.empty((), dtype=dtype).element_size()
            for name, maps, call, call_timed, plain, ref64, out_names, library in stage_cases(
                    shape, dtype, device):
                outs = as_tuple(call())
                torch.cuda.synchronize()
                refs = as_tuple(ref64())
                if not all(torch.isfinite(o.float()).all() for o in outs):
                    raise AssertionError(f"{name} {shape} {dname}: non-finite output")
                errs = {o: rel_max(out, ref) for o, out, ref in zip(out_names, outs, refs)}
                bits = same_bits(call)
                ms, plain_ms, dev_ms = bf16_times(dtype, call_timed, plain, stage_symbol(
                    name, shape)) if timed else (None, None, None)
                library_ms = library_dev_ms = None
                if library is not None and dtype == torch.bfloat16 and timed:
                    library_ms = time_ms(library)
                    library_dev_ms = call_device_ms(library, iters=10)
                bound_ms, bound_by, nbytes, flops = bound(name, shape, itemsize, dname, maps=maps)
                log(f"{name} {shape} {dname}, {maps} map(s): " + ", ".join(
                    f"{o} rel-max {r:.3e} (max-abs {a:.3e})" for o, (r, a) in errs.items())
                    + f" (tol {FU_REL_TOL[dname]:g}, against the plain version in f64), same "
                    f"bits on two launches {bits}; kernel {fmt_ms(ms)} ms/call (profiler device "
                    f"{fmt_ms(dev_ms)} ms), plain {fmt_ms(plain_ms)} ms/call, library {library_ms} "
                    f"ms/call (profiler device {library_dev_ms}), bound {bound_ms:.5f} ms "
                    f"({bound_by}; {nbytes} B, {flops} FLOP)")
                bad = {o: r for o, (r, _) in errs.items() if not r <= FU_REL_TOL[dname]}
                if bad or not bits:
                    raise AssertionError(f"{name} {shape} {dname}: rel-max {bad}, same bits {bits}")
                if dtype == torch.bfloat16 and timed:
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


def check_train_kernels(device, shapes, phase, timed=True):
    """Phases 5 and 9 (training kernels): each wrapper, and on staged maps
    the training op's staged forward and backward, against its plain
    version in f64, two launches giving the same bits, and its times.
    Returns the bf16 rows (and the reduction's f32 rows) for the kernels
    line, and the bf16 rows of the calls that ran as the staged kernels
    (none and no times where not ``timed``)."""
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
                symbols = ([stage_symbol(k, shape) for k in STAGED_CALL[name]] if call_staged
                           else [item] * slices(shape) if item else f"{name}_kernel")
                bits = same_bits(lambda: kern(*args))
                ms, plain_ms, dev_ms = bf16_times(dtype, lambda: kern(*args),
                                                  lambda: plain(*args),
                                                  symbols) if timed else (None, None, None)
                bound_ms, bound_by, nbytes, flops = bound(name, shape, args[0].element_size(), dname)
                log(f"{name} {shape} {dname}{' (staged)' if call_staged else ''}: " + ", ".join(
                    f"{o} rel-max {r:.3e} (max-abs {a:.3e})" for o, (r, a) in errs.items())
                    + f" (tol {FU_REL_TOL[dname]:g}, against the plain version in f64), same "
                    f"bits on two launches {bits}; kernel {fmt_ms(ms)} ms/call with its reduction "
                    f"(profiler device {fmt_ms(dev_ms)} ms"
                    f"{' per call, all stages' if call_staged else ''}"
                    f"{f' per call, {slices(shape)} launches' if slices(shape) > 1 else ''}"
                    f"), plain {fmt_ms(plain_ms)} ms/call, bound "
                    f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B, {flops} FLOP)")
                design, ranks = item_kernel_line(name, shape, dname) if item else ("", None)
                if design:
                    log(f"  {design}")
                gaps = {o: rel_max(p, r)[0] for o, p, r in zip(out_names, plain(*args), refs)}
                log(f"  info: plain version in {dname} vs f64, rel-max " + ", ".join(
                    f"{o} {g:.3e}" for o, g in gaps.items()))
                if dtype == torch.bfloat16 and timed:
                    numbers = dict(phase=phase, max_abs_err=max(a for _, a in errs.values()),
                                   rel_max={o: r for o, (r, _) in errs.items()}, ms=ms,
                                   device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
                    if ranks:
                        numbers["ranks"] = ranks
                    if slices(shape) > 1 and item:
                        numbers["slices"] = slices(shape)
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
    epilogue, the backward sums' (rows, 4C) and gK's (rows, 4C^2; sliced,
    each slice's (rows, 4C Co/T)), a row per item or per run of tiles (B *
    chunks) after the staged stages."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    cases = []
    for shape in fu_shapes:
        b, c, h, w = shape
        n_rows = b * fu.staged_chunks(b, h, w) if staged("stats", shape) else b
        cases += [(n_rows, 4 * c, b * h * (w // 2 + 1)), (n_rows, 4 * c, 0),
                  (n_rows, 4 * c * (c // slices(shape)), 0)]
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
    where the apply's or the dx kernel's grid holds less than one full wave
    of the blocks the card holds at once, by the occupancy calculator's
    count for the built kernel)."""
    from fastfourierconvolution_tpu_torch.ops import bn_act as ba

    b, c, h, w = shape
    if name in ("bn_gelu_apply", "bn_bwd_dx"):
        if name == "bn_gelu_apply":
            vec, tile, group = ba.apply_design(b, c, h * w, x.element_size())
            grid = ba.apply_blocks(b, c, h * w, x.element_size(), vec, tile, group)
            per_sm = ba.apply_blocks_per_sm(x.dtype, noise, vec, tile)
            launch = f"groups of {group}"
        else:
            vec, lanes, group, cluster = ba.dx_design(b, c, h * w, x.element_size(),
                                                      noise=noise)
            tile = 256
            grid = ba.dx_blocks(b, c, h * w, x.element_size(), vec, lanes, group, cluster)
            per_sm = ba.dx_blocks_per_sm(x.dtype, noise, vec, lanes, group)
            launch = (f"{lanes} threads a unit, groups of {group}"
                      + (f" as the ranks of clusters of {cluster}" if noise else ""))
        wave = 132 * per_sm
        full = per_sm > 0 and grid[0] * grid[1] >= wave
        return (f"{'16-byte' if vec else 'element-wise'} units, blocks of {tile}, {launch}: "
                f"grid {grid[0]} x {grid[1]} = {grid[0] * grid[1]} blocks, the card holds "
                f"{per_sm} per SM ({wave} on 132 SMs): full wave {full}"), full
    design = ba.stats_design if name == "bn_stats" else ba.bwd_reduce_design
    vec, cluster = design(b, c, h * w, x.element_size())
    return (f"one launch, {'16-byte' if vec else 'element-wise'} loads, clusters of "
            f"{cluster}"), True


def check_bn_act(device, shapes=PACKED_SHAPES + [STATS_TAIL_SHAPE], phase="training-128px"):
    """Phase 8 (and the 256px part's packed map); returns the bf16 rows for
    the kernels line."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    rows = []
    for shape in shapes:
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
                        name, shape, dname, phase=phase, noise=noise,
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


def calibrate_running_stats(model, z, labels=None):
    """Set every BatchNorm's and FourierUnit's running statistics to the
    f32 batch statistics of its input on ``z`` (and ``labels`` for a
    conditional generator), layer by layer."""
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
            model(z, torch.float32, *(() if labels is None else (None, labels)))
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


def check_96px_kernels(device):
    """The forward, the statistics, the backward sums and the backward
    apply at ``DENSE_SHAPES``, where ``kernel_design`` picks the staged
    kernels with dense DFT transforms for every wrapper, checked as in
    phase 9 (each stage also on its own: ``fu_spectrum`` and ``fu_inverse``
    on dense planes), each wrapper's bf16 device ms a call at
    ``WORKSPACE_96_SHAPE`` printed beside the workspace design's there
    (``WORKSPACE_96_MS``); then the four
    per-item workspace kernels at ``WORKSPACE_SHAPES``, where
    ``kernel_design`` picks them for every wrapper, checked as in phases 3
    and 5. Returns the bf16 (rows, calls) for the kernels and wrapper_calls
    lines."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for shapes, want in ((DENSE_SHAPES, fu.STAGED), (WORKSPACE_SHAPES, fu.WORKSPACE)):
        for shape in shapes:
            designs = {w: fu.kernel_design(w, *shape[1:], limit)
                       for w in ("forward", "stats", "bwd_apply")}
            if set(designs.values()) != {want}:
                raise AssertionError(f"{shape}: not the {want} design: {designs}")
    rows, calls = check_fourier_unit(device, DENSE_SHAPES, "staged-96px")
    rows += check_stages(device, DENSE_SHAPES, "staged-96px")
    train_rows, train_calls = check_train_kernels(device, DENSE_SHAPES, "staged-96px")
    rows += train_rows
    calls += train_calls
    for row in calls:
        if row["name"] not in WORKSPACE_96_MS or tuple(row["shape"]) != WORKSPACE_96_SHAPE:
            continue
        lo, hi = WORKSPACE_96_MS[row["name"]]
        dev, bound_ms = row["device_ms"], row["bound_ms"]
        log(f"{row['name']} {tuple(row['shape'])} bf16, staged on dense planes: profiler device "
            f"{fmt_ms(dev)} ms a call (all stages), {row['ms']:.4f} ms a call, bound "
            f"{bound_ms:.5f} ms" + ("" if dev is None else f" ({dev / bound_ms:.0f}x)")
            + f", plain {row['plain_ms']:.4f} ms; the workspace design {lo:.4f}-{hi:.4f} ms "
            f"a launch; faster: {dev is not None and dev < lo}")
    ws_rows, _ = check_fourier_unit(device, WORKSPACE_SHAPES, "workspace")
    ws_train_rows, _ = check_train_kernels(device, WORKSPACE_SHAPES, "workspace")
    return rows + ws_rows + ws_train_rows, calls


def pair_96(device, card):
    """Phase 15's 96px part: ``check_96px_kernels``, then the 96px pair
    trained in bf16 as in phase 6, 4 replayed f32 steps against 4 eager ones
    (phase 12) and an f32 step against the plain ops (phase 7). Returns the
    (rows, calls) with the training run's launches, and those launches."""
    t0 = time.perf_counter()
    rows, calls = check_96px_kernels(device)
    t1 = time.perf_counter()
    _, counts, _, _ = train(device, card, 96)
    t2 = time.perf_counter()
    graph_parity(device, 96, {"bench": {}})
    t3 = time.perf_counter()
    train_vs_plain(device, 96)
    log(f"96px part, s (host clock): kernel checks {t1 - t0:.1f}, bf16 training {t2 - t1:.1f}, "
        f"graph parity {t3 - t2:.1f}, f32 against the plain ops {time.perf_counter() - t3:.1f}")
    return with_launches(rows, counts), with_calls(calls, counts), counts


def check_256px_kernels(device):
    """The 256px generator's map (32,256,256), where ``kernel_design`` picks
    the staged kernels with each plane split over two blocks for every
    wrapper, at ``SPLIT_SHAPES``, checked as in phase 9 (the split
    ``fu_spectrum`` and ``fu_inverse`` and every stage on their own, beside
    ``torch.fft.rfft2`` / ``irfft2`` on the same spectrum, and the training
    op's staged forward and backward; timed at batch 64 only), each
    wrapper's bf16 device ms a call at (64,32,256,256) printed beside the workspace design's there
    (``WORKSPACE_256_MS``); (8,12,64,64) stays on the workspace; the fused BN
    kernels at the new packed map (64,128,256,256) checked as in phase 8.
    Returns the bf16 (rows, calls) for the kernels and wrapper_calls lines."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for shape, want in ((SPLIT_SHAPES[1], fu.STAGED), (WORKSPACE_SHAPES[0], fu.WORKSPACE)):
        designs = {w: fu.kernel_design(w, *shape[1:], limit)
                   for w in ("forward", "stats", "bwd_apply")}
        if set(designs.values()) != {want}:
            raise AssertionError(f"{shape}: not the {want} design: {designs}")
    if fu.plane_ranks(*SPLIT_SHAPES[1][2:], limit) != 2:
        raise AssertionError("the 256 x 256 plane is not split over two blocks")
    # batch 8 checked only, its times dropped to keep the script within its
    # limit: the trained batch gives the readings
    rows, calls = [], []
    for shape, timed in ((SPLIT_SHAPES[0], False), (SPLIT_SHAPES[1], True)):
        fwd_rows, fwd_calls = check_fourier_unit(device, [shape], "staged-256px", timed)
        train_rows, train_calls = check_train_kernels(device, [shape], "staged-256px", timed)
        rows += fwd_rows + check_stages(device, [shape], "staged-256px", timed) + train_rows
        calls += fwd_calls + train_calls
    for row in calls:
        if row["name"] not in WORKSPACE_256_MS or tuple(row["shape"]) != SPLIT_SHAPES[1]:
            continue
        ws, dev, bound_ms = WORKSPACE_256_MS[row["name"]], row["device_ms"], row["bound_ms"]
        log(f"{row['name']} {SPLIT_SHAPES[1]} bf16, staged on split planes: profiler device "
            f"{fmt_ms(dev)} ms a call (all stages), {row['ms']:.4f} ms a call, bound "
            f"{bound_ms:.5f} ms" + ("" if dev is None else f" ({dev / bound_ms:.0f}x)")
            + f", plain {row['plain_ms']:.4f} ms; the workspace design {ws:.4f} ms a call"
            + ("" if dev is None else f" ({ws / dev:.1f}x the split design's)"))
    rows += check_bn_act(device, PACKED256_SHAPES[-1:], "training-256px")
    return rows, calls


def serve_256(device, card, trainer):
    """The 256px part's serving: ``trainer.generate(z, uint8=True)`` on the
    trained generator in eval mode, batch 64, bf16: ``N_REQUESTS // 2``
    requests with exact launches (the eval forward once a map and request:
    per item at (64,16,16), its three stages at the staged maps), uint8
    images of the expected shape and spread, then requests back to back for
    the ms a request. Returns the launches by map."""
    import torch

    requests = N_REQUESTS // 2
    g = torch.Generator().manual_seed(SEED + 31)
    zs = [torch.randn(BATCH, 128, generator=g).to(device) for _ in range(requests)]
    trainer.generate(zs[0], uint8=True)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    images = [trainer.generate(z, uint8=True) for z in zs]
    torch.cuda.synchronize()
    counts = {k: v for k, v in counts_by_map().items() if v}
    want = {k: v for k, v in launches_of([(s, 0, 0, 1) for s in FU256_SHAPES], [],
                                         requests).items() if v}
    if counts != want:
        raise AssertionError(f"generate's kernel launches {counts}, expected {want}")
    spread = images[0].float().std().item()
    if (any(im.shape != (BATCH, 256, 256, 3) or im.dtype != torch.uint8 for im in images)
            or not spread > 5.0):
        raise AssertionError(f"generate gave {tuple(images[0].shape)} {images[0].dtype}, "
                             f"std {spread:.2f} levels")
    n_timed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TIMED_SECONDS:
        trainer.generate(zs[0], uint8=True)
        n_timed += 1
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n_timed * 1e3
    busy_ms, n_launch, _ = device_breakdown(lambda: trainer.generate(zs[0], uint8=True), iters=3)
    log(f"256px generate(z, uint8=True), batch {BATCH}, bf16: {wall_ms:.3f} ms wall a request "
        f"({n_timed} requests, host clock), {BATCH / wall_ms * 1e3:.1f} img/s, device busy "
        f"{busy_ms:.3f} ms in {n_launch} device launches (profiler), idle share "
        f"{1 - busy_ms / wall_ms:.3f}; image std {spread:.1f} levels; launches {counts}; {card}")
    return counts


def pair_256(device, card):
    """Phase 15's 256px part: ``check_256px_kernels``, then the 256px pair
    (``FFCGenerator.for_resolution(256)``, packed, against
    ``SNConvDiscriminator.for_resolution(256)``) trained in bf16 as in phase
    6 (2 checked eager steps, ``update_steps`` with K = 4), a batch-64
    request served (``serve_256``), 4 replayed f32 steps against 4 eager
    ones (phase 12, batch ``PARITY_BATCH[256]``) and an f32 step against the
    plain ops (phase 7). Returns the (rows, calls) with the training run's
    launches, and the training and serving launches."""
    t0 = time.perf_counter()
    rows, calls = check_256px_kernels(device)
    t1 = time.perf_counter()
    trainer, counts, _, _ = train(device, card, 256)
    t2 = time.perf_counter()
    served = serve_256(device, card, trainer)
    del trainer
    t3 = time.perf_counter()
    graph_parity(device, 256, {"bench": {}})
    t4 = time.perf_counter()
    train_vs_plain(device, 256)
    log(f"256px part, s (host clock): kernel checks {t1 - t0:.1f}, bf16 training {t2 - t1:.1f}, "
        f"serving {t3 - t2:.1f}, graph parity {t4 - t3:.1f}, f32 against the plain ops "
        f"{time.perf_counter() - t4:.1f}")
    return with_launches(rows, counts), with_calls(calls, counts), counts, served


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
             96: ([(s, 2, 1) for s in FU96_SHAPES], []),
             256: ([(s, 2, 1) for s in FU256_SHAPES], PACKED256_SHAPES),
             "fgan64": ([(s, 2, 1) for s in FU_SHAPES + FU64_SHAPES], []),
             **{path: ([], []) for path in ZOO_CONFIGS}}


def expected_launches(path, n_steps):
    """{kernel: {map or partial shape: launches}} for ``n_steps`` training
    steps of ``path``; maps of G and D with the same (C, H, W) add up."""
    fu_maps, bn_shapes = STEP_MAPS[path]
    return launches_of(fu_maps, [(s, BN_STEP_LAUNCHES) for s in bn_shapes], n_steps)


def launches_of(fu_maps, bn_maps, n_runs=1):
    """{kernel: {map or partial shape: launches}} for ``n_runs`` runs of:
    per FourierUnit map (shape, training forwards, backwards[, eval
    forwards]) and per packed BN map (shape, {kernel: launches})."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    want = {k: collections.Counter() for k in launch_wrappers()}
    for shape, forwards, backwards, *evals in fu_maps:
        b, c, h, w = shape
        is_staged = staged("stats", shape)
        t = slices(shape)
        per_forward, per_backward = PASS_LAUNCHES["staged" if is_staged else "per_item"]
        for k, per in [(k, per * forwards) for k, per in per_forward.items()] + [
                (k, per * backwards) for k, per in per_backward.items()]:
            if k in SLICED_KERNELS and t > 1:  # once per slice, under the slice's map
                want[k][(c, h, w, c // t)] += t * per * n_runs
            else:
                want[k][(c, h, w)] += per * n_runs
        for k in (STAGED_CALL["fourier_unit_fwd"] if staged("forward", shape)
                  else ("fourier_unit_fwd",)):
            want[k][(c, h, w)] += sum(evals) * n_runs
        # a statistics reduction per forward and a backward-sums reduction
        # per backward on (rows, 4C), a gK reduction per backward on
        # (rows, 4C^2) (sliced: one per slice on (rows, 4C Co/T)): a row per
        # item, or per run of tiles (B * chunks) after the staged mix stages
        rows = b * fu.staged_chunks(b, h, w) if is_staged else b
        want["fu_reduce"][(rows, 4 * c)] += (forwards + backwards) * n_runs
        want["fu_reduce"][(rows, 4 * c * (c // t))] += t * backwards * n_runs
    for (b, c, h, w), per_kernel in bn_maps:
        for k, per in per_kernel.items():
            want[k][(c, h, w)] += per * n_runs
    return {k: {m: n for m, n in v.items() if n} for k, v in want.items()}


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
    the CLI derives from it (``cli.trainer_keywords``, the JAX CLI's);
    ``options`` override the trainer's keywords."""
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
        from fastfourierconvolution_tpu_torch.cli import trainer_keywords

        cfg = zoo_config(path)
        g, d = build_models(cfg)
        setting = trainer_keywords(cfg)
        setting.update(options, seed=SEED, dtype=dtype)
        return GANTrainer(g, d, device=device, **setting)
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


# Device events one profiled call of replayed steps may hold. Windows of
# one call of 16 sagan steps (about 100,000 events) lost or gained events
# in 5 and 6 windows in a row in two runs (H100 80GB HBM3, 700 W), where
# eager windows of 3 steps (about 19,000) kept every event.
PROFILED_EVENTS = 12_000


def launch_parity(trainer, real, reals, labels, labels_k, extra, attempts=6):
    """The profiler's device events per eager step and per replayed step,
    which must differ by ``extra``; a window whose counts disagree (the
    profiler can lose events: it lost some in 3 windows in a row, at the
    eager and at the replayed step, in 2 of 4 runs of one call on an H100
    80GB HBM3, 700 W) is profiled again, up to ``attempts`` times. The
    replayed window is one call of the first n of the K steps, n as many as
    keep it within ``PROFILED_EVENTS`` at the eager step's count (K at
    most, 1 at least). Returns (eager ms, eager events, graph ms, graph
    events, the names whose counts differ)."""
    for _ in range(attempts):
        eager_ms, eager = step_events(lambda: trainer.update_step(real, labels), 1, 3)
        n = max(1, min(reals.shape[0], int(PROFILED_EVENTS // max(sum(eager.values()), 1))))
        graph_ms, graph = step_events(
            lambda: trainer.update_steps(reals[:n], None if labels_k is None else labels_k[:n]),
            n, 1)
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
    device ms and wall ms."""
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
    return trainer, counts, graph_dev, graph_ms


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
    ``update_steps`` over ``PARITY_STEPS`` batches (of ``PARITY_BATCH``'s
    size where the path has one) against as many ``update_step`` calls. The
    same bits are expected; where they differ
    the largest gaps are printed and must sit within phase 7's bars (losses
    1e-3, rel-max 1e-2 per tensor; the generators' states exactly)."""
    import torch

    batch_size = PARITY_BATCH.get(path, BATCH)
    reals = torch.stack([real_batch(device, SEED + 20 + i, RESOLUTION[path], batch_size)
                         for i in range(PARITY_STEPS)])
    labels = label_batch(device, SEED + 20, path, (PARITY_STEPS, batch_size))
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
                f"steps against {PARITY_STEPS} eager steps, f32, batch {batch_size}: losses max |diff| "
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
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return Count.total


def extractor_gflop(module, images):
    """GFLOP an image of ``module`` (an InceptionV3) on uint8 ``images``: its
    products and convolutions (``step_flops``), the TF1 resize's included."""
    import torch

    # under no_grad, not inference mode: there the composite convolution and
    # product ops reach the dispatch mode undecomposed, outside flop_counter's table
    with torch.no_grad():
        return step_flops(lambda: module(images)) / len(images) / 1e9


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
    trainer, counts, graph_dev, _ = train(device, card, path)
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


# Phases 21-23 and 28: the training CLI through its entry point, at full
# width, batch 64 (the presets'), bf16, on the shapes dataset (no download),
# K = 16 steps per update_steps call and a loss read every chunk; the
# in-loop metrics off in phases 21-23 (``CLI_METRICS_OFF``), on in phase 28.
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_K = 16
CLI_COMMON = ("--set", "train.precision=bf16", "--set", "data.dataset=shapes",
              "--set", f"train.steps_per_call={CLI_K}", "--set", f"log.log_every={CLI_K}")
CLI_METRICS_OFF = ("--set", "eval.isc=false", "--set", "eval.fid=false")
# A CLI command in a child process: the module run as ``python -m`` runs it
# (runpy), then every kernel wrapper's launches over the run, by map, written
# to the JSON file named by the first argument.
CLI_CHILD = (
    "import json, runpy, sys\n"
    "counts_path = sys.argv.pop(1)\n"
    "try:\n"
    "    runpy.run_module('fastfourierconvolution_tpu_torch.cli', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "finally:\n"
    "    import chip_smoke\n"
    "    with open(counts_path, 'w') as f:\n"
    "        json.dump({k: [[list(m), n] for m, n in v.items()]\n"
    "                   for k, v in chip_smoke.counts_by_map().items()}, f)\n"
)


def cli_run(name, args, out_dir, timeout=300, metrics=False, env=None, common=True):
    """One CLI command (``args``, ``CLI_COMMON`` and, unless ``metrics``,
    ``CLI_METRICS_OFF``; logs in ``out_dir``; with ``common`` False
    ``args`` alone, as ``fidelity`` takes them) in a child process with
    the environment ``env`` (None: this one's): (its stdout, its launches
    by kernel and map). A non-zero exit fails the phase."""
    return cli_wait(cli_start(name, args, out_dir, timeout, metrics, env, common))


def cli_start(name, args, out_dir, timeout=300, metrics=False, env=None, common=True):
    """:func:`cli_run`'s child process, started; :func:`cli_wait` ends it.
    Commands that do not read each other's files run side by side."""
    counts_path = f"{out_dir}.{name}.launches.json"
    cmd = [sys.executable, "-c", CLI_CHILD, counts_path, *args]
    if common:
        cmd += [*CLI_COMMON, *(() if metrics else CLI_METRICS_OFF), "-o", out_dir]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    return name, args, counts_path, timeout, proc, time.perf_counter()


def cli_wait(job):
    name, args, counts_path, timeout, proc, t0 = job
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(f"cli {name}: stdout\n{stdout[-3000:]}\nstderr\n{stderr[-3000:]}")
        raise AssertionError(f"cli {name} ({' '.join(args)}) exited {proc.returncode}")
    with open(counts_path) as f:
        counts = {k: {tuple(m): n for m, n in v} for k, v in json.load(f).items()}
    lines = [l for l in stdout.splitlines() if l.startswith(("INFO", "[config]", "step "))]
    log(f"cli {name}: {' '.join(args)}: exit 0 in {wall:.1f} s (child process, host clock); "
        f"{lines if len(lines) <= 4 else lines[:2] + lines[-2:]}")
    return stdout, counts


def eval_launches(g_maps, requests, want=None):
    """``want`` (or no launches) plus ``requests`` eval-mode generator
    forwards' launches: per map the forward kernel, or its three stages
    where the forward is staged."""
    want = {k: dict(v) for k, v in (want or {k: {} for k in launch_wrappers()}).items()}
    for shape in g_maps:
        key = tuple(shape[1:])
        kernels = STAGED_CALL["fourier_unit_fwd"] if staged("forward", shape) else (
            "fourier_unit_fwd",)
        for k in kernels:
            want[k][key] = want[k].get(key, 0) + requests
    return want


def cli_train_launches(path, g_maps, grids):
    """A CLI training run's launches: the first ``update_steps`` call's
    eager step and capture (replays count none), and one eval forward per
    sample grid."""
    return eval_launches(g_maps, grids, expected_launches(path, 2))


def png_size(path):
    """(width, height) from a PNG file's header; raises if it is no PNG."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is no PNG file")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def check_run_files(out_dir, names):
    """Raises unless every file of ``names`` exists under ``out_dir``; each
    .png must be a PNG file; returns the logged losses (finite)."""
    missing = [n for n in names if not os.path.exists(os.path.join(out_dir, n))]
    if missing:
        raise AssertionError(f"{out_dir}: missing {missing}; have {sorted(os.listdir(out_dir))}")
    for n in names:
        if n.endswith(".png"):
            png_size(os.path.join(out_dir, n))
    with open(os.path.join(out_dir, "gan_losses.csv")) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    losses = [float(v) for row in rows for v in row[1:3]]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{out_dir}: logged losses {losses}")
    return losses


def cli_wall_ms(out_dir, first, last):
    """Wall ms per step between the loss logs after steps ``first`` and
    ``last`` (``scalars.jsonl`` times: each log follows a loss read, which
    waits for the chunk's steps; no epoch boundary lies between them)."""
    with open(os.path.join(out_dir, "scalars.jsonl")) as f:
        times = {r["step"]: r["time"] for r in map(json.loads, f) if "loss_g" in r}
    return (times[last - 1] - times[first - 1]) / (last - first) * 1e3


def cli_trainer(device, preset, dtype, seed=SEED, **overrides):
    """``preset``'s pair, built and keyed as the CLI builds it, in ``dtype``."""
    from fastfourierconvolution_tpu_torch import GANTrainer, build_models, make_config
    from fastfourierconvolution_tpu_torch.cli import trainer_keywords

    cfg = make_config(preset, **overrides)
    setting = trainer_keywords(cfg)
    setting.update(dtype=dtype, seed=seed)
    return GANTrainer(*build_models(cfg), device=device, **setting)


def restore_checks(device, card, tmp):
    """Phase 21 in process, the fgan32 pair at full width: a trainer restored
    from a checkpoint equals the saved one bit for bit (every parameter,
    buffer, moment, learning rate, count and generator state), into a
    trainer whose step graph is captured, every tensor keeping its address
    and the optimizers their ``lr`` tensors; then in f32 under
    deterministic algorithms, 16 replayed steps after a save, a restore and
    16 replayed steps again give the same losses' bits."""
    import torch

    from fastfourierconvolution_tpu_torch.train.checkpoint import restore_latest, save_checkpoint

    reals = torch.stack([real_batch(device, SEED + 40 + i, 32) for i in range(CLI_K)])
    saved = cli_trainer(device, "fgan32", "bf16")
    saved.update_steps(reals)
    save_checkpoint(saved, os.path.join(tmp, "restore"), saved.step)
    into = cli_trainer(device, "fgan32", "bf16", seed=SEED + 5)
    into.update_steps(reals[:2])
    before = {k: v.data_ptr() for k, v in trainer_state(into).items()
              if not k.endswith("generator")}
    lr_tensors = (into.g_opt.param_groups[0]["lr"], into.d_opt.param_groups[0]["lr"])
    _, step = restore_latest(into, os.path.join(tmp, "restore"))
    a, b = trainer_state(saved), trainer_state(into)
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    moved = sorted(k for k, ptr in before.items() if b[k].data_ptr() != ptr)
    same_lr = (lr_tensors[0] is into.g_lr.lr and lr_tensors[1] is into.d_lr.lr
               and into.g_opt.param_groups[0]["lr"] is into.g_lr.lr)
    log(f"restore, fgan32 bf16 at full width, into a trainer with a captured step: {len(a)} "
        f"state tensors, {len(a) - len(differ)} the same bits as the saved trainer's; "
        f"{len(moved)} of {len(before)} moved; optimizers read the schedules' lr tensors: "
        f"{same_lr}; step {step} (saved {saved.step})")
    if differ or moved or not same_lr or step != saved.step or into.step != saved.step:
        raise AssertionError(f"restore: differ {differ[:8]}, moved {moved[:8]}, lr {same_lr}")
    del saved, into

    torch.use_deterministic_algorithms(True)
    try:
        trainer = cli_trainer(device, "fgan32", "f32")
        trainer.update_steps(reals)  # the eager step and the capture
        save_checkpoint(trainer, os.path.join(tmp, "replay"), trainer.step)
        later = torch.stack([real_batch(device, SEED + 60 + i, 32) for i in range(CLI_K)])
        first = {k: v.clone() for k, v in trainer.update_steps(later).items()}
        end = {k: v.clone() for k, v in trainer_state(trainer).items()}
        restore_latest(trainer, os.path.join(tmp, "replay"))
        again = trainer.update_steps(later)
        torch.cuda.synchronize()
        after = trainer_state(trainer)
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(first[k], again[k]) for k in first)
    differ = sorted(k for k in end if not torch.equal(end[k], after[k]))
    log(f"restore against a captured graph, fgan32 f32, deterministic algorithms: {CLI_K} "
        f"replayed steps after the save and {CLI_K} after the restore, the same losses' bits "
        f"{same}, the same final state in {len(end) - len(differ)} of {len(end)} tensors "
        f"(generators included); {card}")
    if not same or differ:
        raise AssertionError(f"replays after a restore differ: losses {same}, state {differ[:8]}")


def loader_share(device, card, cli_ms):
    """Phase 21: the data path's share of a CLI step beside its wall ms:
    the loader's host ms per batch (its prefetch thread, overlapped with
    the steps), stacking a chunk, the chunk's host-to-device copy from
    pinned memory on the card's copy engine (overlapped) and the
    normalisation on the card, each per step. The CLI's feed, run on the
    card over all 256 uint8 levels, must give ``cli.unit_levels``' bits
    (the JAX CLI's)."""
    import numpy as np
    import torch

    from fastfourierconvolution_tpu_torch.cli import _Feed, unit_levels
    from fastfourierconvolution_tpu_torch.data import DataLoader, load_dataset

    levels = np.arange(256, dtype=np.uint8).reshape(1, 4, 8, 8, 1)  # (K, B, H, W, C)
    feed = _Feed(iter([(levels[0], np.zeros(4, np.int64))]), 1, device)
    reals, _ = feed.take(feed.put())
    if reals.cpu().numpy().tobytes() != unit_levels().tobytes():
        raise AssertionError("the card's normalisation differs from the JAX CLI's values")
    loader = DataLoader(load_dataset("shapes", "", 32), BATCH, raw_uint8=True)
    batches = loader.epochs()
    try:
        next(batches)
        n = 4 * CLI_K
        t0 = time.perf_counter()
        chunk = [next(batches) for _ in range(n)][:CLI_K]
        loader_ms = (time.perf_counter() - t0) / n * 1e3
    finally:
        batches.close()
    t0 = time.perf_counter()
    x8 = np.stack([b[0] for b in chunk])
    stack_ms = (time.perf_counter() - t0) * 1e3 / CLI_K
    pinned = torch.from_numpy(x8).pin_memory()
    on_dev = torch.empty(x8.shape, dtype=torch.uint8, device=device)
    h2d_ms = time_ms(lambda: on_dev.copy_(pinned, non_blocking=True)) / CLI_K
    norm_ms = time_ms(lambda: feed.levels[on_dev.long()]) / CLI_K
    log(f"CLI data path per step, a chunk of {CLI_K} x {BATCH} x 32 x 32 x 3 uint8 "
        f"({x8.nbytes} B): loader {loader_ms:.4f} ms (host, its own thread), stack "
        f"{stack_ms:.4f} ms (host), host-to-device {h2d_ms:.4f} ms (CUDA events, copy engine, "
        f"{x8.nbytes / CLI_K / h2d_ms / 1e6:.2f} GB/s), normalise {norm_ms:.4f} ms (CUDA "
        f"events); shares of the CLI's {cli_ms:.3f} ms step: loader {loader_ms / cli_ms:.4f}, "
        f"host-to-device {h2d_ms / cli_ms:.4f}; the levels 0-255 normalised to the JAX "
        f"CLI's values on the card; {card}")


def cli_fgan32(device, card, tmp, graph_ms_32):
    """Phase 21: ``train`` 96 steps (epochs of 48, checkpoints), ``train``
    again to 144 (the resume), ``sample`` beside the restore checks in
    process;
    the CLI's wall ms per step beside phase 6's replayed step, and the data
    path's share. Returns the CLI runs' launches by run."""
    out = os.path.join(tmp, "fgan32")
    args = ["--preset", "fgan32", "--set", "train.num_epoch_steps=48", "--checkpoint"]
    _, counts_train = cli_run("fgan32-train", ["train", *args, "-e", "96"], out)
    losses = check_run_files(out, ["gan_losses.csv", "scalars.jsonl", "000048.png", "000096.png",
                                   "checkpoints/ckpt_96_steps.pt"])
    cli_ms = cli_wall_ms(out, 64, 96)
    want = cli_train_launches(32, FU_SHAPES, grids=2)
    if counts_train != want:
        raise AssertionError(f"cli fgan32 train launches {counts_train}, want {want}")
    stdout, counts_resume = cli_run("fgan32-resume", ["train", *args, "-e", "144"], out)
    if "INFO: resumed from step 96" not in stdout:
        raise AssertionError("cli fgan32: the second train did not resume from step 96")
    check_run_files(out, ["000144.png", "checkpoints/ckpt_144_steps.pt"])
    if counts_resume != cli_train_launches(32, FU_SHAPES, grids=1):
        raise AssertionError(f"cli fgan32 resumed launches {counts_resume}")
    # the sample child runs beside the in-process restore checks
    sample_job = cli_start("fgan32-sample", ["sample", "--preset", "fgan32",
                                             "--num_samples", "64"], out)
    restore_checks(device, card, tmp)
    _, counts_sample = cli_wait(sample_job)
    loader_share(device, card, cli_ms)
    size = png_size(os.path.join(out, "samples_000144.png"))
    # the sample grid and the feature-map capture's request of one latent
    if counts_sample != eval_launches(FU_SHAPES, 2):
        raise AssertionError(f"cli fgan32 sample launches {counts_sample}")
    log(f"cli fgan32: 96 steps, resumed to 144, sampled ({size[0]}x{size[1]} grid); "
        f"{len(losses)} logged losses finite; launches as expected in every run (the first "
        f"train: {({k: v for k, v in counts_train.items() if v})})")
    log(f"CLI training step, fgan32, batch {BATCH}, bf16, K={CLI_K}: {cli_ms:.3f} ms wall per "
        f"step between epoch boundaries (scalars.jsonl, steps 64-96); phase 6's replayed step "
        f"{graph_ms_32:.3f} ms; the CLI adds {cli_ms / graph_ms_32 - 1:+.2%}; {card}")
    return {"cli-fgan32-train": counts_train, "cli-fgan32-resume": counts_resume,
            "cli-fgan32-sample": counts_sample}


def cli_cond32(device, card, tmp):
    """Phase 22: ``fgan_cond32`` through the CLI, the class count inferred
    from shapes: train 32 steps (labels through ``update_steps``), then
    ``sample`` with class-stratified labels. Returns the runs' launches."""
    out = os.path.join(tmp, "cond32")
    args = ["--preset", "fgan_cond32", "--set", "model.num_classes=0", "--set", "eval.kid=false"]
    stdout, counts_train = cli_run("cond32-train", [
        "train", *args, "--set", "train.num_epoch_steps=16", "--checkpoint", "-e", "32"], out)
    if "[config] model.num_classes=3" not in stdout:
        raise AssertionError("cli cond32: the class count was not inferred as 3")
    losses = check_run_files(out, ["000016.png", "000032.png", "checkpoints/ckpt_32_steps.pt"])
    if counts_train != cli_train_launches("cond32", FU_SHAPES, grids=2):
        raise AssertionError(f"cli cond32 train launches {counts_train}")
    stdout, counts_sample = cli_run("cond32-sample", ["sample", *args, "--num_samples", "64"], out)
    png_size(os.path.join(out, "samples_000032.png"))
    if "[config] model.num_classes=3" not in stdout or counts_sample != eval_launches(
            FU_SHAPES, 2):
        raise AssertionError(f"cli cond32 sample: launches {counts_sample}")
    log(f"cli fgan_cond32: 32 steps with 3 inferred classes, {len(losses)} logged losses "
        f"finite, sampled with class-stratified labels; launches as expected; {card}")
    return {"cli-cond32-train": counts_train, "cli-cond32-sample": counts_sample}


def cli_fgan64(device, card):
    """Phase 23: the kernels at fgan64's staged map (64,8,64,64) against
    their plain versions (as phase 9 holds the 128px maps); the pair built
    as the CLI builds it, an eager step's launches per map (exact) and its
    device time, replayed steps' wall and device time (its CLI run,
    ``cli_fgan64_train``, runs beside phase 26). Returns the kernels line's
    rows (launches per step) and the staged calls' rows."""
    import torch

    rows, calls = check_fourier_unit(device, FU64_SHAPES, "cli-fgan64")
    rows += check_stages(device, FU64_SHAPES, "cli-fgan64")
    train_rows, train_calls = check_train_kernels(device, FU64_SHAPES, "cli-fgan64")
    rows += train_rows + check_reduce(device, reduce_cases(FU64_SHAPES), "cli-fgan64")
    calls += train_calls

    trainer = cli_trainer(device, "fgan64", "bf16")
    real = real_batch(device, SEED + 2, 64)
    trainer.update_step(real)
    torch.cuda.synchronize()
    zero_counts()
    trainer.update_step(real)
    torch.cuda.synchronize()
    per_step = counts_by_map()
    if per_step != expected_launches("fgan64", 1):
        raise AssertionError(f"fgan64 step launches {per_step}")
    eager_dev, n_launch, top = device_breakdown(lambda: trainer.update_step(real), iters=2)
    reals = torch.stack([real_batch(device, SEED + 10 + i, 64) for i in range(CLI_K)])
    trainer.update_steps(reals)  # the eager step and the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        trainer.update_steps(reals)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) / (2 * CLI_K) * 1e3
    graph_dev, _ = step_events(lambda: trainer.update_steps(reals), CLI_K, 1)
    log(f"fgan64 training step (the CLI's pair), batch {BATCH}, bf16: eager {eager_dev:.3f} ms "
        f"device in {n_launch} launches (profiler); replayed (K={CLI_K}) {graph_ms:.3f} ms wall "
        f"per step (host clock), {graph_dev:.3f} ms device (profiler), idle share "
        f"{1 - graph_dev / graph_ms:.3f}; launches per step {per_step}; {card}")
    for name, ms, count in top:
        log(f"  device {ms:.4f} ms in {count} launches: {name[:90]}")
    del trainer
    return with_launches(rows, per_step), with_calls(calls, per_step)


def cli_fgan64_train(card, tmp):
    """Phase 23 through the CLI, in a child process (run beside phase 26's):
    ``fgan64`` (the shapes dataset at 64px, no hflip), 32 steps, exact
    launches. Returns the run's launches."""
    out = os.path.join(tmp, "fgan64")
    _, counts = cli_run("fgan64-train", [
        "train", "--preset", "fgan64", "--set", "data.hflip_augment=false",
        "--set", "train.num_epoch_steps=32", "-e", "32"], out)
    losses = check_run_files(out, ["000032.png"])
    if counts != cli_train_launches("fgan64", FU_SHAPES + FU64_SHAPES, grids=1):
        raise AssertionError(f"cli fgan64 launches {counts}")
    log(f"cli fgan64: 32 steps, {len(losses)} logged losses finite; launches as expected, the "
        f"staged map's {[(k, v[(8, 64, 64)]) for k, v in counts.items() if (8, 64, 64) in v]}; "
        f"{card}")
    return {"cli-fgan64": counts}


def with_launches(rows, counts):
    """The rows with their kernel's launches by map (by partial shape for
    the reduction) from a training run's counts. ``fu_spectrum``'s count
    covers both of its forms: the backward's two-map launches are one per
    ``fu_bwd_mix`` launch, the rest are the forward's."""
    for row in rows:
        key = tuple(row["shape"]) if row["name"] == "fu_reduce" else tuple(row["shape"][1:])
        if row.get("slices"):  # counted under the slice's map
            key += (key[0] // row["slices"],)
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


# --- phase 24: the FFC layer options ---------------------------------------------------


def lfu_blocks(resolution):
    """[(name, FFC_BN_ACT keywords, input size)] of the upsampling blocks of
    ``FFCGenerator.for_resolution(resolution)`` at their widths, with the
    local Fourier unit on: the blocks that hold a SpectralTransform on the
    tuple path (32px: blocks 1 and 2), every block on the packed path
    (128px), there with ``use_bias``."""
    from fastfourierconvolution_tpu_torch.models.ffc_gan import PACKED_MIN_RES, PRESETS

    preset = PRESETS[resolution]
    packed = resolution >= PACKED_MIN_RES
    in_ch, in_ratio, size, blocks = preset["ngf"] * 8, 0.0, preset["mg"], []
    for i, mult in enumerate(preset["channel_mults"]):
        out_ch = preset["ngf"] * mult
        if packed or in_ratio > 0:
            blocks.append((f"{resolution}px block{i}", dict(
                in_channels=in_ch, out_channels=out_ch, kernel_size=4, ratio_gin=in_ratio,
                ratio_gout=preset["ratio_g"], stride=2, padding=1, norm="batch",
                activation="gelu", upsampling=True, packed=packed, use_bias=packed,
                enable_lfu=True), size))
        in_ch, in_ratio, size = out_ch, preset["ratio_g"], size * 2
    return blocks


def block_maps(kw, size, batch):
    """(FourierUnit map, LFU map) of a block's SpectralTransform, or ()."""
    in_cg = int(kw["in_channels"] * kw["ratio_gin"])
    half = int(kw["out_channels"] * kw["ratio_gout"]) // 2
    if in_cg == 0 or half == 0:
        return ()
    return (batch, half, 2 * size, 2 * size), (batch, half, size, size)


def make_block(kw, device, dtype=None):
    """The block with seeded weights (its conv biases N(0, 0.1), not zero,
    so that they count)."""
    import torch

    from fastfourierconvolution_tpu_torch.nn.ffc import FFC_BN_ACT
    from fastfourierconvolution_tpu_torch.nn.layers import reset_parameters

    block = FFC_BN_ACT(**kw)
    reset_parameters(block, torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("bias") and name.startswith("ffc.conv"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return block.to(device)


def block_pass(block, kw, x, w=None):
    """The block on x (B, C, S, S) split as its input wants; with a weight
    map ``w``, a training pass: (output, gradients of sum(out * w) in x and
    every parameter); without, an eval forward: (output, None)."""
    import torch

    from fastfourierconvolution_tpu_torch.nn.ffc import Packed, resize_output

    cin = kw["in_channels"]
    cl = cin - int(cin * kw["ratio_gin"])
    run = lambda v: resize_output(block(Packed(v, cl) if kw["packed"] else
                                        (v[:, :cl], v[:, cl:] if cl < cin else None)))
    if w is None:
        block.eval()
        with torch.no_grad():
            return run(x), None
    block.train()
    x = x.detach().requires_grad_(True)
    out = run(x)
    grads = torch.autograd.grad((out.float() * w).sum(), [x] + list(block.parameters()))
    return out.detach(), grads


def plain_ops():
    """The FourierUnit and fused BN + GELU kernel wrappers replaced by their
    plain versions (phases 7, 11, 13, 14, 16 and 24)."""
    from fastfourierconvolution_tpu_torch.ops import bn_act as ba
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

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


# Phase 24: the f32 comparison's batch by generator (the 128px blocks at
# phase 11's batch).
BLOCK_F32_BATCH = {32: BATCH, 128: 8}
# The conv biases of a block whose BN normalises in training: their
# gradient is 0 up to rounding (BN subtracts them again).
BLOCK_FREE = re.compile(r"ffc\.conv(l2l|l2g|g2l)\.bias")


def check_lfu_blocks(device, card):
    """Phase 24, the blocks: each block of ``lfu_blocks`` (32 and 128 px) in
    bf16 at batch 64, a training pass (forward and backward) and an eval
    forward with exact launches per map, their outputs against the same
    passes with the plain ops at phase 5's bf16 bar (the plain ops round
    every stage to bf16 where the kernels keep f32), timed with the
    kernels and with the plain ops; then in f32 (TF32 off, deterministic algorithms; the
    128px blocks with the tanh GELU forced, so their fused BN + GELU op runs
    there too) against the same block with the plain ops: the outputs of
    both passes and every gradient at phase 5's bar (the f64 plain
    versions' bar). Returns the bf16 runs' launches by map."""
    import torch

    from fastfourierconvolution_tpu_torch.nn import layers

    counts = {k: collections.Counter() for k in launch_wrappers()}
    for resolution in (32, 128):
        for name, kw, size in lfu_blocks(resolution):
            maps = block_maps(kw, size, BATCH)
            for m in maps:
                log(f"{name} map {m}: kernel_design " + ", ".join(
                    f"{w} {fu_design(w, m)}" for w in ("forward", "stats", "bwd_apply")))
            g = torch.Generator().manual_seed(SEED + 5)
            block = make_block(kw, device)
            x = torch.randn(BATCH, kw["in_channels"], size, size, generator=g).to(
                device, torch.bfloat16)
            out_shape = (BATCH, kw["out_channels"], 2 * size, 2 * size)
            w = torch.randn(out_shape, generator=g).to(device)
            start = {k: v.clone() for k, v in block.state_dict().items()}
            zero_counts()
            out_t, grads = block_pass(block, kw, x, w)
            out_e, _ = block_pass(block, kw, x)
            torch.cuda.synchronize()
            got = counts_by_map()
            bn = ([(out_shape, dict(bn_stats=1, bn_gelu_apply=1, bn_bwd_reduce=1, bn_bwd_dx=1))]
                  if kw["packed"] else [])
            want = launches_of([(m, 1, 1, 1) for m in maps], bn)
            if got != want:
                raise AssertionError(f"{name}: kernel launches {got}, expected {want}")
            for k, v in got.items():
                counts[k].update(v)
            finite = all(torch.isfinite(t.float()).all() for t in (out_t, out_e, *grads))
            if not finite:
                raise AssertionError(f"{name}: non-finite output or gradient in bf16")
            with plain_ops():
                block.load_state_dict(start)
                plain_t, _ = block_pass(block, kw, x, w)
                plain_e, _ = block_pass(block, kw, x)
            bf16_gap = rel_max(out_t, plain_t)[0], rel_max(out_e, plain_e)[0]
            train_ms = time_ms(lambda: block_pass(block, kw, x, w))
            eval_ms = time_ms(lambda: block_pass(block, kw, x))
            with plain_ops():
                plain_train_ms = time_ms(lambda: block_pass(block, kw, x, w))
                plain_eval_ms = time_ms(lambda: block_pass(block, kw, x))
            log(f"{name} {kw['in_channels']}->{kw['out_channels']} at {size}->{2 * size}, "
                f"{'packed, use_bias' if kw['packed'] else 'tuple'}, enable_lfu, bf16 batch "
                f"{BATCH}: training pass {train_ms:.4f} ms (plain ops {plain_train_ms:.4f}), "
                f"eval forward {eval_ms:.4f} ms (plain ops {plain_eval_ms:.4f}); outputs finite; "
                f"launches {got}; against the bf16 plain ops, rel-max training {bf16_gap[0]:.3e}, "
                f"eval {bf16_gap[1]:.3e} (tol {FU_REL_TOL['bfloat16']:g}); {card}")
            if not max(bf16_gap) <= FU_REL_TOL["bfloat16"]:
                raise AssertionError(f"{name}: bf16 outputs against the plain ops {bf16_gap}")

            # f32: the kernels against the plain ops on the same block
            batch = BLOCK_F32_BATCH[resolution]
            block32 = make_block(kw, device)
            x32 = x[:batch].float()
            w32 = w[:batch]
            names = ["x"] + [n for n, _ in block32.named_parameters()]
            layers.set_fast_gelu(True if kw["packed"] else "policy")
            torch.use_deterministic_algorithms(True)
            try:
                runs = {}
                for plain in (False, True):
                    with plain_ops() if plain else contextlib.nullcontext():
                        block32.load_state_dict(start)
                        runs[plain] = (block_pass(block32, kw, x32, w32),
                                       block_pass(block32, kw, x32)[0])
            finally:
                torch.use_deterministic_algorithms(False)
                layers.set_fast_gelu("policy")
            ((kt, kg), ke), ((pt, pg), pe) = runs[False], runs[True]
            out_gap = max(rel_max(kt, pt)[0], rel_max(ke, pe)[0])
            gaps = {n: rel_max(a, b)[0] for n, a, b in zip(names, kg, pg)
                    if not BLOCK_FREE.fullmatch(n)}
            worst = max(gaps.items(), key=lambda kv: kv[1])
            free = [a.abs().max().item() for n, a in zip(names, kg) if BLOCK_FREE.fullmatch(n)]
            log(f"  f32 batch {batch}, kernels against the plain ops: outputs (training, eval) "
                f"rel-max {out_gap:.3e}; {len(gaps)} gradients, worst rel-max {worst[1]:.3e} "
                f"({worst[0]}); tol {FU_REL_TOL['float32']:g}"
                + (f"; the BN-fed conv biases' largest gradient {max(free):.2e} (0 up to "
                   f"rounding, left out)" if free else ""))
            if not max(out_gap, worst[1]) <= FU_REL_TOL["float32"]:
                raise AssertionError(f"{name}: f32 kernels against the plain ops, outputs "
                                     f"{out_gap}, gradient {worst}")
            del block, block32
    return {k: dict(v) for k, v in counts.items()}


def fu_design(wrapper, shape):
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    return fu.kernel_design(wrapper, *shape[1:], limit)


# Phase 24. The local Fourier units' maps at batch 64: each FourierUnit's
# map at half its size with its channels (the bottleneck's first C/4
# channels with their 2x2 quarters folded into C): the 32px generator's
# two, then the 128px generator's four, of which the last two are 128px
# FourierUnit maps too (FU128_SHAPES).
LFU32_SHAPES = [(BATCH, 16, 8, 8), (BATCH, 8, 16, 16)]
LFU128_SHAPES = [(BATCH, 64, 8, 8), (BATCH, 32, 16, 16), (BATCH, 32, 32, 32),
                 (BATCH, 32, 64, 64)]
# FFCCondDCGANDiscriminator at its JAX defaults (ndf 64, so 64px images, nc
# 3, 10 classes) with spectral norm, batch 64: the FourierUnits of its
# blocks 2 and 3.
SND_FU_SHAPES = [(BATCH, 128, 8, 8), (BATCH, 256, 4, 4)]
# Wall ms a replayed step of that pair while (256,4,4)'s statistics and
# backward apply ran the per-item workspace kernels (H100 80GB HBM3, 700 W):
# printed beside the sliced design's reading.
SND_WORKSPACE_REPLAY_MS = 82.953
# The maps where the statistics and the backward apply run sliced, timed
# against the workspace kernels they replaced there: the SN cDCGAN
# discriminator's (256,4,4) (T = 2) and (128,16,16) (T = 4), on no
# preset's path.
SLICED_VS_WORKSPACE_SHAPES = [(BATCH, 256, 4, 4), (BATCH, 128, 16, 16)]
# The maps whose kernels earlier phases check.
CHECKED_MAPS = FU_SHAPES + FU128_SHAPES + D_FU_SHAPES + FU48_SHAPES + FU64_SHAPES


def check_maps(device, shapes, phase):
    """Phases 24 (the kernels at new maps): phases 3, 5 and 9's checks at
    each of ``shapes`` that no earlier phase checks, and ``fu_reduce`` at
    their partial-sum shapes that none checks. Returns (rows, calls)."""
    new = [s for s in shapes if s not in CHECKED_MAPS]
    for shape in shapes:
        log(f"{phase} map {shape}: kernel_design " + ", ".join(
            f"{w} {fu_design(w, shape)}" for w in ("forward", "stats", "bwd_apply"))
            + ("" if shape in new else " (checked in an earlier phase)"))
    if not new:
        return [], []
    rows, calls = check_fourier_unit(device, new, phase)
    train_rows, train_calls = check_train_kernels(device, new, phase)
    seen = set(reduce_cases(CHECKED_MAPS))
    rows += train_rows + check_reduce(device, [c for c in reduce_cases(new) if c not in seen],
                                      phase)
    return rows, calls + train_calls


def sliced_against_workspace(device, card):
    """Phase 24: at ``SLICED_VS_WORKSPACE_SHAPES`` in bf16, each wrapper
    that ``kernel_design`` sends to ``SLICED`` (the statistics, the
    backward sums, the backward apply) against the per-item workspace
    kernel at the same map, which the map took before: ms a call of each
    (CUDA events, with ``fu_reduce``) and the workspace's outputs against
    the sliced ones (``FU_REL_TOL``)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for shape in SLICED_VS_WORKSPACE_SHAPES:
        b, c, h, w = shape
        if fu.kernel_design("stats", c, h, w, limit) != fu.SLICED:
            raise AssertionError(f"{shape}: not the sliced design")
        x, k, scale, bias, mean, var, gy, gscale, gbias = bwd_inputs(
            shape, torch.bfloat16, device, SEED + 70)
        vectors = (scale, bias, mean, var)
        count = b * h * (w // 2 + 1)
        cases = [
            ("fu_train_stats", lambda: fu.fu_train_stats(x, k),
             lambda: fu._reduce(fu._stats_rows(x, k, fu.WORKSPACE), count).split(2 * c)),
            ("fu_bwd_stats", lambda: fu.fu_bwd_stats(x, k, *vectors, gy),
             lambda: fu._reduce(fu._bwd_stats_rows(x, k, vectors, gy, fu.WORKSPACE)).split(2 * c)),
            ("fu_bwd_apply", lambda: fu.fu_bwd_apply(x, k, *vectors, gy, gscale, gbias),
             lambda: fu._bwd_apply_item(x, k, (*vectors, gscale, gbias), gy, fu.WORKSPACE)),
        ]
        for name, sliced, workspace in cases:
            errs = [rel_max(a, r)[0] for a, r in zip(as_tuple(workspace()), as_tuple(sliced()))]
            if max(errs) > FU_REL_TOL["bfloat16"]:
                raise AssertionError(f"{name} {shape}: the workspace kernel against the sliced "
                                     f"design, rel-max {errs}")
            sliced_ms, workspace_ms = tp_ms(sliced, n=5), tp_ms(workspace, n=5)
            log(f"{name} {shape} bf16: sliced on T={slices(shape)} {sliced_ms:.4f} ms a call, "
                f"the workspace kernel {workspace_ms:.4f} ms a call (CUDA events, each with "
                f"fu_reduce), {workspace_ms / sliced_ms:.1f}x; outputs within rel-max "
                f"{max(errs):.3e} of each other; sliced faster: {sliced_ms < workspace_ms}; "
                f"{card}")


def cond_sn_d(device, card):
    """Phase 24, the spectral-normed discriminator: ``FFCCondDCGANDiscriminator
    (use_sn=True)`` at its JAX defaults against the ``train_cond`` preset's
    generator (``CondDCGANGenerator``, z 100, ngf 64; nc 3 for D's images)
    with its trainer settings (bce, Adam, D first, separate D passes), bf16
    at batch 64: 2 eager steps with exact launches per map (D's two maps: 3
    training forwards and 3 backwards a step), then ``update_steps`` (K = 4)
    replayed; losses finite, every ``u`` advanced by the eager steps and
    again by the replays. Returns the eager steps' launches by map."""
    import torch

    from fastfourierconvolution_tpu_torch import (
        CondDCGANGenerator,
        FFCCondDCGANDiscriminator,
        GANTrainer,
    )

    g = CondDCGANGenerator(nz=100, nc=3, ngf=64, num_classes=NUM_CLASSES,
                           generator=torch.Generator().manual_seed(SEED))
    d = FFCCondDCGANDiscriminator(nc=3, ndf=64, num_classes=NUM_CLASSES, use_sn=True,
                                  generator=torch.Generator().manual_seed(SEED + 1))
    trainer = GANTrainer(g, d, z_size=100, conditional=True, num_classes=NUM_CLASSES,
                         loss="bce", optimizer="adam", update_order="d_first", seed=SEED,
                         device=device, dtype="bf16")
    gen = torch.Generator().manual_seed(SEED + 30)
    labels = torch.randint(0, NUM_CLASSES, (4, BATCH), generator=gen).to(device)
    reals = torch.stack([real_batch(device, SEED + 30 + i, 64) for i in range(4)])
    u = lambda: {n: v.clone() for n, v in trainer.d.state_dict().items() if n.endswith(".u")}
    u0 = u()
    zero_counts()
    losses = [trainer.update_step(reals[i], labels[i]) for i in range(2)]
    torch.cuda.synchronize()
    counts = counts_by_map()
    want = launches_of([(s, 3, 3) for s in SND_FU_SHAPES], [], 2)
    if counts != want:
        raise AssertionError(f"SN cDCGAN D: kernel launches {counts}, expected {want}")
    u1 = u()
    losses.append(trainer.update_steps(reals, labels))  # an eager step and the capture
    n_calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        losses.append(trainer.update_steps(reals, labels))
        n_calls += 1
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / (4 * n_calls) * 1e3
    busy_ms, n_launch, top = device_breakdown(lambda: trainer.update_steps(reals, labels),
                                              iters=1, top=6)
    u2 = u()
    values = torch.cat([torch.stack([l["loss_g"], l["loss_d"]]).flatten() for l in losses])
    # a branch with one output channel has a one-element u, always +-1
    wide = [n for n in u0 if u0[n].numel() > 1]
    moved = [n for n in wide if not torch.equal(u0[n], u1[n]) and not torch.equal(u1[n], u2[n])]
    log(f"SN cDCGAN D (FFCCondDCGANDiscriminator(ndf=64, use_sn=True), {len(u0)} u vectors) "
        f"against CondDCGANGenerator(ngf=64), bf16 batch {BATCH}, bce/Adam/D first: 2 eager "
        f"steps, launches {counts}; {n_calls} calls of 4 replayed steps, {replay_ms:.3f} ms wall "
        f"a replayed step (the workspace design's (256,4,4) {SND_WORKSPACE_REPLAY_MS} ms), "
        f"profiler device {busy_ms / 4:.3f} ms a replayed step in {n_launch / 4:.0f} device "
        f"launches, idle share {1 - busy_ms / 4 / replay_ms:.3f}; losses finite "
        f"{bool(torch.isfinite(values).all())}, last "
        f"{values[-2].item():.4f} / {values[-1].item():.4f}; u advanced by the eager steps and "
        f"by the replays: {len(moved)} of the {len(wide)} with more than one element; {card}")
    for name, ms, count in top:
        log(f"  device {ms / 4:.4f} ms a replayed step in {count / 4:.0f} launches: {name[:90]}")
    if not torch.isfinite(values).all() or len(moved) != len(wide):
        raise AssertionError("SN cDCGAN D: a non-finite loss, or a u that did not advance")
    return counts


# --- phase 25: remat -------------------------------------------------------------------

REMAT_MODES = (None, "dots", "full")


def remat_launches(path):
    """Launches of one eager step of ``path`` with remat: G's differentiated
    forward runs again in the G phase's backward, so each G map takes a
    third training forward, and at 128px each packed block its fused BN +
    GELU forward kernels a third time (D, the SN ladder, holds none)."""
    fu_maps, bn_shapes = STEP_MAPS[path]
    bn = dict(BN_STEP_LAUNCHES, bn_stats=3, bn_gelu_apply=3)
    return launches_of([(s, f + 1, b) for s, f, b in fu_maps], [(s, bn) for s in bn_shapes])


def graph_pool_bytes(trainer):
    """Bytes of the segments in the captured step's private memory pool."""
    import torch

    pool = tuple(next(iter(trainer._graphs.values())).graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


def remat_runs(device, card):
    """Phase 25: fgan32 and fgan128 in bench.py's setting (batch 64, bf16,
    fused D pass) under remat none, dots and full: one eager step after a
    first, with exact launches (``remat_launches``) and its peak memory
    (``max_memory_allocated``, and above the memory held before it), the
    captured step's pool, and the replayed step's wall ms (host clock, 1 s
    of calls) and device ms (profiler); then in f32 (TF32 off,
    deterministic algorithms; 128px at batch 8 with the tanh GELU forced)
    4 replayed steps with remat against 4 without: losses and every state
    tensor, the same bits expected, within phase 12's bars. Returns the
    eager steps' launches by run."""
    import torch

    from fastfourierconvolution_tpu_torch.nn import layers

    counts_by_run, readings = {}, {}
    for path in (32, 128):
        resolution, k = RESOLUTION[path], STEPS_PER_CALL[path]
        real = real_batch(device, SEED + 2, resolution)
        reals = torch.stack([real_batch(device, SEED + 10 + i, resolution) for i in range(k)])
        for mode in REMAT_MODES:
            trainer = make_trainer(device, "bf16", path, remat=mode)
            trainer.update_step(real)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            trainer.update_step(real)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            counts = counts_by_map()
            want = remat_launches(path) if mode else expected_launches(path, 1)
            if counts != want:
                raise AssertionError(f"{path}px remat {mode}: launches {counts}, expected {want}")
            counts_by_run[f"remat-{path}px-{mode or 'none'}"] = counts
            trainer.update_steps(reals)  # an eager step and the capture
            pool = graph_pool_bytes(trainer)
            n_calls, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < 1.0:
                out = trainer.update_steps(reals)
                n_calls += 1
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / (n_calls * k) * 1e3
            if not all(torch.isfinite(v).all() for v in out.values()):
                raise AssertionError(f"{path}px remat {mode}: non-finite loss")
            dev_ms = step_events(lambda: trainer.update_steps(reals), k, 1)[0]
            readings[(path, mode)] = (peak, pool, wall_ms, dev_ms)
            base = readings[(path, None)]
            log(f"remat {mode or 'none'}, fgan{path} (batch {BATCH}, bf16, fused D pass): eager "
                f"step peak {peak / 1e9:.3f} GB ({(peak - resident) / 1e9:.3f} GB above the "
                f"{resident / 1e9:.3f} GB held before it; {peak / base[0]:.3f}x no remat's), "
                f"graph pool {pool / 1e9:.3f} GB ({pool / base[1]:.3f}x); replayed step "
                f"{wall_ms:.3f} ms wall ({n_calls} calls of {k}), {dev_ms:.3f} ms device "
                f"(profiler; {dev_ms / base[3]:.3f}x); launches per eager step {counts}; {card}")
            del trainer
            gc.collect()  # the captured graph and the trainer hold each other
            torch.cuda.empty_cache()

    torch.use_deterministic_algorithms(True)
    try:
        for path, batch in ((32, BATCH), (128, 8)):
            layers.set_fast_gelu(True if path >= 128 else "policy")
            reals = torch.stack([real_batch(device, SEED + 40 + i, RESOLUTION[path], batch)
                                 for i in range(PARITY_STEPS)])
            ref = make_trainer(device, "f32", path)
            ref_out = ref.update_steps(reals)
            want = trainer_state(ref)
            for mode in REMAT_MODES[1:]:
                ours = make_trainer(device, "f32", path, remat=mode)
                out = ours.update_steps(reals)
                torch.cuda.synchronize()
                got = trainer_state(ours)
                loss_gap = max((out[k] - ref_out[k]).abs().max().item() for k in out)
                differ = sorted(n for n in want if not torch.equal(got[n], want[n]))
                gaps = {n: (got[n].double() - want[n].double()).abs().max().item()
                        / max(want[n].double().abs().max().item(), 1e-30)
                        for n in differ if not n.endswith("generator")}
                worst = max(gaps.items(), key=lambda kv: kv[1], default=("", 0.0))
                log(f"remat {mode}, fgan{path} f32 batch {batch}: {PARITY_STEPS} replayed steps "
                    f"against {PARITY_STEPS} replayed steps without remat: losses max |diff| "
                    f"{loss_gap:.3e} (tol {STEP_LOSS_TOL:g}); {len(want)} state tensors, the "
                    f"same bits in {len(want) - len(differ)}; largest rel-max gap "
                    f"{worst[1]:.3e} {worst[0]} (tol {STEP_GRAD_TOL[32]:g})")
                if (loss_gap > STEP_LOSS_TOL or worst[1] > STEP_GRAD_TOL[32]
                        or any(n.endswith("generator") for n in differ)):
                    raise AssertionError(f"remat {mode}, fgan{path}: f32 replays differ from "
                                         f"no remat's: {differ[:8]}")
                del ours
            del ref
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        layers.set_fast_gelu("policy")
    return counts_by_run


# --- phases 27-28: the metric pipeline and the CLI's in-loop eval -----------------------

# The extractor and the pipeline on the card against the same module on the
# CPU, both f32 with TF32 off (``eval.pipeline``): every tap within
# EVAL_TAP_TOL of its largest value (rel-max), every metric within
# EVAL_METRIC_TOL of the CPU's relative to it (a standard deviation over
# splits or subsets relative to its mean), on EVAL_IMAGES images a set.
EVAL_TAP_TOL = 1e-3
EVAL_METRIC_TOL = 1e-3
EVAL_IMAGES = 64
# The fgan32 preset's eval (utils/config.py): 10,000 samples, batches of
# min(64, 128), so this many generate requests an epoch; its 5,000-step
# epochs, of which the eval epoch's share is printed.
EVAL_SAMPLES = 10_000
EVAL_REQUESTS = -(-EVAL_SAMPLES // BATCH)
PRESET_EPOCH_STEPS = 5000
EVAL_KEYS = {"isc": ("inception_score_mean", "inception_score_std"),
             "fid": ("frechet_inception_distance",),
             "kid": ("kernel_inception_distance_mean", "kernel_inception_distance_std")}


def seeded_inception_state(seed=SEED):
    """A torch-fidelity-layout InceptionV3 state dict: He-normal convolutions
    (std sqrt(2 / fan_in), so that the deep taps keep images apart), BN
    statistics and affine terms near identity, fc 1 / sqrt(2048)."""
    import numpy as np
    import torch

    from fastfourierconvolution_tpu_torch.eval.inception import FEATURE_NAMES, InceptionV3

    rng = np.random.default_rng(seed)
    state = {}
    for name, t in InceptionV3(FEATURE_NAMES).state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("conv.weight"):
            v = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif name.endswith(("bn.weight", "running_var")):
            v = rng.uniform(0.8, 1.2, shape)
        elif name.endswith(("bn.bias", "running_mean")):
            v = rng.normal(0, 0.1, shape)
        elif name == "fc.weight":
            v = rng.normal(0, 1 / np.sqrt(2048), shape)
        else:
            v = rng.normal(0, 0.1, shape)
        state[name] = torch.from_numpy(v.astype(np.float32))
    return state


def eval_sets(seed, n=EVAL_IMAGES):
    """Two seeded uint8 (n, 32, 32, 3) sets: shapes images and noise."""
    from fastfourierconvolution_tpu_torch.data.datasets import ShapesDataset, SyntheticDataset

    return (ShapesDataset(n=n, size=32, seed=seed).images,
            SyntheticDataset(n=n, size=32, seed=seed + 1).images)


def check_extractor(device, card, tmp):
    """Phase 27: the InceptionV3 with a seeded torch-fidelity-layout state
    dict on the card against the same module on the CPU, every tap on 64
    uint8 images; its ms per image at batch 64 and 128 (deep taps, the cost
    of a user with real weights); then ``calculate_metrics`` ISC, FID and
    KID, weights-free and with the seeded weights file, on the card against
    the CPU on the same two sets."""
    import numpy as np
    import torch

    from fastfourierconvolution_tpu_torch.eval import inception as ti
    from fastfourierconvolution_tpu_torch.eval import pipeline as P

    if ti.weights_available():
        raise AssertionError(f"an InceptionV3 file is in reach ({ti.find_local_weights()}): "
                             f"the weights-free readings would not be weights-free")
    state = seeded_inception_state()
    path = os.path.join(tmp, "inception_seeded.pth")
    torch.save(state, path)
    cpu = ti.load_torch_weights(ti.InceptionV3(ti.FEATURE_NAMES), state).eval()
    card_net = ti.create_extractor(ti.FEATURE_NAMES, weights_path=path, device=device)
    shapes, noise = eval_sets(SEED + 70)
    x = torch.from_numpy(shapes)
    with torch.inference_mode(), P._full_f32():
        ref = cpu(x)
        out = card_net(x.to(device))
        torch.cuda.synchronize()
        gaps = {k: rel_max(out[k].cpu(), ref[k])[0] for k in ti.FEATURE_NAMES}
        f = ref["2048"]
        apart = ((f[:, None] - f[None]).abs().amax(-1).sum() / (len(f) * (len(f) - 1))
                 / f.abs().max()).item()
        xs = torch.from_numpy(np.concatenate([shapes, noise])).to(device)
        per_image = {b: time_ms(lambda b=b: card_net(xs[:b])) / b for b in (64, 128)}
    by_tap = {k: f"{v:.2e}" for k, v in gaps.items()}
    log(f"InceptionV3, seeded torch-fidelity weights, f32 (TF32 off), {EVAL_IMAGES} uint8 "
        f"32x32 images: card against CPU rel-max by tap {by_tap} (tol {EVAL_TAP_TOL:g}); '2048' features of two images differ by {apart:.3f} of the "
        f"largest on average; {card}")
    gflop = extractor_gflop(card_net, xs[:8])
    rate = {b: gflop / per_image[b] for b in per_image}  # GFLOP/ms is TFLOP/s
    log(f"InceptionV3 extraction, all six taps (the full net, deep taps), f32 (TF32 off): "
        f"{per_image[64]:.4f} ms per image at batch 64, {per_image[128]:.4f} at batch 128 "
        f"(CUDA events); {gflop:.3f} GFLOP an image (flop_counter): {rate[64]:.1f} and "
        f"{rate[128]:.1f} TFLOP/s, {rate[64] * 1e12 / PEAK_FLOP_PER_S['float32']:.3f} and "
        f"{rate[128] * 1e12 / PEAK_FLOP_PER_S['float32']:.3f} of the f32 peak; {card}")
    if max(gaps.values()) > EVAL_TAP_TOL or not apart > 100 * EVAL_TAP_TOL:
        raise AssertionError(f"extractor on the card: taps {gaps}, images apart {apart}")

    kw = dict(isc=True, fid=True, kid=True, isc_splits=4, kid_subsets=20, kid_subset_size=32,
              batch_size=EVAL_IMAGES, cache=False)
    for label, weights in (("weights-free", None), ("seeded weights", path)):
        t0 = time.perf_counter()
        on_card = P.calculate_metrics(shapes, noise, feature_extractor_weights_path=weights,
                                      device=device, **kw)
        card_s = time.perf_counter() - t0
        on_cpu = P.calculate_metrics(shapes, noise, feature_extractor_weights_path=weights,
                                     device="cpu", **kw)
        # a spread over splits or subsets is held relative to its mean
        scale = {k: abs(on_cpu[k.replace("_std", "_mean")]) for k in on_cpu}
        gaps = {k: abs(on_card[k] - v) / max(scale[k], 1e-12) for k, v in on_cpu.items()}
        log(f"calculate_metrics {label}, ISC FID KID on {EVAL_IMAGES} + {EVAL_IMAGES} images: "
            f"card {({k: f'{v:.6g}' for k, v in on_card.items()})} ({card_s:.2f} s, extractor "
            f"built in it), relative gaps to the CPU {({k: f'{v:.1e}' for k, v in gaps.items()})} "
            f"(tol {EVAL_METRIC_TOL:g}); {card}")
        if sorted(on_card) != sorted(on_cpu) or max(gaps.values()) > EVAL_METRIC_TOL:
            raise AssertionError(f"calculate_metrics {label}: card {on_card}, CPU {on_cpu}")
    del cpu, card_net
    P._EXTRACTOR_CACHE.clear()
    torch.cuda.empty_cache()


def eval_component_ms(device):
    """The eval epoch's two parts in process, as the CLI runs them for
    fgan32: ms per ``generate(z, uint8=True)`` request at batch 64 in bf16,
    and the weights-free extractor's ms per image at batch 64 (the '192' and
    'logits_unbiased' taps) with its GFLOP an image."""
    import torch

    from fastfourierconvolution_tpu_torch.eval import pipeline as P

    trainer = cli_trainer(device, "fgan32", "bf16")
    z = torch.randn(BATCH, trainer.z_size, device=device,
                    generator=torch.Generator(device).manual_seed(SEED + 80))
    gen_ms = time_ms(lambda: trainer.generate(z, uint8=True))
    images = trainer.generate(z, uint8=True)
    extractor = P.get_feature_extractor("inception-v3-compat", ("192", "logits_unbiased"),
                                        batch_size=BATCH, device=device)
    with torch.inference_mode(), P._full_f32():
        extract_ms = time_ms(lambda: extractor.module(images)) / BATCH
    gflop = extractor_gflop(extractor.module, images[:8])
    del trainer
    P._EXTRACTOR_CACHE.clear()
    return gen_ms, extract_ms, gflop


def cli_metrics(device, card, tmp, graph_ms_32):
    """Phase 28: ``fgan32`` through the CLI with its preset's metrics on (ISC
    and FID, and beside it with KID added), weights-free, the preset's 10,000 samples,
    two epochs of one ``update_steps`` chunk, ``log.checkpoint`` and
    ``log.best_metric_checkpoints``. Fails on ``WARNING: metrics failed``, a
    missing ``metrics/*`` key or ``eval_seconds``, a ``best/`` without
    exactly one checkpoint, or launches other than the steps', the grids'
    and ``EVAL_REQUESTS`` eval-mode forwards per map an epoch. Prints the
    eval epochs' seconds, generate ms per request and extraction ms per
    image (in process) and the eval epoch's share of a 5,000-step epoch at
    phase 6's replayed step. Returns the runs' launches."""
    args = ["train", "--preset", "fgan32", "--set", f"train.num_epoch_steps={CLI_K}",
            "--set", "log.checkpoint=true", "--set", "log.best_metric_checkpoints=true",
            "-e", str(2 * CLI_K)]
    runs = (("isc-fid", []), ("isc-fid-kid", ["--set", "eval.kid=true"]))
    jobs = []
    # side by side, each with a feature cache of its own
    for name, extra in runs:
        env = dict(os.environ, FFC_TPU_HOME=os.path.join(tmp, f"ffc_home_{name}"))
        env.pop("FFC_TPU_INCEPTION_WEIGHTS", None)
        jobs.append(cli_start(f"fgan32-{name}", args + extra, os.path.join(tmp, f"metrics-{name}"),
                              timeout=900, metrics=True, env=env))
    counts_by_run, seconds = {}, {}
    for (name, _), job in zip(runs, jobs):
        out = os.path.join(tmp, f"metrics-{name}")
        stdout, counts = cli_wait(job)
        if "WARNING: metrics failed" in stdout:
            raise AssertionError(f"cli fgan32 {name}: {stdout[-3000:]}")
        with open(os.path.join(out, "scalars.jsonl")) as f:
            evals = [r for r in map(json.loads, f) if "eval_seconds" in r]
        want = {f"metrics/{k}" for m in name.split("-") for k in EVAL_KEYS[m]}
        missing = [sorted(want - set(r)) for r in evals]
        best = os.listdir(os.path.join(out, "checkpoints", "best"))
        launches = cli_train_launches(32, FU_SHAPES, grids=2 + 2 * EVAL_REQUESTS)
        if [r["step"] for r in evals] != [CLI_K, 2 * CLI_K] or any(missing) or len(best) != 1:
            raise AssertionError(f"cli fgan32 {name}: evals at {[r['step'] for r in evals]}, "
                                 f"missing {missing}, best/ {best}")
        if counts != launches:
            raise AssertionError(f"cli fgan32 {name} launches {counts}, want {launches}")
        seconds[name] = [r["eval_seconds"] for r in evals]
        counts_by_run[f"eval-fgan32-{name}"] = counts
        log(f"cli fgan32 {name}: 2 eval epochs of {EVAL_SAMPLES} samples, "
            f"{({k: f'{v:.5g}' for k, v in evals[-1].items() if k.startswith('metrics/')})}, "
            f"eval_seconds {[round(v, 3) for v in seconds[name]]}, best/ {best}; "
            f"fourier_unit_fwd launches per 32px map {EVAL_REQUESTS} an eval epoch (2 grids "
            f"and the eager step and capture's beside them): "
            f"{({m: n for m, n in counts['fourier_unit_fwd'].items()})}; {card}")
    gen_ms, extract_ms, gflop = eval_component_ms(device)
    steady = seconds["isc-fid"][1]
    epoch_s = PRESET_EPOCH_STEPS * graph_ms_32 / 1e3
    log(f"fgan32 eval epoch (ISC and FID, weights-free, {EVAL_SAMPLES} samples): "
        f"{seconds['isc-fid'][0]:.3f} s with the real set's {EVAL_SAMPLES} (shapes: 8192) "
        f"extracted, {steady:.3f} s from its cache (with KID: {seconds['isc-fid-kid'][1]:.3f} s); "
        f"generate {gen_ms:.3f} ms per request of {BATCH} (bf16, CUDA events, in process), "
        f"extraction {extract_ms:.4f} ms per image (weights-free taps, batch {BATCH}; "
        f"{gflop:.3f} GFLOP an image, {gflop / extract_ms:.1f} TFLOP/s, "
        f"{gflop / extract_ms * 1e12 / PEAK_FLOP_PER_S['float32']:.3f} of the f32 peak); "
        f"{EVAL_REQUESTS} requests and {EVAL_SAMPLES} images make "
        f"{(EVAL_REQUESTS * gen_ms + EVAL_SAMPLES * extract_ms) / 1e3:.3f} s; share of a "
        f"{PRESET_EPOCH_STEPS}-step epoch at phase 6's replayed {graph_ms_32:.3f} ms a step "
        f"({epoch_s:.2f} s): {steady / (steady + epoch_s):.4f}; {card}")
    return counts_by_run


# --- phase 29: the serving export -------------------------------------------------------

# The batches the artifacts serve: the trace's example batch is 2.
SERVE_BATCHES = (1, BATCH, 157)
# Requests per timing window of the artifact and of the in-process generate.
SERVE_TIMED = 50
# Calls of the in-process f32 generate held against its first, under each
# of cuDNN's algorithm settings (the witness for the f32 artifact's).
SERVE_REPEATS = 8
# fidelity on a generative input against the shapes set: samples per input
# (batches of 64, so this many generate requests), and the bar on the
# artifact's ISC and FID against the run directory's (the same generator,
# kernels and latents).
FIDELITY_SAMPLES = 1024
FIDELITY_REQUESTS = -(-FIDELITY_SAMPLES // BATCH)
FIDELITY_TOL = 1e-3
FIDELITY_FLAGS = ("-i", "-f", "-j", "--silent", "--device", "cuda",
                  "--input1-model-num-samples", str(FIDELITY_SAMPLES),
                  "--input2-model-num-samples", str(FIDELITY_SAMPLES))
# A child process that loads the serving artifacts with the port's
# ``serving`` alone (JAX absent from sys.modules), TF32 off as in this
# process and cuDNN's deterministic algorithms where the spec asks (the f32
# artifact: under the default algorithms two of its calls at batch 64
# parted in the last bits, H100 80GB HBM3, 700 W), and serves each spec'd
# request twice: the first call's images and launches by FourierUnit wrapper
# and map, whether the second gave the same bits, and the ms per request of
# the batch-64 request over SERVE_TIMED back-to-back calls (host clock,
# synchronised at the end), saved to the second argument's file.
SERVE_CHILD = (
    "import sys, time\n"
    "import torch\n"
    "from fastfourierconvolution_tpu_torch import serving\n"
    "from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu\n"
    "jax = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "             or m.split('.')[0] == 'fastfourierconvolution_tpu')\n"
    "assert not jax, jax\n"
    "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False\n"
    "spec = torch.load(sys.argv[1])\n"
    "wrappers = {n: f for n, f in vars(fu).items() if hasattr(f, 'launches_by_map')}\n"
    "results = {}\n"
    "for name, path in spec['artifacts'].items():\n"
    "    torch.backends.cudnn.deterministic = spec['deterministic'][name]\n"
    "    t0 = time.perf_counter()\n"
    "    call, meta = serving.load_exported(path, 'cuda')\n"
    "    load_s = time.perf_counter() - t0\n"
    "    runs = []\n"
    "    for z, y in spec['inputs'][name]:\n"
    "        z, y = z.cuda(), None if y is None else y.cuda()\n"
    "        for f in wrappers.values():\n"
    "            f.launches_by_map.clear()\n"
    "        first = call(z, y)\n"
    "        torch.cuda.synchronize()\n"
    "        launches = {n: {tuple(m): k for m, k in f.launches_by_map.items()}\n"
    "                    for n, f in wrappers.items() if f.launches_by_map}\n"
    "        same = torch.equal(first, call(z, y))\n"
    "        runs.append({'images': first.cpu(), 'same_bits': same, 'launches': launches})\n"
    "    z, y = spec['inputs'][name][1]\n"
    "    z, y = z.cuda(), None if y is None else y.cuda()\n"
    "    for _ in range(3):\n"
    "        call(z, y)\n"
    "    torch.cuda.synchronize()\n"
    "    t0 = time.perf_counter()\n"
    "    for _ in range(spec['timed']):\n"
    "        call(z, y)\n"
    "    torch.cuda.synchronize()\n"
    "    ms = (time.perf_counter() - t0) / spec['timed'] * 1e3\n"
    "    results[name] = {'runs': runs, 'ms': ms, 'load_s': load_s, 'meta': meta}\n"
    "torch.save(results, sys.argv[2])\n"
)


def request_ms(fn, n=SERVE_TIMED):
    """Host-clock ms per call of ``fn`` over ``n`` back-to-back calls after 3
    warm-up calls, synchronised at the end."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def serving_cases(device):
    """{name: (server, FourierUnit maps at batch 64)}: the 32px generator in
    bf16 and in f32, fgan128's packed generator and fgan_cond32's
    conditional one in bf16, each seeded, its running statistics calibrated
    on a seeded batch as in phase 4."""
    import torch

    from fastfourierconvolution_tpu_torch import Generator, build_generator, make_config

    g = torch.Generator().manual_seed(SEED + 40)
    cases = {}
    for name, preset, maps, classes in (("fgan32", "fgan32", FU_SHAPES, 0),
                                        ("fgan128", "fgan128", FU128_SHAPES, 0),
                                        ("cond32", "fgan_cond32", FU_SHAPES, NUM_CLASSES)):
        torch.manual_seed(SEED + 41)
        cfg = make_config(preset)
        server = Generator(build_generator(cfg), device=device, dtype="bf16")
        if server.num_classes != classes:
            raise AssertionError(f"{name}: the server reads {server.num_classes} classes")
        z = torch.randn(BATCH, cfg.model.z_size, generator=g).to(device)
        labels = torch.arange(BATCH, device=device) % classes if classes else None
        calibrate_running_stats(server.model, z, labels)
        cases[f"{name}-bf16"] = (server, maps)
    f32 = Generator(cases["fgan32-bf16"][0].model, device=device, dtype="f32")
    cases["fgan32-f32"] = (f32, FU_SHAPES)
    return cases


def eval_fu_host_us(device, card):
    """Host µs per ``fourier_unit_eval`` call under no_grad at the 32px maps
    in bf16: through the registered op, and as before it (the autograd
    Function calling the kernel wrapper, the op patched out), in alternating
    windows; the wrapper alone beside them."""
    import statistics

    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    for shape in FU_SHAPES:
        args = fu_inputs(shape, torch.bfloat16, device, SEED + 42)
        us = {"op": [], "before": []}
        with torch.no_grad():
            for i in range(4):
                for name in (("op", "before") if i % 2 == 0 else ("before", "op")):
                    with (mock.patch.object(fu, "fourier_unit_op", fu.fourier_unit_forward)
                          if name == "before" else contextlib.nullcontext()):
                        us[name].append(host_us(lambda: fu.fourier_unit_eval(*args)))
            wrapper = host_us(lambda: fu.fourier_unit_forward(*args))
        log(f"fourier_unit_eval {shape} bf16, host µs per call (no_grad, {card}): through "
            f"the registered op {[round(v, 2) for v in us['op']]} (median "
            f"{statistics.median(us['op']):.2f}), before it (the autograd Function on the "
            f"wrapper) {[round(v, 2) for v in us['before']]} (median "
            f"{statistics.median(us['before']):.2f}); the wrapper alone {wrapper:.2f}")
    zero_counts()


def serve_artifacts(device, card, tmp):
    """Phase 29: the four serving artifacts (``serving_cases``) exported on
    the card (the traces launching no kernel), served in a JAX-free child
    process at ``SERVE_BATCHES``: the in-process ``generate``'s images
    within ``U8_MAX_LEVELS`` / ``U8_MEAN_LEVELS`` of the dtype, the same
    bits on a second call, exactly one forward (its three stages where the
    map is staged) per FourierUnit map and request; ms per batch-64
    request, in the child and, beside the in-process ``generate``'s, in
    this process. Returns the artifacts' launches by kernel and map."""
    import statistics

    import torch

    from fastfourierconvolution_tpu_torch import serving

    names = {w.__name__: k for k, w in launch_wrappers().items()}
    cases = serving_cases(device)
    g = torch.Generator().manual_seed(SEED + 43)
    spec = {"artifacts": {}, "inputs": {}, "timed": SERVE_TIMED, "deterministic": {}}
    expected, gen_ms = {}, {}
    for name, (server, maps) in cases.items():
        zero_counts()
        t0 = time.perf_counter()
        blob = serving.export_generator(server.sampler(), z_size=server.model.z_size,
                                        num_classes=server.num_classes,
                                        image_size=server.model.resolution)
        export_s = time.perf_counter() - t0
        traced = {k: v for k, v in counts_by_map().items() if v}
        if traced:
            raise AssertionError(f"{name}: the export launched kernels {traced}")
        path = os.path.join(tmp, f"{name}.ffcx")
        serving.save_exported(path, blob)
        spec["artifacts"][name] = path
        spec["deterministic"][name] = server.dtype == torch.float32
        inputs = []
        for b in SERVE_BATCHES:
            z = torch.randn(b, server.model.z_size, generator=g)
            y = (torch.randint(0, server.num_classes, (b,), generator=g)
                 if server.num_classes else None)
            inputs.append((z, y))
        spec["inputs"][name] = inputs
        expected[name] = [server.generate(z.to(device), y).cpu() for z, y in inputs]
        if spec["deterministic"][name]:
            z = inputs[1][0].to(device)
            parted, setting = {}, torch.backends.cudnn.deterministic
            for algorithms in ("default", "deterministic"):
                torch.backends.cudnn.deterministic = algorithms == "deterministic"
                first = server.generate(z)
                parted[algorithms] = sum(not torch.equal(first, server.generate(z))
                                         for _ in range(SERVE_REPEATS))
            torch.backends.cudnn.deterministic = setting
            log(f"{name}: the in-process generate at batch {BATCH}, {SERVE_REPEATS} calls "
                f"against the first, other bits under cuDNN's default algorithms "
                f"{parted['default']}, under its deterministic ones {parted['deterministic']}")
        log(f"{name}: exported in {export_s:.2f} s on the card, {len(blob)} bytes, no launch "
            f"while tracing")
    # the artifact and the in-process generate in this process, in
    # alternating windows: host-clock readings of two processes are far apart
    for name, (server, _) in cases.items():
        call, _ = serving.load_exported(spec["artifacts"][name], "cuda")
        z, y = (t if t is None else t.to(device) for t in spec["inputs"][name][1])
        gen_ms[name] = {"artifact": [], "generate": []}
        for i in range(4):
            for side in (("artifact", "generate") if i % 2 == 0 else ("generate", "artifact")):
                fn = (lambda: call(z, y)) if side == "artifact" else (
                    lambda: server.generate(z, y))
                gen_ms[name][side].append(request_ms(fn))
        del call
    zero_counts()
    spec_path, out_path = os.path.join(tmp, "serve_spec.pt"), os.path.join(tmp, "served.pt")
    torch.save(spec, spec_path)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, spec_path, out_path], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        raise AssertionError(f"the serving child exited {proc.returncode}")
    served = torch.load(out_path)
    log(f"served {len(served)} artifacts in a child process (torch, numpy and the port's "
        f"serving; no JAX module) in {time.perf_counter() - t0:.1f} s")
    totals = collections.defaultdict(collections.Counter)
    for name, (server, maps) in cases.items():
        dtype = str(server.dtype).split(".")[-1]
        result, res = served[name], server.model.resolution
        for (z, _), want, run in zip(spec["inputs"][name], expected[name], result["runs"]):
            b = z.shape[0]
            images = run["images"]
            if images.shape != (b, res, res, 3) or images.dtype != torch.uint8:
                raise AssertionError(f"{name} batch {b}: {tuple(images.shape)} {images.dtype}")
            diff = (images.int() - want.int()).abs().float()
            launches = {names[w]: m for w, m in run["launches"].items()}
            per_request = {k: v for k, v in eval_launches(maps, 1).items() if v}
            log(f"{name} artifact, batch {b}: against the in-process generate max "
                f"{int(diff.max())} levels, mean {diff.mean().item():.4f} (bars "
                f"{U8_MAX_LEVELS[dtype]}, {U8_MEAN_LEVELS[dtype]}); second call the same bits "
                f"{run['same_bits']} (cuDNN deterministic {spec['deterministic'][name]}); "
                f"launches {launches}")
            if diff.max() > U8_MAX_LEVELS[dtype] or diff.mean() > U8_MEAN_LEVELS[dtype]:
                raise AssertionError(f"{name} batch {b}: the artifact's images differ from "
                                     f"generate")
            if not run["same_bits"]:
                raise AssertionError(f"{name} batch {b}: two calls gave different bits")
            if launches != per_request:
                raise AssertionError(f"{name} batch {b}: launches {launches}, want "
                                     f"{per_request} (one forward per map and request)")
            for k, by_map in launches.items():
                totals[k].update(by_map)
        spread = result["runs"][1]["images"].float().std().item()
        ms = {k: [round(v, 3) for v in vs] for k, vs in gen_ms[name].items()}
        log(f"{name} artifact: batch-{BATCH} request {result['ms']:.3f} ms wall (host clock, "
            f"{SERVE_TIMED} requests, the child process; loaded in {result['load_s']:.2f} s); "
            f"in this process, alternating windows of {SERVE_TIMED}: the artifact {ms['artifact']}"
            f" (median {statistics.median(gen_ms[name]['artifact']):.3f}), the in-process "
            f"generate {ms['generate']} (median {statistics.median(gen_ms[name]['generate']):.3f})"
            f"; image std {spread:.1f} levels; {card}")
    eval_fu_host_us(device, card)
    return {k: dict(v) for k, v in totals.items()}


def reference_layout_state(model, seed=SEED + 44):
    """A seeded state dict in the reference repo's ``FGenerator`` layout
    (what ``compat.convert_fgan_generator`` reads) with the shapes of the
    port's ``FFCGenerator`` ``model``: blocks i -> conv{i+2}, the to-RGB
    tail -> conv{N+2}, the FourierUnit's mix kernel as a 1x1 convolution and
    its BN as ``fu.bn``, SELayer as ``se_block.fc.{0,2}``."""
    import numpy as np
    import torch

    n = len(model.channel_mults)
    renames = [(r"^noise_to_feature\.", "noise_to_feature.0."),
               (r"^to_rgb\.", f"conv{n + 2}."),
               (r"^block(\d+)\.", lambda m: f"conv{int(m[1]) + 2}."),
               (r"^(lcl|glb)_noise(\d+)\.", lambda m: f"{m[1]}_noise{int(m[2]) + 2}."),
               (r"\.se\.fc1\.", ".se_block.fc.0."), (r"\.se\.fc2\.", ".se_block.fc.2."),
               (r"\.convg2g\.bn\.", ".convg2g.bn1."),
               (r"\.fu\.mix_kernel$", ".fu.conv_layer.weight"),
               (r"\.fu\.bn_scale$", ".fu.bn.weight"), (r"\.fu\.bn_bias$", ".fu.bn.bias"),
               (r"\.fu\.running_", ".fu.bn.running_")]
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in model.state_dict().items():
        key = name
        for pattern, repl in renames:
            key = re.sub(pattern, repl, key)
        shape = tuple(t.shape) + ((1, 1) if key.endswith("conv_layer.weight") else ())
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith(".weight") and len(shape) == 1 and "noise" not in key:
            v = 1 + rng.normal(0, 0.1, shape)
        elif len(shape) >= 2:
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape) / shape[0]), shape)
        else:
            v = rng.normal(0, 0.1, shape)
        state[key] = torch.from_numpy(v.astype(np.float32))
    return state


def reference_paths(tmp):
    """(the seeded reference-layout fgan32 ``.pth``, its artifact) in ``tmp``."""
    return os.path.join(tmp, "reference_fgan32.pth"), os.path.join(tmp, "reference_fgan32.ffcx")


def cli_serving(card, tmp, exported):
    """Phase 29 through the CLI, in child processes only (run beside phase
    26's): ``export`` from phase 21's fgan32 run directory (no launch; the
    event ``exported`` set once it is checked or failed),
    ``sample --exported`` (one forward per map), ``fidelity`` ISC and FID
    of the artifact and of the run directory (``--preset fgan32``) against
    the shapes set on the same latents, weights-free (within
    ``FIDELITY_TOL`` of each other, one forward per map and request each),
    and ``export --torch_checkpoint`` of a seeded reference-layout ``.pth``
    (its artifact checked by ``serving_reference``). Returns the runs'
    launches."""
    import torch

    from fastfourierconvolution_tpu_torch import FFCGenerator, serving

    run = os.path.join(tmp, "fgan32")
    artifact = os.path.join(run, "generator.ffcx")
    none = {k: {} for k in launch_wrappers()}
    env = dict(os.environ, FFC_TPU_HOME=os.path.join(tmp, "ffc_home_fidelity"))
    env.pop("FFC_TPU_INCEPTION_WEIGHTS", None)
    pth, ref_artifact = reference_paths(tmp)
    torch.save({"model_state_dict": reference_layout_state(FFCGenerator.for_resolution(32)),
                "optimizer_state_dict": {}}, pth)

    def fidelity(name, input1, *extra):
        # the inputs first: argparse takes no positional after the flags
        return cli_start(f"fidelity-{name}", ["fidelity", input1, "shapes-32", *extra,
                                              *FIDELITY_FLAGS, "--datasets-root", tmp],
                         tmp, env=env, common=False)

    # side by side: the commands that read no other's files, then the two
    # that read the exported artifact
    try:
        jobs = [cli_start("fgan32-export", ["export", "--preset", "fgan32"], run),
                cli_start("fgan32-export-reference",
                          ["export", "--preset", "fgan32", "--torch_checkpoint", pth,
                           "--output", ref_artifact], os.path.join(tmp, "reference")),
                fidelity("run-dir", run, "--preset", "fgan32", "--set", "train.precision=bf16",
                         "--set", "data.dataset=shapes")]
        (_, counts), (_, counts_ref_export), (stdout_run_dir, counts_run_dir) = map(cli_wait,
                                                                                  jobs)
        meta, _ = serving.read_artifact(artifact)
        if counts != none or counts_ref_export != none or meta["step"] != 144:
            raise AssertionError(f"cli fgan32 export: launches {counts}, {counts_ref_export}, "
                                 f"step {meta['step']}")
    finally:
        exported.set()
    out = os.path.join(tmp, "fgan32-served")
    jobs = [cli_start("fgan32-sample-exported",
                      ["sample", "--exported", artifact, "--num_samples", "64"], out),
            fidelity("artifact", artifact)]
    (_, counts_sample), (stdout_artifact, counts_artifact) = map(cli_wait, jobs)
    size = png_size(os.path.join(out, "samples_000144.png"))
    if counts_sample != eval_launches(FU_SHAPES, 1):
        raise AssertionError(f"cli fgan32 sample --exported launches {counts_sample}")
    log(f"cli fgan32: exported step 144 ({os.path.getsize(artifact)} bytes, no launch), "
        f"sampled the artifact ({size[0]}x{size[1]} grid, one forward per map)")

    scores, counts_fid = {}, {"artifact": counts_artifact, "run-dir": counts_run_dir}
    for name, stdout in (("artifact", stdout_artifact), ("run-dir", stdout_run_dir)):
        scores[name] = json.loads(stdout.strip().splitlines()[-1])
        if counts_fid[name] != eval_launches(FU_SHAPES, FIDELITY_REQUESTS):
            raise AssertionError(f"cli fidelity {name} launches {counts_fid[name]}")
    gaps = {k: abs(scores["artifact"][k] - v) / abs(v) for k, v in scores["run-dir"].items()}
    log(f"cli fidelity (weights-free, {FIDELITY_SAMPLES} samples against shapes-32): the "
        f"artifact {scores['artifact']}, the run directory {scores['run-dir']}; relative gaps "
        f"{({k: f'{v:.2e}' for k, v in gaps.items()})} (bar {FIDELITY_TOL}); "
        f"{FIDELITY_REQUESTS} requests each, one forward per map and request; {card}")
    if max(gaps[k] for k in ("inception_score_mean", "frechet_inception_distance")) > FIDELITY_TOL:
        raise AssertionError("fidelity: the artifact's ISC or FID is not the run directory's")
    return {"cli-fgan32-sample-exported": counts_sample,
            **{f"fidelity-{k}": v for k, v in counts_fid.items()}}


def serving_reference(device, tmp):
    """Phase 29: the artifact that ``cli_serving``'s ``export
    --torch_checkpoint`` wrote must give the converted model's ``generate``
    (within the bf16 bars, one forward per map). Returns its launches."""
    import torch

    from fastfourierconvolution_tpu_torch import FFCGenerator, Generator, compat, serving

    pth, ref_artifact = reference_paths(tmp)
    model = FFCGenerator.for_resolution(32)
    model.load_state_dict(compat.to_state_dict(model, compat.convert_fgan_generator(pth)))
    server = Generator(model, device=device, dtype="bf16")
    call, _ = serving.load_exported(ref_artifact, "cuda")
    z = torch.randn(BATCH, model.z_size,
                    generator=torch.Generator().manual_seed(SEED + 45)).to(device)
    zero_counts()
    served = call(z)
    torch.cuda.synchronize()
    counts_ref = counts_by_map()
    diff = (served.int() - server.generate(z).int()).abs().float()
    log(f"cli export --torch_checkpoint (a seeded reference-layout fgan32 .pth): the artifact "
        f"against the converted model's generate, bf16, batch {BATCH}: max "
        f"{int(diff.max())} levels, mean {diff.mean().item():.4f}; launches "
        f"{({k: v for k, v in counts_ref.items() if v})}")
    if diff.max() > U8_MAX_LEVELS["bfloat16"] or diff.mean() > U8_MEAN_LEVELS["bfloat16"]:
        raise AssertionError("the reference checkpoint's artifact differs from its generate")
    if counts_ref != eval_launches(FU_SHAPES, 1):
        raise AssertionError(f"the reference checkpoint's artifact launched {counts_ref}")
    return {"serving-reference-artifact": counts_ref}


# --- phase 30: VGG16 and LPIPS, PPL, the CLIP and DINOv2 extractors, PRC's split --------

# Card against CPU, f32 with TF32 off: each extractor's features within
# EXTRACTOR_TOL of their largest value (rel-max) on EXTRACTOR_CHECK images;
# PPL's distances on the card within PPL_LPIPS_TOL of the CPU's, each
# relative to itself, on PPL_LPIPS_PAIRS image pairs of one batch.
EXTRACTOR_TOL = 1e-3
EXTRACTOR_CHECK = 8
PPL_LPIPS_TOL = 1e-4
PPL_LPIPS_PAIRS = 16
PPL_SAMPLES = 2048
PPL_BATCHES = -(-PPL_SAMPLES // BATCH)
PRC_SAMPLES = 512
PRC_REQUESTS = -(-PRC_SAMPLES // BATCH)
# phase 30's CLI run: one epoch of one chunk, its PRC and PPL on this many
# samples, and ``fidelity -r -p`` on as many
METRIC_CLI_SAMPLES = 1024
METRIC_CLI_REQUESTS = -(-METRIC_CLI_SAMPLES // BATCH)
PRC_KEYS = ("precision", "recall", "f_score")
PPL_KEYS = ("perceptual_path_length_mean", "perceptual_path_length_std")


def seeded_extractors():
    """{name: (CPU module, the tap it returns)}: the official sizes, weights
    from seeded draws (VGG16 and LPIPS from a seeded torch generator, CLIP
    and DINOv2 from the numpy state dicts the JAX package draws)."""
    import numpy as np
    import torch

    from fastfourierconvolution_tpu_torch.eval import clip, dinov2, lpips

    g = lambda k: torch.Generator().manual_seed(SEED + k)
    return {
        "vgg16": (lpips.create_vgg16(("fc2", "fc2_relu"), generator=g(90), device="cpu"),
                  ("fc2", "fc2_relu")),
        "lpips-vgg16": (lpips.create_lpips(64, generator=g(91), device="cpu"), None),
        "clip-vit-b-32": (clip.create_clip_extractor(name="clip-vit-b-32", device="cpu",
                                                     rng=np.random.RandomState(SEED + 92)),
                          ("clip",)),
        "clip-rn50": (clip.create_clip_extractor(name="clip-rn50", device="cpu",
                                                 rng=np.random.RandomState(SEED + 93)),
                      ("clip",)),
        "dinov2-vit-s-14": (dinov2.create_dinov2_extractor(
            device="cpu", rng=np.random.RandomState(SEED + 94)), ("dinov2",)),
    }


def check_extractors(device, card):
    """Phase 30's extractors: each on the card against the CPU on
    EXTRACTOR_CHECK uint8 32x32 images (LPIPS on as many pairs), two card
    calls the same bits, ms per image at batch 64 (CUDA events) and the
    share of the f32 peak."""
    import copy

    import numpy as np
    import torch

    from fastfourierconvolution_tpu_torch.eval import pipeline as P

    shapes, noise = eval_sets(SEED + 95)
    x = torch.from_numpy(shapes[:EXTRACTOR_CHECK])
    y = torch.from_numpy(noise[:EXTRACTOR_CHECK])
    xs = torch.from_numpy(np.concatenate([shapes, noise])[:BATCH]).to(device)
    ys = torch.from_numpy(noise[:BATCH]).to(device)
    failures = []
    for name, (cpu, taps) in seeded_extractors().items():
        on_card = copy.deepcopy(cpu).to(device)
        pair = taps is None  # LPIPS takes two batches
        with torch.inference_mode(), P._full_f32():
            run = (lambda m, a, b: {"lpips": m(a, b)}) if pair else (lambda m, a, b: m(a))
            ref = run(cpu, x, y)
            out = run(on_card, x.to(device), y.to(device))
            again = run(on_card, x.to(device), y.to(device))
            torch.cuda.synchronize()
            gaps = {k: rel_max(out[k].cpu(), ref[k])[0] for k in ref}
            same = all(torch.equal(out[k], again[k]) for k in out)
            ms = time_ms(lambda: run(on_card, xs, ys)) / BATCH
        with torch.no_grad(), P._full_f32():
            gflop = (step_flops(lambda: on_card(xs[:8], ys[:8])) / 8 / 1e9 if pair
                     else extractor_gflop(on_card, xs[:8]))
        share = gflop / ms * 1e12 / PEAK_FLOP_PER_S["float32"]
        log(f"{name}, seeded weights at the official size, f32 (TF32 off), "
            f"{EXTRACTOR_CHECK} uint8 32x32 images{' (pairs)' if pair else ''}: card against "
            f"CPU rel-max {({k: f'{v:.2e}' for k, v in gaps.items()})} (tol {EXTRACTOR_TOL:g}), "
            f"two card calls the same bits: {same}; {ms:.4f} ms per image"
            f"{' pair' if pair else ''} at batch {BATCH} (CUDA events), {gflop:.3f} GFLOP "
            f"(flop_counter), {gflop / ms:.1f} TFLOP/s, {share:.3f} of the f32 peak; {card}")
        if max(gaps.values()) > EXTRACTOR_TOL or not same:
            failures.append(name)
        del on_card
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"extractors on the card: {failures}")


def fgan32_generative(device, trainer, record=None):
    """fgan32's ``generate(z, uint8=True)`` as a GenerativeModel on the card;
    ``record`` (a list) collects each request's images."""
    from fastfourierconvolution_tpu_torch.eval import GenerativeModel

    def apply(z, labels=None):
        images = trainer.generate(z, labels, uint8=True)
        if record is not None:
            record.append(images)
        return images

    return GenerativeModel(apply=apply, z_size=trainer.z_size, device=device)


def check_prc_split(device, card, trainer):
    """Phase 30's PRC under the default extractors: ISC, FID and PRC of the
    fgan32 generator against the shapes set, weights-free, on the card (the
    dual split); exact launches. Returns them."""
    import numpy as np

    from fastfourierconvolution_tpu_torch.data.datasets import ShapesDataset
    from fastfourierconvolution_tpu_torch.eval import calculate_metrics

    real = ShapesDataset(n=PRC_SAMPLES, size=32, seed=SEED + 96).images
    zero_counts()
    t0 = time.perf_counter()
    out = calculate_metrics(fgan32_generative(device, trainer), real, isc=True, fid=True,
                            prc=True, input1_model_num_samples=PRC_SAMPLES, batch_size=BATCH,
                            cache=False, device=device)
    seconds = time.perf_counter() - t0
    counts = counts_by_map()
    want = eval_launches(FU_SHAPES, 2 * PRC_REQUESTS)
    keys = ("inception_score_mean", "frechet_inception_distance") + PRC_KEYS
    log(f"calculate_metrics(isc, fid, prc) of fgan32 (bf16, weights-free extractors: "
        f"InceptionV3 for ISC and FID, VGG16 for PRC) on {PRC_SAMPLES} samples against "
        f"shapes: {({k: f'{v:.5g}' for k, v in out.items()})} in {seconds:.2f} s (host clock, "
        f"both extractors built in it); fourier_unit_fwd launches per 32px map "
        f"{({m: n for m, n in counts['fourier_unit_fwd'].items()})} ({PRC_REQUESTS} requests "
        f"in each half of the split); {card}")
    if counts != want or not all(k in out and np.isfinite(out[k]) for k in keys):
        raise AssertionError(f"PRC split: {out}, launches {counts}, want {want}")
    return counts


def check_ppl(device, card, trainer):
    """Phase 30's PPL of the fgan32 generator (bf16, batch 64, PPL_SAMPLES
    samples, weights-free LPIPS): exact launches, the same bits on a second
    call, the first batch's pairs through LPIPS on the card and on the CPU,
    and the seconds per 10,000 samples. Returns the launches."""
    import numpy as np
    import torch

    from fastfourierconvolution_tpu_torch.eval import lpips
    from fastfourierconvolution_tpu_torch.eval import pipeline as P
    from fastfourierconvolution_tpu_torch.eval.ppl import KEY_PPL_RAW, calculate_ppl

    runs, seconds, images = [], [], []
    for i in range(2):
        record = [] if i == 0 else None
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(calculate_ppl(fgan32_generative(device, trainer, record),
                                  num_samples=PPL_SAMPLES, batch_size=BATCH, reduction="none",
                                  device=device))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if i == 0:
            counts, images = counts_by_map(), record[:2]
    want = eval_launches(FU_SHAPES, 2 * PPL_BATCHES)
    same = all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    a, b = (t[:PPL_LPIPS_PAIRS] for t in images)
    with torch.inference_mode(), P._full_f32():
        on_card = lpips.create_lpips(64, device=device)(a, b).cpu().double()
        on_cpu = lpips.create_lpips(64, device="cpu")(a.cpu(), b.cpu()).double()
    gaps = (on_card - on_cpu).abs() / on_cpu.abs().clamp_min(1e-30)
    gap = gaps[on_cpu != 0].max().item() if (on_cpu != 0).any() else 0.0
    zeros_agree = torch.equal(on_card == 0, on_cpu == 0)
    raw = runs[0][KEY_PPL_RAW]
    log(f"PPL of fgan32 (bf16, batch {BATCH}, {PPL_SAMPLES} samples, epsilon 1e-4, lerp, "
        f"weights-free LPIPS at 64): mean {runs[0]['perceptual_path_length_mean']:.6g}, std "
        f"{runs[0]['perceptual_path_length_std']:.6g}, {len(raw)} distances after the 1-99 "
        f"percentile filter; a second call the same bits: {same}; {seconds[0]:.3f} s and "
        f"{seconds[1]:.3f} s (host clock, the LPIPS net built in each), "
        f"{seconds[1] * 1e4 / PPL_SAMPLES:.3f} s per 10,000 samples; fourier_unit_fwd launches "
        f"per 32px map {({m: n for m, n in counts['fourier_unit_fwd'].items()})} (two per map "
        f"and batch, {PPL_BATCHES} batches); LPIPS on the card against the CPU on "
        f"{PPL_LPIPS_PAIRS} of its image pairs: largest relative gap {gap:.2e} (tol "
        f"{PPL_LPIPS_TOL:g}), {int((on_cpu == 0).sum())} pairs at 0 on both: {zeros_agree}; "
        f"{card}")
    if counts != want or not same or gap > PPL_LPIPS_TOL or not zeros_agree:
        raise AssertionError(f"PPL: launches {counts} (want {want}), same bits {same}, "
                             f"LPIPS gap {gap}, zeros agree {zeros_agree}")
    if not all(np.isfinite(runs[0][k]).all() for k in runs[0]):
        raise AssertionError(f"PPL: {runs[0]}")
    return counts


def cli_prc_ppl(card, tmp, artifact, exported):
    """Phase 30 through the CLI, in child processes only (run beside phase
    26's): fgan32 ``train`` one chunk with ``eval.prc``
    and ``eval.ppl`` on METRIC_CLI_SAMPLES samples (weights-free), then
    ``fidelity -r -p`` against the shapes set of its run directory and,
    once the event ``exported`` is set, of ``cli_serving``'s fgan32
    ``artifact``, side by side: every metric key present and finite,
    exact launches. Returns them."""
    import numpy as np

    run = os.path.join(tmp, "fgan32-prc-ppl")
    env = dict(os.environ, FFC_TPU_HOME=os.path.join(tmp, "ffc_home_prc_ppl"))
    for name in ("FFC_TPU_INCEPTION_WEIGHTS", "FFC_TPU_VGG16_WEIGHTS", "FFC_TPU_LPIPS_WEIGHTS"):
        env.pop(name, None)
    n = str(METRIC_CLI_SAMPLES)
    stdout, counts_train = cli_run(
        "fgan32-train-prc-ppl",
        ["train", "--preset", "fgan32", "--set", f"train.num_epoch_steps={CLI_K}",
         "--set", "eval.prc=true", "--set", "eval.ppl=true",
         "--set", f"eval.num_samples_for_metrics={n}", "--checkpoint", "-e", str(CLI_K)],
        run, timeout=600, env=env)
    with open(os.path.join(run, "scalars.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval_seconds" in r]
    requests = METRIC_CLI_REQUESTS * 3  # PRC's one per batch, PPL's two
    want = cli_train_launches(32, FU_SHAPES, grids=1 + requests)
    logged = {k: evals[-1].get(f"metrics/{k}") for k in PRC_KEYS + PPL_KEYS} if evals else {}
    if ("WARNING: metrics failed" in stdout or [r["step"] for r in evals] != [CLI_K]
            or not all(v is not None and np.isfinite(v) for v in logged.values())
            or counts_train != want):
        raise AssertionError(f"cli fgan32 prc/ppl: evals {evals}, launches {counts_train}, "
                             f"want {want}; {stdout[-2000:]}")
    flags = ["-r", "-p", "-j", "--silent", "--device", "cuda", "--input1-model-num-samples", n,
             "--input2-model-num-samples", n, "--datasets-root", tmp]

    def fidelity(name, spec, *extra):
        return cli_start(f"fidelity-prc-ppl-{name}", ["fidelity", spec, "shapes-32", *flags,
                                                      *extra], tmp, env=env, common=False)

    jobs = [fidelity("run-dir", run, "--preset", "fgan32", "--set", "train.precision=bf16",
                     "--set", "data.dataset=shapes")]
    if not exported.wait(timeout=900):
        raise AssertionError("cli fgan32 prc/ppl: the fgan32 artifact was not exported")
    jobs.append(fidelity("artifact", artifact))
    scores, counts = {}, {}
    for (name, *_), job in zip((("run-dir",), ("artifact",)), jobs):
        stdout, counts[name] = cli_wait(job)
        scores[name] = json.loads(stdout.strip().splitlines()[-1])
    want_fidelity = eval_launches(FU_SHAPES, requests)
    log(f"cli fgan32 train with eval.prc and eval.ppl ({n} samples, weights-free VGG16 and "
        f"LPIPS): logged {({k: f'{v:.5g}' for k, v in logged.items()})}, eval_seconds "
        f"{evals[-1]['eval_seconds']:.3f}; fidelity -r -p ({n} samples against shapes-32) of "
        f"the run directory {scores['run-dir']} and of phase 29's artifact "
        f"{scores['artifact']}; "
        f"fourier_unit_fwd launches per 32px map {METRIC_CLI_REQUESTS} for PRC and "
        f"{2 * METRIC_CLI_REQUESTS} for PPL in each run; {card}")
    for name, got in scores.items():
        if (sorted(got) != sorted(PRC_KEYS + PPL_KEYS)
                or not all(np.isfinite(v) for v in got.values())
                or counts[name] != want_fidelity):
            raise AssertionError(f"fidelity -r -p {name}: {got}, launches {counts[name]}, "
                                 f"want {want_fidelity}")
    return {"cli-fgan32-prc-ppl": counts_train,
            **{f"fidelity-prc-ppl-{k}": v for k, v in counts.items()}}


def check_metric_extras(device, card):
    """Phase 30 in this process: the extractors, PRC's split and PPL (see the
    module docstring; its CLI runs, ``cli_prc_ppl``, run beside phase 26).
    Returns the main-path launches by run."""
    import torch

    from fastfourierconvolution_tpu_torch.eval import pipeline as P

    check_extractors(device, card)
    trainer = cli_trainer(device, "fgan32", "bf16")
    counts = {"eval-prc-split": check_prc_split(device, card, trainer),
              "eval-ppl": check_ppl(device, card, trainer)}
    del trainer
    P._EXTRACTOR_CACHE.clear()
    torch.cuda.empty_cache()
    return counts


# --- phase 0: a process's first run of a configuration ---------------------------------

# The configurations whose first run in a process differed in its last bits
# from later runs: sagan's replayed step and replayed wgan-gp on the sngan
# pair under remat "dots": (path, trainer keywords).
FIRST_RUN_CONFIGS = {"sagan": ("sagan", {}), "sngan-gp-dots": ("sngan-gp", {"remat": "dots"})}
FIRST_RUN_RUNS = 2
# (configuration, variant): "port", the trainer as it runs; "multithreaded",
# its backward on autograd's device thread, as the trainer ran it before
# ``GANTrainer._step`` moved it to the calling thread: the fault, shown again
# beside its repair.
FIRST_RUN_CASES = (("sagan", "multithreaded"), ("sagan", "port"), ("sngan-gp-dots", "port"))
FIRST_RUN_CHILD = ("import sys, chip_smoke\n"
                   "sys.exit(chip_smoke.first_run_child(sys.argv[1], sys.argv[2]))\n")
PORT_DIR = os.sep + "fastfourierconvolution_tpu_torch" + os.sep


def bits_digest(t):
    """Two int64 numbers from the bits of ``t`` on its device: the sums of
    its words and of their squares (wrapping)."""
    import torch

    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    w = t.detach().contiguous().view(-1).view(words).to(torch.int64)
    return torch.stack([w.sum(), (w * w).sum()])


def op_recorder():
    """A TorchDispatchMode that records every aten op with a CUDA output (for
    an in-place op that returns nothing, its first argument): its name, the
    outputs' shapes and dtype, the innermost frame of the port on the
    Python stack, the autograd node running it with the node's sequence
    number, whether a CUDA graph was capturing, and the outputs'
    ``bits_digest`` on the device. An op run during a capture runs at each
    replay: its digest is then the last replay's."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    current_node = getattr(torch._C, "_current_autograd_node", lambda: None)

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.digests = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            cuda = lambda tree: [t for t in tree_leaves(tree)
                                 if isinstance(t, torch.Tensor) and t.is_cuda]
            tensors = cuda(out) or (cuda(args[0]) if out is None and args else [])
            if not tensors:
                return out
            frame = sys._getframe(1)
            while frame is not None and (PORT_DIR not in frame.f_code.co_filename
                                         or frame.f_code.co_name == "__torch_dispatch__"):
                frame = frame.f_back
            site = "" if frame is None else (
                f"{os.path.relpath(frame.f_code.co_filename, ROOT)}:{frame.f_lineno} "
                f"{frame.f_code.co_name}")
            node = current_node()
            self.ops.append((str(func), [tuple(t.shape) for t in tensors][:3],
                             str(tensors[0].dtype), "" if node is None else node.name(),
                             site, -1 if node is None else node._sequence_nr(),
                             torch.cuda.is_current_stream_capturing()))
            self.digests.append(torch.stack([bits_digest(t) for t in tensors]).sum(0))
            return out

    return Recorder()


def op_line(run, k, tag="op"):
    name, shapes, dtype, node, site, seq, capturing = run["ops"][k]
    return (f"  {tag} {k}: {name} {shapes} {dtype} at {site or '?'} node {node or '-'}"
            f"{'' if seq < 0 else f' (sequence number {seq})'}"
            f"{' (capturing)' if capturing else ''}")


def align_runs(a, b, window=8, reach=64):
    """Walks two runs' ops in step (name, shapes, dtype, node). Where they
    part, skips up to ``reach`` ops of one run (ops that run only once in a
    process, such as a table built at first use) if the next ``window``
    then agree; otherwise the order of the ops differs there. Returns
    (the (i, j) pairs of aligned ops whose digests differ, the skipped ops
    as (run, index, count), the (i, j) where the order differs or None)."""
    import torch

    sig = lambda run, k: run["ops"][k][:4]
    sigs = lambda run, k: [run["ops"][m][:4] for m in range(k, min(k + window,
                                                                    len(run["ops"])))]
    i = j = 0
    differ, skipped = [], []
    while i < len(a["ops"]) and j < len(b["ops"]):
        if sig(a, i) == sig(b, j):
            if not torch.equal(a["digests"][i], b["digests"][j]):
                differ.append((i, j))
            i, j = i + 1, j + 1
            continue
        for k in range(1, reach + 1):
            if sigs(a, i + k) == sigs(b, j):
                skipped.append(("a", i, k))
                i += k
                break
            if sigs(b, j + k) == sigs(a, i):
                skipped.append(("b", j, k))
                j += k
                break
        else:
            return differ, skipped, (i, j)
    return differ, skipped, None


def first_run_child(name, variant):
    """Phase 0 in a fresh process: ``FIRST_RUN_RUNS`` runs of the
    configuration ``name`` (``FIRST_RUN_CONFIGS``), each a new f32 trainer
    from the same seeds (TF32 off, deterministic algorithms) taking
    ``update_steps`` over ``PARITY_STEPS`` batches (an eager step, the
    capture, replays) under ``op_recorder``; ``variant`` "multithreaded"
    runs the backward on autograd's device thread. Prints, for each later
    run against the first and against the one before it, the ops that
    only one run has, the first op where the order of the ops differs, the
    first op whose output bits differ (with the ops around them), and
    whether the losses and the final state are the same bits. Returns 1
    where the first run's losses or final state differ from the second's,
    else 0."""
    import torch

    path, options = FIRST_RUN_CONFIGS[name]
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    reals = torch.stack([real_batch(device, SEED + 20 + i, RESOLUTION[path])
                         for i in range(PARITY_STEPS)])
    threads = (mock.patch.object(torch.autograd, "set_multithreading_enabled",
                                 lambda mode: contextlib.nullcontext())
               if variant == "multithreaded" else contextlib.nullcontext())
    runs = []
    with threads:
        for _ in range(FIRST_RUN_RUNS):
            trainer = make_trainer(device, "f32", path, **options)
            recorder = op_recorder()
            with recorder:
                losses = trainer.update_steps(reals)
            torch.cuda.synchronize()
            runs.append({"ops": recorder.ops, "digests": torch.stack(recorder.digests).cpu(),
                         "losses": {k: v.cpu() for k, v in losses.items()},
                         "state": {k: v.detach().cpu().clone()
                                   for k, v in trainer_state(trainer).items()}})
            del trainer, recorder
            gc.collect()
            torch.cuda.empty_cache()
    first_differs = False
    pairs = [(0, k) for k in range(1, FIRST_RUN_RUNS)] + [
        (k - 1, k) for k in range(2, FIRST_RUN_RUNS)]
    for i, j in pairs:
        a, b = runs[i], runs[j]
        differ, skipped, order = align_runs(a, b)
        same_losses = all(torch.equal(a["losses"][k], b["losses"][k]) for k in a["losses"])
        state_differ = sorted(k for k in a["state"]
                              if not torch.equal(a["state"][k], b["state"][k]))
        head = f"first-run {name} ({variant}): run {i + 1} against run {j + 1}"
        print(f"{head}: {len(a['ops'])} and {len(b['ops'])} recorded ops; "
              f"{sum(k for _, _, k in skipped)} ops in one run only; the order of the ops "
              f"{'is the same' if order is None else f'differs from op {order[0]} / {order[1]}'}"
              f"; {len(differ)} aligned ops differ in their outputs' bits before that; "
              f"losses the same bits {same_losses}; final state {len(a['state'])} tensors, "
              f"{len(state_differ)} differ {state_differ[:4]}", flush=True)
        for run, k, count in skipped[:4]:
            r = a if run == "a" else b
            print(f"  only in run {i + 1 if run == 'a' else j + 1}: {count} ops from "
                  f"{op_line(r, k).strip()}", flush=True)
        if order is not None:
            for tag, run, k in (("run " + str(i + 1), a, order[0]),
                                ("run " + str(j + 1), b, order[1])):
                print(f"  order differs, {tag}:", flush=True)
                for m in range(max(0, k - 3), min(len(run["ops"]), k + 3)):
                    print(op_line(run, m, "HERE" if m == k else "op"), flush=True)
        if differ:
            k, m = differ[0]
            print(f"  first aligned op whose bits differ: {op_line(a, k).strip()}; digests "
                  f"{a['digests'][k].tolist()} / {b['digests'][m].tolist()}", flush=True)
            for n in range(max(0, k - 2), k):
                print(op_line(a, n), flush=True)
        if (i, j) == (0, 1):
            first_differs = not same_losses or bool(state_differ)
    return int(first_differs)


def backward_thread_cost(device, card, rounds=2, steps=16):
    """Phase 26: what running the backward on the calling thread costs an
    eager step: bf16 ``update_step`` wall ms per step (host clock, after a
    synchronise) of the 32px pair and the sngan pair, as the port runs it
    and with the backward on autograd's device thread (as the trainer ran
    it before), in alternating windows of ``steps`` steps."""
    import statistics

    import torch

    device_thread = lambda: mock.patch.object(torch.autograd, "set_multithreading_enabled",
                                              lambda mode: contextlib.nullcontext())
    for path in (32, "sngan"):
        trainer = make_trainer(device, "bf16", path)
        real = real_batch(device, SEED + 2, RESOLUTION[path])
        for _ in range(3):
            trainer.update_step(real)
        ms = {"calling thread": [], "device thread": []}
        for i in range(rounds):
            for name in (("calling thread", "device thread") if i % 2 == 0
                         else ("device thread", "calling thread")):
                with device_thread() if name == "device thread" else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        trainer.update_step(real)
                    torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) / steps * 1e3)
        log(f"eager {path} step, bf16, batch {BATCH}, wall ms per step in {rounds} alternating "
            f"windows of {steps} steps (host clock): backward on the calling thread "
            f"{[round(v, 3) for v in ms['calling thread']]} (median "
            f"{statistics.median(ms['calling thread']):.3f}), on autograd's device thread "
            f"{[round(v, 3) for v in ms['device thread']]} (median "
            f"{statistics.median(ms['device thread']):.3f}); {card}")
        del trainer


def first_run(card):
    """Phase 26: ``first_run_child`` for each of ``FIRST_RUN_CASES`` in a
    fresh child process, the children side by side (each compares its own
    two runs), their lines printed. Raises where the port's first run of a
    configuration differs from its second in the losses or the final
    state; the "multithreaded" case is printed as information."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", FIRST_RUN_CHILD, name, variant], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, variant in FIRST_RUN_CASES]
    try:
        for (name, variant), child in zip(FIRST_RUN_CASES, procs):
            stdout, stderr = child.communicate(timeout=600)
            for line in stdout.splitlines():
                log(line)
            if child.returncode not in (0, 1):
                log(stderr[-3000:])
                raise AssertionError(f"first-run {name} {variant}: the child exited "
                                     f"{child.returncode}")
            differs = child.returncode == 1
            log(f"first-run {name} ({variant}): the process's first run differs from its "
                f"second: {differs} ({time.perf_counter() - t0:.1f} s since the children "
                f"started side by side); {card}")
            if differs and variant == "port":
                raise AssertionError(f"first-run {name}: a process's first run differs from "
                                     f"its second")
    finally:
        for child in procs:
            if child.poll() is None:
                child.kill()
                child.communicate()


# --- phase 31: data parallelism ---------------------------------------------------

DP_WORLD = 2
# Eager bf16 steps of each path at global batch 64, 32 rows a process.
DP_STEPS = {32: 3, 128: 2}
# Two processes against one at the global batch, bf16: the losses within
# this (a hinge mean over the batch; D's convolutions at batch 32 may take
# other cuDNN algorithms than at 64, so its logits differ by bf16 ulps).
DP_LOSS_TOL = 1e-2
# The first step's averaged gradients against one process's, per
# parameter ||g2 - g1|| / ||g1||, in f32 (TF32 off), within this. The
# convolutions at batch 32 take other cuDNN algorithms than at 64, and a
# few tensors (BN and noise weights, SE gates) sum many terms that cancel:
# two processes against one read 4.6e-3 and 9.4e-3 (fgan32, two runs) and
# 3.5e-3 (fgan128), one process against itself on cuDNN's benchmarked
# algorithms up to 1.7e-3 and 4.4e-3 on the same tensors; the control
# (parameters without ``parallel.param_share``) 1.001 (H100 80GB HBM3,
# 700 W). A gradient of the wrong scale (a sum where an average belongs, a
# share not taken or taken twice) is off by 0.5 or more. In bf16 the gaps
# reach 0.36, as one process's own bf16 gradients do against its f32 ones
# on the same tensors, so there they are printed, not held. After the
# first step the states differ by Adam's steps on elements whose gradient
# lies within bf16 noise of 0 (each moves by about lr whatever its
# gradient), so the parameters after each step are printed, not held.
DP_GRAD_TOL = 5e-2
# The packed BN statistics and sums: each process's sums, gathered and
# added, against one launch's sums over the global batch, f32 in another
# order: each within BN_REL_TOL of the f64 sums (phase 8's bar), so twice
# it apart (1.34e-5 at (64,512,8,8)'s backward sums, H100 80GB HBM3, 700 W).
DP_BN_TOL = 2 * BN_REL_TOL
# The FourierUnit statistics and backward sums: every launch takes the
# design of this process's 32 rows, not of the 64; a per-item row does not
# depend on the ranks per item, but the staged kernels sum runs of tiles
# of another length, so the same f32 values are added in another order.
# Each is within the f32 kernels' bar of the f64 sums (phases 5 and 9), so
# twice it apart, rel-max to the largest value; a statistic of the local
# rows alone is off by about 1/sqrt(32 H Wf), 1.5% at (16, 16, 16).
DP_FU_TOL = 2 * FU_REL_TOL["float32"]
DP_CHILD = "import sys, chip_smoke\nsys.exit(chip_smoke.dp_child(sys.argv[1]))\n"
DP_TIMEOUT = 300
# cli train as two processes (phase 31e): steps, epoch, and the resume.
DP_CLI_STEPS, DP_CLI_EPOCH, DP_CLI_RESUME = 4, 2, 6


def dp_expected_launches(path, n_steps, world):
    """One process's launches over ``n_steps`` steps of a group of
    ``world`` at global batch ``BATCH``: one process's at the global batch
    (the FourierUnit maps' keys are the same), but ``fu_reduce`` runs on
    the partial rows of this process's design (a row per item, or per run
    of tiles of its ``staged_chunks``): the statistics and backward sums
    on every process's rows gathered, gK on this process's (gK is a
    parameter's gradient, averaged with the others); plus, per packed BN
    map, the ``fu_reduce`` of the gathered sums: (world, 2C) after each
    ``bn_stats``, (world, 3C) after each ``bn_bwd_reduce`` (S1, S2, S3
    with the noise fold)."""
    want = {k: dict(v) for k, v in expected_launches(path, n_steps).items()}
    red = want.setdefault("fu_reduce", {})
    for (b, c, h, w), forwards, backwards in STEP_MAPS[path][0]:
        rows = partial_rows((b, c, h, w))
        local = partial_rows((b // world, c, h, w))
        for key, n in (((rows, 4 * c), -(forwards + backwards)),
                       ((rows, 4 * c * c), -backwards),
                       ((world * local, 4 * c), forwards + backwards),
                       ((local, 4 * c * c), backwards)):
            red[key] = red.get(key, 0) + n * n_steps
    for _, c, _, _ in STEP_MAPS[path][1]:
        for rows, per in (((world, 2 * c), BN_STEP_LAUNCHES["bn_stats"]),
                          ((world, 3 * c), BN_STEP_LAUNCHES["bn_bwd_reduce"])):
            red[rows] = red.get(rows, 0) + per * n_steps
    want["fu_reduce"] = {k: n for k, n in red.items() if n}
    return want


def partial_rows(shape):
    """The FourierUnit statistics kernels' partial rows on a (B, C, H, W)
    map: a row per item, or per run of tiles after the staged mix."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    b, _, h, w = shape
    return b * fu.staged_chunks(b, h, w) if staged("stats", shape) else b


def dp_expected_collectives(path, bn_calls):
    """A step's collectives by kind: a gather of partial rows per
    FourierUnit map and pass (statistics per forward, backward sums per
    backward) and 3 per packed BN map (the statistics of both forwards, the
    backward sums); a sum per plain BatchNorm call and per backward of one
    (``bn_calls``, counted by forward hooks); 2 averages (the G phase's and
    the D phase's loss and gradients)."""
    fu_maps, bn_maps = STEP_MAPS[path]
    want = {"gather": sum(f + b for _, f, b in fu_maps) + 3 * len(bn_maps),
            "sum": bn_calls, "average": 2}
    return {k: v for k, v in want.items() if v}


def dp_ops(device, path):
    """This process's rows of seeded global inputs through the statistics
    wrappers at ``path``'s maps (bf16): the FourierUnit's statistics and
    backward sums (per item or staged, as the design picks) and the packed
    BN's; and through the training ops (f32, the FourierUnit's ReLU kept
    clear of its kink by ``relu_margin_bias``): the outputs and the rows'
    gradients ("rows ...", each process its rows) and the parameters'
    ("sum ...", each process its share); {name: f32 tensor on the host}."""
    import torch

    from fastfourierconvolution_tpu_torch import parallel
    from fastfourierconvolution_tpu_torch.ops import bn_act as ba
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    rows = parallel.shard_full_batch
    out = {}
    fu_maps, bn_maps = STEP_MAPS[path]
    for shape, _, _ in fu_maps:
        x, kernel, scale, bias, mean, var = fu_inputs(shape, torch.bfloat16, device, SEED + 40)
        gy = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 41)).to(
            device, torch.bfloat16)
        x, gy = rows(x).contiguous(), rows(gy).contiguous()
        out[f"fu_stats {shape}"] = torch.stack(fu.fu_train_stats(x, kernel))
        out[f"fu_bwd_sums {shape}"] = torch.stack(
            fu.fu_bwd_stats(x, kernel, scale, bias, mean, var, gy))
        x, kernel, scale, bias, _, _ = fu_inputs(shape, torch.float32, device, SEED + 43)
        _, m = fu._spectrum_plain(x.double(), kernel.double())
        mean = m.mean(dim=(0, 2, 3))
        bias, _ = fu.relu_margin_bias(x, kernel, scale, bias, mean,
                                      (m * m).mean(dim=(0, 2, 3)) - mean * mean)
        del m
        gy = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 44)).to(device)
        xr = rows(x).contiguous().requires_grad_()
        params = [t.clone().requires_grad_() for t in (kernel, scale, bias)]
        y, _, _ = fu.fourier_unit_train(xr, *params)
        grads = torch.autograd.grad((y * rows(gy)).sum(), [xr, *params])
        out[f"rows fu_train y {shape}"], out[f"rows fu_train gx {shape}"] = y.detach(), grads[0]
        for name, grad in zip(("gK", "gscale", "gbias"), grads[1:]):
            out[f"sum fu_train {name} {shape}"] = grad
    for shape in bn_maps:
        (x, n_l, n_g, g), (scale, bias, _, _, _) = bn_inputs(shape, torch.bfloat16, device,
                                                             SEED + 42)
        # the backward's statistics from the whole map in f64, the same in
        # every process
        xf = x.double()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).float()
        mean = mean.float()
        x, n_l, n_g, g = (rows(t).contiguous() for t in (x, n_l, n_g, g))
        out[f"bn_stats {shape}"] = torch.stack(ba.bn_stats(x))
        out[f"bn_bwd_reduce {shape}"] = torch.stack(
            ba.bn_bwd_reduce(x, g, mean, var, scale, bias, n_l, n_g, shape[1] // 2))
        (x, n_l, n_g, g), vecs = bn_inputs(shape, torch.float32, device, SEED + 45)
        x, n_l, n_g, g = (rows(t).contiguous() for t in (x, n_l, n_g, g))
        inputs = [x, n_l, n_g, *(t.clone() for t in vecs[:3])]
        for t in inputs:
            t.requires_grad_()
        o, _, _ = ba.packed_bn_gelu_noise(inputs[0], *inputs[3:], n_l=inputs[1],
                                          n_g=inputs[2], cl=shape[1] // 2)
        grads = torch.autograd.grad((o * g).sum(), inputs)
        out[f"rows packed out {shape}"] = o.detach()
        for name, grad in zip(("dx", "dn_l", "dn_g"), grads[:3]):
            out[f"rows packed {name} {shape}"] = grad
        for name, grad in zip(("gscale", "gbias", "gw"), grads[3:]):
            out[f"sum packed {name} {shape}"] = grad
    torch.cuda.synchronize()
    return {k: v.float().cpu() for k, v in out.items()}


def dp_gather_ms(device, path, iters=20):
    """Host ms (synchronised) per all-gather of each partial-sum shape of
    ``path``'s step in this process's group: a FourierUnit map's partial
    rows (a row per item, or per run of tiles where it is staged; 4C
    columns) and a packed BN map's sums (one row of 2C and of 3C). Every
    process of the group calls it."""
    import torch

    from fastfourierconvolution_tpu_torch import parallel

    b = BATCH // parallel.process_count()
    fu_maps, bn_maps = STEP_MAPS[path]
    shapes = [(partial_rows((b, c, h, w)), 4 * c) for (_, c, h, w), _, _ in fu_maps]
    for _, c, _, _ in bn_maps:
        shapes += [(1, 2 * c), (1, 3 * c)]
    out = {}
    for shape in dict.fromkeys(shapes):
        t = torch.ones(shape, device=device)
        parallel.all_gather_rows(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            parallel.all_gather_rows(t)
        torch.cuda.synchronize()
        out[str(shape)] = (time.perf_counter() - t0) / iters * 1e3
    return out


def dp_first_grads(device, path, real, dtype):
    """The first step's G and D gradients of ``path``'s pair in ``dtype``
    (from a trainer of their own, so Adam's step does not hide their
    scale) on this process's rows ``real`` (B, H, W, C) of the first
    global batch: the G phase's, then the D update's, averaged over the
    processes in a group; {"g.<name>" or "d.<name>": f32 on the host}."""
    trainer = make_trainer(device, dtype, path)
    z = trainer._latents(real.shape[0])
    grads = {"g": trainer.g_loss_and_grads(z)[1],
             "d": trainer.d_loss_and_grads(real.permute(0, 3, 1, 2).contiguous(), z)[1]}
    # under tensor parallelism a sliced mix's gradient is gathered whole
    return {f"{side}.{n}": trainer.whole(side, n, grad).float().cpu()
            for side, model in (("g", trainer.g), ("d", trainer.d))
            for (n, _), grad in zip(model.named_parameters(), grads[side])}


def dp_grad_gaps(grads, ref):
    """{parameter: ||g - g_ref|| / ||g_ref||} of two gradient sets."""
    return {n: ((grads[n].double() - r.double()).norm() / r.double().norm().clamp_min(1e-30)).item()
            for n, r in ref.items()}


def dp_steps(device, path, n_steps, keep_states):
    """``n_steps`` eager bf16 ``update_step`` calls of ``path``'s pair
    (``make_trainer``) on this process's rows of seeded global batches of
    ``BATCH``: the first step's gradients (``dp_first_grads``, before the
    steps), the losses, per step the host ms (synchronised), the
    collectives by kind and their bytes, the plain BatchNorm calls (forward,
    and backward where the forward kept a graph), the host ms spent in
    ``torch.distributed`` calls, a digest of G's and D's state; the
    launches over the steps; with ``keep_states`` the states on the host."""
    import hashlib

    import torch
    import torch.distributed as dist

    from fastfourierconvolution_tpu_torch import parallel
    from fastfourierconvolution_tpu_torch.nn.layers import BatchNorm, ConditionalBatchNorm

    mesh = parallel.mesh
    reals = [parallel.shard_full_batch(real_batch(device, SEED + 30 + i, RESOLUTION[path]))
             for i in range(n_steps)]
    grads = {dtype: dp_first_grads(device, path, reals[0], dtype) for dtype in ("bf16", "f32")}
    if not parallel.active():  # the same gradients on cuDNN's benchmarked algorithms
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                        allow_tf32=False):
            grads["f32 benchmark"] = dp_first_grads(device, path, reals[0], "f32")
    trainer = make_trainer(device, "bf16", path)
    bn_calls, dist_s = [0], [0.0]

    def hook(module, inputs, output):
        bn_calls[0] += 1 + torch.is_grad_enabled()

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dist_s[0] += time.perf_counter() - t0
        return call

    hooks = [m.register_forward_hook(hook) for model in (trainer.g, trainer.d)
             for m in model.modules() if isinstance(m, (BatchNorm, ConditionalBatchNorm))]
    out = {k: [] for k in ("losses", "ms", "collectives", "bytes", "bn_calls", "dist_ms",
                           "digests", "states")}
    out["grads"] = grads
    zero_counts()
    with contextlib.ExitStack() as stack:
        for name in ("all_reduce", "all_gather_into_tensor", "all_gather"):
            stack.enter_context(mock.patch.object(dist, name, timed(getattr(dist, name))))
        for i in range(n_steps):
            mesh.collectives.clear()
            mesh.collective_bytes.clear()
            bn_calls[0], dist_s[0] = 0, 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = trainer.update_step(reals[i])
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append([losses["loss_g"].item(), losses["loss_d"].item()])
            out["collectives"].append(dict(mesh.collectives))
            out["bytes"].append(dict(mesh.collective_bytes))
            out["bn_calls"].append(bn_calls[0])
            out["dist_ms"].append(dist_s[0] * 1e3)
            whole = trainer.state_dict()  # sliced mixes gathered whole under tp
            state = {f"{side}.{k}": v.detach().cpu().clone() for side in ("g", "d")
                     for k, v in whole[side].items()}
            digest = hashlib.sha256()
            for k in sorted(state):
                raw = state[k].contiguous().view(torch.uint8).numpy().tobytes()
                digest.update(k.encode() + raw)
            out["digests"].append(digest.hexdigest())
            if keep_states:
                out["states"].append(state)
    for h in hooks:
        h.remove()
    out["launches"] = counts_by_map()
    out["params"] = {f"{side}.{n}" for side, model in (("g", trainer.g), ("d", trainer.d))
                     for n, _ in model.named_parameters()}
    return out


def dp_child(spec_path):
    """Phase 31's child: one process of a group (``spec``: its rank, the
    process count, the group's ``init_method``, the paths and where to
    write), which checks nothing itself. It writes the statistics of
    ``dp_ops`` and, from rank 0, the states after each step to the files
    the spec names, and prints one line ``DP_RESULT {json}``."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fastfourierconvolution_tpu_torch import parallel

    with open(spec_path) as f:
        spec = json.load(f)
    device = parallel.initialize("cuda", spec["init"], spec["world"], spec["rank"])
    try:
        result = {"rank": parallel.process_index(), "device": str(device),
                  "backend": parallel.backend(), "runs": {}}
        for path in spec["paths"]:
            ops = dp_ops(device, path)
            run = dp_steps(device, path, DP_STEPS[path], keep_states=spec["rank"] == 0)
            run["gather_ms"] = dp_gather_ms(device, path)
            saved = {"ops": ops, "states": run.pop("states"), "grads": run.pop("grads")}
            if path == 32:  # the control: parameters take the global sums, not their share
                real = parallel.shard_full_batch(real_batch(device, SEED + 30, RESOLUTION[path]))
                with mock.patch.object(parallel, "param_share", lambda t: t):
                    saved["control"] = dp_first_grads(device, path, real, "f32")
            torch.save(saved, f"{spec['out']}-{path}-{spec['rank']}.pt")
            run.pop("params")
            if spec["parity"]:  # raises where the replayed steps differ
                graph_parity(device, path, {"hinge": {}})
            run["launches"] = {k: [[list(m), n] for m, n in v.items()]
                               for k, v in run["launches"].items()}
            result["runs"][str(path)] = run
        print("DP_RESULT " + json.dumps(result), flush=True)
    finally:
        parallel.shutdown()
    return 0


def dp_children(tmp, tag, world, paths, parity=False):
    """``world`` children of one group (``dp_child``; with ``parity`` each
    then runs phase 12's graph parity in the group), started together;
    their ``DP_RESULT`` by rank, rank 0's graph parity line printed. A
    child that fails fails the phase."""
    procs = []
    for rank in range(world):
        spec = os.path.join(tmp, f"{tag}-{rank}.json")
        with open(spec, "w") as f:
            json.dump({"rank": rank, "world": world, "init": f"file://{tmp}/{tag}-store",
                       "paths": paths, "out": os.path.join(tmp, tag), "parity": parity}, f)
        procs.append(subprocess.Popen([sys.executable, "-c", DP_CHILD, spec], cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=DP_TIMEOUT)
            if proc.returncode != 0:
                log(f"dp child {tag} rank {rank}: stdout\n{stdout[-3000:]}\nstderr\n"
                    f"{stderr[-3000:]}")
                raise AssertionError(f"dp child {tag} rank {rank} exited {proc.returncode}")
            line = [l for l in stdout.splitlines() if l.startswith("DP_RESULT ")]
            results.append(json.loads(line[-1][len("DP_RESULT "):]))
            if rank == 0:
                for l in stdout.splitlines():
                    if l.startswith("graph parity"):
                        log(f"dp {tag} group of {world}: {l}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


def dp_compare(card, label, tag, path, ref, ref_ops, results, tmp):
    """Phase 31a/b/d's checks of one path: the statistics wrappers' outputs
    gathered from the processes against one process's (``DP_FU_TOL``,
    ``DP_BN_TOL``), the first step's averaged gradients against one
    process's (``DP_GRAD_TOL``; the control, where there is one, beyond
    it), the processes' states the same bits after every step, rank 0's
    losses against one process's at the global batch, exact launches and
    collectives; prints the step's numbers and the parameters' distance
    from one process's after each step. Returns rank 0's launches."""
    import torch

    world = len(results)
    saved = [torch.load(f"{os.path.join(tmp, tag)}-{path}-{r}.pt", weights_only=False)
             for r in range(world)]
    same_bits, op_gaps = [], {"fu": 0.0, "bn": 0.0}
    for name, want in ref_ops.items():
        got = [s["ops"][name] for s in saved]
        if name.startswith("rows "):  # each process's rows of the output
            got = [torch.cat(got)]
        elif name.startswith("sum "):  # each process's share of a parameter's gradient
            got = [torch.stack(got).sum(dim=0)]
        gap = max(rel_max(g, want)[0] for g in got)
        kind = "fu" if "fu_" in name else "bn"
        op_gaps[kind] = max(op_gaps[kind], gap)
        if gap > (DP_FU_TOL if kind == "fu" else DP_BN_TOL):
            raise AssertionError(f"dp {label} {path}: {name} rel-max {gap:.3e}")
        if all(torch.equal(g, want) for g in got):
            same_bits.append(name)
    grad_gaps = [dp_grad_gaps(s["grads"]["f32"], ref["grads"]["f32"]) for s in saved]
    worst_grads = sorted(grad_gaps[0].items(), key=lambda kv: -kv[1])[:3]
    # one process's f32 gradients on other convolution algorithms
    algos = dp_grad_gaps(ref["grads"]["f32 benchmark"], ref["grads"]["f32"])
    grad_gap = max(max(g.values()) for g in grad_gaps)
    bf16_gaps = dp_grad_gaps(saved[0]["grads"]["bf16"], ref["grads"]["bf16"])
    # one process's own bf16 gradients against its f32 ones: the noise floor
    floor = dp_grad_gaps(ref["grads"]["bf16"], ref["grads"]["f32"])
    worst_bf16 = sorted(bf16_gaps.items(), key=lambda kv: -kv[1])[:4]
    controls = [dp_grad_gaps(s["control"], ref["grads"]["f32"]) for s in saved
                if "control" in s]
    control = ""
    if controls:
        beyond = sorted(n for n, v in controls[0].items() if v > DP_GRAD_TOL)
        control = (f"; the control (parameters take the global sums, not their share): "
                   f"{len(beyond)} of {len(controls[0])} parameters beyond the bar, worst "
                   f"{max(controls[0].values()):.3e}")
    runs = [r["runs"][str(path)] for r in results]
    n_steps = DP_STEPS[path]
    for i in range(n_steps):
        if len({run["digests"][i] for run in runs}) != 1:
            raise AssertionError(f"dp {label} {path}: the processes' states differ after step {i}")
    worst = {"loss": 0.0, "param": [], "buffer": 0.0}
    shares = []
    for i, (ours, theirs) in enumerate(zip(saved[0]["states"], ref["states"])):
        loss_gap = max(abs(a - b) for a, b in zip(runs[0]["losses"][i], ref["losses"][i]))
        worst["loss"] = max(worst["loss"], loss_gap)
        flipped = elements = 0
        param = 0.0
        for name, want in theirs.items():
            if not want.is_floating_point():
                continue
            diff = (ours[name].double() - want.double()).abs()
            if name in ref["params"]:
                param = max(param, diff.max().item())
                flipped += (diff > 1e-5).sum().item()
                elements += diff.numel()
            else:
                worst["buffer"] = max(worst["buffer"], diff.max().item()
                                      / max(want.double().abs().max().item(), 1e-30))
        worst["param"].append(param)
        shares.append(flipped / elements)
    launches = {k: {tuple(m): n for m, n in v} for k, v in runs[0]["launches"].items()}
    want = dp_expected_launches(path, n_steps, world)
    if {k: v for k, v in launches.items() if v} != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"dp {label} {path} launches {launches}, want {want}")
    for run in runs:
        for i in range(n_steps):
            expected = dp_expected_collectives(path, run["bn_calls"][i])
            if run["collectives"][i] != expected:
                raise AssertionError(f"dp {label} {path} step {i}: collectives "
                                     f"{run['collectives'][i]}, want {expected}")
    timed = slice(1, None)  # the first step builds plans and state
    step_ms = [sum(run["ms"][timed]) / len(run["ms"][timed]) for run in runs]
    dist_ms = [sum(run["dist_ms"][timed]) / len(run["dist_ms"][timed]) for run in runs]
    ref_ms = sum(ref["ms"][timed]) / len(ref["ms"][timed])
    log(f"dp {label} {path}: {world} processes on {[r['device'] for r in results]} over "
        f"{results[0]['backend']}, global batch {BATCH} ({BATCH // world} rows a process), "
        f"bf16, {n_steps} eager steps: statistics wrappers (bf16) and training ops (f32) "
        f"against one process's: FourierUnit rel-max {op_gaps['fu']:.3e} (tol "
        f"{DP_FU_TOL:g}), packed BN {op_gaps['bn']:.3e} (tol {DP_BN_TOL:g}); the same bits: "
        f"{same_bits} of {sorted(ref_ops)}; first step's "
        f"averaged gradients against one process's, f32: worst ||g2-g1||/||g1|| "
        f"{grad_gap:.3e} (tol {DP_GRAD_TOL:g}; rank 0's worst, beside one process's gap "
        f"on cuDNN's benchmarked algorithms "
        f"{[(n, f'{v:.3e}', f'{algos[n]:.3e}') for n, v in worst_grads]}, worst of those "
        f"{max(algos.values()):.3e}){control}; bf16 (printed): rank 0's "
        f"worst {[(n, f'{v:.3e}', f'{floor[n]:.3e}') for n, v in worst_bf16]} (the last: "
        f"one process's own bf16 against f32 gap), median "
        f"{sorted(bf16_gaps.values())[len(bf16_gaps) // 2]:.3e}; the processes' states the "
        f"same bits after every step; against one "
        f"process at batch {BATCH}: losses max |diff| {worst['loss']:.3e} (tol "
        f"{DP_LOSS_TOL:g}), parameters max |diff| by step "
        f"{[f'{x:.3e}' for x in worst['param']]} and share of their elements beyond 1e-5 "
        f"{[f'{x:.3e}' for x in shares]} (printed), buffers rel-max {worst['buffer']:.3e}; "
        f"launches exact; collectives per step exact {runs[0]['collectives'][-1]}")
    log(f"  step ms (host clock, synchronised, steps 2-{n_steps}) by process {step_ms} "
        f"against one process's {ref_ms:.3f} ms at batch {BATCH}; host ms in "
        f"torch.distributed calls {dist_ms} (share {[d / s for d, s in zip(dist_ms, step_ms)]}); "
        f"bytes a process puts into collectives per step {runs[0]['bytes'][-1]}; {card}")
    log(f"  host ms per all-gather of each partial-sum shape (rows a process, columns; "
        f"synchronised, 20 calls) by process: {[run['gather_ms'] for run in runs]}; {card}")
    if worst["loss"] > DP_LOSS_TOL or grad_gap > DP_GRAD_TOL:
        raise AssertionError(f"dp {label} {path}: against one process: losses "
                             f"{worst['loss']:.3e}, gradients {grad_gap:.3e}")
    if controls and max(controls[0].values()) <= DP_GRAD_TOL:
        raise AssertionError(f"dp {label} {path}: the control passed the gradients' bar")
    return launches


def dp_graph_nccl(device, card, tmp):
    """Phase 31c: a group of one process over NCCL. f32, TF32 off,
    deterministic algorithms: two ``update_steps`` calls of the fgan32 pair
    (an eager step, the capture with its collectives in the step's CUDA
    graph, replays) against the same calls of a trainer without a group,
    the same bits (every collective of one process gives back what it was
    given); then the second call again from the state before it, the same
    bits."""
    import torch

    from fastfourierconvolution_tpu_torch import parallel

    k = 4
    reals = [torch.stack([real_batch(device, SEED + 50 + 10 * j + i, 32) for i in range(k)])
             for j in range(2)]
    snapshot = lambda trainer: {n: t.clone() for n, t in trainer_state(trainer).items()}
    torch.use_deterministic_algorithms(True)
    try:
        plain = make_trainer(device, "f32", 32)
        for r in reals:
            plain.update_steps(r)
        want = snapshot(plain)
        del plain
        parallel.initialize("cuda", f"file://{tmp}/nccl-store", 1, 0)
        try:
            if parallel.backend() != "nccl":
                raise AssertionError(f"one process on the card took {parallel.backend()}")
            grouped = make_trainer(device, "f32", 32)
            parallel.mesh.collectives.clear()
            grouped.update_steps(reals[0])
            first = dict(parallel.mesh.collectives)
            before = _clone_state(grouped.state_dict())
            grouped.update_steps(reals[1])
            got = snapshot(grouped)
            grouped.load_state_dict(before)
            grouped.update_steps(reals[1])
            again = snapshot(grouped)
            torch.cuda.synchronize()
            replayed = dict(parallel.mesh.collectives)
        finally:
            parallel.shutdown()
    finally:
        torch.use_deterministic_algorithms(False)
    differ = sorted(name for name in want if not torch.equal(want[name], got[name]))
    unequal = sorted(name for name in got if not torch.equal(got[name], again[name]))
    log(f"dp 31c nccl, one process: fgan32 f32 update_steps (K={k}, 2 calls: an eager step, "
        f"the capture, {2 * k - 1} replays) with the collectives in the step's graph against "
        f"the same calls without a group: {len(want)} state tensors, {len(want) - len(differ)} "
        f"the same bits; the second call again from its starting state: "
        f"{len(got) - len(unequal)} of {len(got)} the same bits; collectives counted at the "
        f"first call (eager step and capture) {first}, none added by {3 * k - 1} replays: "
        f"{replayed == first}; {card}")
    if differ or unequal or replayed != first:
        raise AssertionError(f"dp 31c: differs from the trainer without a group {differ[:8]} "
                             f"or between replays {unequal[:8]}")


def _clone_state(state):
    """A copy of a nested trainer state (dicts, lists, tensors)."""
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_clone_state(v) for v in state]
    return state.clone() if hasattr(state, "clone") else state


def dp_cli(card, tmp):
    """Phase 31e: fgan32 ``train`` through the CLI as two processes joined
    by the JAX CLI's environment (gloo on the one card: one eager step a
    call), 4 steps in epochs of 2, checkpoints; then a resume to 6 as two
    processes. Rank 0 alone prints, writes the grids and checkpoints; each
    process's launches are exact. Returns the runs' launches by rank."""
    import socket

    out = os.path.join(tmp, "dp-cli")
    args = ["--preset", "fgan32", "--set", "train.precision=bf16", "--set", "data.dataset=shapes",
            "--set", "train.steps_per_call=1", "--set", "log.log_every=1", *CLI_METRICS_OFF,
            "--set", f"train.num_epoch_steps={DP_CLI_EPOCH}", "--checkpoint", "-o", out]
    counts = {}
    for name, steps, grids in (("train", DP_CLI_STEPS, 2), ("resume", DP_CLI_RESUME, 1)):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        jobs = [cli_start(f"dp-{name}-{rank}", ["train", *args, "-e", str(steps)], out,
                          env={**os.environ, "FFC_TPU_COORDINATOR": f"localhost:{port}",
                               "FFC_TPU_NUM_PROCESSES": str(DP_WORLD),
                               "FFC_TPU_PROCESS_ID": str(rank)}, common=False)
                for rank in range(DP_WORLD)]
        try:
            runs = [cli_wait(job) for job in jobs]
        finally:  # a process whose peer failed waits for it in a collective
            for job in jobs:
                if job[4].poll() is None:
                    job[4].kill()
                    job[4].communicate()
        (out0, counts0), (out1, counts1) = runs
        if f"step {steps}/{steps}" not in out0 or "step " in out1 or "INFO" in out1:
            raise AssertionError(f"dp cli {name}: rank 0 alone must print")
        if name == "resume" and f"INFO: resumed from step {DP_CLI_STEPS}" not in out0:
            raise AssertionError("dp cli: the two processes did not resume")
        n_steps = steps - (0 if name == "train" else DP_CLI_STEPS)
        want = dp_expected_launches(32, n_steps, DP_WORLD)
        for rank, got in enumerate((counts0, counts1)):
            expect = eval_launches(FU_SHAPES, grids, want) if rank == 0 else want
            if {k: v for k, v in got.items() if v} != {k: v for k, v in expect.items() if v}:
                raise AssertionError(f"dp cli {name} rank {rank} launches {got}, want {expect}")
            counts[f"dp-cli-{name}-{rank}"] = got
    losses = check_run_files(out, ["gan_losses.csv", "000002.png", "000004.png", "000006.png",
                                   "checkpoints/ckpt_4_steps.pt", "checkpoints/ckpt_6_steps.pt"])
    log(f"dp 31e cli: fgan32 train as {DP_WORLD} processes (gloo, one card), {DP_CLI_STEPS} "
        f"steps of global batch {BATCH}, resumed to {DP_CLI_RESUME} as {DP_WORLD} processes: "
        f"rank 0 alone printed and wrote grids and checkpoints, {len(losses)} logged losses "
        f"finite, launches exact in each process; {card}")
    return counts


def data_parallel(device, card, cli_counts, parts="abcd"):
    """Phase 31 (see the module docstring) but 31e, which ran beside phase
    26 (``dp_cli``, its launches ``cli_counts``), or the ``parts`` of it
    named; returns the launches of its runs by run."""
    import torch

    counts = dict(cli_counts)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        paths = [path for path, part in ((32, "a"), (128, "b")) if part in parts]
        refs, ref_ops = {}, {}
        for path in sorted(set(paths) | ({32} if "d" in parts else set())):
            ref_ops[path] = dp_ops(device, path)
            refs[path] = dp_steps(device, path, DP_STEPS[path], keep_states=True)
        if paths:
            results = dp_children(tmp, "gloo", DP_WORLD, paths)
            for path in paths:
                tag = "31a" if path == 32 else "31b"
                counts[f"dp-gloo-{path}"] = dp_compare(card, tag, "gloo", path, refs[path],
                                                       ref_ops[path], results, tmp)
        if "c" in parts:
            dp_graph_nccl(device, card, tmp)
        if "d" not in parts:
            return counts
        if torch.cuda.device_count() >= 2:
            results = dp_children(tmp, "nccl", 2, [32], parity=True)
            if results[0]["backend"] != "nccl":
                raise AssertionError(f"two cards took {results[0]['backend']}")
            counts["dp-nccl-32"] = dp_compare(card, "31d", "nccl", 32, refs[32], ref_ops[32],
                                              results, tmp)
        else:
            log(f"dp 31d: not run (NCCL across two cards): this machine has "
                f"{torch.cuda.device_count()} card")
    return counts


def data_parallel_alone(device, card, which):
    """``python3 chip_smoke.py 31`` (phase 31, 31e after the rest) or
    ``31d``: the launches of the runs checked as in phase 32."""
    import torch

    parts = {"31": "abcd", "31d": "d"}.get(which)
    if parts is None:
        raise ValueError(f"unknown argument {which!r}: 31 or 31d")
    if which == "31d" and torch.cuda.device_count() < 2:
        raise AssertionError("31d needs two cards")
    counts = data_parallel(device, card, {}, parts)
    if which == "31":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_cli_") as dp_tmp:
            counts.update(dp_cli(card, dp_tmp))
    for run, by_kernel in counts.items():
        if not any(by_kernel.values()):
            raise AssertionError(f"{run}: no kernel launched")
    return counts


# --- phase 32: tensor parallelism ------------------------------------------------

# The sliced kernels' maps (each wrapper's design decided on the slice's
# plans, ``fourier_unit.kernel_design``): the 32px generator's two (per
# item), a 128px map and the fgan64 one (staged; (64,8,64,64) at T = 4 has
# 2Co = 4 out-columns), a workspace map (workspace at every T) and the SN
# cDCGAN discriminator's (64,256,4,4) (whole: the forward per item, the
# statistics and the backward apply sliced; clustered on its tp slices,
# whose plans fit).
TP_SHAPES = [(BATCH, 16, 16, 16), (BATCH, 8, 32, 32), (BATCH, 32, 32, 32), (BATCH, 8, 64, 64),
             *WORKSPACE_SHAPES, (BATCH, 256, 4, 4)]
TP_SLICES = (2, 4)
TP_WORLD, TP_STEPS = 2, 2
TP_CHILD = "import sys, chip_smoke\nsys.exit(chip_smoke.tp_child(sys.argv[1]))\n"


def tp_slice(args, t, tp):
    """Out-channel slice ``t`` of ``tp`` of ``bwd_inputs``' arguments (x,
    kernel, scale, bias, mean, var, gy, gscale, gbias): K's columns and the
    vectors' entries ``fourier_unit.out_columns`` names, gy's channels."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    x, kernel, scale, bias, mean, var, gy, gscale, gbias = args
    c = x.shape[1]
    co = c // tp
    cols = fu.out_columns(c, t, tp).to(x.device)
    v = lambda t_: t_[cols].contiguous()
    return (x, kernel[:, cols].contiguous(), v(scale), v(bias), v(mean), v(var),
            gy[:, t * co:(t + 1) * co].contiguous(), v(gscale), v(gbias))


def tp_cases(a, staged_map):
    """[(kernel name, wrapper, plain version, arguments)] on the (sliced)
    arguments ``a``: the four wrappers, and on a staged map the four mix
    stages on the spectra of x and of gy's slice."""
    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    x, k, sc, bi, mean, var, gy, gsc, gbi = a
    cases = [("fourier_unit_fwd", fu.fourier_unit_forward, fu.fourier_unit_forward_plain, a[:6]),
             ("fu_train_stats", fu.fu_train_stats, fu.fu_train_stats_plain, a[:2]),
             ("fu_bwd_stats", fu.fu_bwd_stats, fu.fu_bwd_stats_plain, a[:7]),
             ("fu_bwd_apply", fu.fu_bwd_apply, fu.fu_bwd_apply_plain, a)]
    if staged_map:
        z, g = fu.fu_spectrum(x)[0], fu.fu_spectrum(gy)[0]
        cases += [("fu_mix_stats", fu.fu_mix_stats, fu.fu_mix_stats_plain, (z, k)),
                  ("fu_mix_apply", fu.fu_mix_apply, fu.fu_mix_apply_plain,
                   (z, k, sc, bi, mean, var)),
                  ("fu_bwd_stats_mix", fu.fu_bwd_stats_mix, fu.fu_bwd_stats_mix_plain,
                   (z, g, k, sc, bi, mean, var)),
                  ("fu_bwd_mix", fu.fu_bwd_mix, fu.fu_bwd_mix_plain,
                   (z, g, k, sc, bi, mean, var, gsc, gbi))]
    return cases


def tp_ms(fn, n=20):
    """Mean ms per call over ``n`` back-to-back calls (CUDA events) after two
    warm-up calls: phase 32 times many calls, each briefly."""
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# The kernel each case of ``tp_cases`` launches (besides ``fu_reduce``), by
# design: the profiler's symbol for its device ms a launch. A staged
# wrapper launches several stages, whose own cases carry their times.
TP_SYMBOLS = {
    "shared": {"fourier_unit_fwd": "fu_item_fwd_kernel",
               "fu_train_stats": "fu_item_train_stats_kernel",
               "fu_bwd_stats": "fu_item_bwd_stats_kernel",
               "fu_bwd_apply": "fu_item_bwd_apply_kernel"},
    "sliced": {"fu_train_stats": "fu_item_train_stats_kernel",
               "fu_bwd_stats": "fu_item_bwd_stats_kernel",
               "fu_bwd_apply": "fu_item_bwd_apply_kernel"},
    "workspace": {"fourier_unit_fwd": "fourier_unit_fwd_kernel",
                  "fu_train_stats": "fu_train_stats_kernel",
                  "fu_bwd_stats": "fu_bwd_stats_kernel",
                  "fu_bwd_apply": "fu_bwd_apply_kernel"},
    "staged": {name: f"{name}_kernel" for name in ("fu_mix_stats", "fu_mix_apply",
                                                   "fu_bwd_stats_mix", "fu_bwd_mix")},
}


def tp_device_ms(cases, symbols):
    """{case name: profiler device ms a launch of its kernel, or None} over
    one window that runs every case of ``cases`` ([(name, call, args)]) ten
    times (the profiler can miss a window's first launches)."""
    events = device_events(lambda: [kern(*a) for _, kern, a in cases], 10)
    out = {}
    for name, symbol in symbols.items():
        hits = [(t, n) for key, t, n in events if symbol in key]
        launches = sum(n for _, n in hits)
        out[name] = sum(t for t, _ in hits) / launches if launches else None
    return out


def tp_kernels(device):
    """Phase 32a: every sliced kernel, in one process with no group, at
    ``TP_SHAPES`` for T in ``TP_SLICES`` and every slice t, f32 and bf16,
    against its sliced plain version in f64 (``FU_REL_TOL``) with the same
    bits on two launches; at T = 1 the slice (every column) gives the
    whole kernel's bits. Returns the bf16 rows for the kernels line (slice
    t = 0 of each T: kernel, whole-kernel and plain ms, the bound on the
    slice's work)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    f64 = lambda a: [t.double() if isinstance(t, torch.Tensor) else t for t in a]
    rows = []
    for shape in TP_SHAPES:
        c = shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            args = bwd_inputs(shape, dtype, device, SEED + 60)
            staged_map = staged("stats", shape)
            # (the whole map's fu_bwd_mix writes gz over its G, which only
            # the timing of the whole kernels reads after it)
            whole = {name: (kern, a) for name, kern, _, a in tp_cases(args, staged_map)}
            every = {name: a for name, _, _, a in tp_cases(tp_slice(args, 0, 1), staged_map)}
            for name, (kern, a) in whole.items():
                if not all(torch.equal(p, q) for p, q in
                           zip(as_tuple(kern(*a)), as_tuple(kern(*every[name])))):
                    raise AssertionError(f"tp {name} {shape} {dname}: T = 1 is not the whole "
                                         f"kernel's bits")
            for tp in TP_SLICES:
                co = c // tp
                designs = {w: fu.kernel_design(w, *shape[1:], limit, co)
                           for w in ("forward", "stats", "bwd_apply")}
                worst = {}
                for t in range(tp):
                    cases = tp_cases(tp_slice(args, t, tp), staged_map)
                    if t == 0 and dtype == torch.bfloat16:
                        dev = tp_device_ms([(n, k_, a) for n, k_, _, a in cases],
                                           TP_SYMBOLS[designs["stats"]])
                    for name, kern, plain, a in cases:
                        outs = as_tuple(kern(*a))
                        refs = as_tuple(plain(*f64(a)))
                        if not all(torch.isfinite(o.float()).all() for o in outs):
                            raise AssertionError(f"tp {name} {shape} T={tp} t={t}: non-finite")
                        errs = [rel_max(o, r) for o, r in zip(outs, refs)]
                        bits = same_bits(lambda: kern(*a))
                        rel = max(e[0] for e in errs)
                        if rel > FU_REL_TOL[dname] or not bits:
                            raise AssertionError(f"tp {name} {shape} {dname} T={tp} t={t}: "
                                                 f"rel-max {rel:.3e}, same bits {bits}")
                        prev = worst.get(name, (0.0, 0.0))
                        worst[name] = (max(prev[0], rel), max(prev[1], max(e[1] for e in errs)))
                        if t or dtype != torch.bfloat16:
                            continue
                        ms = tp_ms(lambda: kern(*a))
                        whole_ms = tp_ms(lambda: whole[name][0](*whole[name][1]))
                        plain_ms = tp_ms(lambda: plain(*a))
                        bound_ms, bound_by, _, _ = bound(name, shape, a[0].element_size(),
                                                         dname, co=co)
                        rows.append(kernel_row(
                            name, shape, dname, phase="tensor-parallel", tp=tp, co=co,
                            ms=ms, device_ms=dev.get(name), whole_ms=whole_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            design=designs["forward" if name == "fourier_unit_fwd" else
                                           "bwd_apply" if name == "fu_bwd_apply" else "stats"]))
                for row in rows:
                    if (row["shape"] == list(shape) and row["tp"] == tp and dname == "bfloat16"
                            and row["name"] in worst):
                        row["max_abs_err"] = worst[row["name"]][1]
                log(f"tp {shape} {dname} T={tp} (Co {co}; design {designs}): every slice t "
                    f"against its sliced plain version in f64, worst rel-max " + ", ".join(
                        f"{n} {r:.3e}" for n, (r, _) in worst.items())
                    + f" (tol {FU_REL_TOL[dname]:g}), the same bits on two launches; T=1 the "
                    f"whole kernel's bits")
    for row in rows:
        log(f"  tp {row['name']} {tuple(row['shape'])} bf16 T={row['tp']} ({row['design']}): "
            f"{row['ms']:.4f} ms/call sliced (device {fmt_ms(row['device_ms'])} ms a launch), "
            f"whole {fmt_ms(row['whole_ms'])}, plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} ({row['bound_by']})")
    return rows


def tp_expected(path, n_steps, tp, dp=1):
    """(launches, tp collectives per step) of ``n_steps`` steps of
    ``path``'s pair as one process of a dp x tp grid: every FourierUnit
    map whose channels T divides runs on its slice, keyed (C, H, W, Co), and
    its reductions on (rows, 4Co) (the dp group's rows gathered) and
    (local rows, 4C·Co); per step a tp gather of the statistics and of y per
    training forward, of gscale and gbias per backward, and a tp sum of gx
    per backward. The per-item design only (fgan32's maps take it on their
    slices)."""
    import torch

    from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    want = {k: collections.Counter() for k in launch_wrappers()}
    coll = collections.Counter()
    for (b, c, h, w), forwards, backwards in STEP_MAPS[path][0]:
        co = c // tp if c % tp == 0 else c
        if fu.kernel_design("stats", c, h, w, limit, co) != fu.SHARED:
            raise AssertionError(f"tp_expected covers the per-item design, not {(c, h, w)}")
        key = (c, h, w) if co == c else (c, h, w, co)
        for k, per in PASS_LAUNCHES["per_item"][0].items():
            want[k][key] += per * forwards * n_steps
        for k, per in PASS_LAUNCHES["per_item"][1].items():
            want[k][key] += per * backwards * n_steps
        want["fu_reduce"][(b, 4 * co)] += (forwards + backwards) * n_steps
        want["fu_reduce"][(b // dp, 4 * c * co)] += backwards * n_steps
        if co != c:
            coll["tp_gather"] += 2 * forwards + 2 * backwards
            coll["tp_sum"] += backwards
    return {k: dict(v) for k, v in want.items() if v}, dict(coll)


def tp_child(spec_path):
    """Phase 32b's (32d's) child: one process of a dp x tp group on the
    card (``spec`` as ``dp_child``'s, with ``tp``), which checks nothing
    itself: the fgan32 pair's ``dp_steps`` (whole states, gathered), the
    control's first f32 gradients (the sliced input's gradient not summed
    over the tp group), written to the file the spec names; with
    ``parity`` then phase 12's graph parity in the group; prints
    ``TP_RESULT {json}``."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fastfourierconvolution_tpu_torch import parallel

    with open(spec_path) as f:
        spec = json.load(f)
    device = parallel.initialize("cuda", spec["init"], spec["world"], spec["rank"],
                                 tp=spec["tp"])
    try:
        run = dp_steps(device, 32, TP_STEPS, keep_states=spec["rank"] == 0)
        real = parallel.shard_full_batch(real_batch(device, SEED + 30, RESOLUTION[32]))
        with mock.patch.object(parallel.mesh._TpCopy, "backward",
                               staticmethod(lambda ctx, g: g)):
            control = dp_first_grads(device, 32, real, "f32")
        torch.save({"states": run.pop("states"), "grads": run.pop("grads"),
                    "control": control}, f"{spec['out']}-{spec['rank']}.pt")
        run.pop("params")
        run["launches"] = {k: [[list(m), n] for m, n in v.items()]
                           for k, v in run["launches"].items()}
        if spec["parity"]:  # raises where the replayed steps differ
            graph_parity(device, 32, {"hinge": {}})
        print("TP_RESULT " + json.dumps({"rank": parallel.process_index(),
                                          "backend": parallel.backend(), "run": run}),
              flush=True)
    finally:
        parallel.shutdown()
    return 0


def tp_steps(device, card, tmp, world=TP_WORLD, label="32b"):
    """Phase 32b: fgan32 as dp 1 x tp 2 processes on the one card (gloo)
    against one process: the first step's f32 gradients (whole) within
    ``DP_GRAD_TOL`` per tensor (the control beyond it), the losses within
    ``DP_LOSS_TOL``, the processes' whole states the same bits after every
    step, exact launches and collectives (the tp ones included). Phase
    32d (``world`` 4, one card each): dp 2 x tp 2 over NCCL, the same
    checks, then phase 12's graph parity in the group (``update_steps``
    with the tp collectives captured against eager steps). Returns rank
    0's launches."""
    import torch

    tp, parity = 2, world > TP_WORLD
    ref = dp_steps(device, 32, TP_STEPS, keep_states=True)
    procs = []
    for rank in range(world):
        spec = os.path.join(tmp, f"tp-{rank}.json")
        with open(spec, "w") as f:
            json.dump({"rank": rank, "world": world, "tp": tp, "parity": parity,
                       "init": f"file://{tmp}/tp-store", "out": os.path.join(tmp, "tp")}, f)
        procs.append(subprocess.Popen([sys.executable, "-c", TP_CHILD, spec], cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=DP_TIMEOUT)
            if proc.returncode != 0:
                log(f"tp child rank {rank}: stdout\n{stdout[-3000:]}\nstderr\n{stderr[-3000:]}")
                raise AssertionError(f"tp child rank {rank} exited {proc.returncode}")
            line = [l for l in stdout.splitlines() if l.startswith("TP_RESULT ")]
            results.append(json.loads(line[-1][len("TP_RESULT "):]))
            if rank == 0:
                for l in stdout.splitlines():
                    if l.startswith("graph parity"):
                        log(f"tp {label} grid of {world}: {l}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    runs = [r["run"] for r in results]
    saved = [torch.load(os.path.join(tmp, f"tp-{r}.pt"), weights_only=False)
             for r in range(world)]
    if parity and results[0]["backend"] != "nccl":
        raise AssertionError(f"tp {label}: {world} cards took {results[0]['backend']}")
    for i in range(TP_STEPS):
        if len({run["digests"][i] for run in runs}) != 1:
            raise AssertionError(f"tp: the processes' states differ after step {i}")
    gaps = [dp_grad_gaps(s["grads"]["f32"], ref["grads"]["f32"]) for s in saved]
    grad_gap = max(max(g.values()) for g in gaps)
    control = dp_grad_gaps(saved[0]["control"], ref["grads"]["f32"])
    loss_gap = max(abs(a - b) for i in range(TP_STEPS)
                   for a, b in zip(runs[0]["losses"][i], ref["losses"][i]))
    param_gap = [max((ours[n].double() - want.double()).abs().max().item()
                     for n, want in theirs.items() if n in ref["params"])
                 for ours, theirs in zip(saved[0]["states"], ref["states"])]
    launches = {k: {tuple(m): n for m, n in v} for k, v in runs[0]["launches"].items()}
    want_launches, tp_coll = tp_expected(32, TP_STEPS, tp, world // tp)
    if {k: v for k, v in launches.items() if v} != want_launches:
        raise AssertionError(f"tp launches {launches}, want {want_launches}")
    for run in runs:
        for i in range(TP_STEPS):
            expected = {**dp_expected_collectives(32, run["bn_calls"][i]), **tp_coll}
            if run["collectives"][i] != expected:
                raise AssertionError(f"tp step {i}: collectives {run['collectives'][i]}, "
                                     f"want {expected}")
    step_ms = [sum(run["ms"][1:]) / len(run["ms"][1:]) for run in runs]
    ref_ms = sum(ref["ms"][1:]) / len(ref["ms"][1:])
    log(f"tp {label}: fgan32 as dp {world // tp} x tp {tp} processes "
        f"({results[0]['backend']}),"
        f" batch {BATCH}, bf16, {TP_STEPS} eager steps, against one process: first step's f32 "
        f"gradients (whole) worst ||g2-g1||/||g1|| {grad_gap:.3e} (tol {DP_GRAD_TOL:g}), worst "
        f"three {sorted(gaps[0].items(), key=lambda kv: -kv[1])[:3]}; the control (x's "
        f"gradient not summed over the tp group) {sum(v > DP_GRAD_TOL for v in control.values())}"
        f" of {len(control)} parameters beyond the bar, worst {max(control.values()):.3e}; "
        f"losses max |diff| {loss_gap:.3e} (tol {DP_LOSS_TOL:g}); parameters max |diff| by step "
        f"{[f'{x:.3e}' for x in param_gap]} (printed); the processes' whole states the same "
        f"bits after every step; launches exact; collectives per step exact "
        f"{runs[0]['collectives'][-1]}; bytes a process puts into them per step "
        f"{runs[0]['bytes'][-1]}")
    log(f"  tp step ms (host clock, synchronised, step 2) by process {step_ms} against one "
        f"process's {ref_ms:.3f} ms; host ms in torch.distributed calls "
        f"{[sum(r['dist_ms'][1:]) / len(r['dist_ms'][1:]) for r in runs]}; {card}")
    if grad_gap > DP_GRAD_TOL or loss_gap > DP_LOSS_TOL:
        raise AssertionError(f"tp: gradients {grad_gap:.3e}, losses {loss_gap:.3e}")
    if max(control.values()) <= DP_GRAD_TOL:
        raise AssertionError("tp: the control passed the gradients' bar")
    return launches


def tensor_parallel_4(device, card):
    """``python3 chip_smoke.py 32d`` (four cards): phase 32d alone."""
    import torch

    if torch.cuda.device_count() < 4:
        raise AssertionError("32d needs four cards")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp4_") as tmp:
        return tp_steps(device, card, tmp, world=4, label="32d")


def tensor_parallel(device, card):
    """Phase 32 (see the module docstring): the sliced kernels (32a), then
    fgan32 as dp 1 x tp 2 processes (32b). Returns (the kernels line's
    rows with their launches in 32b, 32b's launches)."""
    rows = tp_kernels(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        counts = tp_steps(device, card, tmp)
    for row in rows:
        c, h, w = row["shape"][1:]
        row["launches"] = counts.get(row["name"], {}).get((c, h, w, row["co"]), 0)
    return rows, counts


# --- phase 33: a JAX run directory --------------------------------------------------------

# The fgan32 GANState's layout, written by tools/jax_ckpt_manifest.py with JAX.
JAX_MANIFEST = os.path.join(ROOT, "tools", "fgan32_jax_ckpt_manifest.json")
# the step of the packed .ckpt file, and the CLI run that resumes it
JAX_CKPT_STEP = 32
JAX_CLI_EPOCH = 16
JAX_PARITY_STEPS = 4
BATCHER_STORE = 2048
BATCHER_TIMED = 50


def _msgpack_header(out, n, fix, fix_limit, codes):
    """A msgpack length header: the fix form below ``fix_limit``, else the
    8-, 16- or 32-bit form of ``codes`` (None where a form does not exist)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, size in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * size):
            out.append(code)
            out += n.to_bytes(size, "big")
            return
    raise ValueError(f"msgpack length {n}")


def flax_pack(obj, out=None) -> bytearray:
    """The subset of msgpack that ``flax.serialization.msgpack_serialize``
    writes, as far as this script's seeded checkpoint needs it: maps, str,
    bytes, ints, None, lists, and ndarrays as ext type 1 (a packed ``(shape, dtype
    name, C-order bytes)``)."""
    import struct

    import numpy as np

    out = bytearray() if out is None else out
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(obj)
        else:
            out.append(0xD3)
            out += struct.pack(">q", obj)
    elif isinstance(obj, str):
        data = obj.encode()
        _msgpack_header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _msgpack_header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, list):
        _msgpack_header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            flax_pack(v, out)
    elif isinstance(obj, dict):
        _msgpack_header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            flax_pack(k, out)
            flax_pack(v, out)
    elif isinstance(obj, np.ndarray):
        payload = flax_pack([list(obj.shape), obj.dtype.name, obj.tobytes("C")])
        _msgpack_header(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(1)
        out += payload
    else:
        raise TypeError(f"flax_pack: {type(obj).__name__}")
    return out


def seeded_jax_tree(step, num_dis_updates=1, seed=SEED + 70):
    """The fgan32 GANState tree of ``JAX_MANIFEST`` with seeded values at
    ``step``: kernels N(0, 1/fan_in), BN scales 1 + N(0, 0.1), other
    parameters, means and ``u`` N(0, 0.1), variances U(0.5, 1.5), Adam's
    ``mu`` N(0, 1e-3) and ``nu`` U(0, 1e-6), every count ``step`` (D's
    schedule ``step * num_dis_updates``), a random ``rng`` key."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(JAX_MANIFEST) as f:
        entries = json.load(f)["entries"]
    tree = {}
    for path, spec in entries:
        *parents, name = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        if spec is None or spec == {}:
            node[name] = spec
            continue
        shape, dtype = tuple(spec["shape"]), np.dtype(spec["dtype"])
        if name == "count":  # D's Adam and schedule count every D update
            value = np.full(shape, step * (num_dis_updates if parents[0] == "d" else 1))
        elif path == "step":
            value = np.full(shape, step)
        elif path == "rng":
            value = rng.integers(0, 2 ** 32, shape)
        elif "mu" in parents:
            value = rng.normal(0, 1e-3, shape)
        elif "nu" in parents:
            value = rng.uniform(0, 1e-6, shape)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, shape)
        elif name in ("kernel", "mix_kernel"):
            value = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "bn_scale"):
            value = 1 + rng.normal(0, 0.1, shape)
        else:
            value = rng.normal(0, 0.1, shape)
        node[name] = np.asarray(value, dtype)
    return tree


def bridged_jax_state(trainer, tree):
    """{``trainer_state`` name: CPU tensor} of ``tree`` (the GANState as this
    script packed it) through the bridge, optax's entries by their index in
    the chain (AdamW: Adam first, the schedule last), the learning rates as
    the port's schedule sets them after the counts' updates."""
    import torch

    from fastfourierconvolution_tpu_torch.bridge import jax_params_to_state_dict, jax_to_state_dict
    from fastfourierconvolution_tpu_torch.train.gan import LinearDecay

    out = {}
    for side, model, schedule in (("g", trainer.g, trainer.g_lr), ("d", trainer.d, trainer.d_lr)):
        net = tree[side]
        out.update({f"{side}.{k}": v for k, v in jax_to_state_dict(
            model, net["params"], net["batch_stats"], net["spectral"]).items()})
        chain = net["opt_state"]
        adam, count = chain["0"], int(chain[str(len(chain) - 1)]["count"])
        for key, moments in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
            out.update({f"{side}.{n}.{key}": v
                        for n, v in jax_params_to_state_dict(model, moments).items()})
        out.update({f"{side}.{n}.step": torch.tensor(float(adam["count"]))
                    for n, _ in model.named_parameters()})
        decay = LinearDecay(torch.zeros(()), schedule.base, schedule.total)
        for _ in range(count):
            decay.advance()
        out[f"{side}.lr"], out[f"{side}.count"] = decay.lr, decay.count
    return out


def batcher_checks(card):
    """Phase 33: the native batcher built from ``native/ffc_batcher.cpp`` into
    ``_build/`` (g++) and loaded, its gather + normalise (plain and flipped)
    against numpy's ``x * float32(1/127.5) - 1`` bit for bit on a 64-image
    batch of a seeded 32px store, its ms per batch (threads as JAX's loader
    and the port's ask, and 1, 2, 4; 32px and 128px) beside numpy's and the
    loader's fallback, and its shuffle a permutation."""
    import numpy as np

    from fastfourierconvolution_tpu_torch.data import native
    from fastfourierconvolution_tpu_torch.data.loader import normalize_to_unit

    t0 = time.perf_counter()
    built = native._build()
    build_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the native batcher did not load")
    rng = np.random.default_rng(SEED + 80)
    perm = native.shuffle_indices(50_000, SEED + 81)
    is_perm = bool(np.array_equal(np.sort(perm), np.arange(50_000)))

    def ms(fn):
        fn()
        t = time.perf_counter()
        for _ in range(BATCHER_TIMED):
            fn()
        return (time.perf_counter() - t) / BATCHER_TIMED * 1e3

    out = {}
    for size, n_store in ((32, BATCHER_STORE), (128, 256)):
        store = rng.integers(0, 256, (n_store, size, size, 3), dtype=np.uint8)
        idx = rng.permutation(n_store)[:BATCH]
        want = store[idx].astype(np.float32) * np.float32(1 / 127.5) - np.float32(1)
        same = native.gather_normalize(store, idx).tobytes() == want.tobytes()
        same_flip = (native.gather_normalize(store, idx, hflip=True).tobytes()
                     == np.ascontiguousarray(want[:, :, ::-1]).tobytes())
        same_one = native.gather_normalize(store, idx, n_threads=1).tobytes() == want.tobytes()
        if not (same and same_flip and same_one):
            raise AssertionError(f"the native batcher's {size}px batch differs from numpy's")
        chosen = native.loader_threads(want.nbytes)
        times = {t: ms(lambda t=t: native.gather_normalize(store, idx, n_threads=t))
                 for t in sorted({0, 1, 2, 4, chosen})}
        numpy_ms = ms(lambda: store[idx].astype(np.float32) * np.float32(1 / 127.5)
                      - np.float32(1))
        fallback_ms = ms(lambda: normalize_to_unit(store[idx]))
        out[size] = dict(native_ms=times, loader_threads=chosen, numpy_ms=numpy_ms,
                         fallback_ms=fallback_ms)
        log(f"native batcher, a {BATCH}-image {size}x{size}x3 batch of a {n_store}-image "
            f"store: the same bits as numpy's x * float32(1/127.5) - 1 (plain, flipped, one "
            f"thread); ms per batch (host clock, {os.cpu_count()} cores, "
            f"{len(os.sched_getaffinity(0))} ours) by n_threads (0: the hardware's, JAX's "
            f"loader's; {chosen}: the port's loader's) "
            f"{({t: round(v, 4) for t, v in times.items()})} against numpy's "
            f"{numpy_ms:.4f} and the loader's fallback x/127.5 - 1 {fallback_ms:.4f}; {card}")
    log(f"native batcher: built {built} with g++ in {build_s:.2f} s (wall, host clock), "
        f"loaded {native.library_path()}; shuffle_indices(50000) a permutation {is_perm}")
    if not is_perm or built.parent != native.BUILD_DIR:
        raise AssertionError("the native batcher's build or shuffle is wrong")
    return out


def jax_checkpoint(device, card):
    """Phase 33 (see the module docstring); returns the restored step's
    launches by kernel and map (``check_main_path_launches`` key
    ``jax-ckpt``)."""
    import numpy as np
    import torch

    from fastfourierconvolution_tpu_torch.train import checkpoint as ckpt
    from fastfourierconvolution_tpu_torch.train import flax_msgpack

    n = JAX_CKPT_STEP
    tree = seeded_jax_tree(n)
    data = bytes(flax_pack(tree))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jax_run_") as tmp:
        run = os.path.join(tmp, "run")
        os.makedirs(os.path.join(run, "checkpoints"))
        path = os.path.join(run, "checkpoints", f"ckpt_{n}_steps.ckpt")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        decoded = flax_msgpack.restore(data)
        decode_s = time.perf_counter() - t0
        if int(decoded["step"]) != n or decoded["d"]["batch_stats"] is not None:
            raise AssertionError("the decoder's tree differs from the packed one")
        del decoded

        # bf16, as the CLI trains: the restore's wall time, its bits, the step's launches
        trainer = cli_trainer(device, "fgan32", "bf16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, step = ckpt.restore_latest(trainer, os.path.join(run, "checkpoints"))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want = bridged_jax_state(trainer, tree)
        got = {k: v for k, v in trainer_state(trainer).items() if not k.endswith("generator")}
        differ = sorted(k for k in want if not torch.equal(got[k].cpu(), want[k]))
        opt_states = [v for opt in (trainer.g_opt, trainer.d_opt) for s in opt.state.values()
                      for v in s.values()]
        on_card = all(v.device.type == "cuda" for v in opt_states)
        capturable = trainer.g_opt.param_groups[0]["capturable"] and \
            trainer.d_opt.param_groups[0]["capturable"]
        log(f"jax .ckpt, fgan32 at full width, step {n}: {len(data)} B packed from "
            f"{os.path.relpath(JAX_MANIFEST, ROOT)}; decoded in {decode_s * 1e3:.1f} ms "
            f"({len(data) / decode_s / 1e6:.1f} MB/s, host clock); restore_latest into a bf16 "
            f"trainer {restore_s * 1e3:.1f} ms wall (read, decode, bridge, copy to the card); "
            f"{len(want) - len(differ)} of {len(want)} tensors the same bits as the bridged "
            f"values, keys {'match' if set(want) == set(got) else 'differ'}; optimizer state "
            f"on the card {on_card} ({len(opt_states)} tensors), capturable {capturable}; step "
            f"{step}; {card}")
        if differ or set(want) != set(got) or not on_card or not capturable or step != n:
            raise AssertionError(f"jax .ckpt restore: differ {differ[:8]}")
        real = real_batch(device, SEED + 71, 32)
        zero_counts()
        trainer.update_step(real)
        torch.cuda.synchronize()
        counts = counts_by_map()
        if counts != expected_launches(32, 1):
            raise AssertionError(f"jax .ckpt: the restored step's launches {counts}, want "
                                 f"{expected_launches(32, 1)}")
        log(f"  the restored bf16 step's launches as phase 6's step: "
            f"{({k: v for k, v in counts.items() if v})}")
        del trainer
        torch.cuda.empty_cache()

        # in child processes beside the f32 checks: the CLI resumes the run
        # directory, and samples a copy of it
        cli_args = ["--preset", "fgan32", "--set", f"train.num_epoch_steps={JAX_CLI_EPOCH}",
                    "--checkpoint"]
        end = n + JAX_CLI_EPOCH
        copy = os.path.join(tmp, "copy")
        os.makedirs(os.path.join(copy, "checkpoints"))
        shutil.copy(path, os.path.join(copy, "checkpoints"))
        train_job = cli_start("jax-ckpt-train", ["train", *cli_args, "-e", str(end)], run)
        sample_job = cli_start("jax-ckpt-sample", ["sample", "--preset", "fgan32",
                                                   "--num_samples", "64"], copy)

        # f32 from the same restore: kernels against the plain ops, replays against eager steps
        parsed = flax_msgpack.read(path)

        def restored():
            t = cli_trainer(device, "fgan32", "f32")
            t.load_state_dict(ckpt.jax_trainer_state(t, parsed))
            return t

        g = torch.Generator().manual_seed(SEED + 72)
        zs = torch.randn(2, BATCH, 128, generator=g).to(device)
        torch.use_deterministic_algorithms(True)
        try:
            kern = restored()
            names = [f"g.{k}" for k, _ in kern.g.named_parameters()]
            grads_k = kern.g_loss_and_grads(zs[0])[1]
            del kern
            with plain_ops():
                grads_p = restored().g_loss_and_grads(zs[0])[1]
            worst, where, worst_norm = grad_gap(grads_k, grads_p, names)
            lk = restored().update_step(real, zs=zs)
            with plain_ops():
                lp = restored().update_step(real, zs=zs)
            loss_gap = max(abs(lk[k].item() - lp[k].item()) for k in lk)
            reals = torch.stack([real_batch(device, SEED + 73 + i, 32)
                                 for i in range(JAX_PARITY_STEPS)])
            graph, eager = restored(), restored()
            out = graph.update_steps(reals)
            ref = [eager.update_step(r) for r in reals]
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        # phase 12's rule: the same bits expected, any gap printed and held to
        # phase 7's bars, the generators' states exactly
        replay_gap = max((out[k] - torch.stack([r[k] for r in ref])).abs().max().item()
                         for k in out)
        a, b = trainer_state(graph), trainer_state(eager)
        differ = sorted(k for k in b if not torch.equal(a[k], b[k]))
        gaps = {k: (a[k].double() - b[k].double()).abs().max().item()
                / max(b[k].double().abs().max().item(), 1e-30)
                for k in differ if not k.endswith("generator")}
        largest = max(gaps.items(), key=lambda kv: kv[1], default=("", 0.0))
        log(f"  f32 from the restore (deterministic algorithms): generator gradients, kernels "
            f"vs plain ops, worst rel-max {worst:.3e} ({where}), rel-norm {worst_norm:.3e} "
            f"(tol {STEP_GRAD_TOL[32]:g}); a step's losses |diff| {loss_gap:.3e} (tol "
            f"{STEP_LOSS_TOL:g}); {JAX_PARITY_STEPS} replayed steps against eager ones: losses "
            f"max |diff| {replay_gap:.3e}, {len(b) - len(differ)} of {len(b)} state tensors "
            f"the same bits, largest rel-max gap {largest[1]:.3e} {largest[0]}; steps "
            f"{graph.step} and {eager.step}; {card}")
        if worst > STEP_GRAD_TOL[32] or loss_gap > STEP_LOSS_TOL:
            raise AssertionError(f"jax .ckpt f32: gradients {worst:.3e}, losses {loss_gap:.3e}")
        if (replay_gap > STEP_LOSS_TOL or largest[1] > STEP_GRAD_TOL[32]
                or any(k.endswith("generator") for k in differ)
                or graph.step != eager.step or graph.step != n + JAX_PARITY_STEPS):
            raise AssertionError(f"jax .ckpt: replayed steps differ from eager ones: "
                                 f"{differ[:8]}")
        del graph, eager, parsed

        batcher = batcher_checks(card)
        stdout, counts_train = cli_wait(train_job)
        if f"INFO: resumed from step {n}" not in stdout:
            raise AssertionError(f"cli: train did not resume the JAX run directory at {n}")
        listing = sorted(os.listdir(os.path.join(run, "checkpoints")))
        if listing != sorted([f"ckpt_{end}_steps.pt", f"ckpt_{n}_steps.ckpt"]):
            raise AssertionError(f"cli: the run directory's checkpoints {listing}")
        if counts_train != cli_train_launches(32, FU_SHAPES, grids=1):
            raise AssertionError(f"cli jax-ckpt train launches {counts_train}")
        stdout, counts_sample = cli_wait(sample_job)
        if f"INFO: sample from step {n}" not in stdout:
            raise AssertionError(f"cli: sample did not draw from the JAX checkpoint at {n}")
        size = png_size(os.path.join(copy, f"samples_{n:06d}.png"))
        if counts_sample != eval_launches(FU_SHAPES, 2):
            raise AssertionError(f"cli jax-ckpt sample launches {counts_sample}")
        log(f"  cli: train resumed the JAX run directory at step {n} and wrote {listing}; "
            f"sample drew a {size[0]}x{size[1]} grid from the .ckpt; launches as expected; "
            f"{card}")
    return {"jax-ckpt": counts, "cli-jax-ckpt-train": counts_train,
            "cli-jax-ckpt-sample": counts_sample}, dict(restore_s=restore_s, decode_s=decode_s,
                                                        batcher=batcher)


def main() -> int:
    # Python compiles a module from source wherever it finds no bytecode it
    # may read or write; where the installed packages are read-only, every
    # child process compiled torch anew, about 6 s of a 20-30 s CLI child
    # (cProfile, H100 80GB HBM3 machine). A bytecode cache of this run's own,
    # which the child processes inherit.
    pycache = tempfile.TemporaryDirectory(prefix="chip_smoke_pycache_")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = pycache.name
    try:
        return run()
    finally:
        pycache.cleanup()


def run() -> int:
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

    if len(sys.argv) > 1:
        phase(f"{sys.argv[1]} alone")
        if sys.argv[1] == "32":
            tp_rows, _ = tensor_parallel(device, card)
            log(json.dumps({"kernels": tp_rows}))
        elif sys.argv[1] == "32d":
            tensor_parallel_4(device, card)
        elif sys.argv[1] == "33":
            jax_checkpoint(device, card)
        elif sys.argv[1] == "8":
            log(json.dumps({"kernels": check_bn_act(device)}))
        elif sys.argv[1] == "96":
            log(json.dumps({"kernels": pair_96(device, card)[0]}))
        elif sys.argv[1] == "256":
            log(json.dumps({"kernels": pair_256(device, card)[0]}))
        else:
            data_parallel_alone(device, card, sys.argv[1])
        phase("result")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    _, counts_32, _, graph_ms_32 = train(device, card, 32)
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
    _, counts, _, _ = train(device, card, 128)
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
    _, counts_sngan, _, _ = train(device, card, "sngan")
    rows += with_launches(rows_sngan, counts_sngan)
    calls += with_calls(calls_sngan, counts_sngan)
    train_vs_plain(device, "sngan")
    phase("14: the fgan_cond32 pair (conditional), 32px: training, generate, f32 step")
    trainer_c32, counts_c32, _, _ = train(device, card, "cond32")
    by_map_c32 = serve_generate(device, card, trainer_c32)
    del trainer_c32
    train_vs_plain(device, "cond32")
    phase("15: the fgan_cond48 pair: FourierUnit kernels at its maps, training; the staged "
          "kernels at 96x96, the workspace kernels, the 96px pair trained; the staged kernels "
          "on split 256x256 planes, the 256px pair trained and served")
    rows_48, calls_48 = check_fourier_unit(device, FU48_SHAPES, "training-cond48")
    train_rows, train_calls = check_train_kernels(device, FU48_SHAPES, "training-cond48")
    against_workspace(train_rows)
    rows_48 += train_rows + check_reduce(device, reduce_cases(FU48_SHAPES), "training-cond48")
    calls_48 += train_calls
    _, counts_c48, _, _ = train(device, card, "cond48")
    rows += with_launches(rows_48, counts_c48)
    calls += with_calls(calls_48, counts_c48)
    rows_96, calls_96, counts_96 = pair_96(device, card)
    rows += rows_96
    calls += calls_96
    rows_256, calls_256, counts_256, served_256 = pair_256(device, card)
    rows += rows_256
    calls += calls_256
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
    # phase 29 exports phase 21's run directory
    cli_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    tmp = cli_tmp.name
    phase("21: fgan32 through the CLI: train, resume, sample; restores in process")
    cli_counts = cli_fgan32(device, card, tmp, graph_ms_32)
    # phase 22 (fgan_cond32 through the CLI) runs beside phase 26
    phase("23: fgan64: the kernels at its staged map, the CLI's pair stepped")
    rows_64, calls_64 = cli_fgan64(device, card)
    rows += rows_64
    calls += calls_64
    phase("24: the FFC layer options: the LFU maps' kernels, the LFU blocks (32px tuple, "
          "128px packed with biases), the spectral-normed cDCGAN discriminator")
    rows_lfu, calls_lfu = check_maps(device, LFU32_SHAPES + LFU128_SHAPES, "lfu-blocks")
    counts_lfu = check_lfu_blocks(device, card)
    rows += with_launches(rows_lfu, counts_lfu)
    calls += with_calls(calls_lfu, counts_lfu)
    rows_snd, calls_snd = check_maps(device, SND_FU_SHAPES, "training-cond-sn-d")
    sliced_against_workspace(device, card)
    counts_snd = cond_sn_d(device, card)
    rows += with_launches(rows_snd, counts_snd)
    calls += with_calls(calls_snd, counts_snd)
    phase("25: remat none / dots / full, fgan32 and fgan128")
    remat_counts = remat_runs(device, card)
    phase("26: a process's first run of a configuration against its second, beside phase 22 "
          "(fgan_cond32 through the CLI: train, sample), phase 31e (cli train and a resume "
          "as two processes) and the CLI runs of phases 23 (fgan64 train), 29 (export, sample "
          "--exported, fidelity, --torch_checkpoint) and 30 (train / fidelity with PRC and "
          "PPL), all in child processes side by side")
    prc_ppl_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_metrics_")
    exported = threading.Event()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_cli_") as dp_tmp, \
            ThreadPoolExecutor(5) as pool:
        prc_ppl_cli = pool.submit(cli_prc_ppl, card, prc_ppl_tmp.name,
                                  os.path.join(tmp, "fgan32", "generator.ffcx"), exported)
        serving_cli = pool.submit(cli_serving, card, tmp, exported)
        cond32 = pool.submit(cli_cond32, device, card, tmp)
        dp_cli_run = pool.submit(dp_cli, card, dp_tmp)
        fgan64_cli = pool.submit(cli_fgan64_train, card, tmp)
        first_run(card)
        cli_counts.update(cond32.result())
        cli_counts.update(fgan64_cli.result())
        dp_cli_counts = dp_cli_run.result()
        serving_counts = serving_cli.result()
        prc_ppl_counts = prc_ppl_cli.result()
    prc_ppl_tmp.cleanup()
    backward_thread_cost(device, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        phase("27: the InceptionV3 extractor and calculate_metrics on the card against the CPU")
        check_extractor(device, card, tmp)
        phase("28: fgan32 through the CLI with its preset's metrics (ISC, FID; with KID)")
        eval_counts = cli_metrics(device, card, tmp, graph_ms_32)
    phase("29: the serving export: artifacts on the card served in a JAX-free process; "
          "the --torch_checkpoint artifact of phase 26's CLI runs against its model")
    artifact_counts = serve_artifacts(device, card, cli_tmp.name)
    serving_counts.update(serving_reference(device, cli_tmp.name))
    cli_tmp.cleanup()
    phase("30: VGG16 and LPIPS, PPL, the CLIP and DINOv2 extractors, PRC's dual split")
    metric_counts = {**check_metric_extras(device, card), **prc_ppl_counts}
    for row in rows:
        if row["name"] in artifact_counts and row.get("maps", 1) == 1:
            key = tuple(row["shape"][1:])
            row["artifact_launches"] = artifact_counts[row["name"]].get(key, 0)
            row["prc_ppl_launches"] = sum(c.get(row["name"], {}).get(key, 0)
                                          for c in metric_counts.values())
            row["launches"] = (row.get("launches", 0) + row["artifact_launches"]
                               + row["prc_ppl_launches"])
    phase("31: data parallelism: fgan32 and fgan128 as two processes on one card (gloo) "
          "against one, one process's captured collectives (NCCL), two cards (NCCL), "
          "train and resume through the CLI as two processes")
    dp_counts = data_parallel(device, card, dp_cli_counts)
    phase("32: tensor parallelism: the sliced kernels (per item, staged, workspace) against "
          "their sliced plain versions; fgan32 as dp 1 x tp 2 processes on one card (gloo) "
          "against one")
    tp_rows, tp_counts = tensor_parallel(device, card)
    rows += tp_rows
    phase("33: a JAX run directory: a full-width fgan32 .ckpt restored, stepped against the "
          "plain ops and as replays, resumed and sampled through the CLI; the native batcher")
    jax_counts, _ = jax_checkpoint(device, card)
    for row in rows:  # the 32px maps' rows of phases 3 and 5
        if row.get("phase") not in ("serving", "training") or "co" in row:
            continue
        key = tuple(row["shape"]) if row["name"] == "fu_reduce" else tuple(row["shape"][1:])
        extra = jax_counts["jax-ckpt"].get(row["name"], {}).get(key, 0)
        if extra and row.get("maps", 1) == 1:
            row["jax_ckpt_launches"] = extra
            row["launches"] = row.get("launches", 0) + extra
    phase("34: result")
    check_main_path_launches({"serving-32px": {"fourier_unit_fwd": by_map},
                              "training-32px": counts_32, "training-128px": counts,
                              "training-sngan": counts_sngan, "training-cond32": counts_c32,
                              "serving-cond32": {"fourier_unit_fwd": by_map_c32},
                              "training-cond48": counts_c48, "training-96px": counts_96,
                              "training-256px": counts_256, "serving-256px": served_256,
                              **cli_counts,
                              "lfu-blocks": counts_lfu, "training-cond-sn-d": counts_snd,
                              **remat_counts, **eval_counts,
                              "serving-artifacts": artifact_counts, **serving_counts,
                              **metric_counts, **dp_counts, "tp-32": tp_counts,
                              **jax_counts})
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
