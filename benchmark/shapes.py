"""The maps a configuration's generator computes on, from its sizes, and
the functions a training step or a served request calls on them: what
the roofline and peak shares count as work.

A training step (G's update, then one D update) runs the generator
forward twice, in training mode (the G update's pass and the D update's
pass without gradients), and backward once; a served request runs it
forward once in eval mode.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference.ffc_gan import split_channels

Shape = Tuple[int, int, int, int]


def block_maps(cfg: dict, batch: int) -> List[Shape]:
    """(B, C, H, W) of each up-block's output, which its BN normalises."""
    side, out = cfg["mg"], []
    for mult in cfg["channel_mults"]:
        side *= 2
        out.append((batch, cfg["ngf"] * mult, side, side))
    return out


def fourier_unit_maps(cfg: dict, batch: int) -> List[Shape]:
    """(B, C, H, W) of each FourierUnit's input: the g2g branch of every
    block with global channels on both sides, C half the block's global
    output channels, at the block's output size."""
    maps, gin = [], 0.0
    for b, c, h, w in block_maps(cfg, batch):
        cg = split_channels(c, cfg["ratio_g"])[1]
        if gin > 0 and cg > 0:
            maps.append((b, cg // 2, h, w))
        gin = cfg["ratio_g"]
    return maps


def fourier_unit_calls(cfg: dict, batch: int, train: bool) -> List[tuple]:
    """(function, shape, noise) of every FourierUnit call of one training
    step (the training op: two forwards and one backward at each map) or
    of one request (the eval forward)."""
    calls = []
    for shape in fourier_unit_maps(cfg, batch):
        if train:
            calls += [("train_forward", shape, False)] * 2 + [("train_backward", shape, False)]
        else:
            calls.append(("fourier_unit_fwd", shape, False))
    return calls


def fused_bn_calls(cfg: dict, batch: int) -> List[tuple]:
    """(function, shape, noise) of every fused BN + GELU call of one
    training step: at each block's map the statistics and the apply with
    the noise fold on both forwards, the backward sums and dx once."""
    calls = []
    for shape in block_maps(cfg, batch):
        calls += [("bn_stats", shape, False), ("bn_gelu_apply", shape, True)] * 2
        calls += [("bn_bwd_reduce", shape, True), ("bn_bwd_dx", shape, True)]
    return calls
