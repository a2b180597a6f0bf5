"""The launch rules of the fused BN + GELU family's backward reduce and
apply kernels, and their tilings, on the CPU.

``bn_act.bwd_reduce_design`` picks the backward reduce's load width and
cluster size, ``bn_act.apply_design`` the apply's load width, block size
and channels per thread; both are pure functions, checked here at the
128px generator's five packed maps, the map whose planes are no multiple
of 16 bytes and an unaligned map. The kernels' index arithmetic
(``csrc/bn_act.cu``: ``PlaneWalk`` and ``bn_gelu_apply_kernel``'s grid) is
emulated at small shapes: every element is read exactly once, and every
apply thread loads the noise map its channels take. On the CPU the two
wrappers run their plain versions.
"""

from __future__ import annotations

import math

import pytest
import torch

from fastfourierconvolution_tpu_torch.ops import bn_act as ba

# (B, C, H*W, itemsize) -> (vec, cluster): the five packed maps in bf16 and
# the largest and smallest in f32, planes of 200 bytes in bf16 and f32.
REDUCE_CASES = {
    (64, 512, 64, 2): (True, 1), (64, 256, 256, 2): (True, 4), (64, 128, 1024, 2): (True, 8),
    (64, 128, 4096, 2): (True, 8), (64, 128, 16384, 2): (True, 8),
    (64, 512, 64, 4): (True, 1), (64, 128, 16384, 4): (True, 8),
    (64, 192, 100, 2): (False, 1), (64, 192, 100, 4): (True, 1),
}

# (B, C, H*W, itemsize) -> (vec, tile, group), the same maps.
APPLY_CASES = {
    (64, 512, 64, 2): (True, 32, 1), (64, 256, 256, 2): (True, 256, 1),
    (64, 128, 1024, 2): (True, 256, 1), (64, 128, 4096, 2): (True, 256, 4),
    (64, 128, 16384, 2): (True, 256, 16),
    (64, 512, 64, 4): (True, 256, 1), (64, 128, 16384, 4): (True, 256, 32),
    (64, 192, 100, 2): (False, 256, 2), (64, 192, 100, 4): (True, 256, 1),
}


@pytest.mark.parametrize("shape,design", list(REDUCE_CASES.items()))
def test_bwd_reduce_design_at_the_packed_maps(shape, design):
    assert ba.bwd_reduce_design(*shape) == design


@pytest.mark.parametrize("b,c,hw,itemsize", list(REDUCE_CASES))
def test_bwd_reduce_design_keeps_every_block_resident_and_busy(b, c, hw, itemsize):
    """bn_stats's rule with 4096 elements (two maps' bytes) a block: 16-byte
    loads exactly where a plane is a whole number of 16 bytes; a cluster of
    1-8 blocks that grows only while all blocks fit the card at once (132
    SMs x 8) and each keeps 4096 elements and a plane."""
    vec, cluster = ba.bwd_reduce_design(b, c, hw, itemsize)
    assert vec == (hw * itemsize % 16 == 0)
    assert cluster in (1, 2, 4, 8)
    if cluster > 1:
        assert c * cluster <= 1056 and b >= cluster and b * hw >= cluster * 4096
    if cluster < 8:
        assert c * cluster * 2 > 1056 or b < 2 * cluster or b * hw < 2 * cluster * 4096


@pytest.mark.parametrize("shape,design", list(APPLY_CASES.items()))
def test_apply_design_at_the_packed_maps(shape, design):
    assert ba.apply_design(*shape) == design


@pytest.mark.parametrize("b,c,hw,itemsize", list(APPLY_CASES))
def test_apply_design_holds_a_full_wave(b, c, hw, itemsize):
    """The grid holds at least one full wave of blocks (the most that 132
    SMs hold at once: 32 blocks or 2048 threads each); a block is 32-256
    threads, a power of two, and halves only while one channel per thread
    misses a wave; channels per thread double only while two waves remain."""
    vec, tile, group = ba.apply_design(b, c, hw, itemsize)
    assert vec == (hw * itemsize % 16 == 0)
    assert tile in (32, 64, 128, 256) and 1 <= group <= 32
    blocks = lambda t, g: math.prod(ba.apply_blocks(b, c, hw, itemsize, vec, t, g))
    assert ba.apply_wave(tile) == 132 * min(32, 2048 // tile)
    assert blocks(tile, group) >= ba.apply_wave(tile)
    if tile < 256:
        assert blocks(2 * tile, 1) < ba.apply_wave(2 * tile)
    if group > 1:
        assert blocks(tile, group) >= 2 * ba.apply_wave(tile)
    if group < 32:
        assert blocks(tile, 2 * group) < 2 * ba.apply_wave(tile)


def test_designs_take_loads_of_one_value_off_a_16_byte_boundary():
    assert ba.bwd_reduce_design(64, 128, 1024, 2, aligned=False) == (False, 8)
    assert ba.apply_design(64, 128, 1024, 2, aligned=False) == (False, 256, 8)


def _unit(itemsize, vec):
    return 16 // itemsize if vec else 1


def _apply_reads(b, c, hw, itemsize, vec, tile, group, cl):
    """bn_gelu_apply_kernel's index arithmetic: {(item, channel, position):
    reads}, and whether each read found its noise unit loaded (n_l below
    cl, n_g from cl on)."""
    per = _unit(itemsize, vec)
    units = hw // per
    tiles, groups = ba.apply_blocks(b, c, hw, itemsize, vec, tile, group)
    reads, noise_ok = {}, True
    for gy in range(groups):
        c0, c1 = gy * group, min(c, gy * group + group)
        for q in range(tiles * tile):
            if q >= b * units:
                continue
            item, j = divmod(q, units)
            has_lo, has_hi = c0 < cl, c1 > cl
            for ch in range(c0, c1):
                noise_ok &= has_lo if ch < cl else has_hi
                for p in range(j * per, j * per + per):
                    reads[item, ch, p] = reads.get((item, ch, p), 0) + 1
    return reads, noise_ok


# (B, C, H*W, itemsize, cl): groups that straddle cl, planes of one unit,
# ragged tiles, planes of 200 bytes in bf16 (the element-wise path).
TILING_SHAPES = [(2, 7, 16, 2, 3), (3, 12, 24, 4, 5), (1, 5, 8, 2, 0), (2, 6, 100, 2, 6),
                 (4, 9, 40, 4, 9)]


@pytest.mark.parametrize("b,c,hw,itemsize,cl", TILING_SHAPES)
@pytest.mark.parametrize("tile,group", [("rule", "rule"), (32, 3), (64, 4), (32, 32)])
def test_apply_tiling_covers_every_element_once(b, c, hw, itemsize, cl, tile, group):
    vec, rule_tile, rule_group = ba.apply_design(b, c, hw, itemsize)
    tile = rule_tile if tile == "rule" else tile
    group = rule_group if group == "rule" else group
    reads, noise_ok = _apply_reads(b, c, hw, itemsize, vec, tile, group, cl)
    assert set(reads) == {(i, ch, p) for i in range(b) for ch in range(c) for p in range(hw)}
    assert set(reads.values()) == {1}
    assert noise_ok


def _reduce_reads(b, c, hw, itemsize, vec, cluster, threads=256, unroll=2):
    """bn_bwd_reduce_kernel's index arithmetic (PlaneWalk, planes in flight):
    {(item, channel, position): reads}."""
    per = _unit(itemsize, vec)
    units = hw // per
    span = 1
    while span < units and span < threads:
        span *= 2
    step = threads // span
    per_rank = -(-b // cluster)
    reads = {}
    for ch in range(c):
        for rank in range(cluster):
            b0, b1 = rank * per_rank, min(b, rank * per_rank + per_rank)
            for t in range(threads):
                first, j0 = divmod(t, span)
                for item in range(b0 + first, b1, step * unroll):
                    for j in range(j0, units, span):
                        for k in range(unroll):
                            if item + k * step < b1:
                                for p in range(j * per, j * per + per):
                                    key = (item + k * step, ch, p)
                                    reads[key] = reads.get(key, 0) + 1
    return reads


@pytest.mark.parametrize("b,c,hw,itemsize,cluster",
                         [(16, 2, 64, 2, 4), (5, 3, 8, 2, 2), (64, 1, 16, 4, 8),
                          (3, 2, 100, 2, 1), (9, 2, 2048, 2, 8)])
def test_bwd_reduce_walk_reads_every_element_once(b, c, hw, itemsize, cluster):
    vec = hw * itemsize % 16 == 0
    reads = _reduce_reads(b, c, hw, itemsize, vec, cluster)
    assert set(reads) == {(i, ch, p) for i in range(b) for ch in range(c) for p in range(hw)}
    assert set(reads.values()) == {1}


def _args(noise, dtype):
    g = torch.Generator().manual_seed(2)
    b, c, h, w = 2, 6, 5, 5
    x = (torch.randn(b, c, h, w, generator=g) * 1.5 + 0.3).to(dtype)
    gy = torch.randn(b, c, h, w, generator=g).to(dtype)
    n_l, n_g = (torch.randn(b, 1, h, w, generator=g).to(dtype) for _ in range(2))
    scale, bias, wn = (torch.randn(c, generator=g) for _ in range(3))
    mean, var = ba.bn_stats_plain(x)
    noise_args = (wn, n_l, n_g, 4) if noise else ()
    reduce_noise = (n_l, n_g, 4) if noise else ()
    return (x, mean, var, scale, bias) + noise_args, (x, gy, mean, var, scale, bias) + reduce_noise


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noise", [False, True])
def test_apply_and_reduce_run_their_plain_versions_on_the_cpu(noise, dtype):
    apply_args, reduce_args = _args(noise, dtype)
    before = (ba.bn_gelu_apply.launches, ba.bn_bwd_reduce.launches)
    torch.testing.assert_close(ba.bn_gelu_apply(*apply_args),
                               ba.bn_gelu_apply_plain(*apply_args), rtol=0, atol=0)
    sums = ba.bn_bwd_reduce(*reduce_args)
    assert len(sums) == (3 if noise else 2)
    for ours, ref in zip(sums, ba.bn_bwd_reduce_plain(*reduce_args)):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    assert (ba.bn_gelu_apply.launches, ba.bn_bwd_reduce.launches) == before
