"""The launch rules of the fused BN + GELU family's backward reduce, apply
and dx kernels, and their tilings, on the CPU.

``bn_act.bwd_reduce_design`` picks the backward reduce's load width and
cluster size, ``bn_act.apply_design`` the apply's load width, block size
and channels per thread, ``bn_act.dx_design`` the dx kernel's load width,
block size, threads per unit, channels per block and cluster; all are pure
functions, checked here at the 128px generator's five packed maps (and the
256px generator's for dx), the map whose planes are no multiple of 16
bytes and an unaligned map. The kernels' index arithmetic
(``csrc/bn_act.cu``: ``PlaneWalk``, ``bn_gelu_apply_kernel``'s grid and
``bn_bwd_dx_kernel``'s grid and sums) is emulated at small shapes: every
element is read (or written) exactly once, every apply thread loads the
noise map its channels take, and every dn_l and dn_g value adds each
channel of its side exactly once, the cluster's ranks in order. On the
CPU the wrappers run their plain versions.
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


# (B, C, H*W, itemsize, noise) -> (vec, lanes, group, cluster): the
# 128px generator's five packed maps and the 256px generator's last, in
# bf16 and f32, with and without the noise fold.
DX_CASES = {
    (64, 512, 64, 2, False): (True, 1, 1, 1),
    (64, 256, 256, 2, False): (True, 1, 2, 1),
    (64, 128, 1024, 2, False): (True, 1, 4, 1),
    (64, 128, 4096, 2, False): (True, 1, 16, 1),
    (64, 128, 16384, 2, False): (True, 1, 64, 1),
    (64, 128, 65536, 2, False): (True, 1, 128, 1),
    (64, 512, 64, 2, True): (True, 32, 64, 8),
    (64, 256, 256, 2, True): (True, 32, 128, 2),
    (64, 128, 1024, 2, True): (True, 16, 128, 1),
    (64, 128, 4096, 2, True): (True, 8, 128, 1),
    (64, 128, 16384, 2, True): (True, 8, 128, 1),
    (64, 128, 65536, 2, True): (True, 8, 128, 1),
    (64, 512, 64, 4, False): (True, 1, 2, 1),
    (64, 256, 256, 4, False): (True, 1, 4, 1),
    (64, 128, 1024, 4, False): (True, 1, 8, 1),
    (64, 128, 4096, 4, False): (True, 1, 32, 1),
    (64, 128, 16384, 4, False): (True, 1, 128, 1),
    (64, 128, 65536, 4, False): (True, 1, 128, 1),
    (64, 512, 64, 4, True): (True, 32, 128, 4),
    (64, 256, 256, 4, True): (True, 32, 256, 1),
    (64, 128, 1024, 4, True): (True, 8, 128, 1),
    (64, 128, 4096, 4, True): (True, 8, 128, 1),
    (64, 128, 16384, 4, True): (True, 8, 128, 1),
    (64, 128, 65536, 4, True): (True, 8, 128, 1),
}


@pytest.mark.parametrize("shape,design", list(DX_CASES.items()))
def test_dx_design_at_the_packed_maps(shape, design):
    b, c, hw, itemsize, noise = shape
    assert ba.dx_design(b, c, hw, itemsize, noise=noise) == design


def _pow2_ceil(n):
    return 1 << (n - 1).bit_length()


# A grid of maps: batches, widths (C < 8 and C not a power of two among
# them), planes of one unit, of 200 bytes in bf16, and large ones.
DX_GRID = [(b, c, hw, itemsize) for b in (1, 8, 64) for c in (3, 6, 128, 192, 512)
           for hw in (8, 64, 100, 1024, 16384) for itemsize in (2, 4)]


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("b,c,hw,itemsize", DX_GRID)
def test_dx_design_holds_a_full_wave(b, c, hw, itemsize, noise):
    """256-thread blocks, whose wave (the blocks 132 SMs hold at once) is
    3 a SM with 16-byte units and 8 with units of one value. Without the
    noise fold a thread a unit; the channels a block double from 1 only
    while the grid keeps two waves. With it one cluster of 1-8 ranks covers
    the C channels: the threads that share a unit (lanes) double up to a
    warp only while the grid misses a wave or a thread walks more than 16
    channels; the ranks double only while the grid misses a wave, once the
    lanes are a warp (or one channel each), and only while each lane keeps
    a channel; then the lanes double on only while the grid misses a wave.
    Either way the grid holds a full wave wherever the map allows one."""
    vec, lanes, group, cluster = ba.dx_design(b, c, hw, itemsize, noise=noise)
    assert vec == (hw * itemsize % 16 == 0)
    tile, wave = 256, 132 * (3 if vec else 8)
    assert ba.dx_wave(vec) == wave
    blocks = lambda l, g: math.prod(ba.dx_blocks(b, c, hw, itemsize, vec, l, g, cluster))
    units = b * (hw // (16 // itemsize if vec else 1))
    if not noise:
        assert (lanes, cluster) == (1, 1) and group == _pow2_ceil(group) and group <= _pow2_ceil(c)
        if group > 1:
            assert blocks(1, group) >= 2 * wave
        if group < c:
            assert blocks(1, 2 * group) < 2 * wave
        assert blocks(1, group) >= wave or group == 1
        return
    ranks = min(8, _pow2_ceil(c))
    assert cluster == _pow2_ceil(cluster) <= ranks and group == -(-c // cluster)
    assert lanes == _pow2_ceil(lanes) <= min(tile, _pow2_ceil(group))
    grid = lambda l, r: math.prod(ba.dx_blocks(b, c, hw, itemsize, vec, l, -(-c // r), r))
    assert ba.dx_blocks(b, c, hw, itemsize, vec, lanes, group, cluster)[1] == cluster
    if cluster > 1:
        assert lanes >= min(32, _pow2_ceil(c)) and grid(lanes, cluster // 2) < wave
    if 1 < lanes <= 32 and cluster == 1:
        assert grid(lanes // 2, 1) < wave or -(-c // (lanes // 2)) > 16
    if lanes > 32:
        assert grid(lanes // 2, cluster) < wave
    if grid(lanes, cluster) < wave:
        assert cluster == ranks or -(-c // (2 * cluster)) < lanes
        assert lanes == min(tile, _pow2_ceil(group))


def test_dx_design_fills_the_card_at_every_packed_map():
    """At every packed map, in both dtypes, with and without the noise
    fold, the grid holds at least one full wave of blocks."""
    for (b, c, hw, itemsize, noise), (vec, lanes, group, cluster) in DX_CASES.items():
        grid = math.prod(ba.dx_blocks(b, c, hw, itemsize, vec, lanes, group, cluster))
        assert grid >= ba.dx_wave(vec), (b, c, hw, itemsize, noise)


def test_dx_design_takes_units_of_one_value_off_a_16_byte_boundary():
    for noise in (False, True):
        assert not ba.dx_design(64, 128, 1024, 2, aligned=False, noise=noise)[0]
        assert not ba.dx_design(64, 192, 100, 2, noise=noise)[0]
    assert ba.dx_design(64, 128, 1024, 2, aligned=False, noise=True) == (False, 8, 128, 1)
    assert ba.dx_design(64, 192, 100, 2, noise=True) == (False, 32, 96, 2)


def _shuffle_down(vals, per_block):
    """A warp's lanes after ``for (off = 16; off >= U; off >>= 1) v +=
    __shfl_down_sync(~0, v, off)``: each value a tuple of the leaves of its
    sum in left-to-right order; a lane whose source is past the warp reads
    its own value."""
    off = 16
    while off >= per_block:
        vals = [vals[l] + vals[l + off if l + off < 32 else l] for l in range(32)]
        off //= 2
    return vals


def _dx_emulate(b, c, hw, itemsize, vec, lanes, group, cluster, cl, noise, tile=256):
    """bn_bwd_dx_kernel's index arithmetic and sums: ({(item, channel,
    position): dx writes}, {(side, item, position): [the leaves of each
    write of dn_l (side 0) or dn_g, as (rank, channel) in summation
    order]})."""
    per = _unit(itemsize, vec)
    units = hw // per
    per_block = tile // lanes
    tiles, groups = ba.dx_blocks(b, c, hw, itemsize, vec, lanes, group, cluster)
    chans_per = -(-group // lanes)
    row_threads = max(per_block, 32)
    writes, dn = {}, {}
    for tile_index in range(tiles):
        parts = []
        for rank in range(groups):
            c0 = rank * group
            n_ch = max(0, min(c, c0 + group) - c0)
            # per thread and side, a tuple of leaves per value of its unit
            sums = {}
            for t in range(tile):
                j, lane = t % per_block, t // per_block
                q = tile_index * per_block + j
                k0 = min(n_ch, lane * chans_per)
                k1 = min(n_ch, k0 + chans_per)
                kc = min(max(cl - c0, k0), k1)
                for side, (ka, kb) in enumerate([(k0, kc), (kc, k1)]):
                    acc = [() for _ in range(per)]
                    if q < b * units:
                        item, pos = q // units, (q % units) * per
                        for k in range(ka, kb):
                            for i in range(per):
                                key = (item, c0 + k, pos + i)
                                writes[key] = writes.get(key, 0) + 1
                                acc[i] += ((rank, c0 + k),)
                    sums[t, side] = acc
            if not noise:
                continue
            n = 2 * per * per_block
            part = [None] * n
            if lanes == 1:
                for (t, side), acc in sums.items():
                    for i in range(per):
                        part[(side * per + i) * per_block + t] = acc[i]
            else:
                rows = {}
                for side in (0, 1):
                    for i in range(per):
                        for w in range(tile // 32):
                            warp = _shuffle_down([sums[w * 32 + l, side][i] for l in range(32)],
                                                 per_block)
                            for l in range(min(per_block, 32)):
                                t = w * 32 + l
                                rows[((t // row_threads * 2 + side) * per + i) * per_block
                                     + t % per_block] = warp[l]
                for p in range(n):
                    part[p] = sum((rows[r * n + p] for r in range(tile // row_threads)), ())
            parts.append(part)
        if not noise:
            continue
        n = 2 * per * per_block
        share = -(-n // groups)
        for rank in range(groups):
            for p in range(rank * share, min(n, rank * share + share)):
                v, ju = divmod(p, per_block)
                pos = (tile_index * per_block + ju) * per + v % per
                if pos < b * hw:
                    item, at = divmod(pos, hw)
                    dn.setdefault((v // per, item, at), []).append(
                        sum((parts[r][p] for r in range(groups)), ()))
    return writes, dn


# (B, C, H*W, itemsize, cl) and forced launches (lanes, group, cluster)
# beside the rule's: groups that straddle cl, cl = 0 and cl = C, ragged
# tiles and ragged lanes, C below the cluster's ranks, planes of 200 bytes
# in bf16 (units of one value); lanes of whole warps (U >= 32) and lanes
# inside a warp (U < 32).
DX_TILING_SHAPES = [(2, 7, 16, 2, 3), (3, 12, 24, 4, 5), (1, 5, 8, 2, 0), (2, 6, 100, 2, 6),
                    (4, 9, 40, 4, 9), (2, 3, 100, 2, 1)]
DX_LAUNCHES = ["rule", (1, 2, 4), (4, 3, 4), (2, 5, 2), (16, 2, 8), (64, 3, 2),
               (128, 3, 1)]


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("launch", DX_LAUNCHES, ids=str)
@pytest.mark.parametrize("b,c,hw,itemsize,cl", DX_TILING_SHAPES)
def test_dx_tiling_writes_every_element_once_and_sums_dn_in_rank_order(
        b, c, hw, itemsize, cl, launch, noise):
    vec = ba.dx_design(b, c, hw, itemsize, noise=noise)[0]
    if launch == "rule":
        lanes, group, cluster = ba.dx_design(b, c, hw, itemsize, noise=noise)[1:]
    else:
        lanes, group, cluster = launch
        if not noise:
            cluster = 1
        elif cluster * group < c:
            group = -(-c // cluster)
    writes, dn = _dx_emulate(b, c, hw, itemsize, vec, lanes, group, cluster, cl, noise)
    assert set(writes) == {(i, ch, p) for i in range(b) for ch in range(c) for p in range(hw)}
    assert set(writes.values()) == {1}
    if not noise:
        assert dn == {}
        return
    assert set(dn) == {(side, i, p) for side in (0, 1) for i in range(b) for p in range(hw)}
    for (side, _, _), sums in dn.items():
        assert len(sums) == 1  # written once
        leaves = sums[0]
        chans = sorted(ch for _, ch in leaves)
        assert chans == (list(range(cl)) if side == 0 else list(range(cl, c)))
        ranks = [r for r, _ in leaves]
        assert ranks == sorted(ranks)
        assert all(ch // group == r for r, ch in leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noise", [False, True])
def test_dx_runs_its_plain_version_on_the_cpu(noise, dtype):
    (x, mean, var, scale, bias, *_), (_, gy, *_) = _args(noise, dtype)
    g = torch.Generator().manual_seed(5)
    s1, s2, g_mean, g_var, wn = (torch.randn(x.shape[1], generator=g) for _ in range(5))
    args = (x, gy, mean, var, scale, bias, s1, s2, g_mean, g_var) + ((wn, 4) if noise else ())
    before = ba.bn_bwd_dx.launches
    outs, refs = ba.bn_bwd_dx(*args), ba.bn_bwd_dx_plain(*args)
    outs, refs = (t if isinstance(t, tuple) else (t,) for t in (outs, refs))
    assert len(outs) == len(refs) == (3 if noise else 1)
    for ours, ref in zip(outs, refs):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    assert ba.bn_bwd_dx.launches == before
