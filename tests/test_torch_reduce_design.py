"""The fixed launch rules of the port's two reduction kernels, and the
callers' reduce entry, on the CPU.

``fourier_unit.reduce_design`` picks ``fu_reduce``'s load width and
cluster size from the partial sums' shape, ``bn_act.stats_design``
``bn_stats``'s from the map's; both are pure functions, checked here at
the shapes the 32px and 128px training steps give them. The callers'
entry ``fourier_unit._reduce`` takes the plain version on the CPU.
"""

from __future__ import annotations

import pytest
import torch

from fastfourierconvolution_tpu_torch.ops import bn_act as ba
from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

# (rows, cols, moments) -> (vec, cluster). 32px: (B, 4C) statistics and
# backward sums, (B, 4C^2) gK; 128px: (B * chunks, 4C) and (B * chunks,
# 4C^2) after the staged stages; narrow (rows, 3C) sums, the shapes the BN
# backward reduce gave it before it summed its own channels; an odd column
# count.
REDUCE_CASES = {
    (64, 64, True): (4, 4), (64, 64, False): (4, 4), (64, 1024, False): (4, 4),
    (64, 32, True): (4, 4), (64, 256, False): (4, 4),
    (192, 256, True): (4, 8), (192, 256, False): (4, 8), (192, 16384, False): (4, 1),
    (512, 128, True): (4, 8), (512, 128, False): (4, 8), (512, 4096, False): (4, 4),
    (1, 1536, False): (4, 1), (4, 768, False): (4, 1), (16, 384, False): (4, 1),
    (64, 384, False): (4, 4), (256, 384, False): (4, 8), (37, 1001, False): (1, 2),
}


@pytest.mark.parametrize("shape,design", list(REDUCE_CASES.items()))
def test_reduce_design_at_the_main_path_shapes(shape, design):
    assert fu.reduce_design(*shape) == design


@pytest.mark.parametrize("rows,cols,moments", list(REDUCE_CASES))
def test_reduce_design_fills_the_card_within_its_limits(rows, cols, moments):
    """float4 loads exactly where the reduced width is a multiple of 4; a
    cluster of 1-8 blocks, a power of two, that grows only while the tiles
    times twice the cluster fit 132 SMs and each block keeps 16 rows."""
    vec, cluster = fu.reduce_design(rows, cols, moments)
    n = cols // 2 if moments else cols
    assert vec == (4 if n % 4 == 0 else 1)
    assert cluster in (1, 2, 4, 8)
    tiles = -(-n // (32 * vec))
    if cluster > 1:
        assert tiles * cluster <= 132 and rows >= cluster * 16
    if cluster < 8:
        assert tiles * cluster * 2 > 132 or rows < 2 * cluster * 16


def test_reduce_design_takes_scalar_loads_off_a_16_byte_boundary():
    assert fu.reduce_design(64, 128, False, aligned=False) == (1, 4)


# (B, C, H*W, itemsize) -> (vec, cluster): the 128px generator's five packed
# maps in bf16 and f32, the gpu test's map, and planes of 200 bytes in bf16.
STATS_CASES = {
    (64, 512, 64, 2): (True, 1), (64, 256, 256, 2): (True, 2), (64, 128, 1024, 2): (True, 8),
    (64, 128, 4096, 2): (True, 8), (64, 128, 16384, 2): (True, 8),
    (64, 512, 64, 4): (True, 1), (64, 128, 16384, 4): (True, 8),
    (8, 256, 256, 2): (True, 1), (64, 192, 100, 2): (False, 1), (64, 192, 100, 4): (True, 1),
}


@pytest.mark.parametrize("shape,design", list(STATS_CASES.items()))
def test_stats_design_at_the_packed_maps(shape, design):
    assert ba.stats_design(*shape) == design


@pytest.mark.parametrize("b,c,hw,itemsize", list(STATS_CASES))
def test_stats_design_keeps_every_block_resident_and_busy(b, c, hw, itemsize):
    """16-byte loads exactly where a plane is a whole number of 16 bytes; a
    cluster per channel of 1-8 blocks that grows only while all blocks fit
    the card at once (132 SMs x 8), each keeps 8192 elements and a plane."""
    vec, cluster = ba.stats_design(b, c, hw, itemsize)
    assert vec == (hw * itemsize % 16 == 0)
    assert cluster in (1, 2, 4, 8)
    if cluster > 1:
        assert c * cluster <= 1056 and b >= cluster and b * hw >= cluster * 8192
    if cluster < 8:
        assert c * cluster * 2 > 1056 or b < 2 * cluster or b * hw < 2 * cluster * 8192


def test_stats_design_takes_scalar_loads_off_a_16_byte_boundary():
    assert ba.stats_design(64, 128, 1024, 2, aligned=False) == (False, 8)


@pytest.mark.parametrize("count", [0, 37 * 9])
def test_callers_reduce_entry_is_the_plain_version_on_the_cpu(count):
    """The callers' entry, like the public wrapper, sums on the CPU with the
    plain version: the same values, and no launch counted."""
    partial = torch.randn(37, 20, generator=torch.Generator().manual_seed(0))
    before = fu.fu_reduce.launches
    torch.testing.assert_close(fu._reduce(partial, count), fu.fu_reduce_plain(partial, count),
                               rtol=0, atol=0)
    torch.testing.assert_close(fu._reduce(partial, count), fu.fu_reduce(partial, count),
                               rtol=0, atol=0)
    assert fu.fu_reduce.launches == before


def test_bn_stats_on_the_cpu_is_the_plain_version():
    x = torch.randn(4, 6, 5, 5, generator=torch.Generator().manual_seed(1)).bfloat16()
    before = ba.bn_stats.launches
    for ours, ref in zip(ba.bn_stats(x), ba.bn_stats_plain(x)):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    assert ba.bn_stats.launches == before
