"""The clustered per-item FourierUnit kernels' launch rule and index
arithmetic, on the CPU.

``fourier_unit.item_design`` picks the ranks per item of the clustered
forward, statistics, backward sums and backward apply
(csrc/fourier_unit_item.cuh); it is a pure function, checked at every map
that ``kernel_design`` sends to SHARED. The
kernels cannot run here, so their index arithmetic is emulated in numpy,
task by task as the CUDA code walks it (tile sizes read from the header):
every stage's tiles write every output once and read in range, the ranks
own every channel once (and every column of a statistics kernel's partial
row is written once per item), and the emulated kernels, run in f64 through the
same buffers, stage order and tables, agree with ``np.fft`` and with the
plain versions.
"""

from __future__ import annotations

import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu
from fastfourierconvolution_tpu_torch.ops.fourier import forward_factors

H100_SMEM = 232448
CSRC = Path(fu.__file__).resolve().parents[1] / "csrc"
TILE = {k: int(v) for k, v in re.findall(r"\b(k[A-Z][A-Za-z]*) = (\d+)",
                                         (CSRC / "fourier_unit_item.cuh").read_text())}
THREADS = TILE["kItemThreads"]

# (C, H, W) -> kernel_design of the forward, the backward apply and the
# statistics at 227 KB, at every FourierUnit map of the 32-256px generators.
# (8, 48, 48)'s backward apply and statistics were "workspace" while the rule
# read only the one-block plan (259,940 B); they fit on clusters of 2 ranks
# (221,348 B a rank), so they are "shared". Every other answer is the one-block
# rule's (``one_block_design``).
DESIGNS = {
    (16, 16, 16): ("shared", "shared", "shared"),
    (8, 32, 32): ("shared", "shared", "shared"),
    (16, 24, 24): ("shared", "shared", "shared"),
    (8, 48, 48): ("shared", "shared", "shared"),
    (8, 64, 64): ("staged", "staged", "staged"),
    (8, 96, 96): ("workspace", "workspace", "workspace"),
    (64, 16, 16): ("shared", "staged", "staged"),
    (32, 32, 32): ("staged", "staged", "staged"),
    (32, 64, 64): ("staged", "staged", "staged"),
    (32, 128, 128): ("staged", "staged", "staged"),
    (32, 256, 256): ("workspace", "workspace", "workspace"),
}
SHARED_MAPS = [m for m, d in DESIGNS.items() if "shared" in d[:2]]
# (B, C, H, W) -> ranks per item: batch 64 takes 2 (128 blocks make one wave
# on the H100's 132 SMs, 4 ranks' 256 two), batches 1 and 7 the most, 8.
ITEM_DESIGNS = {(b,) + m: (2 if b == 64 else 8) for m in SHARED_MAPS for b in (1, 7, 64)}


@pytest.mark.parametrize("cmap", list(DESIGNS))
def test_kernel_design_answers_do_not_move(cmap):
    got = tuple(fu.kernel_design(k, *cmap, H100_SMEM) for k in ("forward", "bwd_apply", "stats"))
    assert got == DESIGNS[cmap]


def one_block_design(wrapper, c, h, w, smem_limit):
    """The design rule before it read the per-rank plans: SHARED where the
    one-block plan fits, else STAGED where the staged kernels take the map,
    else WORKSPACE."""
    if fu._item_floats(fu._DESIGN_STEMS[wrapper], c, h, w) * 4 <= smem_limit:
        return "shared"
    pow2 = lambda v: v >= 4 and v & (v - 1) == 0
    if (pow2(h) and pow2(w) and 2 * c in (16, 32, 64, 128)
            and fu._staged_smem(c, h, w) <= smem_limit):
        return "staged"
    return "workspace"


# The answers that reading the per-rank plans moved.
MOVED = {("bwd_apply", (8, 48, 48)), ("stats", (8, 48, 48))}


@pytest.mark.parametrize("cmap", list(DESIGNS))
def test_kernel_design_moves_only_the_48px_training_kernels(cmap):
    """Every answer of DESIGNS but (8, 48, 48)'s backward apply and
    statistics is the one-block rule's."""
    for k in ("forward", "bwd_apply", "stats"):
        old = one_block_design(k, *cmap, H100_SMEM)
        if (k, cmap) in MOVED:
            assert (old, fu.kernel_design(k, *cmap, H100_SMEM)) == ("workspace", "shared")
        else:
            assert fu.kernel_design(k, *cmap, H100_SMEM) == old


def _fourier_unit_maps(model, *inputs, **kw):
    """(C, H, W) of every FourierUnit in an eval-mode forward of ``model``
    at batch 1, each FourierUnit replaced by the identity."""
    from fastfourierconvolution_tpu_torch.nn import ffc

    seen = set()

    def identity(self, x, y=None):
        seen.add(tuple(x.shape[1:]))
        return x

    with mock.patch.object(ffc.FourierUnit, "forward", identity), torch.no_grad():
        model.eval()(*inputs, **kw)
    return seen


def _preset_maps(name):
    from fastfourierconvolution_tpu_torch.models.conditional import FFCCondGenerator
    from fastfourierconvolution_tpu_torch.models.ffc_gan import FFCDiscriminator

    if name == "FFCDiscriminator":
        return _fourier_unit_maps(FFCDiscriminator(), torch.zeros(1, 3, 32, 32))
    return _fourier_unit_maps(FFCCondGenerator.for_preset(name), torch.zeros(1, 128),
                              y=torch.zeros(1, dtype=torch.long))


@pytest.mark.parametrize("name,maps", [
    ("cifar32", {(16, 16, 16), (8, 32, 32)}),
    ("stl48", {(16, 24, 24), (8, 48, 48)}),
    ("tex128", {(16, 16, 16), (8, 32, 32), (8, 64, 64), (8, 128, 128)}),
    ("library64", {(16, 16, 16), (8, 32, 32), (8, 64, 64)}),
    ("FFCDiscriminator", {(16, 16, 16), (32, 8, 8)}),
])
def test_kernel_design_keeps_the_presets_maps(name, maps):
    """At every FourierUnit map of the conditional presets and of
    FFCDiscriminator the rule gives the one-block rule's answer, but for
    stl48's (8, 48, 48), whose backward apply and statistics now run
    clustered."""
    assert _preset_maps(name) == maps
    for cmap in maps:
        for k in ("forward", "bwd_apply", "stats"):
            want = "shared" if (k, cmap) in MOVED else one_block_design(k, *cmap, H100_SMEM)
            assert fu.kernel_design(k, *cmap, H100_SMEM) == want


def test_kernel_design_at_the_edges_of_the_48px_rank_plans():
    """(64, 8, 48, 48): at 227 KB 2 ranks (the backward apply's 221,348 B a
    rank); 1 B under that plan, 4 ranks (163,140 B); under every rank plan
    of the backward apply (134,036 B at 8 ranks) the training kernels take
    the workspace while the forward runs clustered on 8 ranks (124,292 B),
    and under every plan of every kernel all three take the workspace."""
    assert fu.item_design(64, 8, 48, 48, H100_SMEM) == 2
    assert fu._item_rank_floats("bwd_apply", 8, 48, 48, 2) * 4 == 221348
    limit = 221348 - 1
    assert all(fu.kernel_design(k, 8, 48, 48, limit) == "shared"
               for k in ("forward", "bwd_apply", "stats"))
    assert fu.item_design(64, 8, 48, 48, limit) == 4
    limit = fu._item_rank_floats("bwd_apply", 8, 48, 48, 8) * 4 - 1
    assert [fu.kernel_design(k, 8, 48, 48, limit) for k in ("forward", "bwd_apply", "stats")] == [
        "shared", "workspace", "workspace"]
    assert fu.item_design(64, 8, 48, 48, limit) == 8
    limit = fu._item_rank_floats("train_stats", 8, 48, 48, 8) * 4 - 1
    assert all(fu.kernel_design(k, 8, 48, 48, limit) == "workspace"
               for k in ("forward", "bwd_apply", "stats"))


def _shared_kernels(cmap):
    return [k for k in ("forward", "bwd_apply", "stats")
            if fu.kernel_design(k, *cmap, H100_SMEM) == "shared"]


@pytest.mark.parametrize("shape", list(ITEM_DESIGNS))
def test_item_design_at_the_shared_maps(shape):
    """The rule's ranks at every SHARED map and batch 1, 7, 64; each rank's
    plan of every kernel that runs there within the H100's 232,448 B."""
    b, c, h, w = shape
    ranks = fu.item_design(b, c, h, w, H100_SMEM)
    assert ranks == ITEM_DESIGNS[shape] and c % ranks == 0
    for kernel in _shared_kernels((c, h, w)):
        assert fu._item_rank_floats(kernel, c, h, w, ranks) * 4 <= H100_SMEM


@pytest.mark.parametrize("cmap", SHARED_MAPS)
def test_item_plans_shrink_with_the_ranks_and_fit_where_the_old_plan_fit(cmap):
    """One rank's plan at R = 1 is no larger than the per-item plan that
    kernel_design reads (the forward's; the backward's up to its second
    slice of K; the statistics' and backward sums' within it), and falls as
    R grows; the statistics' pair ("stats", what item_design checks) is
    the larger of the two statistics plans, both within the backward
    apply's."""
    c, h, w = cmap
    assert fu._item_rank_floats("forward", c, h, w, 1) <= fu._item_floats(fu._FWD, c, h, w)
    assert (fu._item_rank_floats("bwd_apply", c, h, w, 1)
            <= fu._item_floats(fu._TRAIN, c, h, w) + 4 * c * c)
    for kernel in ("train_stats", "bwd_stats"):
        assert fu._item_rank_floats(kernel, c, h, w, 1) <= fu._item_floats(fu._TRAIN, c, h, w)
    for r in (1, 2, 4, 8):
        if c % r == 0:
            pair = [fu._item_rank_floats(k, c, h, w, r) for k in ("train_stats", "bwd_stats")]
            assert fu._item_rank_floats("stats", c, h, w, r) == max(pair)
            assert max(pair) <= fu._item_rank_floats("bwd_apply", c, h, w, r)
    for kernel in ("forward", "bwd_apply", "train_stats", "bwd_stats", "stats"):
        sizes = [fu._item_rank_floats(kernel, c, h, w, r) for r in (1, 2, 4, 8) if c % r == 0]
        assert sizes == sorted(sizes, reverse=True)


def test_item_design_takes_more_ranks_where_one_rank_does_not_fit():
    """At a limit equal to the parent's backward plan of (16, 16, 16), one
    rank of the backward (which holds a second slice of K) does not fit, so
    the rule takes 2 ranks even at a batch that covers the SMs. A backward
    map of odd C, whose only cluster is one rank, fits no cluster at such a
    limit: the rule raises."""
    limit = fu._item_floats(fu._TRAIN, 16, 16, 16) * 4
    assert fu.kernel_design("bwd_apply", 16, 16, 16, limit) == "shared"
    assert fu._item_rank_floats("bwd_apply", 16, 16, 16, 1) * 4 > limit
    assert fu.item_design(256, 16, 16, 16, limit) == 2
    limit = fu._item_floats(fu._TRAIN, 3, 16, 16) * 4
    assert fu.kernel_design("bwd_apply", 3, 16, 16, limit) == "shared"
    with pytest.raises(ValueError, match="no cluster"):
        fu.item_design(64, 3, 16, 16, limit)


# --- a numpy emulation of csrc/fourier_unit_item.cuh ---------------------------


def cdiv(a, b):
    return -(-a // b)


class Rank:
    """``ItemRank``: one rank's geometry."""

    def __init__(self, c, h, w, r):
        self.C, self.H, self.W, self.R = c, h, w, r
        self.wf, self.cr, self.wp = w // 2 + 1, c // r, w | 1
        self.hwf = h * self.wf
        self.ns = self.cr * self.hwf
        self.buf = (2 * self.ns + 3) & ~3

    def channel(self, dl, rank):
        return dl // self.cr * self.C + rank * self.cr + dl % self.cr

    def half_weight(self, v):
        return np.where((v == 0) | ((self.W % 2 == 0) & (v == self.wf - 1)), 1.0, 2.0)

    def gk_chunks(self):
        tiles = cdiv(2 * self.cr, TILE["kGJ"]) * cdiv(2 * self.C, TILE["kGE"])
        return max(1, min(self.hwf // (2 * self.C), THREADS // tiles))


class Writes:
    """Records the flat indices a stage writes, to check that its tiles
    cover every output exactly once."""

    def __init__(self):
        self.index = []

    def __call__(self, out, idx, val):
        out[idx] = val
        self.index.append(np.asarray(idx).ravel())

    def once(self, n):
        idx = np.concatenate(self.index) if self.index else np.zeros(0, int)
        return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


def tables(h, w):
    ah, bh, cw, dw = (m.astype(np.float64) for m in forward_factors(h, w))
    return {"cw": cw.ravel(), "dw": dw.ravel(), "ah": ah.ravel(), "bh": bh.ravel()}


def read(buf, idx, n):
    """buf[idx] after checking that every index lies in [0, n)."""
    assert idx.min() >= 0 and idx.max() < n
    return buf[idx]


def tile_rows(tasks_with_small_tiles):
    """``small_rows``: the rows of a stage's tiles."""
    small = tasks_with_small_tiles <= THREADS
    return TILE["kRowsSmall"] if small else TILE["kRowsLarge"]


def dft_w(k, t, src, dst, rec):
    rows, nv = k.cr * k.H, cdiv(k.wf, TILE["kWV"])
    kr = tile_rows(nv * cdiv(rows, TILE["kRowsSmall"]))
    task = np.arange(nv * cdiv(rows, kr))
    vt, r0 = task % nv, task // nv * kr
    v = [np.minimum(vt + b * nv, k.wf - 1) for b in range(TILE["kWV"])]
    x = [np.minimum(r0 + a, rows - 1) * k.wp for a in range(kr)]
    for a in range(kr):
        for b in range(TILE["kWV"]):
            re = sum(read(src, x[a] + q, k.buf) * read(t["cw"], q * k.wf + v[b], t["cw"].size)
                     for q in range(k.W))
            im = sum(read(src, x[a] + q, k.buf) * t["dw"][q * k.wf + v[b]] for q in range(k.W))
            r, c = r0 + a, vt + b * nv
            ok = (r < rows) & (c < k.wf)
            rec(dst, (r * k.wf + c)[ok], re[ok])
            rec(dst, (k.ns + r * k.wf + c)[ok], im[ok])


def dft_h(k, t, src, dst, inverse, rec):
    nv = cdiv(k.wf, TILE["kHV"])
    kr = tile_rows(nv * cdiv(k.H, TILE["kRowsSmall"]) * k.cr)
    nu = cdiv(k.H, kr)
    task = np.arange(nv * nu * k.cr)
    vt, rest = task % nv, task // nv
    u0, c = rest % nu * kr, rest // nu
    v = [np.minimum(vt + b * nv, k.wf - 1) for b in range(TILE["kHV"])]
    u = [np.minimum(u0 + a, k.H - 1) for a in range(kr)]
    sign = -1.0 if inverse else 1.0
    for a in range(kr):
        for b in range(TILE["kHV"]):
            re = im = 0.0
            for h in range(k.H):
                ca = read(t["ah"], h * k.H + u[a], k.H * k.H)
                sb = sign * t["bh"][h * k.H + u[a]]
                pr = read(src, c * k.hwf + h * k.wf + v[b], k.buf)
                pi = read(src, k.ns + c * k.hwf + h * k.wf + v[b], k.buf)
                re, im = re + ca * pr - sb * pi, im + ca * pi + sb * pr
            uu, vv = u0 + a, vt + b * nv
            ok = (uu < k.H) & (vv < k.wf)
            o = (c * k.hwf + uu * k.wf + vv)[ok]
            rec(dst, o, re[ok])
            rec(dst, k.ns + o, im[ok])


def idft_w(k, t, src, dst, rec):
    rows, nq = k.cr * k.H, cdiv(k.W, TILE["kIQ"])
    kr = tile_rows(nq * cdiv(rows, TILE["kRowsSmall"]))
    task = np.arange(nq * cdiv(rows, kr))
    qt, r0 = task % nq, task // nq * kr
    for a in range(kr):
        p = np.minimum(r0 + a, rows - 1) * k.wf
        for b in range(TILE["kIQ"]):
            q = np.minimum(qt + b * nq, k.W - 1)
            acc = sum(read(src, p + v, k.buf) * t["cw"][q * k.wf + v]
                      + read(src, p + k.ns + v, k.buf) * t["dw"][q * k.wf + v]
                      for v in range(k.wf))
            r, qq = r0 + a, qt + b * nq
            ok = (r < rows) & (qq < k.W)
            rec(dst, (r * k.W + qq)[ok], acc[ok])


def cluster_gather(k, srcs, rec):
    """The item's 2C planes in item order from the ranks' buffers: run r =
    half * R + q is rank q's planes of one half, copied as whole 16-byte
    units where a run is a multiple of them."""
    if k.R == 1:
        return srcs[0]
    full = np.zeros(2 * k.C * k.hwf)
    unit = 4 if k.ns % 4 == 0 else 1
    runlen = k.ns // unit
    i = np.arange(2 * k.R * runlen)
    run = i // runlen
    q, half = run % k.R, run // k.R
    for e in range(unit):
        src = half * k.ns + (i - run * runlen) * unit + e
        vals = np.stack(srcs)[q, src]
        assert src.max() < k.buf
        rec(full, i * unit + e, vals)
    return full


def item_mix(k, full, kslice, epi):
    """Calls epi(dl, s, value) for every task's valid outputs."""
    c2r, nst = 2 * k.cr, cdiv(k.hwf, TILE["kMS"])
    kr = tile_rows(nst * cdiv(c2r, TILE["kRowsSmall"]))
    task = np.arange(nst * cdiv(c2r, kr))
    st, d0 = task % nst, task // nst * kr
    for a in range(kr):
        dl = np.minimum(d0 + a, c2r - 1)
        for b in range(TILE["kMS"]):
            s = np.minimum(st + b * nst, k.hwf - 1)
            acc = sum(read(full, j * k.hwf + s, 2 * k.C * k.hwf)
                      * read(kslice, j * c2r + dl, 2 * k.C * c2r) for j in range(2 * k.C))
            ok = (d0 + a < c2r) & (st + b * nst < k.hwf)
            epi((d0 + a)[ok], (st + b * nst)[ok], acc[ok])


def item_gk(k, z, gm, rank, gk, rec):
    c2, c2r, P = 2 * k.C, 2 * k.cr, k.gk_chunks()
    ne = cdiv(c2, TILE["kGE"])
    task = np.arange(P * ne * cdiv(c2r, TILE["kGJ"]))
    p, rest = task % P, task // P
    e0, j0 = rest % ne * TILE["kGE"], rest // ne * TILE["kGJ"]
    part = np.zeros(max(k.buf, 1))
    part_rec = Writes()
    assert P == 1 or P * c2r * c2 <= k.buf
    for a in range(TILE["kGJ"]):
        zr = np.minimum(j0 + a, c2r - 1) * k.hwf
        for b in range(TILE["kGE"]):
            gr = np.minimum(e0 + b, c2 - 1) * k.hwf
            acc = np.zeros(task.size)
            for i in range(cdiv(k.hwf, P)):
                s = p + i * P
                live = s < k.hwf
                sc = np.minimum(s, k.hwf - 1)
                acc = acc + np.where(live, read(z, zr + sc, k.buf)
                                     * read(gm, gr + sc, 2 * k.C * k.hwf), 0.0)
            jl, ee = j0 + a, e0 + b
            ok = (jl < c2r) & (ee < c2)
            if P == 1:
                rec(gk, (k.channel(jl, rank) * c2 + ee)[ok], acc[ok])
            else:
                part_rec(part, ((jl * c2 + ee) * P + p)[ok], acc[ok])
    if P > 1:
        assert part_rec.once(c2r * c2 * P)
        i = np.arange(c2r * c2)
        rec(gk, k.channel(i // c2, rank) * c2 + i % c2,
            part[: c2r * c2 * P].reshape(c2r * c2, P).sum(axis=1))


WARPS = THREADS // 32


def channel_sums(k, terms, rank, row, rec):
    """``item_channel_sums`` with ``write_sums``: warp w takes the local
    channels dl = w, w + WARPS, ...; its lanes sum the (n, 2) terms of the
    flat indices dl * H * Wf + s over s = lane, lane + 32, ..., then the
    shuffle tree (``warp_sum``: a lane whose source lies beyond the warp
    adds its own value) leaves the pair in lane 0, which goes to
    row[channel] and row[2C + channel]."""
    for w in range(WARPS):
        for dl in range(w, 2 * k.cr, WARPS):
            lanes = np.zeros((32, 2))
            for lane in range(32):
                s = np.arange(lane, k.hwf, 32)
                lanes[lane] = terms(dl * k.hwf + s).sum(axis=0) if s.size else 0.0
            for off in (16, 8, 4, 2, 1):
                src = np.arange(32) + off
                lanes = lanes + lanes[np.where(src < 32, src, np.arange(32))]
            d = k.channel(dl, rank)
            rec(row, np.array([d, 2 * k.C + d]), lanes[0])


def load_kslice(k, kmix, rank, columns):
    c2, c2r = 2 * k.C, 2 * k.cr
    i = np.arange(c2 * c2r)
    outer, local = i // c2r, k.channel(i % c2r, rank)
    return kmix.ravel()[outer * c2 + local if columns else local * c2 + outer]


def load_planes(k, x_item, rank):
    buf = np.zeros(k.buf)
    i = np.arange(k.cr * k.H * k.W)
    row = i // k.W
    buf[row * k.wp + i - row * k.W] = x_item[rank * k.cr:(rank + 1) * k.cr].ravel()
    return buf


def emulate_forward(x, kmix, scale, bias, mean, var, ranks, rec=None):
    """fu_item_fwd_kernel on (B, C, H, W) f64 numpy operands."""
    b_, c, h, w = x.shape
    k, t = Rank(c, h, w, ranks), tables(h, w)
    rec = rec or Writes()
    y = np.zeros(x.size)
    for item in range(b_):
        a = [load_planes(k, x[item], r) for r in range(ranks)]
        bufs = [np.zeros(k.buf) for _ in range(ranks)]
        for r in range(ranks):
            dft_w(k, t, a[r], bufs[r], rec)
            dft_h(k, t, bufs[r], a[r], False, rec)
        for r in range(ranks):
            kc = load_kslice(k, kmix, r, True)
            d = k.channel(np.arange(2 * k.cr), r)
            inv = 1 / np.sqrt(var[d] + fu.EPS)

            def epi(dl, s, m, r=r, d=d, inv=inv):
                pre = (m - mean[d][dl]) * inv[dl] * scale[d][dl] + bias[d][dl]
                rec(bufs[r], dl * k.hwf + s, np.maximum(pre, 0) * k.half_weight(s % k.wf))

            item_mix(k, cluster_gather(k, a, rec), kc, epi)
        for r in range(ranks):
            dft_h(k, t, bufs[r], a[r], True, rec)
            planes = (item * c + r * k.cr) * h * w
            out = np.zeros(k.cr * h * w)
            idft_w(k, t, a[r], out, rec)
            y[planes:planes + out.size] = out
    return y.reshape(x.shape)


def emulate_bwd_apply(x, gy, kmix, scale, bias, mean, var, gscale, gbias, ranks):
    """fu_item_bwd_apply_kernel: (gx, gK summed over the batch)."""
    b_, c, h, w = x.shape
    k, t, rec = Rank(c, h, w, ranks), tables(h, w), Writes()
    gx, gk_rows = np.zeros(x.size), np.zeros((b_, 4 * c * c))
    count = b_ * k.hwf
    for item in range(b_):
        a = [load_planes(k, x[item], r) for r in range(ranks)]
        g = [np.zeros(k.buf) for _ in range(ranks)]
        z = [np.zeros(k.buf) for _ in range(ranks)]
        for r in range(ranks):
            dft_w(k, t, a[r], g[r], rec)
            dft_h(k, t, g[r], z[r], False, rec)
            a[r] = load_planes(k, gy[item], r)
            dft_w(k, t, a[r], g[r], rec)
            dft_h(k, t, g[r], a[r], False, rec)
        for r in range(ranks):
            d = k.channel(np.arange(2 * k.cr), r)
            inv = 1 / np.sqrt(var[d] + fu.EPS)
            mgn, mgnn = scale[d] * gbias[d] / count, scale[d] * gscale[d] / count

            def epi(dl, s, m, r=r, d=d, inv=inv, mgn=mgn, mgnn=mgnn):
                o = dl * k.hwf + s
                n_hat = (m - mean[d][dl]) * inv[dl]
                pre = n_hat * scale[d][dl] + bias[d][dl]
                gpre = np.where(pre > 0, k.half_weight(s % k.wf) * a[r][o], 0.0)
                gn = gpre * scale[d][dl]
                a[r][o] = inv[dl] * (gn - mgn[dl] - n_hat * mgnn[dl])

            item_mix(k, cluster_gather(k, z, rec), load_kslice(k, kmix, r, True), epi)
        for r in range(ranks):
            gm = cluster_gather(k, a, rec)
            item_gk(k, z[r], gm, r, gk_rows[item], rec)
            item_mix(k, gm, load_kslice(k, kmix, r, False),
                     lambda dl, s, v, r=r: rec(g[r], dl * k.hwf + s, v))
        for r in range(ranks):
            dft_h(k, t, g[r], a[r], True, rec)
            planes = (item * c + r * k.cr) * h * w
            out = np.zeros(k.cr * h * w)
            idft_w(k, t, a[r], out, rec)
            gx[planes:planes + out.size] = out
    return gx.reshape(x.shape), gk_rows.sum(axis=0).reshape(2 * c, 2 * c)


def emulate_train_stats(x, kmix, ranks, rec=None):
    """fu_item_train_stats_kernel: the (B, 4C) partial rows [sum m | sum
    m^2]."""
    b_, c, h, w = x.shape
    k, t = Rank(c, h, w, ranks), tables(h, w)
    rec = rec or Writes()
    rows = np.zeros((b_, 4 * c))
    for item in range(b_):
        a = [load_planes(k, x[item], r) for r in range(ranks)]
        b = [np.zeros(k.buf) for _ in range(ranks)]
        for r in range(ranks):
            dft_w(k, t, a[r], b[r], rec)
            dft_h(k, t, b[r], a[r], False, rec)
        full = cluster_gather(k, a, rec)
        for r in range(ranks):
            item_mix(k, full, load_kslice(k, kmix, r, True),
                     lambda dl, s, m, r=r: rec(b[r], dl * k.hwf + s, m))
            channel_sums(k, lambda o, r=r: np.stack([b[r][o], b[r][o] ** 2], axis=-1), r,
                         rows[item], rec)
    return rows


def emulate_bwd_stats(x, gy, kmix, scale, bias, mean, var, ranks):
    """fu_item_bwd_stats_kernel: the (B, 4C) partial rows [sum gpre * n |
    sum gpre]."""
    b_, c, h, w = x.shape
    k, t, rec = Rank(c, h, w, ranks), tables(h, w), Writes()
    rows = np.zeros((b_, 4 * c))
    for item in range(b_):
        a = [load_planes(k, x[item], r) for r in range(ranks)]
        g = [np.zeros(k.buf) for _ in range(ranks)]
        z = [np.zeros(k.buf) for _ in range(ranks)]
        for r in range(ranks):
            dft_w(k, t, a[r], g[r], rec)
            dft_h(k, t, g[r], z[r], False, rec)
            a[r] = load_planes(k, gy[item], r)
            dft_w(k, t, a[r], g[r], rec)
            dft_h(k, t, g[r], a[r], False, rec)
        full = cluster_gather(k, z, rec)
        for r in range(ranks):
            d = k.channel(np.arange(2 * k.cr), r)
            inv = 1 / np.sqrt(var[d] + fu.EPS)

            def epi(dl, s, m, r=r, d=d, inv=inv):
                o = dl * k.hwf + s
                n_hat = (m - mean[d][dl]) * inv[dl]
                pre = n_hat * scale[d][dl] + bias[d][dl]
                rec(a[r], o, np.where(pre > 0, k.half_weight(s % k.wf) * a[r][o], 0.0))
                rec(g[r], o, n_hat)

            item_mix(k, full, load_kslice(k, kmix, r, True), epi)
            channel_sums(k, lambda o, r=r: np.stack([a[r][o] * g[r][o], a[r][o]], axis=-1),
                         r, rows[item], rec)
    return rows


def _inputs(shape, seed=0):
    b, c, h, w = shape
    rng = np.random.default_rng(seed)
    x, gy = rng.standard_normal(shape), rng.standard_normal(shape)
    kmix = rng.standard_normal((2 * c, 2 * c)) * 0.2
    scale = np.abs(rng.standard_normal(2 * c)) + 0.5
    bias, mean = rng.standard_normal(2 * c) * 0.1, rng.standard_normal(2 * c) * 0.1
    var = np.abs(rng.standard_normal(2 * c)) + 0.5
    return x, gy, kmix, scale, bias, mean, var


# Maps of odd and uneven sizes, which take the stages' unaligned loads and
# clamped tiles: H % 4 != 0, odd W, odd C.
ODD_MAPS = [(6, 10, 14), (4, 12, 9), (3, 5, 7)]
# Per map, the cluster sizes emulated: every R the rule can pick there.
EMULATED = [(m, r) for m in SHARED_MAPS + ODD_MAPS for r in (1, 2, 4, 8) if m[0] % r == 0]


@pytest.mark.parametrize("cmap,ranks", EMULATED)
def test_item_stages_cover_every_output_once(cmap, ranks):
    """Each stage's tiles, walked as the kernel walks them, write every
    output of the rank exactly once, and every read lies in its buffer; the
    ranks own every map channel and spectral channel once."""
    c, h, w = cmap
    k, t = Rank(c, h, w, ranks), tables(h, w)
    src = np.random.default_rng(1).standard_normal(k.buf)
    for stage, n in ((lambda rec: dft_w(k, t, src, np.zeros(k.buf), rec), 2 * k.ns),
                     (lambda rec: dft_h(k, t, src, np.zeros(k.buf), False, rec), 2 * k.ns),
                     (lambda rec: idft_w(k, t, src, np.zeros(k.cr * h * w), rec), k.cr * h * w)):
        rec = Writes()
        stage(rec)
        assert rec.once(n)
    rec = Writes()
    full = cluster_gather(k, [src] * ranks, rec)
    assert ranks == 1 or rec.once(2 * c * k.hwf)
    rec = Writes()
    out = np.zeros(2 * k.ns)
    item_mix(k, full, np.zeros(4 * c * k.cr), lambda dl, s, v: rec(out, dl * k.hwf + s, v))
    assert rec.once(2 * k.ns)
    rec, gk = Writes(), np.zeros(4 * c * c)
    for r in range(ranks):
        item_gk(k, src, full, r, gk, rec)
    assert rec.once(4 * c * c)
    channels = np.concatenate([k.channel(np.arange(2 * k.cr), r) for r in range(ranks)])
    assert sorted(channels) == list(range(2 * c))


@pytest.mark.parametrize("cmap", SHARED_MAPS + ODD_MAPS)
def test_item_transform_stages_match_np_fft(cmap):
    """The W-stage then the H-stage, on the kernel's buffers and tables, is
    np.fft.rfft2 (ortho); the inverse H-stage then the inverse W-stage is
    its adjoint (for Re of a spectrum without the half-spectrum weights)."""
    c, h, w = cmap
    k, t = Rank(c, h, w, 2 if c % 2 == 0 else 1), tables(h, w)
    x = np.random.default_rng(2).standard_normal((k.C, h, w))
    buf, spec, z = load_planes(k, x, 0), np.zeros(k.buf), np.zeros(k.buf)
    dft_w(k, t, buf, spec, Writes())
    dft_h(k, t, spec, z, False, Writes())
    ref = np.fft.rfft2(x[: k.cr], norm="ortho")
    got = z[: k.ns].reshape(ref.shape) + 1j * z[k.ns: 2 * k.ns].reshape(ref.shape)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    back, y = np.zeros(k.buf), np.zeros(k.cr * h * w)
    dft_h(k, t, z, back, True, Writes())
    idft_w(k, t, back, y, Writes())
    # the adjoint of rfft2 (no weights) applied to rfft2(x) is x weighted by
    # the half-spectrum duplication: compare with the plain version's
    ref_y = fu.rfft2_ortho_adjoint(*(torch.from_numpy(v) for v in (ref.real, ref.imag)), (h, w))
    assert np.abs(y - ref_y.numpy().ravel()).max() <= 1e-6 * np.abs(ref_y.numpy()).max()


@pytest.mark.parametrize("cmap,ranks", [(m, r) for m, r in EMULATED
                                        if r in (2, 8) or m[0] == 8 or m in ODD_MAPS])
def test_emulated_item_forward_matches_the_plain_version(cmap, ranks):
    """The emulated forward kernel, every rank and stage, against
    fourier_unit_forward_plain in f64, at batch 2."""
    x, _, kmix, scale, bias, mean, var = _inputs((2,) + cmap)
    y = emulate_forward(x, kmix, scale, bias, mean, var, ranks)
    ref = fu.fourier_unit_forward_plain(*(torch.from_numpy(v) for v in
                                          (x, kmix, scale, bias, mean, var))).numpy()
    assert np.abs(y - ref).max() <= 1e-6 * np.abs(ref).max()


BWD_MAPS = [m for m in SHARED_MAPS if fu.kernel_design("bwd_apply", *m, H100_SMEM) == "shared"]


@pytest.mark.parametrize("cmap,ranks", [(m, r) for m in BWD_MAPS for r in (1, 4, 8)]
                         + [(m, r) for m, r in EMULATED if m in ODD_MAPS])
def test_emulated_item_bwd_apply_matches_the_plain_version(cmap, ranks):
    """The emulated backward apply kernel (gm, gK rows with their position
    chunks, gz, the adjoint transform) against fu_bwd_apply_plain in f64,
    at batch 2."""
    x, gy, kmix, scale, bias, mean, var = _inputs((2,) + cmap)
    t64 = lambda *a: [torch.from_numpy(v) for v in a]
    gscale, gbias = (v.numpy() for v in fu.fu_bwd_stats_plain(*t64(x, kmix, scale, bias, mean,
                                                                   var, gy)))
    gx, gk = emulate_bwd_apply(x, gy, kmix, scale, bias, mean, var, gscale, gbias, ranks)
    ref_gx, ref_gk = (v.numpy() for v in fu.fu_bwd_apply_plain(
        *t64(x, kmix, scale, bias, mean, var, gy, gscale, gbias)))
    assert np.abs(gx - ref_gx).max() <= 1e-6 * np.abs(ref_gx).max()
    assert np.abs(gk - ref_gk).max() <= 1e-6 * np.abs(ref_gk).max()


def test_item_tables_are_the_plain_factor_matrices():
    """The tables the kernels read are forward_factors' f32 matrices in the
    order [cw | dw | ah | bh]: the plain version's own factors."""
    ah, bh, cw, dw = forward_factors(24, 24)
    flat = np.concatenate([m.ravel() for m in (cw, dw, ah, bh)])
    assert flat.dtype == np.float32 and flat.size == 2 * 24 * 13 + 2 * 24 * 24
    assert np.array_equal(flat[: cw.size].reshape(cw.shape), cw)
    assert np.array_equal(flat[2 * cw.size: 2 * cw.size + ah.size].reshape(ah.shape), ah)


@pytest.mark.parametrize("cmap,ranks", EMULATED)
def test_item_statistics_write_every_partial_column_once(cmap, ranks):
    """The statistics kernels' sums, walked warp by warp over every rank of
    an item: each of the 4C columns of the item's partial row is written
    exactly once (each rank its own channels, both halves)."""
    c, h, w = cmap
    k = Rank(c, h, w, ranks)
    terms = np.random.default_rng(3).standard_normal((k.buf, 2))
    rec, row = Writes(), np.zeros(4 * c)
    for r in range(ranks):
        channel_sums(k, lambda o: terms[o], r, row, rec)
    assert rec.once(4 * c)


STATS_MAPS = [m for m in SHARED_MAPS if fu.kernel_design("stats", *m, H100_SMEM) == "shared"]
STATS_CASES = ([(m, r) for m in STATS_MAPS for r in (1, 2, 4, 8)]
               + [(m, r) for m, r in EMULATED if m in ODD_MAPS])


@pytest.mark.parametrize("cmap,ranks", STATS_CASES)
def test_emulated_item_train_stats_match_the_plain_version(cmap, ranks):
    """The emulated statistics kernel (every rank's transforms, the gather,
    the mix and the warp sums), its rows reduced as fu_reduce reduces them,
    against fu_train_stats_plain in f64, at batch 2."""
    x, _, kmix, *_ = _inputs((2,) + cmap)
    rows = emulate_train_stats(x, kmix, ranks)
    count = 2 * cmap[1] * (cmap[2] // 2 + 1)
    got = fu.fu_reduce_plain(torch.from_numpy(rows), count).split(2 * cmap[0])
    for g, ref in zip(got, fu.fu_train_stats_plain(torch.from_numpy(x), torch.from_numpy(kmix))):
        assert (g - ref).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.parametrize("cmap,ranks", STATS_CASES)
def test_emulated_item_bwd_stats_match_the_plain_version(cmap, ranks):
    """The emulated backward-sums kernel (x and gy transformed, gpre and n
    from the mix's epilogue, the warp sums), its rows summed, against
    fu_bwd_stats_plain in f64, at batch 2."""
    x, gy, kmix, scale, bias, mean, var = _inputs((2,) + cmap)
    rows = emulate_bwd_stats(x, gy, kmix, scale, bias, mean, var, ranks)
    got = torch.from_numpy(rows.sum(axis=0)).split(2 * cmap[0])
    refs = fu.fu_bwd_stats_plain(*(torch.from_numpy(v) for v in
                                   (x, kmix, scale, bias, mean, var, gy)))
    for g, ref in zip(got, refs):
        assert (g - ref).abs().max() <= 1e-6 * ref.abs().max()
