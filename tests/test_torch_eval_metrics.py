"""The port's metric functions and TF1 resize against the JAX package's (CPU).

``eval/metrics.py`` is float64 numpy in both packages: on the same seeded
feature arrays every result is equal, not merely close. The resize is two
products with the same (out, in) weights: the port's float32 result within
1e-6 of the JAX package's (relative to the largest value), its float64
result equal to the same products in numpy float64.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.eval import metrics as jm
from fastfourierconvolution_tpu.eval.resize import resize_bilinear_tf1 as jax_resize
from fastfourierconvolution_tpu_torch.eval import metrics as tm
from fastfourierconvolution_tpu_torch.eval.resize import _resize_matrix, resize_bilinear_tf1

RESIZE_RTOL = 1e-6


def _features(seed, n=48, d=24, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) + shift).astype(np.float32)


def test_fid_statistics_and_metric_equal_jax():
    a, b = _features(0), _features(1, shift=0.3)
    sa, sb = tm.fid_features_to_statistics(a), jm.fid_features_to_statistics(a)
    assert np.array_equal(sa["mu"], sb["mu"]) and np.array_equal(sa["sigma"], sb["sigma"])
    assert tm.fid_features_to_metric(a, b) == jm.fid_features_to_metric(a, b)
    stats = [jm.fid_features_to_statistics(x) for x in (a, b)]
    assert tm.fid_statistics_to_metric(*stats) == jm.fid_statistics_to_metric(*stats)


@pytest.mark.parametrize("splits,shuffle", [(10, True), (3, False)])
def test_isc_equals_jax(splits, shuffle):
    logits = _features(2, n=50, d=30) * 3
    kw = dict(splits=splits, shuffle=shuffle, rng_seed=7)
    assert tm.isc_features_to_metric(logits, **kw) == jm.isc_features_to_metric(logits, **kw)


@pytest.mark.parametrize("kernel", ["poly", "rbf"])
def test_kid_equals_jax(kernel):
    a, b = _features(3, n=40), _features(4, n=36, shift=0.2)
    kw = dict(subsets=7, subset_size=20, kernel=kernel, rbf_sigma=5.0, rng_seed=11)
    assert tm.kid_features_to_metric(a, b, **kw) == jm.kid_features_to_metric(a, b, **kw)
    kw = dict(subsets=3, subset_size=1000, degree=2, gamma=0.1, coef0=0.5)
    assert tm.kid_features_to_metric(a, b, **kw) == jm.kid_features_to_metric(a, b, **kw)


@pytest.mark.parametrize("batch_size", [10000, 7])
def test_prc_equals_jax(batch_size):
    """Tiles of 7 rows exercise the streamed k-NN radii and coverage."""
    a, b = _features(5, n=30, d=8), _features(6, n=26, d=8, shift=0.5)
    kw = dict(neighborhood=3, batch_size=batch_size)
    assert tm.prc_features_to_metric(a, b, **kw) == jm.prc_features_to_metric(a, b, **kw)


def test_prc_small_n_raises_like_jax():
    a, b = _features(7, n=3, d=4), _features(8, n=10, d=4)
    for fn in (tm.prc_features_to_metric, jm.prc_features_to_metric):
        with pytest.raises(ValueError, match="more than prc_neighborhood=3"):
            fn(a, b)


def test_bad_feature_shapes_raise_value_error():
    with pytest.raises(ValueError, match=r"\(N, D\) matrix"):
        tm.fid_features_to_statistics(np.zeros(5))
    with pytest.raises(ValueError, match="feature widths differ"):
        tm.prc_features_to_metric(_features(9, n=8, d=4), _features(9, n=8, d=5))


RESIZE_CASES = [(32, 299, False), (16, 299, False), (7, 5, False), (5, 9, True), (299, 64, True)]


@pytest.mark.parametrize("size_in,size_out,align", RESIZE_CASES)
def test_resize_matches_jax(size_in, size_out, align):
    """uint8 NHWC in, float32 out, in both layouts; non-square maps."""
    rng = np.random.default_rng(size_in)
    x = rng.integers(0, 256, (2, size_in, size_in + 3, 3), dtype=np.uint8)
    out_hw = (size_out, size_out + 1)
    ref = np.asarray(jax_resize(jnp.asarray(x), out_hw, align_corners=align))
    scale = np.abs(ref).max()
    ours = resize_bilinear_tf1(torch.from_numpy(x), out_hw, align_corners=align)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert np.abs(ours.numpy() - ref).max() <= RESIZE_RTOL * scale
    nchw = resize_bilinear_tf1(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw,
                               align_corners=align, layout="NCHW")
    assert np.abs(nchw.permute(0, 2, 3, 1).numpy() - ref).max() <= RESIZE_RTOL * scale


# Resizes whose lerp weights are multiples of 1/4, so that every product and
# sum below is exact in float64, in any order.
DYADIC_CASES = [(8, 32, False), (16, 8, False), (5, 9, True), (9, 33, True)]


@pytest.mark.parametrize("size_in,size_out,align", DYADIC_CASES)
def test_resize_float64_is_the_float64_product(size_in, size_out, align):
    """A float64 input resizes in float64: the port's result equals the
    two products of the weight matrices in numpy float64. The inputs carry
    a part of 2**-36, which float32 arithmetic would drop."""
    rng = np.random.default_rng(size_out)
    x = (rng.integers(0, 256, (2, size_in, size_in, 3))
         + rng.integers(1, 1 << 8, (2, size_in, size_in, 3)) * 2.0**-36)
    wh = _resize_matrix(size_in, size_out, align).astype(np.float64)
    want = np.einsum("pw,bhwc->bhpc", wh, np.einsum("oh,bhwc->bowc", wh, x))
    ours = resize_bilinear_tf1(torch.from_numpy(x), (size_out, size_out), align_corners=align)
    assert ours.dtype == torch.float64
    assert np.array_equal(ours.numpy(), want)
    f32 = resize_bilinear_tf1(torch.from_numpy(x).float(), (size_out, size_out), align)
    assert not np.array_equal(f32.double().numpy(), want)


def test_resize_rejects_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        resize_bilinear_tf1(torch.zeros(1, 4, 4, 3), (8, 8), layout="HWC")
