"""The port's convolutions and FFC block against the JAX package (CPU, f32).

The JAX module is initialised, its variables are replaced by seeded numpy
values at unit signal scale (He-scaled kernels, non-trivial BatchNorm
running statistics), and the same variables reach the port through the
bridge. Inputs are NHWC numpy arrays; the port runs NCHW.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.nn.ffc import FFC_BN_ACT as JFFC_BN_ACT
from fastfourierconvolution_tpu.nn.ffc import resize_output as jresize
from fastfourierconvolution_tpu.ops import conv as jconv
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.nn.ffc import FFC_BN_ACT, resize_output
from fastfourierconvolution_tpu_torch.ops import conv as tconv


def seeded_variables(variables, seed):
    """Numpy arrays in the shapes of flax ``variables`` (arrays or shape
    structs) with seeded values at unit signal scale: kernels
    N(0, 1/fan_in), BN scales 1 + N(0, 0.1), biases N(0, 0.1), running
    means N(0, 0.1), running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        collection, name = path[0].key, path[-1].key
        shape = tuple(x.shape)
        if collection == "batch_stats":
            v = rng.normal(0, 0.1, shape) if name == "mean" else rng.uniform(0.5, 1.5, shape)
        elif name in ("kernel", "mix_kernel"):
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "bn_scale"):
            v = 1 + rng.normal(0, 0.1, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_conv2d_matches_jax():
    """k3 s1 p1 convolution, weights bridged HWIO -> OIHW; 1e-5 absolute."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 10, 6)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 6, 5)) / np.sqrt(54)).astype(np.float32)
    y_j = jconv.conv2d(jnp.asarray(x), jnp.asarray(k), stride=1, padding=1)
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    y_t = tconv.conv2d(nchw(x), w, stride=1, padding=1)
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), atol=1e-5)


def test_conv_transpose2d_matches_jax():
    """k4 s2 p1 transposed convolution, the JAX kernel flipped into IOHW;
    1e-5 absolute."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 5, 6)).astype(np.float32)
    k = (rng.normal(size=(4, 4, 6, 5)) / np.sqrt(24)).astype(np.float32)
    y_j = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(k), stride=2, padding=1)
    w = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
    y_t = tconv.conv_transpose2d(nchw(x), w, stride=2, padding=1)
    assert y_t.shape == (2, 5, 10, 10)
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), atol=1e-5)


# (in_ch, out_ch, k, ratio_gin, ratio_gout, stride, padding, upsampling, act)
FFC_CASES = {
    "upsample_g2g": (32, 32, 4, 0.25, 0.25, 2, 1, True, "gelu"),
    "pool_g2g": (32, 32, 3, 0.25, 0.25, 2, 1, False, "relu"),
    "to_rgb": (16, 3, 3, 0.25, 0.0, 1, 1, False, "tanh"),
}


@pytest.mark.parametrize("case", sorted(FFC_CASES))
def test_ffc_bn_act_eval_matches_jax(case):
    """FFC_BN_ACT in eval with bridged weights and seeded running stats.
    The upsampling case holds a g2g SpectralTransform whose FourierUnit
    runs on 16x16 maps. 1e-4 absolute on O(1) outputs (a conv, a
    FourierUnit and a second conv chained in f32)."""
    cin, cout, k, rin, rout, s, p, up, act = FFC_CASES[case]
    norm = "identity" if act == "tanh" else "batch"
    jmod = JFFC_BN_ACT(
        cin, cout, k, rin, rout, stride=s, padding=p, upsampling=up,
        norm=norm, activation=act,
    )
    rng = np.random.default_rng(5)
    cin_g = int(cin * rin)
    x_l = rng.normal(size=(2, 8, 8, cin - cin_g)).astype(np.float32)
    x_g = rng.normal(size=(2, 8, 8, cin_g)).astype(np.float32)
    jx = (jnp.asarray(x_l), jnp.asarray(x_g))
    shapes = jax.eval_shape(
        lambda x: jmod.init({"params": jax.random.PRNGKey(0)}, x, False), jx
    )
    variables = seeded_variables(shapes, seed=6)
    y_j = jax.jit(lambda v, x: jresize(jmod.apply(v, x, False)))(variables, jx)

    tmod = FFC_BN_ACT(
        cin, cout, k, rin, rout, stride=s, padding=p, upsampling=up,
        norm=norm, activation=act,
    )
    tmod.load_state_dict(jax_to_state_dict(
        tmod, variables["params"], variables.get("batch_stats", {})
    ))
    with torch.no_grad():
        y_t = resize_output(tmod.eval()((nchw(x_l), nchw(x_g))))
    assert y_t.shape[1:] == (y_j.shape[3], y_j.shape[1], y_j.shape[2])
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), atol=1e-4)
