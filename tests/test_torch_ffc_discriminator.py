"""The all-FFC discriminator against the JAX package (CPU, f32).

``FFCDiscriminator`` at 16 and 32 px, batch 2, with seeded variables at unit
signal scale carried across by the bridge (biased convolutions, the blocks'
BatchNorms, the FourierUnits' BN and the head's ``u``): the training
forward's logits, the updated running statistics and ``u``, and the
gradient of the logits' sum in the input, which is what feeds the
generator's gradient through D. ``tests/test_torch_sngan.py`` trains it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.models.ffc_gan as jffc_gan
from fastfourierconvolution_tpu_torch import FFCDiscriminator
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict

from test_torch_ffc import nchw, nhwc, seeded_variables

# f32 on both sides: the same function summed in other orders through four
# blocks and two FourierUnits, relative to the largest value.
TOL = 1e-4


@pytest.mark.parametrize("resolution", [16, 32])
def test_ffc_discriminator_matches_jax(resolution):
    jd = jffc_gan.FFCDiscriminator(impl="dft")
    x = np.random.default_rng(resolution).uniform(
        -1, 1, size=(2, resolution, resolution, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda v: jd.init({"params": jax.random.PRNGKey(0)}, v, True),
                            jnp.asarray(x))
    variables = seeded_variables(shapes, seed=resolution + 1)

    def logits_sum(v):
        out, upd = jd.apply(variables, v, True, mutable=["batch_stats", "spectral"])
        return out.sum(), (out, upd)

    (_, (ref, upd)), ref_gx = jax.value_and_grad(logits_sum, has_aux=True)(jnp.asarray(x))
    d = FFCDiscriminator(mg=resolution // 8)
    d.load_state_dict(jax_to_state_dict(d, variables["params"], variables["batch_stats"],
                                        variables["spectral"]))
    xt = nchw(x).requires_grad_(True)
    out = d(xt)
    (gx,) = torch.autograd.grad(out.sum(), xt)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=TOL * np.abs(ref).max())
    ref_gx = np.asarray(ref_gx)
    np.testing.assert_allclose(nhwc(gx), ref_gx, rtol=0, atol=TOL * np.abs(ref_gx).max())
    after = jax_to_state_dict(d, variables["params"], upd["batch_stats"], upd["spectral"])
    for name, value in d.state_dict().items():
        np.testing.assert_allclose(value.numpy(), after[name].numpy(), atol=1e-5, err_msg=name)
