"""The port's InceptionV3 extractor against the JAX package's (CPU, f32).

Two sets of weights, both made here (nothing is downloaded):

- the JAX weights-free shallow extractor's own variables (its init, jitted,
  gives ``create_extractor``'s draws), taken to the port by
  ``bridge.inception_variables_to_state_dict``: the '64', '192' and
  'logits_unbiased' taps within 1e-5 of each tap's largest value;
- one seeded state dict in torch-fidelity's layout, He-scaled so that the
  deep taps keep images apart, loaded by both packages'
  ``load_torch_weights``: all six taps at batch 2 of 32x32 within 1e-3 of
  each tap's largest value (94 convolutions, each summed in another
  order), with the JAX net under ``jax.jit``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastfourierconvolution_tpu.eval import inception as ji
from fastfourierconvolution_tpu_torch.bridge import inception_variables_to_state_dict
from fastfourierconvolution_tpu_torch.eval import inception as ti

SHALLOW_RTOL = 1e-5
DEEP_RTOL = 1e-3
SHALLOW_TAPS = ("64", "192", "logits_unbiased")


def seeded_fidelity_state_dict(seed: int = 0) -> dict:
    """A torch-fidelity-layout InceptionV3 state dict: He-normal convolutions
    (std sqrt(2 / fan_in)), BN statistics and affine terms near identity,
    fc 1 / sqrt(2048), and the ``num_batches_tracked`` entries torch's
    BatchNorm2d saves."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in ti.InceptionV3(ti.FEATURE_NAMES).state_dict().items():
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
        if name.endswith("bn.running_var"):
            state[name.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    return state


def images(n=2, size=32, seed=0):
    """Seeded uint8 images: the first noise, the others smooth ramps of
    seeded colours."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    axis = np.linspace(0, 1, size)
    ramp = axis[None, :, None, None] * axis[None, None, :, None]
    x[1:] = (ramp * rng.integers(64, 256, (n - 1, 1, 1, 3))).astype(np.uint8)
    return x


def rel_max(ours, ref):
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", autouse=True)
def no_local_weights(tmp_path_factory):
    """No torch-fidelity file in reach (its variable unset, HOME elsewhere)
    and torch on two intra-op threads beside the JAX package's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(ti.WEIGHTS_ENV_VAR, raising=False)
        mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fidelity_state():
    return seeded_fidelity_state_dict()


@pytest.fixture(scope="module")
def weights_free():
    return ti.create_extractor(SHALLOW_TAPS, device="cpu")


@pytest.fixture(scope="module")
def deep_taps(fidelity_state):
    """Both packages' six taps on the same two images from the seeded dict."""
    x = images()
    module = ji.InceptionV3(features_list=ji.FEATURE_NAMES, shallow_logits=False)
    ref = jax.jit(module.apply)(ji.load_torch_weights(fidelity_state), jnp.asarray(x))
    model = ti.load_torch_weights(ti.InceptionV3(ti.FEATURE_NAMES), fidelity_state).eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in ours.items()})


@pytest.mark.parametrize("tap", ti.FEATURE_NAMES)
def test_seeded_weights_taps_match_jax(deep_taps, tap):
    ref, ours = deep_taps
    assert ours[tap].shape == ref[tap].shape and ours[tap].dtype == np.float32
    assert rel_max(ours[tap], ref[tap]) <= DEEP_RTOL


def test_seeded_weights_keep_images_apart(deep_taps):
    """A net that maps both images to one point could pass the parity test;
    the seeded one keeps their '2048' features far apart."""
    _, ours = deep_taps
    f = ours["2048"]
    assert np.abs(f[0] - f[1]).max() / np.abs(f).max() > 100 * DEEP_RTOL


def test_weights_free_shallow_taps_match_jax_bridged():
    """The JAX weights-free extractor's variables (its jitted init draws the
    same as ``create_extractor``) through the bridge."""
    module = ji.InceptionV3(features_list=SHALLOW_TAPS, shallow_logits=True)
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3), jnp.uint8))
    x = images(seed=1)
    ref = jax.jit(module.apply)(variables, jnp.asarray(x))
    state = inception_variables_to_state_dict(jax.device_get(variables))
    model = ti.InceptionV3(SHALLOW_TAPS, shallow_logits=True)
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all(k.startswith("Mixed_") for k in missing)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x))
    for tap in SHALLOW_TAPS:
        assert rel_max(ours[tap].numpy(), np.asarray(ref[tap])) <= SHALLOW_RTOL, tap


def test_taps_exit_early():
    """Only the layers a tap needs run: '64' stops before Conv2d_3b_1x1,
    the shallow logits before Mixed_5b."""
    model = ti.InceptionV3(("64", "192", "logits_unbiased"), shallow_logits=True).eval()
    ran = []
    for name in ("Conv2d_3b_1x1", "Mixed_5b"):
        getattr(model, name).register_forward_hook(lambda *a, name=name: ran.append(name))
    with torch.no_grad():
        out = model(torch.from_numpy(images()))
    assert sorted(out) == ["192", "64", "logits_unbiased"] and ran == ["Conv2d_3b_1x1"]
    model.features_list = ("64",)
    ran.clear()
    with torch.no_grad():
        model(torch.from_numpy(images()))
    assert ran == []


def test_create_extractor_weights_free_and_from_a_file(tmp_path, monkeypatch, fidelity_state,
                                                     weights_free):
    """Weights-free: the draws of a generator seeded 0 (lecun-normal), the
    shallow head with a zero bias and no deep fc. From a .pth file:
    torch-fidelity's dict loaded strictly (its num_batches_tracked
    dropped), the deep fc."""
    assert ti.find_local_weights() is None and not ti.weights_available()
    a = weights_free
    b = ti.lecun_normal_(ti.InceptionV3(SHALLOW_TAPS, shallow_logits=True),
                         torch.Generator().manual_seed(0))
    assert a.shallow_logits and hasattr(a, "fc192") and not hasattr(a, "fc")
    assert not a.training and not a.fc192.bias.any()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    conv = a.Mixed_7c.branch_pool.conv.weight
    assert abs(conv.std().item() * np.sqrt(2048) - 1) < 0.05
    path = tmp_path / ti.WEIGHTS_FILE
    torch.save(fidelity_state, path)
    monkeypatch.setenv(ti.WEIGHTS_ENV_VAR, str(path))
    assert ti.find_local_weights() == str(path) and ti.weights_available()
    real = ti.create_extractor(("2048",), device="cpu")
    assert not real.shallow_logits and hasattr(real, "fc") and not hasattr(real, "fc192")
    assert torch.equal(real.fc.weight, fidelity_state["fc.weight"])


def test_float64_internal_dtype(weights_free):
    """'float64' computes every stage in float64 (input cast before the
    resize); anything but None, 'float32' and 'float64' raises."""
    f32 = weights_free
    f64 = ti.create_extractor(SHALLOW_TAPS, internal_dtype="float64", device="cpu")
    x = torch.from_numpy(images(seed=2))
    with torch.no_grad():
        a, b = f32(x), f64(x)
    for tap in SHALLOW_TAPS:
        assert b[tap].dtype == torch.float64
        assert rel_max(a[tap].double().numpy(), b[tap].numpy()) <= SHALLOW_RTOL
    with pytest.raises(ValueError, match="internal_dtype"):
        ti.create_extractor(SHALLOW_TAPS, internal_dtype="float16", device="cpu")


def test_bad_inputs_raise():
    model = ti.InceptionV3(("64",), shallow_logits=True)
    with pytest.raises(ValueError, match="uint8"):
        model(torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError, match="features_list"):
        ti.InceptionV3(("4096",))
    with pytest.raises(KeyError, match="no port entry"):
        inception_variables_to_state_dict({"params": {"Conv2d_1a_3x3": {"scale": np.ones(1)}}})
