"""The port's ``utils/config.py`` and ``zoo.py`` against the JAX package's.

- For each of the ten ``PRESETS``, ``make_config`` gives the same
  ``dataclasses.asdict`` as the JAX package's, and ``apply_overrides``
  coerces the same strings to the same values.
- ``build_models`` of each preset gives a pair whose state dicts load, through
  the bridge, from the shapes of the JAX ``build_models`` pair's variables
  (``jax.eval_shape`` of their init), every port tensor filled and every
  JAX leaf used; the SAGAN pair through ``TupleHeadWrapper``.
- The unknown-name errors, the ``num_classes`` error of a conditional
  config, and ``fourier_impl``: the values the JAX package takes build,
  another raises.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.utils.config as jconfig
import fastfourierconvolution_tpu.zoo as jzoo
from fastfourierconvolution_tpu_torch import TupleHeadWrapper, zoo
from fastfourierconvolution_tpu_torch.utils import config

from test_torch_dcgan import bridge_shapes

OVERRIDES = ["train.lr=1e-3", "train.d_lr=4e-4", "train.remat=dots", "model.fourier_impl=dft",
             "model.gen_preset=stl48", "log.checkpoint=yes", "log.profile_at_step=7",
             "data.image_size=48", "model.ratio_g=0.5", "train.steps_per_call=4",
             "eval.input2_dataset=cifar10-32", "log.compilation_cache=none"]


def test_presets_are_the_jax_presets():
    assert config.PRESETS == jconfig.PRESETS
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(jconfig.Config())


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_make_config_and_overrides_match_jax(name):
    ours, theirs = config.make_config(name), jconfig.make_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_json() == theirs.to_json()
    config.apply_overrides(ours, OVERRIDES)
    jconfig.apply_overrides(theirs, OVERRIDES)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    kw = {"train.batch_size": 8, "model.ngf": 16}
    assert (dataclasses.asdict(config.make_config(name, **kw))
            == dataclasses.asdict(jconfig.make_config(name, **kw)))


def test_config_errors_match_jax():
    for module in (config, jconfig):
        with pytest.raises(KeyError, match="unknown preset"):
            module.make_config("nope")
        with pytest.raises(KeyError, match="unknown config field"):
            module.make_config("sagan", **{"train.nope": 1})


def _jax_inputs(cfg):
    """(G's init input, D's init input, extra init arguments) at batch 1."""
    d = cfg.data
    z = np.zeros((1, cfg.model.z_size), np.float32)
    x = np.zeros((1, d.image_size, d.image_size, d.channels), np.float32)
    extra = (jnp.zeros((1,), jnp.int32),) if cfg.model.conditional else ()
    return z, x, extra


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_build_models_loads_the_jax_pair(name):
    jg, jd = jzoo.build_models(jconfig.make_config(name))
    g, d = zoo.build_models(config.make_config(name))
    z, x, extra = _jax_inputs(jconfig.make_config(name))
    bridge_shapes(jg, g, z, *extra)
    bridge_shapes(jd, d, x, *extra)
    assert isinstance(g, TupleHeadWrapper) == (name == "sagan")
    assert isinstance(d, TupleHeadWrapper) == (name == "sagan")


def test_the_wrapper_hands_on_the_first_output():
    g, d = zoo.build_models(config.make_config("sagan", **{"model.ngf": 16, "model.ndf": 16}))
    g.eval(), d.eval()
    z = torch.randn(2, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        images = g(z, torch.float32)
        assert torch.equal(images, g.module(z, torch.float32)[0])
        assert images.shape == (2, 3, 32, 32)
        assert d(images, torch.float32).shape == (2, 1)


@pytest.mark.parametrize("side", ["generator", "discriminator"])
def test_unknown_names_raise_as_in_jax(side):
    for module, build in ((config, getattr(zoo, f"build_{side}")),
                          (jconfig, getattr(jzoo, f"build_{side}"))):
        with pytest.raises(KeyError, match=f"unknown {side} 'nope'"):
            build(module.make_config(**{f"model.{side}": "nope"}))


def test_conditional_needs_two_classes_as_in_jax():
    for module, build in ((config, zoo.build_models), (jconfig, jzoo.build_models)):
        cfg = module.make_config("fgan_cond32", **{"model.num_classes": 1})
        with pytest.raises(ValueError, match="num_classes >= 2"):
            build(cfg)


def test_fourier_impl_takes_the_jax_values_without_effect():
    small = {"model.ngf": 8, "model.ndf": 8}
    base = zoo.build_generator(config.make_config("fgan32", **small))
    for impl in ("fft", "dft", "auto"):
        g = zoo.build_generator(config.make_config("fgan32", **small, **{"model.fourier_impl": impl}))
        assert all(torch.equal(a, b) for a, b in zip(g.state_dict().values(),
                                                     base.state_dict().values()))
    for build in (zoo.build_generator, zoo.build_discriminator):
        with pytest.raises(ValueError, match="fourier_impl"):
            build(config.make_config("fgan32", **{"model.fourier_impl": "cufft"}))
