"""The JAX package's ``.ckpt`` checkpoints read by the port (CPU, f32).

- ``train/flax_msgpack.py`` gives ``flax.serialization.msgpack_restore``'s
  tree, bit for bit, for bytes ``msgpack_serialize`` wrote (f32, bf16 as
  f32, int32, a uint32 key, 0-d arrays, complex numbers, numpy scalars,
  empty maps, nesting; chunked arrays with flax's chunk size made small);
  truncated or malformed bytes raise ValueError with the offset.
- The narrow pairs of ``tests/test_torch_train_step.py`` (tuple, with AdamW
  and with Adam at two D updates a step; packed, with AdamW): the JAX
  trainer takes two steps and saves its ``.ckpt``; ``restore_latest``
  gives every parameter, buffer, Adam moment and count, learning rate,
  schedule count and step of the JAX state (bridged, the optax entries
  picked by index here), bit for bit, and leaves the generators; one more
  step on both sides with the same latents and the noise neutralised:
  losses within 1e-3, parameters and moments within 1e-4 rel-max per
  tensor, BN statistics and ``u`` within 1e-4.
- A tree of other models, of the pre-unification FourierUnit layout or
  with an optimizer entry the trainer lacks raises, naming the leaf.
- The family rules: the newest file across ``.pt`` and ``.ckpt``, the
  ``.pt`` one at an equal step; the port's pruning leaves every ``.ckpt``.
- ``tools/jax_ckpt_manifest.py`` regenerates the committed fgan32 manifest
  that ``chip_smoke.py`` packs its file from.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import fastfourierconvolution_tpu.models.ffc_gan as jffc_gan
import fastfourierconvolution_tpu.train.checkpoint as jckpt
import fastfourierconvolution_tpu_torch.models.ffc_gan as tffc_gan
from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
from fastfourierconvolution_tpu.train.gan import GANState, NetState
from fastfourierconvolution_tpu.utils import policy as jpolicy
from fastfourierconvolution_tpu_torch import GANTrainer
from fastfourierconvolution_tpu_torch.bridge import jax_params_to_state_dict, jax_to_state_dict
from fastfourierconvolution_tpu_torch.train import checkpoint as ckpt
from fastfourierconvolution_tpu_torch.train import flax_msgpack
from fastfourierconvolution_tpu_torch.train.gan import LinearDecay

from test_torch_ffc import seeded_variables
from test_torch_train_step import (
    PAIRS,
    _fast_gelu,
    _no_noise,
    _NoNoise,
    _NoNoiseHolder,
    _port_d,
    _port_g,
)

BATCH, TOTAL_STEPS, SAVED_AT = 4, 100, 2
LOSS_TOL = 1e-3
# parameters and Adam moments after the step, rel-max per tensor
TENSOR_TOL = 1e-4
# BN statistics and u, absolute (as tests/test_torch_train_step.py)
STATE_TOL = 1e-4
# name -> (pair of tests/test_torch_train_step.py, optimizer, D updates a step)
CASES = {"tuple-adamw": ("tuple", "adamw", 1), "tuple-adam-2d": ("tuple", "adam", 2),
         "packed-adamw": ("packed", "adamw", 1)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops, where torch's thread pool only
    adds contention with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the decoder ----------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(3)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "bf16": jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16),
        "i32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
        "key": np.array([1113701576, 4046130448], np.uint32),
        "zero_d": np.asarray(np.float32(2.5)),
        "zero_d_int": jnp.asarray(7, jnp.int32),
        "complex": 1.5 - 2.25j,
        "scalars": {"f": np.float32(0.1), "i": np.int64(-3), "u": np.uint8(200),
                    "b": np.bool_(True), "bf": jnp.bfloat16(1.75)},
        "python": {"int": 300, "neg": -40000, "big": 2 ** 40, "float": 0.3, "none": None,
                   "true": True, "text": "é" * 40},
        "empty": {},
        "nested": {"a": {"b": {"c": rng.normal(size=(2, 2, 2)).astype(np.float64)}},
                   "long": {str(i): np.full((1,), i, np.int16) for i in range(20)}},
        "large": rng.normal(size=(300,)).astype(np.float32),
    }


def _leaf_equal(ours, theirs, path):
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and list(ours) == list(theirs), path
        for k in theirs:
            _leaf_equal(ours[k], theirs[k], f"{path}/{k}")
        return
    if getattr(theirs, "dtype", None) == jnp.bfloat16:  # read as float32
        want = np.asarray(theirs).astype(np.float32)
        assert np.asarray(ours).dtype == np.float32 and np.asarray(ours).shape == want.shape, path
        assert np.asarray(ours).tobytes() == want.tobytes(), path
        return
    assert type(ours) is type(theirs), (path, type(ours), type(theirs))
    if isinstance(theirs, (np.ndarray, np.generic)):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        assert ours.tobytes() == theirs.tobytes(), path
    else:
        assert ours == theirs, path


@pytest.mark.parametrize("chunked", [False, True])
def test_the_decoder_gives_msgpack_restore_s_tree(chunked, monkeypatch):
    if chunked:  # flax chunks arrays over MAX_CHUNK_SIZE bytes: 256 B here
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    data = serialization.msgpack_serialize(_tree())
    if chunked:
        assert data.count(flax_msgpack.CHUNKED.encode()) == 1  # "large", in 5 chunks
    _leaf_equal(flax_msgpack.restore(data), serialization.msgpack_restore(data), "")


def test_truncated_or_malformed_bytes_raise_with_the_offset():
    data = serialization.msgpack_serialize(_tree())
    for cut in (1, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError, match=r"truncated.* at byte offset \d+"):
            flax_msgpack.restore(data[:cut])
    with pytest.raises(ValueError, match="1 bytes after the object at byte offset"):
        flax_msgpack.restore(data + b"\x00")
    with pytest.raises(ValueError, match=r"byte 0xc1 starts no msgpack object at byte offset 0"):
        flax_msgpack.restore(b"\xc1")
    with pytest.raises(ValueError, match="ext type 5, which flax does not write"):
        flax_msgpack.restore(b"\xd4\x05\x00")
    bad = serialization.msgpack_serialize({"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="an ndarray of 12 bytes for shape"):
        flax_msgpack.restore(bad.replace(b"\x93\x91\x03", b"\x93\x91\x04"))


# --- the JAX trainer's checkpoint -------------------------------------------------------


def _seeded_state(trainer, z_size, resolution):
    """A ``GANState`` of ``trainer`` with seeded variables (the shapes traced,
    not initialised: ``trainer.init`` compiles for seconds) and fresh
    optimizer states."""
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}

    def net(model, x, seed, tx):
        shapes = jax.eval_shape(lambda x: model.init(rngs, x, True), x)
        v = seeded_variables(shapes, seed)
        return NetState(params=v["params"], batch_stats=v.get("batch_stats"),
                        spectral=v.get("spectral"), opt_state=jax.jit(tx.init)(v["params"]))

    return GANState(step=jnp.zeros((), jnp.int32),
                    g=net(trainer.g_model, jnp.zeros((2, z_size)), 1, trainer.g_tx),
                    d=net(trainer.d_model, jnp.zeros((2, resolution, resolution, 3)), 2,
                          trainer.d_tx),
                    rng=jax.random.PRNGKey(2))


def _jax_run(case, directory):
    """The JAX trainer of ``case``: two steps, the ``.ckpt`` saved, one more
    step; the saved and the final states and the third step's losses."""
    pair, optimizer, n_dis = CASES[case]
    g_cfg, ladder, head, resolution, packed = PAIRS[pair]
    rng = np.random.default_rng(7)
    reals = rng.uniform(-1, 1, size=(3, BATCH, resolution, resolution, 3)).astype(np.float32)
    zs = rng.normal(size=(3, 1 + n_dis, BATCH, g_cfg["z_size"])).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp, _fast_gelu(packed):
        mp.setattr(jffc_gan, "NoiseInjection", _NoNoise)
        mp.setattr(jffc_gan, "NoiseWeightHolder", _NoNoiseHolder)
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        trainer = JGANTrainer(
            jffc_gan.FFCGenerator(**g_cfg, impl="dft", packed=packed),
            jffc_gan.SNConvDiscriminator(ladder=ladder, mg=head), z_size=g_cfg["z_size"],
            total_steps=TOTAL_STEPS, fused_dis_batch=True, optimizer=optimizer,
            num_dis_updates=n_dis)
        state = _seeded_state(trainer, g_cfg["z_size"], resolution)
        step = jax.jit(trainer.update_step)
        for k in range(SAVED_AT):
            state, _ = step(state, jnp.asarray(reals[k]), zs=jnp.asarray(zs[k]))
        jckpt.save_checkpoint(state, directory, SAVED_AT)
        saved = jax.device_get(state)
        state, metrics = step(state, jnp.asarray(reals[SAVED_AT]), zs=jnp.asarray(zs[SAVED_AT]))
        composed = _composed_g_grads(trainer, saved, zs[SAVED_AT, 0]) if packed else None
    return dict(case=case, dir=directory, saved=saved, after=jax.device_get(state),
                losses=(float(metrics["loss_g"]), float(metrics["loss_d"])), reals=reals,
                zs=zs, packed=packed, composed=composed)


def _composed_g_grads(trainer, state, z):
    """The G phase's gradient at ``state`` as the JAX package's G and D give
    it in three jitted calls: G's forward, D's gradient at the fakes, G's
    VJP of that gradient. At the packed pair's saved state the jitted step,
    whose one trace rounds G's fakes otherwise, gives a gradient 9.3e-3
    rel-max away from this one (D's leaky ReLUs switch on rounding-level
    changes of the fakes); the port's is 2e-6 from this one."""
    g_of = lambda p: trainer._apply_g({"params": p, "batch_stats": state.g.batch_stats},
                                      jnp.asarray(z), jax.random.PRNGKey(1))[0]
    d_loss = lambda x: trainer.gen_loss(trainer._apply_d(
        {"params": state.d.params, "spectral": state.d.spectral}, x)[0])
    fake = jax.jit(g_of)(state.g.params)
    at_fake = jax.jit(jax.grad(d_loss))(fake)
    return jax.device_get(jax.jit(lambda p, c: jax.vjp(g_of, p)[1](c)[0])(state.g.params,
                                                                          at_fake))


_RUNS = {}


def _run_of(case, tmp_path_factory):
    """``_jax_run`` of ``case``, once per module."""
    if case not in _RUNS:
        _RUNS[case] = _jax_run(case, str(tmp_path_factory.mktemp(case)))
    return _RUNS[case]


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request, tmp_path_factory):
    return _run_of(request.param, tmp_path_factory)


def _port_trainer(case, seed=5):
    pair, optimizer, n_dis = CASES[case]
    return GANTrainer(_port_g(pair), _port_d(pair), z_size=PAIRS[pair][0]["z_size"],
                      total_steps=TOTAL_STEPS, fused_dis_batch=True, optimizer=optimizer,
                      num_dis_updates=n_dis, device="cpu", dtype="f32", seed=seed)


def _advanced(base, total, n):
    schedule = LinearDecay(torch.zeros(()), base, total)
    for _ in range(n):
        schedule.advance()
    return schedule


def _bridged(trainer, state):
    """{name: tensor} of the JAX ``state`` in the port's layout, the optax
    entries by their index in the chain (Adam first, the schedule last)."""
    out = {"step": torch.tensor(int(state.step)),
           "step_count": torch.tensor(float(state.step) if trainer.d_progress_arg else 0.0)}
    for side, model, total in (("g", trainer.g, TOTAL_STEPS),
                               ("d", trainer.d, TOTAL_STEPS * trainer.num_dis_updates)):
        net = getattr(state, side)
        out.update({f"{side}.{k}": v for k, v in jax_to_state_dict(
            model, net.params, net.batch_stats, net.spectral).items()})
        adam, schedule = net.opt_state[0], net.opt_state[-1]
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            out.update({f"{side}_opt.{n}.{key}": v
                        for n, v in jax_params_to_state_dict(model, tree).items()})
        out.update({f"{side}_opt.{n}.step": torch.tensor(float(adam.count))
                    for n, _ in model.named_parameters()})
        decay = _advanced(2e-4, total, int(schedule.count))
        out[f"{side}_lr.lr"], out[f"{side}_lr.count"] = decay.lr, decay.count
    return out


def _ours(trainer):
    """{name: tensor} of ``trainer.state_dict()`` in ``_bridged``'s names."""
    state = trainer.state_dict()
    out = {"step": torch.tensor(state["step"]), "step_count": state["step_count"]}
    for side, model in (("g", trainer.g), ("d", trainer.d)):
        out.update({f"{side}.{k}": v for k, v in state[side].items()})
        for (name, _), entries in zip(model.named_parameters(), state[f"{side}_opt"],
                                      strict=True):
            out.update({f"{side}_opt.{name}.{k}": v for k, v in entries.items()})
        out.update({f"{side}_lr.{k}": v for k, v in state[f"{side}_lr"].items()})
    return out


def test_a_jax_checkpoint_restores_bit_for_bit(jax_run):
    trainer = _port_trainer(jax_run["case"])
    streams = trainer.z_generator.get_state(), trainer.noise_generator.get_state()
    _, step = ckpt.restore_latest(trainer, jax_run["dir"])
    assert step == trainer.step == SAVED_AT
    ours, want = _ours(trainer), _bridged(trainer, jax_run["saved"])
    assert ours.keys() == want.keys()
    differ = [k for k in want
              if ours[k].dtype != want[k].dtype or not torch.equal(ours[k], want[k])]
    assert not differ, differ[:8]
    # D's schedule counts num_dis_updates updates a step
    assert trainer.d_lr.count.item() == SAVED_AT * trainer.num_dis_updates
    assert torch.equal(trainer.z_generator.get_state(), streams[0])
    assert torch.equal(trainer.noise_generator.get_state(), streams[1])


def test_a_restored_step_is_in_lockstep_with_jax(jax_run, monkeypatch):
    monkeypatch.setattr(tffc_gan, "draw_noise", _no_noise)
    trainer = _port_trainer(jax_run["case"])
    ckpt.restore_latest(trainer, jax_run["dir"])
    with _fast_gelu(jax_run["packed"]):
        out = trainer.update_step(jax_run["reals"][SAVED_AT], zs=jax_run["zs"][SAVED_AT])
    np.testing.assert_allclose((out["loss_g"].item(), out["loss_d"].item()), jax_run["losses"],
                               atol=LOSS_TOL)
    ours, want = _ours(trainer), _bridged(trainer, jax_run["after"])
    if jax_run["composed"] is not None:
        want.update(_adam_moments(trainer, jax_run["saved"].g.opt_state[0],
                                  jax_run["composed"]))
    params = {f"{side}.{n}" for side, m in (("g", trainer.g), ("d", trainer.d))
              for n, _ in m.named_parameters()}
    for key, ref in want.items():
        got = ours[key].double()
        ref = ref.double()
        if key in params or key.endswith(("exp_avg", "exp_avg_sq")):
            tol = TENSOR_TOL * ref.abs().max().item()
        elif key.startswith(("g.", "d.")):
            tol = STATE_TOL
        else:  # counts, learning rates, steps
            tol = 0.0
        assert (got - ref).abs().max().item() <= tol, key


def _adam_moments(trainer, adam, grads, b1=0.5, b2=0.999):
    """G's moments after one Adam update by ``grads`` from ``adam``'s."""
    g = jax_params_to_state_dict(trainer.g, grads)
    mu = jax_params_to_state_dict(trainer.g, adam.mu)
    nu = jax_params_to_state_dict(trainer.g, adam.nu)
    out = {}
    for name in g:
        grad = g[name].double()
        out[f"g_opt.{name}.exp_avg"] = b1 * mu[name].double() + (1 - b1) * grad
        out[f"g_opt.{name}.exp_avg_sq"] = b2 * nu[name].double() + (1 - b2) * grad * grad
    return out


def test_a_tree_that_does_not_match_raises(tmp_path_factory):
    """On the tuple pair's AdamW file."""
    run = _run_of("tuple-adamw", tmp_path_factory)
    tree = flax_msgpack.read(jckpt.get_latest_checkpoint(run["dir"]))

    def restore(edit, trainer=None):
        bad = copy.deepcopy(tree)
        edit(bad)
        return ckpt.jax_trainer_state(trainer or _port_trainer("tuple-adamw"), bad)

    # another preset's models: the packed pair
    with pytest.raises(ValueError, match=r"noise_to_feature.weight: JAX leaf .* gives shape"):
        ckpt.jax_trainer_state(_port_trainer("packed-adamw"), tree)
    # the FourierUnit's BN before the parameter unification
    unit = "g/params/block1/ffc/convg2g/FourierUnit_0"

    def old_layout(t):
        node = t
        for key in unit.split("/"):
            node = node[key]
        node["BatchNorm_0"] = {"scale": node.pop("bn_scale"), "bias": node.pop("bn_bias")}

    with pytest.raises(KeyError, match="bn_scale: no JAX leaf params/block1/ffc/convg2g"):
        restore(old_layout)
    with pytest.raises(ValueError, match=r"g/opt_state/3: an optimizer entry"):
        restore(lambda t: t["g"]["opt_state"].update({"3": {"trace": np.zeros(1)}}))
    # an AdamW file into an Adam trainer
    with pytest.raises(ValueError, match="Adam wants entries"):
        restore(lambda t: None, _port_trainer("tuple-adam-2d"))
    with pytest.raises(KeyError, match=r"'g', 'rng', 'step'"):
        restore(lambda t: t.pop("d"))


# --- the family rules -------------------------------------------------------------------


class _Stub:
    def __init__(self, value):
        self.value = value

    def state_dict(self):
        return {"value": torch.tensor(self.value)}


def test_the_newest_file_across_both_suffixes_and_pruning_keeps_ckpt_files(tmp_path):
    d = str(tmp_path)
    for step in (10, 20):
        open(os.path.join(d, f"ckpt_{step}_steps.ckpt"), "wb").close()
    assert ckpt.get_latest_checkpoint(d).endswith("ckpt_20_steps.ckpt")
    ckpt.save_checkpoint(_Stub(1), d, 15)
    assert ckpt.get_latest_checkpoint(d).endswith("ckpt_20_steps.ckpt")
    ckpt.save_checkpoint(_Stub(2), d, 20)  # the .pt file at an equal step
    assert ckpt.get_latest_checkpoint(d).endswith("ckpt_20_steps.pt")
    for step in (25, 30, 35):
        ckpt.save_checkpoint(_Stub(step), d, step, keep=2)
    assert sorted(os.listdir(d)) == ["ckpt_10_steps.ckpt", "ckpt_20_steps.ckpt",
                                     "ckpt_30_steps.pt", "ckpt_35_steps.pt"]
    # another family is never read
    open(os.path.join(d, "netG_99_steps.ckpt"), "wb").close()
    assert ckpt.get_latest_checkpoint(d).endswith("ckpt_35_steps.pt")
    assert ckpt.get_latest_checkpoint(d, "netG").endswith("netG_99_steps.ckpt")
    with pytest.raises(ValueError, match="a checkpoint ends in .pt"):
        ckpt.restore_checkpoint(_Stub(0), os.path.join(d, "ckpt_1_steps.npz"))


# --- the manifest chip_smoke.py packs its file from ----------------------------------


def test_the_committed_fgan32_manifest_is_the_jax_package_s():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_manifest", os.path.join(ROOT, "tools", "jax_ckpt_manifest.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(tool.DEFAULT_OUT) as f:
        committed = json.load(f)
    assert tool.manifest("fgan32") == committed
