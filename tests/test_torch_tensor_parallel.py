"""Tensor parallelism in the port (``train.tp``) on the CPU.

- The FourierUnit module sliced over two processes (dp 1 x tp 2) in
  training and eval mode and class-conditional, against one process.
- The sliced ops, in one process with no group: for T of 1, 2 and 4 and
  every slice t, the FourierUnit's per-item and staged plain versions (the
  kernel wrappers on CPU tensors) on out-channel slice t
  (``ops.fourier_unit.out_columns``: K's columns, the vectors' entries, gy's
  channels) give the slice of the whole op's y, statistics, backward sums
  and gK within 1e-6 of each tensor's largest value; the T partial gx add
  up to the whole gx within 1e-5; at T = 1 the slice is the whole op, bit
  for bit.
- The JAX package's tensor-parallel test pair (``tests/test_parallel.py``,
  ``_tiny``: the 8px generator against the SN conv discriminator, batch
  16), from the JAX trainer's init through ``bridge`` with NoiseInjection
  neutralised and the latents given, takes two steps as two processes of a
  gloo group (dp 1 x tp 2) and as four (dp 2 x tp 2),
  ``tests/torch_parallel_worker.py``: the first step's gradients, the
  losses and the states against one process at ``test_torch_parallel.py``'s
  bars, and against the JAX package's single-device ``update_step`` at the
  JAX tensor-parallel test's bars (losses rtol 2e-3, atol 1e-3; G and D
  parameters atol 5e-4). The tp peers hold the same bits.
- The sngan pairing (wgan-gp, ``FFCDiscriminator``; the gradient penalty's
  double backward through the tp collectives) as dp 1 x tp 2: the first
  step's gradients within ``GRAD_TOL`` of one process's (the biases that
  BN cancels left out, as ``check_steps`` leaves them), its losses within
  1e-4.
- Checkpoints across grids: a tp 2 run's checkpoint restored into one
  process, and one process's checkpoint into tp 2, each continued for two
  steps, equal the one-process run's continuation.
- ``cli train --set train.tp=2`` as two processes: rank 0 alone writes,
  the first step's losses within 5e-3 of a one-process run's, then a
  two-process resume continues the run.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from fastfourierconvolution_tpu_torch import cli
from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

from test_torch_parallel import (  # noqa: F401
    CLI_FLAGS,
    LR,
    STEP_LOSS_RTOL,
    _cli_group,
    _loss_rows,
    check_steps,
    one_thread,
    run_group,
)
from test_torch_train_options import FREE_BIAS, _check_param
from test_torch_train_step import GRAD_TOL, STATE_TOL

SLICE_TOL, GX_TOL = 1e-6, 1e-5
# JAX's tensor-parallel bars (tests/test_parallel.py)
JAX_LOSS_RTOL, JAX_LOSS_ATOL, JAX_PARAM_ATOL = 2e-3, 1e-3, 5e-4
CLI_LOSS_TOL = 5e-3


def _close(name, got, want, tol):
    got, want = got.double(), want.double()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    gap = (got - want).abs().max().item()
    assert gap <= tol * max(want.abs().max().item(), 1e-30), (name, gap)


def _op_inputs(seed=0, b=3, c=8, h=8, w=8):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    x, gy = t(rng.normal(size=(b, c, h, w))), t(rng.normal(size=(b, c, h, w)))
    kernel = t(rng.normal(size=(2 * c, 2 * c)) * 0.3)
    scale, bias = t(1 + 0.1 * rng.normal(size=2 * c)), t(0.1 * rng.normal(size=2 * c))
    return x, gy, kernel, scale, bias


def _item_outputs(x, gy, kernel, scale, bias):
    """The per-item wrappers' outputs (CPU: their plain versions)."""
    mean, var = fu.fu_train_stats(x, kernel)
    y = fu.fourier_unit_forward(x, kernel, scale, bias, mean, var)
    gscale, gbias = fu.fu_bwd_stats(x, kernel, scale, bias, mean, var, gy)
    gx, gk = fu.fu_bwd_apply(x, kernel, scale, bias, mean, var, gy, gscale, gbias)
    return {"y": y, "mean": mean, "var": var, "gscale": gscale, "gbias": gbias, "gx": gx,
            "gk": gk}


def _staged_outputs(x, gy, kernel, scale, bias):
    """The staged wrappers' outputs, composed as the training op composes
    them (CPU: their plain versions)."""
    z, g = fu.fu_spectrum(x)[0], fu.fu_spectrum(gy)[0]
    mean, var = fu.fu_mix_stats(z, kernel)
    y = fu.fu_inverse(fu.fu_mix_apply(z, kernel, scale, bias, mean, var), x.dtype, x.shape[3])
    gscale, gbias = fu.fu_bwd_stats_mix(z, g, kernel, scale, bias, mean, var)
    gz, gk = fu.fu_bwd_mix(z, g, kernel, scale, bias, mean, var, gscale, gbias)
    return {"y": y, "mean": mean, "var": var, "gscale": gscale, "gbias": gbias,
            "gx": fu.fu_inverse(gz, x.dtype, x.shape[3]), "gk": gk}


@pytest.mark.parametrize("design", ["item", "staged"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sliced_ops_are_slices_of_the_whole_op(design, tp):
    run = _item_outputs if design == "item" else _staged_outputs
    x, gy, kernel, scale, bias = _op_inputs()
    c = x.shape[1]
    whole = run(x, gy, kernel, scale, bias)
    gx_sum = None
    for t in range(tp):
        cols = fu.out_columns(c, t, tp)
        co = c // tp
        part = run(x, gy[:, t * co:(t + 1) * co].contiguous(), kernel[:, cols].contiguous(),
                   scale[cols], bias[cols])
        if tp == 1:
            assert all(torch.equal(part[k], whole[k]) for k in whole), "T = 1 is the whole op"
        _close("y", part["y"], whole["y"][:, t * co:(t + 1) * co], SLICE_TOL)
        for k in ("mean", "var", "gscale", "gbias"):
            _close(k, part[k], whole[k][cols], SLICE_TOL)
        _close("gk", part["gk"], whole["gk"][:, cols], SLICE_TOL)
        gx_sum = part["gx"] if gx_sum is None else gx_sum + part["gx"]
    _close("gx", gx_sum, whole["gx"], GX_TOL)


def test_fourier_unit_module_sliced_over_two_processes(tmp_path):
    """The FourierUnit module as dp 1 x tp 2 (each process its slice of the
    mix) against one process: in training and eval mode and
    class-conditional (the whole mix gathered from the slices), y, x's
    gradient (the slices' partial gradients summed), the parameters'
    gradients (the mix's gathered whole) and the running statistics, each
    within 1e-5 of its largest value; the two processes the same bits."""
    ref = W.fu_module_case({})
    outs = run_group(tmp_path, {"case": "fu_module", "tp": 2})
    for mode, want in ref.items():
        for name, value in want.items():
            _close(f"{mode} {name}", outs[0][mode][name], value, GX_TOL)
            assert torch.equal(outs[0][mode][name], outs[1][mode][name]), (mode, name)


def test_out_columns_and_refusals():
    assert fu.out_columns(4, 1, 2).tolist() == [2, 3, 6, 7]
    assert fu.out_columns(4, 0, 1).tolist() == list(range(8))
    with pytest.raises(ValueError, match="no slice"):
        fu.out_columns(6, 0, 4)
    x, gy, kernel, scale, bias = _op_inputs()
    with pytest.raises(ValueError, match="Co dividing"):
        fu.fu_train_stats(x, kernel[:, :6].contiguous())
    with pytest.raises(ValueError, match="gy must be"):
        cols = fu.out_columns(8, 0, 2)
        mean, var = fu.fu_train_stats(x, kernel[:, cols])
        fu.fu_bwd_stats(x, kernel[:, cols], scale[cols], bias[cols], mean, var, gy)


# --- the JAX package's tensor-parallel test pair -------------------------------

TINY_G = W.MULTIHOST_G
TINY_D = dict(ladder=((16, 3, 1), (16, 4, 2), (32, 4, 2)), head_size=2)
TINY_BATCH, TINY_STEPS = 16, 2


def _jax_tiny(tmp_path):
    """The JAX trainer on ``_tiny``'s pair (NoiseInjection neutralised, f32,
    the latents given): its init and data written for the workers, and the
    losses and G's and D's state dicts after each single-device step, in
    the port's layout."""
    import jax
    import jax.numpy as jnp

    import fastfourierconvolution_tpu.models.ffc_gan as jffc_gan
    import fastfourierconvolution_tpu.train.checkpoint as jckpt
    from fastfourierconvolution_tpu.train import GANTrainer as JGANTrainer
    from fastfourierconvolution_tpu.utils import policy as jpolicy
    from fastfourierconvolution_tpu_torch import FFCGenerator, SNConvDiscriminator
    from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict

    from test_torch_train_step import _NoNoise, _NoNoiseHolder

    rng = np.random.default_rng(3)
    reals = rng.uniform(-1, 1, size=(TINY_STEPS, TINY_BATCH, 8, 8, 3)).astype(np.float32)
    zs = rng.normal(size=(TINY_STEPS, 2, TINY_BATCH, TINY_G["z_size"])).astype(np.float32)

    def port(params, stats, spectral):
        g = jax_to_state_dict(FFCGenerator(**TINY_G), params[0], stats)
        d = jax_to_state_dict(SNConvDiscriminator(**TINY_D), params[1], spectral=spectral)
        return {**{f"g.{k}": v for k, v in g.items()}, **{f"d.{k}": v for k, v in d.items()}}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jffc_gan, "NoiseInjection", _NoNoise)
        mp.setattr(jffc_gan, "NoiseWeightHolder", _NoNoiseHolder)
        mp.setattr(jpolicy, "_COMPUTE_DTYPE", jnp.float32)
        jg = jffc_gan.FFCGenerator(**TINY_G, impl="dft")
        jd = jffc_gan.SNConvDiscriminator(ladder=TINY_D["ladder"], mg=TINY_D["head_size"])
        trainer = JGANTrainer(jg, jd, z_size=TINY_G["z_size"], total_steps=100)
        state = trainer.init(jax.random.PRNGKey(0), jnp.asarray(reals[0]))
        init = port(*jax.device_get(((state.g.params, state.d.params), state.g.batch_stats,
                                     state.d.spectral)))
        step = jax.jit(trainer.update_step)
        losses, states = [], []
        for k in range(TINY_STEPS):
            state, metrics = step(state, jnp.asarray(reals[k]), zs=jnp.asarray(zs[k]))
            losses.append((float(metrics["loss_g"]), float(metrics["loss_d"])))
            states.append(port(*jax.device_get(((state.g.params, state.d.params),
                                                state.g.batch_stats, state.d.spectral))))
            if k == 0:  # the JAX package's checkpoint after step 1
                jckpt.save_checkpoint(state, str(tmp_path / "jax"), 1)
    split = lambda side: {k[2:]: v for k, v in init.items() if k.startswith(side + ".")}
    torch.save({"g_cfg": TINY_G, "packed": False, "d_kind": "sn", "d_cfg": TINY_D,
                "options": dict(z_size=TINY_G["z_size"]), "g": split("g"), "d": split("d")},
               tmp_path / "init-tiny.pt")
    np.savez(tmp_path / "data-tiny.npz", reals=reals, zs=zs)
    return {"losses": losses, "states": states,
            "ckpt": str(tmp_path / "jax" / "ckpt_1_steps.ckpt")}, {
        "inputs": str(tmp_path / "init-tiny.pt"), "data": str(tmp_path / "data-tiny.npz")}


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The JAX run, the one-process run, the dp 1 x tp 2 and dp 2 x tp 2
    runs of the tiny pair, and its worker spec."""
    tmp = tmp_path_factory.mktemp("tiny")
    jax_run, spec = _jax_tiny(tmp)
    spec = {"case": "step", "pair": "tiny", **spec}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = W.step_case(spec)
        groups = {world: run_group(tmp_path_factory.mktemp(f"tiny{world}"), {**spec, "tp": 2},
                                   world=world) for world in (2, 4)}
    finally:
        torch.set_num_threads(threads)
    return jax_run, ref, groups, spec


@pytest.mark.parametrize("world", [2, 4])
def test_tp_steps_equal_one_process(world, tiny_runs):
    _, ref, groups, _ = tiny_runs
    outs = groups[world]
    check_steps(ref, outs)
    for k in range(TINY_STEPS):
        for out in outs[1:]:
            assert all(torch.equal(out["states"][k][n], outs[0]["states"][k][n])
                       for n in outs[0]["states"][k]), f"the processes differ after step {k}"


@pytest.mark.parametrize("world", [2, 4])
def test_tp_steps_in_lockstep_with_jax(world, tiny_runs):
    jax_run, ref, groups, _ = tiny_runs
    params = set(ref["params"])
    for k in range(TINY_STEPS):
        ours = groups[world][0]
        np.testing.assert_allclose(ours["losses"][k], jax_run["losses"][k], rtol=JAX_LOSS_RTOL,
                                   atol=JAX_LOSS_ATOL, err_msg=f"losses at step {k}")
        for name in params:
            np.testing.assert_allclose(ours["states"][k][name].numpy(),
                                       jax_run["states"][k][name].numpy(), atol=JAX_PARAM_ATOL,
                                       err_msg=f"{name} after step {k}")


def test_tp_wgan_gp_first_step_equals_one_process(tmp_path):
    """The sngan pairing (wgan-gp, FFCDiscriminator) as dp 1 x tp 2: the
    first step's gradients and losses against one process."""
    spec = {"case": "step", "pair": "gp"}
    ref = W.step_case(spec)
    outs = run_group(tmp_path, {**spec, "tp": 2})
    for out in outs:
        for name, want in ref["grads"].items():
            if FREE_BIAS.fullmatch(name):  # BN cancels them: rounding, as check_steps
                continue
            got = out["grads"][name]
            assert (got - want).abs().max() <= GRAD_TOL * want.abs().max(), name
        np.testing.assert_allclose(out["losses"][0], ref["losses"][0], rtol=STEP_LOSS_RTOL)
    assert all(torch.equal(outs[0]["states"][0][n], outs[1]["states"][0][n])
               for n in outs[0]["states"][0])


def test_checkpoints_move_between_grids(tiny_runs, tmp_path):
    """A tp 2 run's checkpoint after step 1 restored into one process, and
    one process's into tp 2, each continued to step 2: both equal the
    one-process run (``ref``), whose second step they repeat."""
    _, ref, _, spec = tiny_runs
    spec = {**spec, "case": "ckpt"}
    one, two = tmp_path / "one.pt", tmp_path / "two.pt"
    W.ckpt_case({**spec, "steps": (0, 1), "save": str(one)})
    for sub in "ab":
        (tmp_path / sub).mkdir()
    run_group(tmp_path / "a", {**spec, "tp": 2, "steps": (0, 1), "save": str(two)})
    from_two = W.ckpt_case({**spec, "steps": (1, 2), "restore": str(two)})
    from_one = run_group(tmp_path / "b", {**spec, "tp": 2, "steps": (1, 2), "restore": str(one)})
    assert all(torch.equal(from_one[0]["states"][0][n], from_one[1]["states"][0][n])
               for n in ref["states"][1])
    for run in (from_two, from_one[0]):
        np.testing.assert_allclose(run["losses"][0], ref["losses"][1], rtol=STEP_LOSS_RTOL)
        for name, want in ref["states"][1].items():
            got = run["states"][0][name]
            if name in ref["params"]:
                _check_param(name, got.numpy(), want.numpy(), 2, LR)
            elif want.is_floating_point():
                np.testing.assert_allclose(got.numpy(), want.numpy(), atol=STATE_TOL,
                                           err_msg=name)


def test_a_jax_checkpoint_restores_under_tp(tiny_runs, tmp_path):
    """The JAX trainer's ``.ckpt`` after step 1 restored into a dp 1 x tp 2
    group, each process taking its slices of the whole mixes, and continued
    to step 2 in lockstep with the JAX trainer's second step."""
    jax_run, ref, _, spec = tiny_runs
    outs = run_group(tmp_path, {**spec, "case": "ckpt", "tp": 2, "steps": (1, 2),
                                "restore": jax_run["ckpt"]})
    assert all(torch.equal(outs[0]["states"][0][n], outs[1]["states"][0][n])
               for n in outs[0]["states"][0])
    np.testing.assert_allclose(outs[0]["losses"][0], jax_run["losses"][1], rtol=JAX_LOSS_RTOL,
                               atol=JAX_LOSS_ATOL)
    for name in ref["params"]:
        np.testing.assert_allclose(outs[0]["states"][0][name].numpy(),
                                   jax_run["states"][1][name].numpy(), atol=JAX_PARAM_ATOL,
                                   err_msg=name)


def test_cli_trains_under_tp_and_resumes(tmp_path):
    run, single = tmp_path / "run", tmp_path / "single"
    outs = _cli_group(run, 2, tp=2)
    assert "step 2/2" in outs[0] and "step " not in outs[1]
    assert "dp 0 of 1 x tp 1 of 2" in outs[1]
    assert sorted(os.listdir(run / "checkpoints")) == ["ckpt_1_steps.pt", "ckpt_2_steps.pt"]
    cli.main(["train", *CLI_FLAGS, "-e", "2", "-o", str(single)])
    np.testing.assert_allclose(_loss_rows(run)[0], _loss_rows(single)[0], atol=CLI_LOSS_TOL)
    outs = _cli_group(run, 3, tp=2)
    assert "INFO: resumed from step 2" in outs[0] and "INFO" not in outs[1]
    assert [int(r[0]) for r in _loss_rows(run)] == list(range(3))
    assert os.path.exists(run / "checkpoints" / "ckpt_3_steps.pt")
