"""Data parallelism in the port against the JAX package (CPU, gloo): the
narrow tuple pair of ``tests/test_torch_train_step.py``, from the JAX
trainer's init with NoiseInjection neutralised, takes three steps of
global batch 4 as two processes of a gloo group
(``tests/torch_parallel_worker.py``); they equal one process's steps at
the bars of ``test_torch_parallel.py`` and are in lockstep with the JAX
package's single-device ``update_step`` (losses, running statistics and
``u`` at ``test_torch_train_step.py``'s bars). The packed and wgan-gp
pairs: ``test_torch_parallel_jax_pairs.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict

import torch_parallel_worker as W
from test_torch_parallel import check_steps, one_thread, step_runs  # noqa: F401
from test_torch_train_step import LOSS_TOL, PAIRS, STATE_TOL, _jax_lockstep, _port_d, _port_g


def jax_init(pair, tmp_path):
    """The JAX lockstep run of ``pair`` ("tuple", or "jax-packed": the
    packed pair of ``test_torch_train_step.py``), and its initial state and
    data written for the workers."""
    name = "packed" if pair == "jax-packed" else pair
    run = _jax_lockstep(name)
    g_cfg, ladder, head, _, packed = PAIRS[name]
    g_params, g_stats, d_params, d_u = run["init"]
    init = {"g_cfg": g_cfg, "packed": packed, "d_kind": "sn",
            "d_cfg": dict(ladder=ladder, head_size=head),
            "options": dict(z_size=g_cfg["z_size"], fused_dis_batch=True),
            "g": jax_to_state_dict(_port_g(name), g_params, g_stats),
            "d": jax_to_state_dict(_port_d(name), d_params, spectral=d_u)}
    torch.save(init, tmp_path / f"init-{pair}.pt")
    np.savez(tmp_path / f"data-{pair}.npz", reals=run["reals"], zs=run["zs"])
    return run, {"inputs": str(tmp_path / f"init-{pair}.pt"),
                 "data": str(tmp_path / f"data-{pair}.npz")}


def test_two_process_steps_equal_one_process(step_runs):
    check_steps(*step_runs("tuple")[:2])


def test_two_process_steps_in_lockstep_with_jax(step_runs):
    _, outs, jax_run = step_runs("tuple")
    for k in range(W.STEPS):
        np.testing.assert_allclose(outs[0]["losses"][k], jax_run["losses"][k], atol=LOSS_TOL,
                                   err_msg=f"losses at step {k}")
        for name, ref in jax_run["states"][k].items():
            np.testing.assert_allclose(outs[0]["states"][k][name].numpy(), ref.numpy(),
                                       atol=STATE_TOL, err_msg=f"{name} after step {k}")
