"""Data parallelism in the port (``parallel``) on the CPU: gloo groups of two
processes against one process on the global batch.

The processes run ``tests/torch_parallel_worker.py`` (no JAX), one intra-op
thread each; the one-process reference runs the same case here, without a
group. Each process takes its rows of every global batch.

- The op level: the FourierUnit's statistics and backward sums (per-item
  and staged plain versions), the fused packed BN's statistics and
  backward sums, BatchNorm's statistics, running statistics and the three
  training ops' gradients (rows of x, parameters summed over the
  processes) equal the one-process values on the concatenated batch
  within 1e-5 of each tensor's largest value: the same sums taken in
  another order in f32 (the processes' partial sums are added across).
- Three ``update_step`` calls of two processes equal three of one process
  at the global batch, and the two processes hold the same bits after each
  step: the JAX multi-process test's pair (8px, batch 8, hinge, fused D
  pass, noise maps and latents drawn for the global batch), the narrow
  tuple pair of ``tests/test_torch_train_step.py`` (from the JAX trainer's
  init, noise neutralised, batch 4), its packed pair from seeds (64px,
  batch 8, the fused packed BN's plain versions with the noise fold under
  the tanh GELU), and the multi-process pair's G against
  ``FFCDiscriminator`` under wgan-gp with Adam (the sngan preset's
  pairing: BN and FourierUnit statistics inside the gradient penalty's
  double backward). The first step's G and D gradients within 1e-4 of
  each tensor's largest (``GRAD_TOL``; a copy of the pair, since Adam's
  step hides a gradient's scale); losses within 1e-4 relative; parameters, running
  statistics and ``u`` at the JAX lockstep's bars (``STATE_TOL``; an Adam
  step flips on an element whose gradient is within rounding of 0, see
  ``test_torch_train_options._check_param``; the biases that BN cancels
  and the running means they feed are left out as there). The wgan-gp
  batch is seeded (2): D's penalty gradient jumps where one of
  FFCDiscriminator's ReLU inputs crosses 0, and on one of 16 seeded
  batches tried, one input lay within f32 rounding of 0, so the two sums
  of different order took different sides (0.3% on most of D's
  gradients).
- ``test_torch_parallel_jax.py`` and ``test_torch_parallel_jax_pairs.py``:
  the tuple, packed and wgan-gp pairs from the JAX trainer's init, against
  one process and against the JAX package's single-device step.
- ``calculate_metrics`` in a group: two processes' ISC, FID and
  KID equal one process's, the cache read in both.
- ``cli train`` as two processes joined by the JAX CLI's environment: rank
  0 alone prints, logs and writes the checkpoint, the losses equal a
  one-process run's, and a two-process resume continues the run.
- The refusals: ``train.tp=2`` in a single process (T must divide the
  process count), ``update_steps`` and
  ``train.steps_per_call`` above 1 under gloo on the card, a partial
  launch environment.
"""

from __future__ import annotations

import csv
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from fastfourierconvolution_tpu_torch import FFCGenerator, GANTrainer, SNConvDiscriminator, cli
from fastfourierconvolution_tpu_torch import parallel

from test_torch_train_options import FED_MEAN, FREE_BIAS, _check_param
from test_torch_train_step import GRAD_TOL, STATE_TOL

TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
OP_TOL = 1e-5
STEP_LOSS_RTOL = 1e-4
LR = 2e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}


def run_group(tmp_path, spec, world=2):
    """The worker case ``spec`` as ``world`` processes of one gloo group:
    their results by rank."""
    init = f"file://{tmp_path}/store-{spec['case']}-{spec.get('pair', '')}"
    procs = []
    for rank in range(world):
        path = tmp_path / f"spec{rank}.json"
        out = tmp_path / f"out{rank}.pt"
        path.write_text(json.dumps({**spec, "rank": rank, "world": world, "init": init,
                                    "out": str(out)}))
        procs.append((subprocess.Popen([sys.executable, WORKER, str(path)], env=_env(),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), out))
    results = []
    for proc, out in procs:
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
            raise
        assert proc.returncode == 0, log[-3000:]
        results.append(torch.load(out, weights_only=False))
    return results


def _close(name, ours, ref, tol=OP_TOL):
    ours, ref = torch.as_tensor(ours).double(), torch.as_tensor(ref).double()
    assert ours.shape == ref.shape, name
    gap = (ours - ref).abs().max().item()
    assert gap <= tol * max(ref.abs().max().item(), 1e-30), (name, gap)


ROW_ENTRIES = ("fu_train_y", "fu_train_gx", "packed_out", "bn_y", "bn_gx")


def test_statistics_and_sums_are_the_global_batchs(tmp_path):
    ref = W.ops_case({})
    outs = run_group(tmp_path, {"case": "ops"})
    for name, value in ref.items():
        if name in ROW_ENTRIES:
            _close(name, torch.cat([o[name] for o in outs]), value)
        elif name == "packed_grad_rows":
            for i, v in enumerate(value):
                _close(f"{name}[{i}]", torch.cat([o[name][i] for o in outs]), v)
        else:
            values = value if isinstance(value, list) else [value]
            for out in outs:
                theirs = out[name] if isinstance(out[name], list) else [out[name]]
                for i, (a, b) in enumerate(zip(theirs, values)):
                    _close(f"{name}[{i}]", a, b)


def test_metrics_split_over_two_processes(tmp_path):
    """``calculate_metrics`` on two processes of a group: every
    process gets the metrics of one process's call within 1e-4 (the
    extractor runs 4 rows a call instead of 8), and a second call reads
    the real set's features from the cache (every process has the file)
    and gives the same numbers."""
    ref = W.metrics_case({"cache": str(tmp_path / "one")})
    outs = run_group(tmp_path, {"case": "metrics", "cache": str(tmp_path / "two")})
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one"))
    for out in outs:
        assert out["again"] == out["first"]
        assert out["first"].keys() == ref["first"].keys()
        for key, value in ref["first"].items():
            assert abs(out["first"][key] - value) <= 1e-4 * abs(value), (key, value)


def jax_init(pair, tmp_path):
    """The JAX run of a pair held against JAX (``test_torch_parallel_jax.py``,
    ``test_torch_parallel_jax_pairs.py``), and the workers' inputs."""
    if pair == "jax-gp":
        from test_torch_parallel_jax_pairs import jax_gp_init

        return jax_gp_init(tmp_path)
    from test_torch_parallel_jax import jax_init as init

    return init(pair, tmp_path)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """pair -> (the one-process run, the two processes' runs, the JAX
    lockstep run or None), each made once."""
    cache = {}

    def get(pair):
        if pair not in cache:
            tmp = tmp_path_factory.mktemp(f"step-{pair}")
            jax_run, spec = (None, {}) if pair in W.SEEDED else jax_init(pair, tmp)
            spec = {"case": "step", "pair": pair, **spec}
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                cache[pair] = (W.step_case(spec), run_group(tmp, spec), jax_run)
            finally:
                torch.set_num_threads(threads)
        return cache[pair]

    return get


@pytest.mark.parametrize("pair", ["multihost", "packed", "gp"])
def test_two_process_steps_equal_one_process(pair, step_runs):
    check_steps(*step_runs(pair)[:2])


def check_steps(ref, outs):
    """Two processes' steps (``outs``) against one process's (``ref``): the
    first step's gradients, then the losses and states after each step."""
    for out in outs:
        for name, want in ref["grads"].items():
            if FREE_BIAS.fullmatch(name):
                continue
            got = out["grads"][name]
            assert (got - want).abs().max() <= GRAD_TOL * want.abs().max(), name
    for k in range(len(ref["losses"])):
        for out in outs:
            np.testing.assert_allclose(out["losses"][k], ref["losses"][k],
                                       rtol=STEP_LOSS_RTOL, err_msg=f"losses at step {k}")
        states = [out["states"][k] for out in outs]
        assert all(torch.equal(states[0][n], states[1][n]) for n in states[0]), (
            f"the two processes' states differ after step {k}")
        ours, theirs = states[0], ref["states"][k]
        assert ours.keys() == theirs.keys()
        params = set(ref["params"])
        free_gap = max([(ours[n] - theirs[n]).abs().max().item()
                        for n in theirs if FREE_BIAS.fullmatch(n)], default=0.0)
        for name, value in theirs.items():
            if FREE_BIAS.fullmatch(name) or not value.is_floating_point():
                continue
            if name in params:
                _check_param(f"{name} after step {k}", ours[name].numpy(), value.numpy(),
                             k + 1, LR)
                continue
            tol = STATE_TOL + (free_gap if FED_MEAN.fullmatch(name) else 0.0)
            np.testing.assert_allclose(ours[name].numpy(), value.numpy(), atol=tol,
                                       err_msg=f"{name} after step {k}")


# A narrow CLI run (tests/test_torch_cli.py's TINY flags at 32px with the
# SN conv D, the fgan32 preset's, whose pass is fused), 2 steps of global
# batch 8, checkpoints at steps 1 and 2.
CLI_FLAGS = ["--set", "data.dataset=synthetic", "--set", "data.image_size=32",
             "--set", "model.generator=ffc", "--set", "model.discriminator=sn_conv",
             "--set", "model.ngf=16", "--set", "model.z_size=32", "--set", "model.mg=4",
             "--set", "train.batch_size=8", "--set", "train.num_epoch_steps=1",
             "--set", "eval.isc=false", "--set", "eval.fid=false",
             "--set", "log.checkpoint=true", "--set", "log.checkpoint_after_frac=0.3",
             "--set", "log.log_every=1", "--set", "log.samples_grid=4",
             "--set", "log.tensorboard=false", "--device", "cpu"]


def _cli_group(run_dir, steps, world=2, tp=1):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**_env(), "FFC_TPU_COORDINATOR": f"localhost:{port}",
               "FFC_TPU_NUM_PROCESSES": str(world), "FFC_TPU_PROCESS_ID": str(rank)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fastfourierconvolution_tpu_torch.cli", "train", *CLI_FLAGS,
             "--set", f"train.tp={tp}", "-e", str(steps), "-o", str(run_dir)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


def _loss_rows(run):
    with open(os.path.join(run, "gan_losses.csv")) as f:
        return [[float(v) for v in r.values()] for r in csv.DictReader(f)]


def test_cli_trains_as_two_processes_and_resumes(tmp_path):
    run, single = tmp_path / "run", tmp_path / "single"
    outs = _cli_group(run, 2)
    assert "step 2/2" in outs[0] and "Configuration" in outs[0]
    assert "step " not in outs[1] and "Configuration" not in outs[1]
    assert "[parallel] process 1 of 2 on cpu: gloo" in outs[1]
    assert sorted(os.listdir(run / "checkpoints")) == ["ckpt_1_steps.pt", "ckpt_2_steps.pt"]
    assert os.path.exists(run / "000002.png")
    cli.main(["train", *CLI_FLAGS, "-e", "2", "-o", str(single)])
    np.testing.assert_allclose(_loss_rows(run), _loss_rows(single), rtol=STEP_LOSS_RTOL)
    # a resume on two processes continues from the checkpoint rank 0 wrote
    outs = _cli_group(run, 3)
    assert "INFO: resumed from step 2" in outs[0] and "INFO" not in outs[1]
    rows = _loss_rows(run)
    assert [int(r[0]) for r in rows] == list(range(3))
    assert os.path.exists(run / "checkpoints" / "ckpt_3_steps.pt")


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="train.tp=2 must divide the process count 1"):
        cli.main(["train", *CLI_FLAGS, "--set", "train.tp=2", "-o", str(tmp_path)])
    monkeypatch.setenv("FFC_TPU_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="FFC_TPU_NUM_PROCESSES, FFC_TPU_PROCESS_ID"):
        cli.main(["train", *CLI_FLAGS, "-o", str(tmp_path)])
    monkeypatch.delenv("FFC_TPU_COORDINATOR")
    monkeypatch.setenv("FFC_TPU_DISTRIBUTED", "yes")
    with pytest.raises(ValueError, match="only value is 'auto'"):
        parallel.launch_env()
    monkeypatch.delenv("FFC_TPU_DISTRIBUTED")
    assert parallel.launch_env() is None
    assert not os.listdir(tmp_path)  # nothing written before the refusals
    # on the card under gloo (processes that share one): K steps as a graph
    monkeypatch.setattr(parallel, "backend", lambda: "gloo")
    monkeypatch.setattr("fastfourierconvolution_tpu_torch.utils.policy.resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="gloo backend's collectives"):
        cli.main(["train", *CLI_FLAGS, "--set", "train.steps_per_call=2", "-e", "2",
                  "--set", "log.log_every=2", "--set", "train.num_epoch_steps=2",
                  "-o", str(tmp_path)])
    g = FFCGenerator(**W.MULTIHOST_G, generator=torch.Generator().manual_seed(0))
    d = SNConvDiscriminator(**W.MULTIHOST_D, generator=torch.Generator().manual_seed(1))
    trainer = GANTrainer(g, d, z_size=32, device="cpu")
    trainer.device = torch.device("cuda")
    with pytest.raises(ValueError, match="under gloo take update_step"):
        trainer.update_steps(np.zeros((2, 8, 8, 8, 3), np.float32))
