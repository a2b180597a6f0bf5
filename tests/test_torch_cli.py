"""The port's training CLI (``cli.py``), its config parser and its logs
against the JAX package's, on the CPU.

- ``ScalarLogger`` writes the JAX logger's CSV rows and JSONL records (all
  but the wall time); ``make_grid`` gives the JAX grid, and the PNG the
  port writes without PIL decodes to the pixels of the JAX PNG.
- ``parse_cli`` gives the JAX config for a set of argv (and ``--device``).
- The on-device normalisation of the CLI's feed equals JAX's ``_norm``
  as the JAX CLI runs it (jitted) for all 256 uint8 values.
- ``trainer_keywords`` equals, for each of the ten presets, the keywords
  the JAX ``run_train`` passes to its ``GANTrainer`` (captured by a stub
  that records and raises), with the precision and the seed beside them.
- ``train`` writes the JAX CLI's set of files on the same flags (``.pt``
  checkpoints for ``.ckpt``); a run stopped after step 6 and resumed to 9
  logs the losses of an uninterrupted run bit for bit, K-step chunks log
  the losses of single steps (with a profiler trace taken on the way);
  ``sample`` writes its grid, the per-sample
  PNGs and the feature-map figure; each option the port does not have
  raises with its message; ``download`` fetches through the transport.
- A run directory whose one checkpoint the JAX package wrote (a ``.ckpt``
  after one jitted step of TINY's models): ``sample`` draws from it,
  ``train`` resumes it at its step and writes ``.pt`` files beside it; in
  a child process that cannot import jax, flax, optax, msgpack or the JAX
  package, on the shapes data, too (``train`` there imports nothing beyond
  torch, numpy and the standard library).
- ``train`` with ``eval.prc`` and ``eval.ppl`` logs both (weights-free);
  ``fidelity -r`` prints ``calculate_metrics``' PRC, and ``fidelity -p``
  of the run directory the PPL the run logged.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import fastfourierconvolution_tpu.cli as jcli
import fastfourierconvolution_tpu.train as jtrain
import fastfourierconvolution_tpu.utils.config as jconfig
import fastfourierconvolution_tpu.utils.logging as jlogging
from fastfourierconvolution_tpu_torch import cli
from fastfourierconvolution_tpu_torch.utils import config
from fastfourierconvolution_tpu_torch.utils import logging as tlogging

# the JAX test suite's tiny CLI run (tests/test_cli.py), losses logged
# every step
TINY = ["--set", "data.dataset=synthetic", "--set", "data.image_size=16",
        "--set", "model.generator=ffc", "--set", "model.discriminator=ffc",
        "--set", "model.ngf=16", "--set", "model.z_size=32", "--set", "model.mg=2",
        "--set", "train.batch_size=8", "--set", "train.num_epoch_steps=3",
        "--set", "eval.isc=false", "--set", "eval.fid=false",
        "--set", "log.checkpoint=true", "--set", "log.checkpoint_after_frac=0.3",
        "--set", "log.log_every=1"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, where torch's
    thread pool only adds contention with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows_without_time(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        assert isinstance(row.pop("time"), float)
    return rows


def test_scalar_logger_writes_the_jax_rows(tmp_path):
    ours = tlogging.ScalarLogger(str(tmp_path / "torch"))
    theirs = jlogging.ScalarLogger(str(tmp_path / "jax"))
    calls = [(0, {"loss_g": 1.25, "loss_d": -0.5, "lr": 2e-4}),
             (3, {"loss_g": np.float32(0.1), "loss_d": 2.0, "lr": 1e-4}),
             (5, {"metrics/fid": 12.5, "eval_seconds": 3.0}),
             (9, {"loss_g": 7, "loss_d": 1e-30, "lr": 0.0})]
    for logger in (ours, theirs):
        for step, scalars in calls:
            logger.log(step, {k: (float(v) if isinstance(v, np.floating) else v)
                              for k, v in scalars.items()})
        logger.log_image_grid(9, np.zeros((4, 6, 3), np.uint8))
        logger.close()
    for name in ("gan_losses.csv",):
        assert (tmp_path / "torch" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert _rows_without_time(ours.jsonl_path) == _rows_without_time(theirs.jsonl_path)
    assert os.listdir(tmp_path / "torch" / "tb")  # tensorboardX is installed here
    # appending to an existing log keeps one header, as JAX's does
    again = tlogging.ScalarLogger(str(tmp_path / "torch"), tensorboard=False)
    again.log(10, {"loss_g": 1.0, "loss_d": 1.0, "lr": 0.0})
    again.close()
    with open(ours.csv_path) as f:
        assert [r[0] for r in csv.reader(f)] == ["step", "0", "3", "9", "10"]
    assert os.path.exists(tlogging.save_loss_plot(ours.csv_path))


@pytest.mark.parametrize("channels, n, nrow", [(3, 10, 4), (1, 5, 8), (3, 64, 8)])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_grids_and_pngs_match_jax(channels, n, nrow, kind, tmp_path):
    rng = np.random.RandomState(n)
    images = (rng.randint(0, 256, (n, 7, 5, channels)).astype(np.uint8) if kind == "uint8"
              else rng.uniform(-1.3, 1.3, (n, 7, 5, channels)).astype(np.float32))
    grid = tlogging.make_grid(images, nrow)
    assert np.array_equal(grid, jlogging.make_grid(images, nrow))
    ours = tlogging.save_image_grid(images, str(tmp_path / "a" / "ours.png"), nrow)
    theirs = jlogging.save_image_grid(images, str(tmp_path / "theirs.png"), nrow)
    with Image.open(ours) as a, Image.open(theirs) as b:
        assert a.mode == b.mode == "RGB"
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape", [(3, 4), (3, 4, 1), (5, 2, 3), (2, 6, 4)])
def test_png_encoder_round_trips(shape, tmp_path):
    image = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = tlogging.save_png(image, str(tmp_path / "x.png"))
    with Image.open(path) as decoded:
        assert np.array_equal(np.asarray(decoded), image.reshape(image.shape[:2] + (
            () if image.ndim == 2 or image.shape[2] == 1 else image.shape[2:])))
    with pytest.raises(ValueError):
        tlogging.encode_png(image.astype(np.float32))


ARGVS = [
    ["train"],
    ["train", "--preset", "fgan32", "-b", "32", "-e", "1000", "-l", "1e-3", "-o", "runs/a",
     "--set", "model.ratio_g=0.5", "--set", "eval.fid=false", "--checkpoint"],
    ["sample", "--preset", "fgan_cond48", "--dataset", "stl10", "--data_path", "/d",
     "--num_samples", "100", "--per_sample"],
    ["train", "--preset", "sagan", "--set", "train.steps_per_call=4",
     "--set", "log.compilation_cache=None", "--set", "train.d_lr=5e-4"],
    ["export", "--preset", "fgan128", "--output", "g.ffcx", "--platforms", "cpu"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:3]))
def test_parse_cli_matches_jax(argv):
    command, cfg, extras = config.parse_cli(argv + ["--device", "cpu"])
    jcommand, jcfg, jextras = jconfig.parse_cli(argv)
    assert command == jcommand
    assert cfg.to_json() == jcfg.to_json()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert extras.pop("device") == "cpu"
    # the port's artifact runs on cpu and cuda: its default platforms
    jax_platforms = jextras.pop("platforms")
    assert extras.pop("platforms") == (jax_platforms if "--platforms" in argv
                                       else ("cpu", "cuda"))
    assert extras == jextras
    assert config.parse_cli(argv)[2]["device"] == "cuda"


def test_the_feed_normalises_as_jax_does():
    levels = np.arange(256, dtype=np.uint8).reshape(2, 2, 4, 4, 4)  # (K, B, H, W, C)
    norm = jax.jit(lambda x8: x8.astype(jnp.float32) / 127.5 - 1.0)  # cli.py's _norm
    want = np.asarray(norm(jnp.asarray(levels)))
    batches = iter([(levels[0], np.zeros(2, np.int64)), (levels[1], np.ones(2, np.int64))])
    feed = cli._Feed(batches, 2, torch.device("cpu"))
    reals, labels = feed.take(feed.put())
    assert reals.dtype == torch.float32
    assert reals.numpy().tobytes() == want.tobytes()
    assert cli.unit_levels().tobytes() == want.reshape(-1).tobytes()
    assert labels.tolist() == [[0, 0], [1, 1]]


class _Captured(Exception):
    pass


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_trainer_keywords_are_the_jax_clis(preset, monkeypatch, tmp_path):
    seen = {}

    def stub(g_model, d_model, **kwargs):
        seen.update(kwargs)
        raise _Captured

    monkeypatch.setattr(jtrain, "GANTrainer", stub)
    jcfg = jconfig.make_config(preset)
    jcfg.data.dataset = "synthetic"
    jcfg.log.compilation_cache = None
    jcfg.log.dir_logs = str(tmp_path)
    with pytest.raises(_Captured):
        jcli.run_train(jcfg)
    ours = cli.trainer_keywords(config.make_config(preset))
    assert (ours.pop("dtype"), ours.pop("seed")) == ("f32", 0)
    assert ours == seen


def _files(root):
    """The relative paths under ``root``, TensorBoard event files by their
    directory and checkpoints by their step."""
    found = set()
    for dirpath, _, names in os.walk(root):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if rel.startswith("tb" + os.sep):
                rel = os.path.join("tb", "events")
            found.add(rel.replace(".ckpt", ".pt"))
    return found


def _run(argv):
    cli.main(argv + CPU)


# a pair the JAX CLI compiles quickly, for the run both CLIs make
DCGAN = TINY + ["--set", "data.image_size=64", "--set", "model.generator=dcgan",
                "--set", "model.discriminator=dcgan", "--set", "model.ngf=8",
                "--set", "model.ndf=8", "--set", "model.z_size=16",
                "--set", "train.loss=bce"]


def test_train_writes_the_jax_clis_files(tmp_path):
    ours, theirs = str(tmp_path / "torch"), str(tmp_path / "jax")
    flags = ["-e", "6"] + DCGAN
    _run(["train", *flags, "-o", ours])
    jcli.main(["train", *flags, "--set", "log.compilation_cache=", "-o", theirs])
    assert _files(ours) == _files(theirs)
    assert {"000003.png", "000006.png", "gan_losses.csv", "gan_losses.png",
            os.path.join("checkpoints", "ckpt_6_steps.pt")} <= _files(ours)
    with open(os.path.join(ours, "gan_losses.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == list(range(6))
    assert all(np.isfinite(float(r["loss_G"])) and np.isfinite(float(r["loss_D"]))
               for r in rows)
    with open(os.path.join(theirs, "gan_losses.csv")) as f:
        assert [r["lr"] for r in csv.DictReader(f)] == [r["lr"] for r in rows]


def _loss_rows(run):
    with open(os.path.join(run, "gan_losses.csv")) as f:
        return [tuple(r.values()) for r in csv.DictReader(f)]


def test_train_with_remat_logs_the_losses_of_the_run_without(tmp_path):
    """``--set train.remat=dots`` trains (the tiny FFC pair, 3 steps) and
    logs the same losses as the run without remat: the recompute changes
    nothing the step computes."""
    runs = {}
    for remat in ("none", "dots"):
        runs[remat] = str(tmp_path / remat)
        _run(["train", *TINY, "-e", "3", "--set", f"train.remat={remat}", "-o", runs[remat]])
    rows = _loss_rows(runs["dots"])
    assert len(rows) == 3 and rows == _loss_rows(runs["none"])
    assert os.path.exists(os.path.join(runs["dots"], "checkpoints", "ckpt_3_steps.pt"))


def test_resume_sample_and_chunks_continue_the_run(tmp_path, capsys):
    run = str(tmp_path / "run")
    _run(["train", "-e", "9", *TINY, "-o", run])
    straight = _loss_rows(run)
    assert [r[0] for r in straight] == [str(s) for s in range(9)]
    # the process stopped after step 6's checkpoint
    os.unlink(os.path.join(run, "checkpoints", "ckpt_9_steps.pt"))
    capsys.readouterr()
    _run(["train", "-e", "9", *TINY, "-o", run])
    assert "INFO: resumed from step 6" in capsys.readouterr().out
    resumed = _loss_rows(run)[9:]
    assert resumed == straight[6:]

    chunked = str(tmp_path / "chunked")
    _run(["train", "-e", "9", *TINY, "--set", "train.steps_per_call=3",
          "--set", "log.log_every=3", "--set", "log.profile_at_step=3", "-o", chunked])
    assert _loss_rows(chunked) == [straight[2], straight[5], straight[8]]
    assert os.path.getsize(os.path.join(chunked, "profile", "trace.json")) > 0

    _run(["sample", *TINY, "--num_samples", "5", "--per_sample", "-o", run])
    assert "INFO: sample from step 9" in capsys.readouterr().out
    with Image.open(os.path.join(run, "samples_000009.png")) as grid:
        assert grid.size == (8 * 18 + 2, 18 + 2)
    assert sorted(os.listdir(os.path.join(run, "samples_000009"))) == [
        f"sample_{i:05d}.png" for i in range(5)]
    assert os.path.exists(os.path.join(run, "feature_maps_000009.png"))


def test_conditional_runs_infer_the_class_count(tmp_path, capsys):
    run = str(tmp_path / "cond")
    flags = ["--preset", "fgan_cond32", "--set", "model.num_classes=0",
             "--set", "data.dataset=shapes", "--set", "model.ngf=8", "--set", "model.z_size=8",
             "--set", "train.batch_size=4", "--set", "eval.isc=false",
             "--set", "eval.fid=false", "--set", "eval.kid=false", "--checkpoint"]
    _run(["train", *flags, "-e", "2", "--set", "train.num_epoch_steps=2", "-o", run])
    _run(["sample", *flags, "--num_samples", "6", "-o", run])
    out = capsys.readouterr().out
    assert out.count("[config] model.num_classes=3") == 2
    assert os.path.exists(os.path.join(run, "samples_000002.png"))
    # a dataset that fails to load raises its own error, not "no labels"
    with pytest.raises(FileNotFoundError):
        _run(["sample", *flags, "--set", "data.dataset=mnist", "--data_path",
              str(tmp_path / "absent"), "-o", run])


# The in-loop eval at TINY size: the metric combinations the presets switch
# on (fgan32, sngan: ISC and FID; fgan_cond32, fgan_cond48, resnet32, sagan:
# with KID), on few samples, weights-free (no InceptionV3 file in reach),
# the feature cache in the run's own directory.
METRIC_SETS = {"isc-fid": ("isc", "fid"), "isc-fid-kid": ("isc", "fid", "kid")}
METRIC_KEYS = {"isc": ("inception_score_mean", "inception_score_std"),
               "fid": ("frechet_inception_distance",),
               "kid": ("kernel_inception_distance_mean", "kernel_inception_distance_std")}


@contextlib.contextmanager
def _weights_free_env(root):
    """No InceptionV3, VGG16 or LPIPS file in reach, the feature cache under
    ``root``."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("FFC_TPU_INCEPTION_WEIGHTS", "FFC_TPU_VGG16_WEIGHTS",
                     "FFC_TPU_LPIPS_WEIGHTS"):
            mp.delenv(name, raising=False)
        mp.setenv("HOME", str(root / "home"))
        mp.setenv("FFC_TPU_HOME", str(root / "ffc_home"))
        yield root / "ffc_home"


@pytest.fixture
def weights_free_home(tmp_path):
    with _weights_free_env(tmp_path) as home:
        yield home


def _metric_flags(metrics, best=True):
    flags = ["--set", "eval.num_samples_for_metrics=16"]
    for name in ("isc", "fid", "kid"):
        flags += ["--set", f"eval.{name}={'true' if name in metrics else 'false'}"]
    return flags + ["--set", f"log.best_metric_checkpoints={'true' if best else 'false'}"]


def _metric_run(root, metrics):
    """A 6-step TINY run with ``metrics`` and best-metric checkpoints:
    (its directory, its stdout, the cache directory)."""
    run, out = str(root / "run"), io.StringIO()
    with _weights_free_env(root) as home, contextlib.redirect_stdout(out):
        _run(["train", *TINY, "-e", "6", *_metric_flags(metrics), "-o", run])
    return run, out.getvalue(), home


@pytest.fixture(scope="module")
def kid_run(tmp_path_factory):
    return _metric_run(tmp_path_factory.mktemp("kid_run"), METRIC_SETS["isc-fid-kid"])


@pytest.mark.parametrize("metrics", list(METRIC_SETS), ids=list(METRIC_SETS))
def test_train_logs_the_metrics_and_keeps_the_best_checkpoint(metrics, tmp_path, request):
    """Every epoch's ``metrics/<key>`` and ``eval_seconds`` in scalars.jsonl,
    the real set's features cached under ``FFC_TPU_HOME``, one checkpoint
    in ``checkpoints/best/``, the weights-free warning printed once."""
    run, out, home = (request.getfixturevalue("kid_run") if metrics == "isc-fid-kid"
                      else _metric_run(tmp_path, METRIC_SETS[metrics]))
    with open(os.path.join(run, "scalars.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval_seconds" in r]
    want = {f"metrics/{k}" for m in METRIC_SETS[metrics] for k in METRIC_KEYS[m]}
    assert [r["step"] for r in evals] == [3, 6]
    for r in evals:
        assert want <= set(r) and all(np.isfinite(r[k]) for k in want) and r["eval_seconds"] > 0
    assert out.count("WARNING: no InceptionV3 weights found") == 1
    assert "WARNING: metrics failed" not in out and "INFO: best ISC so far" in out
    assert len(os.listdir(os.path.join(run, "checkpoints", "best"))) == 1
    cached = os.listdir(home / "fidelity_cache_torch")
    assert "synthetic-16-n16-inception-v3-compat-weights-free-features-192.npz" in cached


def test_a_failed_eval_is_logged_and_training_goes_on(tmp_path, capsys, monkeypatch,
                                                     weights_free_home):
    from fastfourierconvolution_tpu_torch import eval as teval

    def broken(*args, **kwargs):
        raise RuntimeError("extractor broke")

    monkeypatch.setattr(teval, "calculate_metrics", broken)
    run = str(tmp_path / "run")
    _run(["train", *TINY, "-e", "3", *_metric_flags(("isc", "fid")), "-o", run])
    captured = capsys.readouterr()
    assert "WARNING: metrics failed: extractor broke" in captured.out
    assert "RuntimeError: extractor broke" in captured.err  # the traceback
    assert "Training finished." in captured.out
    assert os.path.exists(os.path.join(run, "checkpoints", "ckpt_3_steps.pt"))


def test_metrics_leave_the_training_run_unchanged(tmp_path, kid_run):
    """The eval draws from its own generators and runs G in eval mode: the
    f32 losses and the final checkpoint of a run with ISC, FID and KID are
    the bits of the run without metrics."""
    on, off = kid_run[0], str(tmp_path / "off")
    _run(["train", *TINY, "-e", "6", *_metric_flags((), best=False), "-o", off])
    assert _loss_rows(on) == _loss_rows(off)
    saved = [torch.load(os.path.join(run, "checkpoints", "ckpt_6_steps.pt"), weights_only=True)
             for run in (on, off)]
    flat = [dict(_flatten_state(s)) for s in saved]
    assert flat[0].keys() == flat[1].keys()
    for key, value in flat[0].items():
        other = flat[1][key]
        assert (torch.equal(value, other) if isinstance(value, torch.Tensor)
                else value == other), key


def _flatten_state(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_state(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_state(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


PRC_KEYS = ("precision", "recall", "f_score")
PPL_KEYS = ("perceptual_path_length_mean", "perceptual_path_length_std")


@pytest.fixture(scope="module")
def prc_ppl_run(tmp_path_factory):
    """A 3-step TINY run with ``eval.prc`` and ``eval.ppl`` on 8 samples,
    weights-free: (its directory, its stdout, the cache directory)."""
    root = tmp_path_factory.mktemp("prc_ppl_run")
    run, out = str(root / "run"), io.StringIO()
    with _weights_free_env(root) as home, contextlib.redirect_stdout(out):
        _run(["train", *TINY, "-e", "3", "--set", "eval.num_samples_for_metrics=8",
              "--set", "eval.prc=true", "--set", "eval.ppl=true", "-o", run])
    return run, out.getvalue(), home


def _logged_metrics(run):
    with open(os.path.join(run, "scalars.jsonl")) as f:
        return [r for r in map(json.loads, f) if "eval_seconds" in r]


@pytest.mark.parametrize("metric", ["prc", "ppl"])
def test_train_evaluates_prc_and_ppl(metric, prc_ppl_run):
    """``eval.prc`` (VGG16 features of the generated samples against the
    registered real set, cached under its name) and ``eval.ppl`` (LPIPS on
    the generator's latent pairs) logged at the epoch boundary, finite, with
    the weights-free warning."""
    run, out, home = prc_ppl_run
    evals = _logged_metrics(run)
    assert [r["step"] for r in evals] == [3]
    keys = PRC_KEYS if metric == "prc" else PPL_KEYS
    assert all(np.isfinite(evals[0][f"metrics/{k}"]) for k in keys), evals
    assert "WARNING: metrics failed" not in out
    assert "WARNING: no VGG16 (PRC) or LPIPS (PPL) weights found" in out
    if metric == "prc":
        cached = os.listdir(home / "fidelity_cache_torch")
        assert cached == ["synthetic-16-n8-vgg16-weights-free-features-fc2_relu.npz"]
    else:
        assert evals[0]["metrics/perceptual_path_length_mean"] > 0


REFUSED = [
    (["train", *TINY, "--set", "train.tp=2"], ValueError, "must divide the process count 1"),
    (["train", *TINY, "--set", "train.steps_per_call=4"], ValueError, "must divide"),
    (["sample", *TINY, "--num_samples", "0"], SystemExit, "num_samples"),
    (["sample", *TINY], SystemExit, "no checkpoint found"),
    (["export", *TINY], SystemExit, "no checkpoint found"),
    (["export", *TINY, "--platforms", "cpu,tpu"], SystemExit, "--platforms tpu"),
    (["sample", *TINY, "--set", "model.generator=sngan_resnet", "--torch_checkpoint", "g.pth"],
     SystemExit, "supports the 'ffc' generator"),
    (["sample", *TINY, "--torch_checkpoint", "g.pth"], SystemExit, "no such checkpoint file"),
    (["sample", *TINY, "--exported", "g.ffcx"], SystemExit, "no such serving artifact"),
    (["--preset", "fgan32", "fidelity"], SystemExit, "put the command first"),
]


@pytest.mark.parametrize("argv, error, message", REFUSED, ids=lambda v: str(v)[:40])
def test_options_not_ported_are_refused(argv, error, message, tmp_path):
    with pytest.raises(error, match=message.replace(".", r"\.")):
        _run(argv + ["-o", str(tmp_path)])


FIDELITY_REFUSED = [
    (["fidelity", "a", "b"], SystemExit, "at least one of"),
    (["fidelity", "a", "-i"], SystemExit, "cannot resolve input 'a'"),
    (["fidelity", "absent.ffcx", "-i"], SystemExit, "no such model file"),
]


@pytest.mark.parametrize("argv, error, message", FIDELITY_REFUSED, ids=lambda v: str(v)[:40])
def test_fidelity_refusals(argv, error, message):
    with pytest.raises(error, match=message.replace(".", r"\.")):
        _run(argv)


def test_refusals_at_start(tmp_path, monkeypatch):
    # a partial multi-process launch (tests/test_torch_parallel.py runs whole ones)
    monkeypatch.setenv("FFC_TPU_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="a multi-process launch needs all of"):
        _run(["train", *TINY, "-o", str(tmp_path)])
    monkeypatch.delenv("FFC_TPU_COORDINATOR")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", *TINY, "-o", str(tmp_path)])
    assert not os.listdir(tmp_path)  # nothing written before the refusals


def test_download_fetches_the_dataset(tmp_path, monkeypatch, capsys):
    """``download`` runs ``data/download.py``'s ``fetch`` of ``--dataset``
    into ``--data_path``, every file through the transport."""
    from fastfourierconvolution_tpu_torch.data import download

    opened = []

    def transport(url):
        opened.append(url)
        return io.BytesIO(b"svhn bytes")

    monkeypatch.setattr(download, "_default_transport", transport)
    monkeypatch.setenv("FFC_TPU_DOWNLOAD_NO_VERIFY", "1")
    _run(["download", "--dataset", "svhn", "--data_path", str(tmp_path)])
    assert f"downloaded 2 file(s) to {tmp_path}" in capsys.readouterr().out
    assert opened == [f.url for f in download.DOWNLOADS["svhn"]]
    assert sorted(os.listdir(tmp_path)) == ["test_32x32.mat", "train_32x32.mat"]


@pytest.fixture(scope="module")
def jax_run_dir(tmp_path_factory):
    """A run directory whose one checkpoint the JAX package wrote: TINY's
    config (the same ``make_config`` and overrides) built by the JAX zoo,
    its trainer keyed as the JAX CLI keys it, seeded variables, one jitted
    step, ``save_checkpoint`` at step 1."""
    from fastfourierconvolution_tpu.train.checkpoint import save_checkpoint
    from fastfourierconvolution_tpu.zoo import build_models as jbuild_models

    from test_torch_jax_checkpoint import _seeded_state

    jcfg = jconfig.apply_overrides(jconfig.make_config(), TINY[1::2])
    m, t = jcfg.model, jcfg.train
    trainer = jtrain.GANTrainer(*jbuild_models(jcfg), z_size=m.z_size, lr=t.lr,
                                total_steps=t.num_total_steps, optimizer=t.optimizer,
                                b1=t.beta1, b2=t.beta2)
    size = jcfg.data.image_size
    state = _seeded_state(trainer, m.z_size, size)
    real = np.random.default_rng(3).uniform(-1, 1, (t.batch_size, size, size, 3))
    state, _ = jax.jit(trainer.update_step)(state, jnp.asarray(real, jnp.float32))
    run = str(tmp_path_factory.mktemp("jax_run"))
    save_checkpoint(state, os.path.join(run, "checkpoints"), 1)
    return run


def _copy_run(run, tmp_path):
    import shutil

    return shutil.copytree(run, str(tmp_path / "run"))


def test_train_resumes_and_sample_reads_a_jax_run_directory(jax_run_dir, tmp_path, capsys):
    run = _copy_run(jax_run_dir, tmp_path)
    _run(["sample", *TINY, "--num_samples", "4", "-o", run])
    assert "INFO: sample from step 1" in capsys.readouterr().out
    assert os.path.exists(os.path.join(run, "samples_000001.png"))
    _run(["train", "-e", "3", *TINY, "-o", run])
    assert "INFO: resumed from step 1" in capsys.readouterr().out
    assert [r[0] for r in _loss_rows(run)] == ["1", "2"]
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == [
        "ckpt_1_steps.ckpt", "ckpt_3_steps.pt"]
    _run(["sample", *TINY, "--num_samples", "4", "-o", run])
    assert "INFO: sample from step 3" in capsys.readouterr().out


# A child process in which the optional packages are absent (a None entry
# in sys.modules makes an import raise and find_spec report no module).
WITHOUT_OPTIONAL_PACKAGES = """
import sys
for name in ('PIL', 'matplotlib', 'sklearn', 'scipy', 'tensorboardX', 'tqdm', 'jax', 'flax',
             'optax', 'msgpack', 'fastfourierconvolution_tpu'):
    sys.modules[name] = None
from fastfourierconvolution_tpu_torch import cli
cli.main(sys.argv[1:])
"""


def test_train_needs_only_torch_and_numpy(jax_run_dir, tmp_path):
    """On a copy of the JAX run directory: ``train`` resumes its ``.ckpt``
    and ``sample`` draws from the ``.pt`` that train wrote."""
    run = _copy_run(jax_run_dir, tmp_path)

    def child(*argv):
        out = subprocess.run(
            [sys.executable, "-c", WITHOUT_OPTIONAL_PACKAGES, *argv, *TINY,
             "--set", "data.dataset=shapes", *CPU, "-o", run],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    stdout = child("train", "-e", "3")
    assert "INFO: resumed from step 1" in stdout
    assert "WARNING: loss plot failed" in stdout
    assert {"000003.png", "gan_losses.csv", "scalars.jsonl"} <= set(os.listdir(run))
    assert "tb" not in os.listdir(run)
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == [
        "ckpt_1_steps.ckpt", "ckpt_3_steps.pt"]
    assert "INFO: sample from step 3" in child("sample", "--num_samples", "4")


# --- export, sample --exported, --torch_checkpoint, fidelity --------------------------


def test_export_then_sample_exported_draws_the_checkpoints_grid(kid_run, tmp_path, capsys):
    """``export`` of the 6-step TINY run (default path ``<run>/generator.ffcx``)
    writes the JAX package's metadata; ``sample --exported`` draws the PNG
    grid ``sample`` draws from the checkpoint, byte for byte."""
    from fastfourierconvolution_tpu_torch.serving import read_artifact

    run = kid_run[0]
    _run(["export", *TINY, "-o", run])
    assert "exported " + os.path.join(run, "generator.ffcx") in capsys.readouterr().out
    meta, _ = read_artifact(os.path.join(run, "generator.ffcx"))
    assert meta == {"z_size": 32, "z_type": "normal", "num_classes": 0, "image_size": 16,
                    "channels": 3, "platforms": ["cpu", "cuda"], "step": 6}
    served = str(tmp_path / "served")
    _run(["sample", *TINY, "--exported", os.path.join(run, "generator.ffcx"),
          "--num_samples", "5", "-o", served])
    _run(["sample", *TINY, "--num_samples", "5", "-o", run])
    with open(os.path.join(served, "samples_000006.png"), "rb") as a, \
            open(os.path.join(run, "samples_000006.png"), "rb") as b:
        assert a.read() == b.read()


def _tiny_reference_checkpoint(path):
    """A seeded reference-repo ``.pth`` (the FFCModel container) for TINY's
    generator, and the JAX model it converts to."""
    from fastfourierconvolution_tpu.zoo import build_generator as jbuild_generator

    from test_torch_compat import reference_dict

    jcfg = jconfig.apply_overrides(jconfig.make_config(), TINY[1::2])
    jmodel = jbuild_generator(jcfg)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda z: jmodel.init(rngs, z, True), jnp.zeros((2, 32)))
    torch.save({"model_state_dict": reference_dict(shapes, seed=5)}, path)
    return jmodel


def test_torch_checkpoint_samples_and_exports(tmp_path, capsys):
    """``sample --torch_checkpoint`` draws from a reference ``.pth``;
    ``export --torch_checkpoint`` gives an artifact whose images are within
    1 uint8 level of the JAX package's generator on the JAX converter's
    variables (f32)."""
    import fastfourierconvolution_tpu.compat as jcompat
    from fastfourierconvolution_tpu.models.ffc_gan import to_uint8 as jto_uint8
    from fastfourierconvolution_tpu_torch.serving import load_exported

    pth, out = str(tmp_path / "ref.pth"), str(tmp_path / "out")
    jmodel = _tiny_reference_checkpoint(pth)
    _run(["sample", *TINY, "--torch_checkpoint", pth, "--num_samples", "4", "-o", out])
    assert f"INFO: sample from reference checkpoint {pth}" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "samples_000000.png"))
    _run(["export", *TINY, "--torch_checkpoint", pth, "-o", out])
    call, meta = load_exported(os.path.join(out, "generator.ffcx"), "cpu")
    assert meta["step"] == 0
    z = np.random.default_rng(6).normal(size=(3, 32)).astype(np.float32)
    ours = call(z).numpy().astype(int)
    variables = jcompat.convert_fgan_generator(pth, mg=2)
    ref = np.asarray(jto_uint8(jmodel.apply(variables, jnp.asarray(z), False))).astype(int)
    assert ref.std() > 5  # real images
    assert np.abs(ours - ref).max() <= 1


def _metric_flags_fidelity(n):
    return ["-i", "-f", "-k", "--kid-subsets", "10", "--kid-subset-size", "8", "--isc-splits",
            "2", "-b", "8", "--input1-model-num-samples", str(n), "--silent", "-j"]


def test_fidelity_gives_calculate_metrics(kid_run, tmp_path, capsys, weights_free_home):
    """``fidelity`` on .npz against .npz, and on the TINY run's artifact and
    on its run directory (``--preset`` and TINY's ``--set``s) against .npz,
    prints ``calculate_metrics``' numbers on the same inputs: the artifact
    and the run directory the same, the same generator on the same
    latents."""
    from fastfourierconvolution_tpu_torch.eval import calculate_metrics
    from fastfourierconvolution_tpu_torch.serving import exported_generative_model

    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 256, (16, 16, 16, 3), dtype=np.uint8) for _ in range(2))
    np.savez(tmp_path / "a.npz", images=a)
    np.savez(tmp_path / "b.npz", images=b)
    keywords = dict(isc=True, fid=True, kid=True, kid_subsets=10, kid_subset_size=8,
                    isc_splits=2, batch_size=8, input1_model_num_samples=16, device="cpu")

    def printed(argv):
        capsys.readouterr()
        _run(["fidelity", *argv, *_metric_flags_fidelity(16)])
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    arrays = printed([str(tmp_path / "a.npz"), str(tmp_path / "b.npz")])
    assert arrays == {k: float(v) for k, v in calculate_metrics(a, b, **keywords).items()}

    run = kid_run[0]
    artifact = os.path.join(run, "generator.ffcx")
    if not os.path.exists(artifact):
        _run(["export", *TINY, "-o", run])
    served = printed([artifact, str(tmp_path / "b.npz")])
    want = calculate_metrics(exported_generative_model(artifact, "cpu"), b, **keywords)
    assert served == {k: float(v) for k, v in want.items()}
    assert printed([run, str(tmp_path / "b.npz"), "--preset", "fgan32",
                    *[f"--set={kv}" for kv in TINY[1::2]]]) == served


def test_fidelity_prc_gives_calculate_metrics(tmp_path, capsys, weights_free_home):
    """``fidelity -r`` on .npz against .npz prints ``calculate_metrics``'
    PRC (the weights-free VGG16, PRC's default extractor)."""
    from fastfourierconvolution_tpu_torch.eval import calculate_metrics

    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8) for _ in range(2))
    np.savez(tmp_path / "a.npz", images=a)
    np.savez(tmp_path / "b.npz", images=b)
    _run(["fidelity", str(tmp_path / "a.npz"), str(tmp_path / "b.npz"), "-r", "-b", "5",
          "--silent", "-j"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = calculate_metrics(a, b, prc=True, batch_size=5, device="cpu")
    assert printed == {k: float(v) for k, v in want.items()} and sorted(want) == sorted(PRC_KEYS)


def test_fidelity_ppl_of_the_run_directory_is_the_runs(prc_ppl_run, tmp_path, capsys):
    """``fidelity -p`` on the run directory (its step-3 checkpoint, 8 samples,
    batch 8) prints the PPL the run logged at step 3; ``-p`` on images exits
    with the JAX CLI's message."""
    run, _, home = prc_ppl_run
    with _weights_free_env(tmp_path):
        _run(["fidelity", run, "-p", "--preset", "fgan32", *[f"--set={kv}" for kv in TINY[1::2]],
              "-b", "8", "--input1-model-num-samples", "8", "--silent", "-j"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == {k: _logged_metrics(run)[0][f"metrics/{k}"] for k in PPL_KEYS}
        np.savez(tmp_path / "a.npz", images=np.zeros((4, 16, 16, 3), np.uint8))
        with pytest.raises(SystemExit, match="--ppl needs a generative input1"):
            _run(["fidelity", str(tmp_path / "a.npz"), "-p"])
