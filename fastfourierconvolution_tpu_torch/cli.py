"""The CLI, the JAX package's ``cli.py``: train, sample, export, fidelity.

    python -m fastfourierconvolution_tpu_torch.cli train --preset fgan32 \\
        --set eval.isc=false --set eval.fid=false --checkpoint -o DIR
    python -m fastfourierconvolution_tpu_torch.cli sample --preset fgan32 -o DIR
    python -m fastfourierconvolution_tpu_torch.cli export --preset fgan32 -o DIR
    python -m fastfourierconvolution_tpu_torch.cli sample --exported DIR/generator.ffcx -o DIR
    python -m fastfourierconvolution_tpu_torch.cli fidelity DIR/generator.ffcx REAL -i -f

``train`` loads the dataset, feeds uint8 batches to the device (the next
chunk's copy overlapping the current one's steps) and normalises them
there to the JAX CLI's f32 values (``unit_levels``), runs ``train.steps_per_call`` steps per ``GANTrainer.update_steps``
call (on the card, replays of the step's captured CUDA graph), logs the
losses every ``log.log_every`` steps, and every ``train.num_epoch_steps``
steps evaluates the metrics the config switches on (``eval.isc``,
``eval.fid``, ``eval.kid``, ``eval.prc``, ``eval.ppl``:
``eval.calculate_metrics`` on ``eval.num_samples_for_metrics`` samples of
``GANTrainer.generate`` against the training set's registered real set,
logged as
``metrics/<key>`` with ``eval_seconds``; the best leading metric's
checkpoint kept in ``checkpoints/best/`` with
``log.best_metric_checkpoints``), writes a fixed-latent sample grid and
(past ``log.checkpoint_after_frac``) a checkpoint, and resumes from the
newest checkpoint where the JAX CLI does, data order included. A failed
evaluation prints ``WARNING: metrics failed`` and training goes on.
``sample`` draws PNG grids from the newest checkpoint, from a reference
repo's ``.pth`` (``--torch_checkpoint``, through ``compat.py``) or from a
serving artifact (``--exported``). ``export`` writes the eval-mode
generator of the newest checkpoint (or of a ``--torch_checkpoint``) as a
serving artifact (``serving.export_generator``, default
``<dir_logs>/generator.ffcx``; ``--platforms`` cpu and cuda). ``fidelity``,
which must come first on the command line, computes ISC, FID, KID, PRC and
PPL (``eval.calculate_metrics``) of two inputs with torch-fidelity's flags:
registered datasets, ``.npz``/``.npy`` arrays, serving artifacts,
TorchScript and ONNX models, run directories with checkpoints (through
``--preset``), directories of images and ``<dataset>-<size>`` names. All
run on ``cuda`` unless ``--device cpu`` is given.

``train`` runs data-parallel as N processes, one card each, where the
JAX CLI's launch environment asks for it (``parallel.initialize``:
``FFC_TPU_COORDINATOR``, ``FFC_TPU_NUM_PROCESSES`` and
``FFC_TPU_PROCESS_ID``, or ``FFC_TPU_DISTRIBUTED=auto`` under torchrun).
Every process joins the group before it touches a device, loads its
``train.batch_size / N`` slice of each global batch, steps in lockstep
with the others (the step is the global batch's, ``train/gan.py``),
restores the same checkpoint, and takes its share of each evaluation
(``calculate_metrics`` in the group); rank 0 alone prints, logs and
writes grids and checkpoints. Where processes share a card (gloo), whose
collectives run on the host and cannot be captured, each call is one
eager ``update_step`` and K = ``train.steps_per_call`` above 1 is refused
at start.

With ``train.tp`` = T above 1 the N processes form a dp x tp grid, as the
JAX CLI's mesh: rank d·T + t is slice t of its tp group (ranks d·T to
d·T + T - 1, which must sit on one host) and takes dp slice d of each
global batch; every FourierUnit whose channels T divides runs on its
out-channel slice (``train/gan.py``). T must divide N (ValueError, a
single process with T > 1 included). The epoch's sample grid and every
checkpoint gather over the tp group, so every process takes part and rank
0 alone writes; checkpoints hold whole tensors, so a run resumes at any T.

``download`` fetches ``data.dataset`` into ``data.data_dir`` from its
canonical source (``data/download.py``). ``train``, ``sample``, ``export``
and ``fidelity`` read the JAX package's ``.ckpt`` checkpoints too
(``train/checkpoint.py``): a run directory the JAX CLI wrote resumes (the
port then writes ``.pt`` files beside the ``.ckpt`` ones), samples and
scores with the config that run used. ``log.compilation_cache`` is the JAX
package's XLA compile cache: accepted, and nothing in the port reads it.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

# The leading metric of best-metric checkpoints: its key and the sign that
# makes larger better (ISC higher, FID/KID/PPL lower is better).
_LEADING = {"ISC": ("inception_score_mean", +1), "FID": ("frechet_inception_distance", -1),
            "KID": ("kernel_inception_distance_mean", -1),
            "PPL": ("perceptual_path_length_mean", -1)}
# reference-checkpoint converters by generator (compat.py)
_CONVERTERS = {"ffc": "convert_fgan_generator", "ffc_cond": "convert_fcond_generator"}


def trainer_keywords(cfg) -> dict:
    """The ``GANTrainer`` keywords of a config: those the JAX CLI passes
    (D's fused pass only for the BN-free SN discriminators and without the
    aw-method, D's progress only for the library cDCGAN discriminator),
    plus the compute dtype (``train.precision``) and the seed of the
    latent and noise generators (``train.seed``)."""
    m, t = cfg.model, cfg.train
    return dict(z_size=m.z_size, lr=t.lr, d_lr=t.d_lr, total_steps=t.num_total_steps,
                num_dis_updates=t.num_dis_updates, loss=t.loss, optimizer=t.optimizer,
                b1=t.beta1, b2=t.beta2, conditional=m.conditional, num_classes=m.num_classes,
                fused_dis_batch=(m.discriminator in ("sn_conv", "cond_sn_conv", "sn_dcgan")
                                 and not t.aw_method),
                gp_lambda=t.gp_lambda, aw_method=t.aw_method, update_order=t.update_order,
                remat=t.remat, d_progress_arg=m.discriminator == "cond_dcgan",
                dtype=t.precision, seed=t.seed)


def _say(*args, **kwargs) -> None:
    """print, on rank 0 of a process group (every process runs the same
    loop; one of them speaks)."""
    from . import parallel

    if parallel.process_index() == 0:
        print(*args, **kwargs)


def _maybe_infer_num_classes(cfg, dataset=None) -> None:
    """Fill ``model.num_classes`` from the dataset's labels when a
    conditional run leaves it unset (< 2). Used by train (with its loaded
    dataset) and by sample (loading the dataset), so a checkpoint trained
    with an inferred count reloads with the same flags. A dataset that
    fails to load raises its own error."""
    if not cfg.model.conditional or cfg.model.num_classes >= 2:
        return
    from .data.datasets import load_dataset, num_classes_of

    if dataset is None:
        dataset = load_dataset(cfg.data.dataset, cfg.data.data_dir, cfg.data.image_size,
                               cfg.data.channels, download=cfg.data.download)
    inferred = num_classes_of(dataset)
    if inferred < 2:
        raise SystemExit(
            "model.conditional=true needs model.num_classes: the "
            f"'{cfg.data.dataset}' dataset does not carry class labels "
            "to infer it from — pass --set model.num_classes=N or use "
            "an unconditional model"
        )
    _say(f"[config] model.num_classes={inferred} (inferred from dataset '{cfg.data.dataset}')")
    cfg.model.num_classes = inferred


def unit_levels() -> np.ndarray:
    """The f32 value in [-1, 1] of each uint8 level as the JAX CLI's
    jitted ``x / 127.5 - 1`` gives it: XLA turns the division by the
    constant into a product with its f32 reciprocal and fuses the product
    with the add into one rounding, which differs from the division in
    the last bit for 205 of the 256 levels (XLA on the CPU). Here the
    product and the add are exact in f64 and rounded to f32 once."""
    reciprocal = np.float64(np.float32(1 / 127.5))
    return (np.arange(256, dtype=np.float64) * reciprocal - 1.0).astype(np.float32)


class _Feed:
    """Chunks of ``k`` batches from a ``DataLoader.epochs()`` stream on the
    device. :meth:`put` gathers the next chunk and starts its copy;
    :meth:`take` returns it as f32 images in [-1, 1] (``unit_levels``,
    looked up on the device) and int64 labels, ordered after the copy on
    the current stream.

    On the card a chunk goes through one of two pinned host buffers and a
    device buffer of the same slot, copied on a side stream, so the next
    chunk's copy runs while the current chunk's steps do. A slot's pinned
    buffer is refilled only after its last copy has finished, and its
    device buffer only after the current stream has read it."""

    def __init__(self, batches, k: int, device: torch.device):
        self.batches, self.k, self.device = batches, k, device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.levels = torch.from_numpy(unit_levels()).to(device)
        self._slots = [None, None]
        self._turn = 0

    def put(self):
        chunk = [next(self.batches) for _ in range(self.k)]
        x8 = np.stack([b[0] for b in chunk])
        y = np.stack([b[1] for b in chunk]).astype(np.int64)
        if not self.cuda:
            return torch.from_numpy(x8), torch.from_numpy(y)
        slot = self._slots[self._turn]
        if slot is None:
            slot = self._slots[self._turn] = {
                "host_x": torch.empty(x8.shape, dtype=torch.uint8, pin_memory=True),
                "host_y": torch.empty(y.shape, dtype=torch.int64, pin_memory=True),
                "x": torch.empty(x8.shape, dtype=torch.uint8, device=self.device),
                "y": torch.empty(y.shape, dtype=torch.int64, device=self.device),
                "copied": torch.cuda.Event(), "read": torch.cuda.Event(),
            }
        self._turn ^= 1
        slot["copied"].synchronize()  # the pinned buffers' last copy is done
        slot["host_x"].numpy()[...] = x8
        slot["host_y"].numpy()[...] = y
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(slot["read"])  # the device buffers' last reader
            slot["x"].copy_(slot["host_x"], non_blocking=True)
            slot["y"].copy_(slot["host_y"], non_blocking=True)
            slot["copied"].record(self.stream)
        return slot

    def take(self, slot):
        if not self.cuda:
            x8, y = slot
        else:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(slot["copied"])
            x8, y = slot["x"], slot["y"]
        reals, labels = self.levels[x8.long()], y.clone()
        if self.cuda:
            slot["read"].record(current)
        return reals, labels


def _register_real_set(cfg, dataset) -> str:
    """Register the training data's eval-side real set for FID, KID and PRC and
    return its name, ``{dataset}-{size}[-{tag}]-n{num_samples}``, which keys
    the feature cache: a path-dependent dataset or an aug stack adds a
    content tag (sha1 of the data directory and the stack). The set holds
    ``eval.num_samples_for_metrics`` images in a seeded order (2020), so a
    class-sorted folder gives all its classes; grayscale is repeated to
    RGB."""
    from .eval import register_dataset

    tag = ""
    path_kinds = ("folder", "local", "local_dataset", "tar")
    if cfg.data.dataset.lower() in path_kinds or cfg.data.aug_stack:
        key = f"{os.path.abspath(cfg.data.data_dir)}|{cfg.data.aug_stack}"
        tag = "-" + hashlib.sha1(key.encode()).hexdigest()[:8]
    n = cfg.eval.num_samples_for_metrics
    name = f"{cfg.data.dataset}-{cfg.data.image_size}{tag}-n{n}"

    def load_real():
        order = np.random.RandomState(2020).permutation(len(dataset))
        imgs = np.stack([dataset[int(i)][0] for i in order[:min(n, len(dataset))]])
        return np.repeat(imgs, 3, axis=-1) if imgs.shape[-1] == 1 else imgs

    register_dataset(name, load_real)
    return name


class _EpochEval:
    """``train``'s evaluation at an epoch boundary: the config's ISC, FID,
    KID, PRC and PPL of ``eval.num_samples_for_metrics`` samples of
    ``GANTrainer.generate`` (eval mode, latents and labels from the
    pipeline's own generators, so the trainer's state is not touched)
    against the registered real set, logged as ``metrics/<key>`` with
    ``eval_seconds``; a better leading metric is printed and, with
    ``log.checkpoint`` and ``log.best_metric_checkpoints``, its checkpoint
    kept alone in ``checkpoints/best/``. A failure is printed with its
    traceback and training goes on."""

    def __init__(self, cfg, trainer, dataset, device, ckpt_dir, logger):
        from .eval.inception import weights_available
        from .eval.lpips import LPIPS_WEIGHTS_ENV_VAR, vgg16_weights_path

        self.cfg, self.trainer, self.device, self.logger = cfg, trainer, device, logger
        self.best_dir = os.path.join(ckpt_dir, "best")
        e = cfg.eval
        self.on = e.isc or e.fid or e.kid or e.prc or e.ppl
        if (e.fid or e.kid or e.prc) and e.input2_dataset is None:
            e.input2_dataset = _register_real_set(cfg, dataset)
        self.lead_key, self.lead_sign = _LEADING.get(e.leading_metric.upper(), _LEADING["ISC"])
        self.best = None
        self.weights_free = ((e.isc or e.fid or e.kid)
                             and not weights_available(e.feature_extractor_weights_path))
        if self.weights_free:
            _say("WARNING: no InceptionV3 weights found — metrics run in weights-free "
                  "shallow-tap mode (relative trends only; not comparable to published FID/ISC "
                  "numbers, nor to the JAX package's weights-free numbers)")
        free = [what for what, on, path in (
            ("VGG16 (PRC)", e.prc, vgg16_weights_path(e.vgg_weights_path)),
            ("LPIPS (PPL)", e.ppl, e.lpips_weights_path or os.environ.get(LPIPS_WEIGHTS_ENV_VAR)))
            if on and not path]
        if free:
            _say(f"WARNING: no {' or '.join(free)} weights found — weights-free nets (relative "
                  f"trends only)")

    def __call__(self, step: int) -> None:
        from . import parallel
        from .eval import GenerativeModel, calculate_metrics

        if not self.on:
            return
        cfg, e = self.cfg, self.cfg.eval
        t0 = time.perf_counter()
        try:
            gm = GenerativeModel(
                apply=lambda z, labels=None: self.trainer.generate(z, labels, uint8=True),
                z_size=cfg.model.z_size,
                num_classes=cfg.model.num_classes if cfg.model.conditional else 0,
                device=self.device)
            with_real = e.input2_dataset is not None
            out = calculate_metrics(
                gm, e.input2_dataset, isc=e.isc, fid=e.fid and with_real,
                kid=e.kid and with_real, prc=e.prc and with_real, ppl=e.ppl,
                prc_input1_generated=True, input1_model_num_samples=e.num_samples_for_metrics,
                batch_size=min(cfg.train.batch_size, 128),
                feature_extractor_weights_path=e.feature_extractor_weights_path,
                lpips_weights_path=e.lpips_weights_path, vgg_weights_path=e.vgg_weights_path,
                device=self.device)
            seconds = time.perf_counter() - t0
            _say(f"step {step} metrics ({seconds:.1f}s): {out}", flush=True)
            self.logger.log(step, {**{f"metrics/{k}": v for k, v in out.items()},
                                   "eval_seconds": seconds})
            if self.lead_key in out:
                value = float(out[self.lead_key])
                if self.best is None or self.lead_sign * value > self.lead_sign * self.best:
                    self.best = value
                    tag = " [weights-free mode]" if self.weights_free else ""
                    _say(f"INFO: best {e.leading_metric} so far: {value:.5g} (step {step}){tag}")
                    if cfg.log.checkpoint and cfg.log.best_metric_checkpoints:
                        _save(self.trainer, self.best_dir, step, keep=1)
        except Exception as err:  # a failed evaluation must not end the training run
            traceback.print_exc()
            print(f"WARNING: metrics failed: {err}", flush=True)


def run_train(cfg, device="cuda") -> None:
    """Train the config's pair (see the module docstring), as one process
    of a group where the environment launches one."""
    from . import parallel

    # the process group first, before any device use
    device = parallel.initialize(device, tp=int(cfg.train.tp))
    try:
        _train(cfg, device)
        parallel.barrier()  # rank 0's last writes are done before any process leaves
    finally:
        parallel.shutdown()


def _train(cfg, device) -> None:
    from . import parallel
    from .data import DataLoader, load_dataset
    from .train.checkpoint import restore_latest
    from .train.gan import GANTrainer
    from .utils.logging import ScalarLogger, make_grid, save_image_grid, save_loss_plot
    from .utils.policy import resolve_device
    from .zoo import build_models

    device = resolve_device(device)
    t = cfg.train
    spc = max(1, int(t.steps_per_call))
    if spc > 1 and (cfg.log.log_every % spc or t.num_epoch_steps % spc
                    or t.num_total_steps % spc):
        raise ValueError("train.steps_per_call must divide log.log_every, "
                         "train.num_epoch_steps and train.num_total_steps")
    if spc > 1 and device.type == "cuda" and parallel.backend() == "gloo":
        raise ValueError(f"train.steps_per_call={spc}: the step runs as a CUDA graph, which "
                         f"cannot hold the gloo backend's collectives (processes that share a "
                         f"card); take train.steps_per_call=1, or one card per process (NCCL)")
    rank0 = parallel.process_index() == 0
    # under tp the sample grid and the checkpoints' states gather over the
    # tp group: every process makes those calls
    gathers = parallel.tp_count() > 1
    # gloo's collectives run on the host, outside any CUDA graph: one eager
    # step a call
    eager = device.type == "cuda" and parallel.backend() == "gloo"
    dataset = load_dataset(
        cfg.data.dataset, cfg.data.data_dir, cfg.data.image_size, cfg.data.channels,
        hflip_augment=cfg.data.hflip_augment, aug_stack=cfg.data.aug_stack,
        download=cfg.data.download,
    )
    _maybe_infer_num_classes(cfg, dataset)
    g_model, d_model = build_models(cfg)
    trainer = GANTrainer(g_model, d_model, **trainer_keywords(cfg), device=device)
    # uint8 batches, normalised on the device: 4x less host->device traffic;
    # each process its slice of every global batch
    loader = DataLoader(dataset, t.batch_size, seed=t.seed, raw_uint8=True,
                        process_index=parallel.dp_index(),
                        process_count=parallel.dp_count())

    ckpt_dir = os.path.join(cfg.log.dir_logs, "checkpoints")
    ini_step = 0
    if cfg.log.checkpoint:
        _, ini_step = restore_latest(trainer, ckpt_dir)
        if not parallel.all_equal(ini_step):
            raise SystemExit(f"the processes found different checkpoints to resume from (this "
                             f"one step {ini_step}): every process must see the same "
                             f"{ckpt_dir}")
        if ini_step:
            # replay the seeded epoch shuffles, so the batches continue
            # where the interrupted run stopped
            loader.skip_batches(ini_step)
            _say(f"INFO: resumed from step {ini_step}")

    logger = (ScalarLogger(cfg.log.dir_logs, tensorboard=cfg.log.tensorboard) if rank0
              else _NoLogger())
    evaluate = _EpochEval(cfg, trainer, dataset, device, ckpt_dir, logger)
    z_vis = torch.randn((cfg.log.samples_grid, cfg.model.z_size), device=device,
                        generator=torch.Generator(device).manual_seed(1234))
    y_vis = (torch.arange(cfg.log.samples_grid, device=device) % max(cfg.model.num_classes, 1)
             if cfg.model.conditional else None)
    lr_of = lambda s: t.lr * max(0.0, 1.0 - s / t.num_total_steps)
    step = ini_step
    profiler, profile_at = None, cfg.log.profile_at_step
    profile_dir = os.path.join(cfg.log.dir_logs, "profile")

    def stop_profiler():
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"INFO: profiler trace written to {profile_dir}")

    batches = loader.epochs()
    feed = _Feed(batches, spc, device)
    try:
        pending = None
        while step < t.num_total_steps:
            # a torch.profiler trace of ~3 steps on request (rank 0)
            if profile_at is not None and rank0:
                if profiler is None and step >= profile_at:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                elif profiler is not None and step >= profile_at + 3:
                    stop_profiler()
                    profiler, profile_at = None, None
            reals, labels = feed.take(pending if pending is not None else feed.put())
            labels = labels if cfg.model.conditional else None
            if eager:
                out = {k: v[None] for k, v in trainer.update_step(
                    reals[0], None if labels is None else labels[0]).items()}
            else:
                out = trainer.update_steps(reals, labels)
            step += spc
            # the next chunk's gather and copy overlap these steps
            pending = feed.put() if step < t.num_total_steps else None

            if step % cfg.log.log_every == 0 and rank0:
                scal = {"loss_g": out["loss_g"][-1].item(), "loss_d": out["loss_d"][-1].item(),
                        "lr": lr_of(step - 1)}
                logger.log(step - 1, scal)
                print(f"step {step}/{t.num_total_steps}: loss_g {scal['loss_g']:.4f} "
                      f"loss_d {scal['loss_d']:.4f} lr {scal['lr']:.3e}", flush=True)

            if step % t.num_epoch_steps != 0:
                continue
            logger.flush()
            evaluate(step)
            if not (rank0 or gathers):
                continue
            grid = trainer.generate(z_vis, y_vis).float().cpu().numpy()
            if rank0:
                save_image_grid(grid, os.path.join(cfg.log.dir_logs, f"{step:06d}.png"))
                logger.log_image_grid(step, make_grid(grid))
            if cfg.log.checkpoint and step > t.num_total_steps * cfg.log.checkpoint_after_frac:
                _save(trainer, ckpt_dir, step)
    finally:
        batches.close()  # stops the prefetch thread
        logger.close()
        if profiler is not None:  # the requested window ran into the end
            stop_profiler()
    if cfg.log.checkpoint and step % t.num_epoch_steps != 0 and (rank0 or gathers):
        # the steps since the last epoch boundary would be lost on resume
        _save(trainer, ckpt_dir, step)
    if not rank0:
        return
    if cfg.log.loss_csv and os.path.exists(logger.csv_path):
        try:
            save_loss_plot(logger.csv_path)
        except Exception as e:  # the plot is a diagnostic; matplotlib may be absent
            print(f"WARNING: loss plot failed: {e}")
    print("Training finished.")


def _save(trainer, directory: str, step: int, keep: int = 3) -> None:
    """``save_checkpoint`` on rank 0; under tp the other processes take part
    in its gather of the state (``GANTrainer.state_dict``)."""
    from . import parallel
    from .train.checkpoint import save_checkpoint

    if parallel.process_index() == 0:
        save_checkpoint(trainer, directory, step, keep=keep)
    elif parallel.tp_count() > 1:
        trainer.state_dict()


class _NoLogger:
    """The logger of a process other than rank 0: writes nothing."""

    def log(self, step, scalars) -> None:
        pass

    def log_image_grid(self, step, grid) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _load_generator_state(cfg, torch_checkpoint: Optional[str], command: str, device):
    """The trainer of the config with its generator restored from the newest
    checkpoint under ``cfg.log.dir_logs``, or converted from a reference
    repo's ``.pth`` (``torch_checkpoint``: an FGenerator or FCondGenerator
    state dict or the FFCModel container, through ``compat.py``); returns
    ``(trainer, step)``. Refuses to run on random weights."""
    from .train.checkpoint import restore_latest
    from .train.gan import GANTrainer
    from .zoo import build_models

    _maybe_infer_num_classes(cfg)
    g_model, d_model = build_models(cfg)
    trainer = GANTrainer(g_model, d_model, **trainer_keywords(cfg), device=device)
    if torch_checkpoint is not None:
        from . import compat

        if cfg.model.generator not in _CONVERTERS:
            raise SystemExit(
                f"{command}: --torch_checkpoint supports the 'ffc' generator (reference "
                "FGenerator checkpoints) and the 'ffc_cond' generator (reference "
                "FCondGenerator / FCondGeneratorSTL checkpoints)")
        if not os.path.isfile(torch_checkpoint):
            raise SystemExit(f"{command}: no such checkpoint file: {torch_checkpoint}")
        variables = getattr(compat, _CONVERTERS[cfg.model.generator])(
            torch_checkpoint, mg=cfg.model.mg)
        trainer.g.load_state_dict(compat.to_state_dict(trainer.g, variables))
        print(f"INFO: {command} from reference checkpoint {torch_checkpoint}")
        return trainer, 0
    ckpt_dir = os.path.join(cfg.log.dir_logs, "checkpoints")
    _, step = restore_latest(trainer, ckpt_dir)
    if step == 0:
        raise SystemExit(
            f"{command}: no checkpoint found under {ckpt_dir} — the output would come from "
            f"random weights. Point -o at a run directory with checkpoints/, or pass "
            f"--torch_checkpoint."
        )
    print(f"INFO: {command} from step {step}")
    return trainer, step


def _stratified_labels(num_samples: int, num_classes: int, device) -> torch.Tensor:
    """num_samples // num_classes labels of each class in order, the last
    class taking the rest (the reference's test_cond.py)."""
    labels = torch.arange(num_samples, device=device) // max(1, num_samples // num_classes)
    return labels.clamp(0, num_classes - 1)


def _sample_exported(cfg, exported: str, num_samples: int, device) -> None:
    """``sample --exported``: a grid of the artifact's images, latents of
    seed 7 and class-stratified labels, to ``samples_{step:06d}.png``."""
    from .serving import load_exported
    from .utils.logging import save_image_grid

    if not os.path.isfile(exported):
        raise SystemExit(f"sample: no such serving artifact: {exported}")
    call, meta = load_exported(exported, device)
    z = torch.randn((num_samples, meta["z_size"]), device=device,
                    generator=torch.Generator(device).manual_seed(7))
    labels = (_stratified_labels(num_samples, meta["num_classes"], device)
              if meta["num_classes"] > 0 else None)
    chunk = 64
    imgs = np.concatenate([
        call(z[i:i + chunk], None if labels is None else labels[i:i + chunk]).cpu().numpy()
        for i in range(0, num_samples, chunk)
    ])
    os.makedirs(cfg.log.dir_logs, exist_ok=True)
    out = os.path.join(cfg.log.dir_logs, f"samples_{meta.get('step', 0):06d}.png")
    save_image_grid(imgs, out)
    print(f"INFO: sampled from serving artifact {exported}")
    print(f"saved {out}")


def run_sample(cfg, num_samples: int = 64, per_sample: bool = False,
               torch_checkpoint: Optional[str] = None, exported: Optional[str] = None,
               device="cuda") -> None:
    """Newest checkpoint (or a reference ``.pth`` with ``torch_checkpoint``)
    -> ``samples_{step:06d}.png`` (class-stratified labels when
    conditional; ``per_sample`` also saves each image), and the
    feature-map figure ``feature_maps_{step:06d}.png``; with ``exported``,
    the grid of a serving artifact instead."""
    from .utils.logging import save_image_grid, save_png
    from .utils.policy import resolve_device

    if num_samples < 1:
        raise SystemExit("sample: --num_samples must be >= 1")
    device = resolve_device(device)
    if exported is not None:
        _sample_exported(cfg, exported, num_samples, device)
        return
    trainer, step = _load_generator_state(cfg, torch_checkpoint, "sample", device)
    z = torch.randn((num_samples, cfg.model.z_size), device=device,
                    generator=torch.Generator(device).manual_seed(7))
    labels = (_stratified_labels(num_samples, cfg.model.num_classes, device)
              if cfg.model.conditional else None)
    # chunked: one forward over a large --num_samples would hold the
    # whole ladder's activations at once
    chunk = 64
    imgs = np.concatenate([
        trainer.generate(z[i:i + chunk], None if labels is None else labels[i:i + chunk],
                         uint8=True).cpu().numpy()
        for i in range(0, num_samples, chunk)
    ])
    out = os.path.join(cfg.log.dir_logs, f"samples_{step:06d}.png")
    save_image_grid(imgs, out)
    print(f"saved {out}")
    if per_sample:
        sample_dir = os.path.join(cfg.log.dir_logs, f"samples_{step:06d}")
        for i, im in enumerate(imgs):
            if im.shape[-1] == 1:
                im = np.repeat(im, 3, axis=-1)
            save_png(im, os.path.join(sample_dir, f"sample_{i:05d}.png"))
        print(f"saved {len(imgs)} PNGs to {sample_dir}")

    try:
        from .utils.visualize import capture_feature_maps, save_feature_map_figure

        maps = capture_feature_maps(trainer, z[:1], None if labels is None else labels[:1])
        fm_path = os.path.join(cfg.log.dir_logs, f"feature_maps_{step:06d}.png")
        save_feature_map_figure(maps, fm_path)
        print(f"saved {fm_path}")
    except Exception as e:  # diagnostics must never block sampling
        print(f"WARNING: feature-map figure failed: {e}")


def run_export(cfg, output: Optional[str] = None, platforms=("cpu", "cuda"),
               torch_checkpoint: Optional[str] = None, device="cuda") -> None:
    """The eval-mode generator of the newest checkpoint (or of a reference
    ``.pth``) as a serving artifact (``serving.export_generator``), traced
    on ``device`` in ``train.precision``; ``output`` defaults to
    ``<dir_logs>/generator.ffcx``. The artifact samples with ``sample
    --exported`` and feeds the metrics as a generative input
    (``fidelity g.ffcx REAL -f``)."""
    from .serving import Sampler, export_generator, save_exported
    from .utils.policy import resolve_device

    device = resolve_device(device)
    trainer, step = _load_generator_state(cfg, torch_checkpoint, "export", device)
    blob = export_generator(
        Sampler(trainer.g, trainer.dtype, cfg.model.conditional),
        z_size=cfg.model.z_size,
        num_classes=cfg.model.num_classes if cfg.model.conditional else 0,
        image_size=cfg.data.image_size,
        channels=cfg.data.channels,
        platforms=tuple(platforms),
        step=step,
    )
    if output is None:
        os.makedirs(cfg.log.dir_logs, exist_ok=True)
        output = os.path.join(cfg.log.dir_logs, "generator.ffcx")
    save_exported(output, blob)
    print(f"exported {output} ({len(blob)} bytes, platforms={','.join(platforms)}, "
          f"step={step})")


# --- fidelity -----------------------------------------------------------------------


def _resolve_fidelity_input(spec: str, args, idx: int = 1):
    """A fidelity input, every kind the JAX CLI resolves: a registered
    dataset's name, a ``.npz`` (its first array) or ``.npy`` uint8 array, a
    serving artifact (``.ffcx``), a TorchScript (``.pt``/``.pth``) or ONNX
    generative model (latent spec from ``--input{N}-model-*``), a run
    directory with ``checkpoints/`` (through ``--preset`` and ``--set``), a
    directory of images, or ``<dataset>-<size>`` (``--datasets-root``)."""
    from .eval import pipeline

    if spec in pipeline.registered_datasets():
        return spec
    if spec.endswith(".npz"):
        data = np.load(spec)
        return data[list(data.keys())[0]]
    if spec.endswith(".npy"):
        return np.load(spec)
    if spec.endswith((".ffcx", ".pt", ".pth", ".onnx")):
        if not os.path.isfile(spec):
            raise SystemExit(f"fidelity: no such model file: {spec}")
        if spec.endswith(".ffcx"):
            from .serving import exported_generative_model

            return exported_generative_model(spec, args.device)
        latent = dict(z_size=getattr(args, f"input{idx}_model_z_size"),
                      z_type=getattr(args, f"input{idx}_model_z_type"),
                      num_classes=getattr(args, f"input{idx}_model_num_classes"))
        if spec.endswith(".onnx"):
            return pipeline.onnx_generative_model(spec, **latent)
        return pipeline.torchscript_generative_model(spec, **latent, device=args.device)
    if os.path.isdir(os.path.join(spec, "checkpoints")):
        return _generative_model_from_run_dir(spec, args)
    limit = max(args.input1_model_num_samples, args.input2_model_num_samples)
    if os.path.isdir(spec):
        return _load_images_dir(
            spec, args.samples_find_ext, args.samples_find_deep,
            resize_and_crop=args.samples_resize_and_crop,
            shuffle_seed=None if args.no_samples_shuffle else args.rng_seed, limit=limit)
    m = re.fullmatch(r"([a-z0-9_]+)-(\d+)", spec)
    if m:
        from .data import load_dataset

        try:
            ds = load_dataset(m.group(1), args.datasets_root, int(m.group(2)), 3)
        except (KeyError, FileNotFoundError) as e:
            raise SystemExit(f"fidelity: cannot resolve input '{spec}' (dataset lookup "
                             f"failed: {e})")
        order = np.random.RandomState(args.rng_seed).permutation(len(ds))
        imgs = np.stack([ds[int(i)][0] for i in order[:min(len(ds), limit)]])
        return np.repeat(imgs, 3, axis=-1) if imgs.shape[-1] == 1 else imgs
    raise SystemExit(f"fidelity: cannot resolve input '{spec}'")


def _load_images_dir(path: str, exts: str, deep: bool, resize_and_crop: int = 0,
                     shuffle_seed=None, limit: Optional[int] = None) -> np.ndarray:
    """A directory of samples (torch-fidelity's glob_samples_paths): the
    files with one of ``exts``, sorted, shuffled with ``shuffle_seed`` and
    cut to ``limit`` before decoding, as RGB uint8; ``resize_and_crop``
    resizes the short side and centre-crops to NxN. Decoding needs
    Pillow."""
    from .data.datasets import _pil, _resize_center_crop

    wanted = {e.strip().lower() for e in exts.split(",") if e.strip()}
    files = []
    for root, _dirs, names in os.walk(path):
        if not deep and os.path.realpath(root) != os.path.realpath(path):
            continue
        files += [os.path.join(root, n) for n in names
                  if os.path.splitext(n)[1].lstrip(".").lower() in wanted]
    files.sort()
    if not files:
        raise SystemExit(f"fidelity: no samples with ext {exts} in {path}")
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(files)
    if limit is not None:
        files = files[:limit]
    image = _pil()

    def load(f):
        img = image.open(f).convert("RGB")
        if resize_and_crop:
            img = _resize_center_crop(img, resize_and_crop)
        return np.asarray(img, np.uint8)

    imgs = [load(f) for f in files]
    shapes = {im.shape for im in imgs}
    if len(shapes) > 1:
        raise SystemExit(f"fidelity: samples in {path} have mixed shapes {sorted(shapes)}; "
                         f"pass --samples-resize-and-crop N to normalise them")
    return np.stack(imgs)


def _generative_model_from_run_dir(run_dir: str, args):
    """The generator of a run directory's newest checkpoint (the config of
    ``--preset`` and ``--set``) as a GenerativeModel on ``--device``."""
    from .eval import GenerativeModel
    from .serving import to_rgb
    from .train.checkpoint import restore_latest
    from .train.gan import GANTrainer
    from .utils.config import apply_overrides, make_config
    from .utils.policy import resolve_device
    from .zoo import build_models

    device = resolve_device(args.device)
    cfg = make_config(args.preset)
    apply_overrides(cfg, args.set or [])
    _maybe_infer_num_classes(cfg)
    trainer = GANTrainer(*build_models(cfg), **trainer_keywords(cfg), device=device)
    _, step = restore_latest(trainer, os.path.join(run_dir, "checkpoints"))
    if step == 0:
        raise SystemExit(f"fidelity: no checkpoint under {run_dir}/checkpoints — metrics of "
                         f"random weights would be reported as the run's")
    print(f"fidelity: loaded generator at step {step} from {run_dir}", file=sys.stderr)
    return GenerativeModel(apply=lambda z, labels=None: to_rgb(
                               trainer.generate(z, labels, uint8=True)),
                           z_size=cfg.model.z_size,
                           num_classes=cfg.model.num_classes if cfg.model.conditional else 0,
                           device=device)


def build_fidelity_parser():
    """torch-fidelity's ``fidelity`` flags as the JAX CLI has them, plus
    ``--device`` (``cuda`` unless ``cpu`` is given)."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m fastfourierconvolution_tpu_torch.cli fidelity",
                                description="Compute generative metrics")
    p.add_argument("input1", help="registered dataset | samples dir | .npz/.npy | .ffcx "
                   "serving artifact | .pt/.pth TorchScript model | .onnx | run dir with "
                   "checkpoints/ | <dataset>-<size>")
    p.add_argument("input2", nargs="?", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("-j", "--json", action="store_true", help="print scores in JSON")
    p.add_argument("-i", "--isc", action="store_true")
    p.add_argument("-f", "--fid", action="store_true")
    p.add_argument("-k", "--kid", action="store_true")
    p.add_argument("-r", "--prc", action="store_true")
    p.add_argument("-p", "--ppl", action="store_true")
    p.add_argument("--feature-extractor", default=None)
    p.add_argument("--feature-layer-isc", default=None)
    p.add_argument("--feature-layer-fid", default=None)
    p.add_argument("--feature-layer-kid", default=None)
    p.add_argument("--feature-layer-prc", default=None)
    p.add_argument("--feature-extractor-weights-path", default=None)
    p.add_argument("--feature-extractor-internal-dtype", default=None,
                   choices=["float32", "float64"])
    p.add_argument("--isc-splits", type=int, default=10)
    p.add_argument("--kid-subsets", type=int, default=100)
    p.add_argument("--kid-subset-size", type=int, default=1000)
    p.add_argument("--kid-kernel", default="poly", choices=["poly", "rbf"])
    p.add_argument("--kid-kernel-poly-degree", type=int, default=3)
    p.add_argument("--kid-kernel-poly-gamma", type=float, default=None)
    p.add_argument("--kid-kernel-poly-coef0", type=float, default=1.0)
    p.add_argument("--kid-kernel-rbf-sigma", type=float, default=10.0)
    p.add_argument("--ppl-epsilon", type=float, default=1e-4)
    p.add_argument("--ppl-sample-similarity", default="lpips-vgg16")
    p.add_argument("--ppl-reduction", default="mean", choices=["mean", "none"])
    p.add_argument("--ppl-sample-similarity-resize", type=int, default=64)
    p.add_argument("--ppl-z-interp-mode", default="lerp",
                   choices=["lerp", "slerp_any", "slerp_unit"])
    p.add_argument("--ppl-discard-percentile-lower", type=float, default=1.0)
    p.add_argument("--ppl-discard-percentile-higher", type=float, default=99.0)
    p.add_argument("--prc-neighborhood", type=int, default=3)
    p.add_argument("--prc-batch-size", type=int, default=10000)
    p.add_argument("--save-cpu-ram", action="store_true")
    p.add_argument("--lpips-weights-path", default=None)
    p.add_argument("--vgg-weights-path", default=None)
    p.add_argument("--samples-find-deep", action="store_true")
    p.add_argument("--samples-resize-and-crop", type=int, default=0)
    p.add_argument("--no-samples-shuffle", action="store_true",
                   help="keep sorted order (torch-fidelity shuffles)")
    p.add_argument("--samples-find-ext", default="png,jpg,jpeg")
    p.add_argument("--input1-model-num-samples", type=int, default=10000)
    p.add_argument("--input2-model-num-samples", type=int, default=10000)
    for i in (1, 2):
        p.add_argument(f"--input{i}-model-z-size", type=int, default=128)
    for i in (1, 2):
        p.add_argument(f"--input{i}-model-z-type", default="normal",
                       choices=["normal", "unit", "uniform_0_1"])
    for i in (1, 2):
        p.add_argument(f"--input{i}-model-num-classes", type=int, default=0)
    p.add_argument("--input1-cache-name", default=None)
    p.add_argument("--input2-cache-name", default=None)
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--cache-root", default=None,
                   help="feature cache directory (default $FFC_TPU_HOME/fidelity_cache_torch)")
    p.add_argument("--rng-seed", type=int, default=2020)
    p.add_argument("--silent", action="store_true")
    p.add_argument("--preset", default="fgan32", help="model preset for run-dir inputs")
    p.add_argument("--set", action="append", default=[],
                   help="config overrides for run-dir inputs")
    p.add_argument("--datasets-root", default="./data",
                   help="data dir for '<dataset>-<size>' inputs")
    p.add_argument("--device", default="cuda",
                   help="where the extractor and generative inputs run: cuda (the default) "
                        "or cpu")
    return p


def run_fidelity(argv) -> dict:
    """Standalone metric computation, torch-fidelity's ``fidelity``: prints
    the scores (JSON with ``-j``) and returns them."""
    import json

    from .eval import GenerativeModel, calculate_metrics

    args = build_fidelity_parser().parse_args(argv)
    if not (args.isc or args.fid or args.kid or args.prc or args.ppl):
        raise SystemExit("fidelity: at least one of -i/-f/-k/-r/-p must be given")
    input1 = _resolve_fidelity_input(args.input1, args, idx=1)
    input2 = _resolve_fidelity_input(args.input2, args, idx=2) if args.input2 else None
    if args.ppl and not isinstance(input1, GenerativeModel):
        raise SystemExit("fidelity: --ppl needs a generative input1 (a run directory with "
                         "checkpoints/, loaded via --preset)")
    out = calculate_metrics(
        input1, input2, isc=args.isc, fid=args.fid, kid=args.kid, prc=args.prc, ppl=args.ppl,
        feature_extractor=args.feature_extractor,
        feature_layer_isc=args.feature_layer_isc, feature_layer_fid=args.feature_layer_fid,
        feature_layer_kid=args.feature_layer_kid, feature_layer_prc=args.feature_layer_prc,
        input1_model_num_samples=args.input1_model_num_samples,
        input2_model_num_samples=args.input2_model_num_samples,
        input1_cache_name=args.input1_cache_name, input2_cache_name=args.input2_cache_name,
        batch_size=args.batch_size, rng_seed=args.rng_seed, isc_splits=args.isc_splits,
        kid_subsets=args.kid_subsets, kid_subset_size=args.kid_subset_size,
        kid_kernel=args.kid_kernel, kid_kernel_poly_degree=args.kid_kernel_poly_degree,
        kid_kernel_poly_gamma=args.kid_kernel_poly_gamma,
        kid_kernel_poly_coef0=args.kid_kernel_poly_coef0,
        kid_kernel_rbf_sigma=args.kid_kernel_rbf_sigma,
        prc_neighborhood=args.prc_neighborhood, prc_batch_size=args.prc_batch_size,
        save_cpu_ram=args.save_cpu_ram, ppl_epsilon=args.ppl_epsilon,
        ppl_sample_similarity=args.ppl_sample_similarity,
        ppl_z_interp_mode=args.ppl_z_interp_mode, ppl_reduction=args.ppl_reduction,
        ppl_sample_similarity_resize=args.ppl_sample_similarity_resize,
        ppl_discard_percentile_lower=args.ppl_discard_percentile_lower,
        ppl_discard_percentile_higher=args.ppl_discard_percentile_higher,
        lpips_weights_path=args.lpips_weights_path, vgg_weights_path=args.vgg_weights_path,
        feature_extractor_weights_path=args.feature_extractor_weights_path,
        feature_extractor_internal_dtype=args.feature_extractor_internal_dtype,
        cache=not args.no_cache, cache_dir=args.cache_root, verbose=not args.silent,
        device=args.device)
    printable = {k: float(v) for k, v in out.items() if np.ndim(v) == 0}
    print(json.dumps(printable) if args.json else printable)
    return out


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "fidelity":
        run_fidelity(argv[1:])
        return
    from .utils.config import parse_cli

    command, cfg, extras = parse_cli(argv)
    if command == "fidelity":
        # the fidelity flags have their own parser, which needs the command first
        raise SystemExit("fidelity: put the command first — python -m "
                         "fastfourierconvolution_tpu_torch.cli fidelity <input1> [input2] "
                         "[flags]")
    if command == "download":
        from .data.download import fetch

        paths = fetch(cfg.data.dataset, cfg.data.data_dir)
        print(f"downloaded {len(paths)} file(s) to {cfg.data.data_dir}")
        return
    # the process of a multi-process launch that will be rank 0 (its group
    # is joined later, in run_train)
    if os.environ.get("FFC_TPU_PROCESS_ID", os.environ.get("RANK", "0")) == "0":
        print("Configuration:\n" + cfg.to_json())
    if command == "train":
        run_train(cfg, device=extras["device"])
    elif command == "export":
        run_export(cfg, output=extras["output"], platforms=extras["platforms"],
                   torch_checkpoint=extras["torch_checkpoint"], device=extras["device"])
    else:
        run_sample(cfg, num_samples=extras["num_samples"], per_sample=extras["per_sample"],
                   torch_checkpoint=extras["torch_checkpoint"], exported=extras["exported"],
                   device=extras["device"])


if __name__ == "__main__":
    main()
