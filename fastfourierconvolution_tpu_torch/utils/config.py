"""The configuration tree and presets, the JAX package's ``utils/config.py``.

One dataclass tree (data, model, train, eval, log) with the same fields and
defaults as the JAX package's, so ``dataclasses.asdict`` of a config agrees
field for field; ``PRESETS`` holds the same ten presets, one per reference
entry point; ``make_config`` and ``apply_overrides`` build and override a
config the same way.

``zoo.build_models`` reads ``model`` and ``data``; the CLI (``cli.py``)
reads the rest: ``train.steps_per_call`` is the K of each
``GANTrainer.update_steps`` call, ``log.profile_at_step`` starts a
``torch.profiler`` trace, ``train.tp`` the tensor-parallel width of the
process grid (``parallel.initialize``). One field only the JAX runtime
reads, kept as data so that the trees agree: ``log.compilation_cache``
(XLA's compile cache). ``parse_cli`` parses the
CLI's arguments as the JAX package's does, plus ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple


@dataclass
class DataConfig:
    dataset: str = "synthetic"  # mnist|fmnist|cifar10|svhn|stl10|tar|folder|synthetic
    data_dir: str = "./data"
    image_size: int = 32
    channels: int = 3
    hflip_augment: bool = False
    aug_stack: Optional[str] = None  # flowers|cars|textures|stl_cond|hflip (AUG_STACKS)
    workers: int = 8  # kept for interface parity; loader uses one prefetch thread
    download: bool = False  # fetch missing named datasets (reference download=True)


@dataclass
class ModelConfig:
    generator: str = "ffc"  # ffc|ffc_cond|dcgan|cond_dcgan|attn_dcgan|sngan_resnet|sagan
    discriminator: str = "sn_conv"  # sn_conv|cond_sn_conv|ffc|ffc_cond|dcgan|sn_dcgan|cond_dcgan|ffc_cond_dcgan|sngan_resnet|sagan
    z_size: int = 128
    ngf: int = 64
    ndf: int = 64
    ratio_g: float = 0.25
    mg: int = 4
    conditional: bool = False
    num_classes: int = 0
    gen_preset: Optional[str] = None  # conditional generator preset name
    fourier_impl: Optional[str] = None  # fft|dft|auto|None: the JAX transforms; no effect in the port


@dataclass
class TrainConfig:
    batch_size: int = 64
    num_total_steps: int = 100_000
    num_epoch_steps: int = 5_000  # eval/snapshot cadence
    num_dis_updates: int = 1
    lr: float = 2e-4
    d_lr: Optional[float] = None  # TTUR when set
    beta1: float = 0.5
    beta2: float = 0.999
    steps_per_call: int = 1  # K steps per update_steps call of the CLI
    loss: str = "hinge"  # hinge|bce|wgan|wgan-gp
    gp_lambda: float = 10.0  # wgan-gp penalty weight (sagan parameter.py:18)
    aw_method: bool = False  # aw-method D-gradient combination (aw_loss.py)
    update_order: str = "g_first"  # g_first (fgan_complete) | d_first (train_cond/sagan)
    optimizer: str = "adamw"  # adamw|adam
    seed: int = 0
    precision: str = "f32"  # f32|bf16 (activation compute dtype)
    remat: Optional[str] = None  # none|dots|full activation rematerialisation
    tp: int = 1  # tensor-parallel width T: the dp x tp process grid, T dividing the processes


@dataclass
class EvalConfig:
    isc: bool = True
    fid: bool = True
    kid: bool = False
    prc: bool = False
    ppl: bool = False
    num_samples_for_metrics: int = 10_000
    input2_dataset: Optional[str] = None  # registered real-set name
    feature_extractor_weights_path: Optional[str] = None  # also $FFC_TPU_INCEPTION_WEIGHTS
    lpips_weights_path: Optional[str] = None  # also $FFC_TPU_LPIPS_WEIGHTS
    vgg_weights_path: Optional[str] = None  # also $FFC_TPU_VGG16_WEIGHTS
    leading_metric: str = "ISC"  # ISC|FID|KID|PPL


@dataclass
class LogConfig:
    dir_logs: str = "./logs_ffc_tpu"
    checkpoint: bool = False
    checkpoint_after_frac: float = 0.5  # save only after this fraction
    log_every: int = 10
    samples_grid: int = 64  # fixed z_vis grid size
    loss_csv: bool = True
    tensorboard: bool = True  # TB event records (reference SummaryWriter)
    compilation_cache: Optional[str] = (
        "~/.cache/ffc_tpu/jax_cache"  # the JAX compile cache; unread by the port
    )
    profile_at_step: Optional[int] = None  # a torch.profiler trace of 3 steps
    best_metric_checkpoints: bool = False  # keep best-leading-metric ckpt


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    log: LogConfig = field(default_factory=LogConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


# --- presets: one per reference entry point ---------------------------------

PRESETS: Dict[str, Dict] = {
    # fgan_complete.py: FFC G 32px vs 7-conv SN D, SVHN, hinge, AdamW
    "fgan32": dict(
        data=dict(dataset="svhn", image_size=32),
        model=dict(generator="ffc", discriminator="sn_conv", mg=4,
                   ratio_g=0.25),
        train=dict(batch_size=64, num_total_steps=100_000),
        eval=dict(isc=True, fid=True),
    ),
    # fgan64_complete.py: 64px CelebA (tar), no metrics
    "fgan64": dict(
        data=dict(dataset="tar", image_size=64, hflip_augment=True),
        model=dict(generator="ffc", discriminator="sn_conv", mg=4,
                   ratio_g=0.25),
        train=dict(batch_size=64),
        eval=dict(isc=False, fid=False),
        log=dict(checkpoint_after_frac=0.1),
    ),
    # fgan128_complete.py: 128px Flowers, ngf 128 ratio 0.5
    "fgan128": dict(
        data=dict(dataset="folder", image_size=128, aug_stack="flowers"),
        model=dict(generator="ffc", discriminator="sn_conv", ngf=128,
                   ratio_g=0.5, mg=4),
        train=dict(batch_size=64),
        eval=dict(isc=False, fid=False),
    ),
    # fgan_cond_complete.py: conditional 32px CIFAR/SVHN
    "fgan_cond32": dict(
        data=dict(dataset="cifar10", image_size=32),
        model=dict(generator="ffc_cond", discriminator="cond_sn_conv",
                   conditional=True, num_classes=10, gen_preset="cifar32"),
        train=dict(batch_size=64),
        eval=dict(isc=True, fid=True, kid=True),
    ),
    # fgan_cond_complete.py STL-10 48px variant
    "fgan_cond48": dict(
        data=dict(dataset="stl10", image_size=48, aug_stack="stl_cond"),
        model=dict(generator="ffc_cond", discriminator="cond_sn_conv",
                   conditional=True, num_classes=10, gen_preset="stl48",
                   mg=6),
        train=dict(batch_size=64),
        eval=dict(isc=True, fid=True, kid=True),
    ),
    # fgan128_cond_complete.py: textures 128px
    "fgan_cond128": dict(
        data=dict(dataset="tar", image_size=128, aug_stack="textures"),
        model=dict(generator="ffc_cond", discriminator="cond_sn_conv",
                   conditional=True, num_classes=10, gen_preset="tex128"),
        train=dict(batch_size=64),
        eval=dict(isc=False, fid=False),
    ),
    # sngan_complete.py: FFC G vs all-FFC D, CIFAR-10, Adam, no checkpoints
    "sngan": dict(
        data=dict(dataset="cifar10", image_size=32),
        model=dict(generator="ffc", discriminator="ffc", mg=4, ratio_g=0.25),
        train=dict(batch_size=64, num_total_steps=50_000, optimizer="adam"),
        eval=dict(isc=True, fid=True),
    ),
    # resnet_complete.py (intended config): SNGAN-ResNet 32 on CIFAR,
    # AdamW(0.0, 0.9) — the TTUR/SNGAN recipe
    "resnet32": dict(
        data=dict(dataset="cifar10", image_size=32),
        model=dict(generator="sngan_resnet", discriminator="sngan_resnet",
                   ngf=256, ndf=128),
        train=dict(batch_size=64, beta1=0.0, beta2=0.9),
        eval=dict(isc=True, fid=True, kid=True),
    ),
    # train_cond.py library path: conditional DCGAN/FFC, BCE, Adam
    "train_cond": dict(
        data=dict(dataset="mnist", image_size=64, channels=1),
        model=dict(generator="cond_dcgan", discriminator="cond_dcgan",
                   conditional=True, num_classes=10, z_size=100),
        train=dict(loss="bce", optimizer="adam", batch_size=128,
                   update_order="d_first"),
        eval=dict(isc=False, fid=False),
    ),
    # benchmark_models/sagan: TTUR hinge comparator on CIFAR-10
    "sagan": dict(
        data=dict(dataset="cifar10", image_size=32),
        model=dict(generator="sagan", discriminator="sagan", z_size=128),
        train=dict(lr=1e-4, d_lr=4e-4, beta1=0.0, beta2=0.9,
                   num_dis_updates=5, optimizer="adam", loss="wgan-gp",
                   update_order="d_first"),
        eval=dict(isc=True, fid=True, kid=True),
    ),
}


def make_config(preset: Optional[str] = None, **overrides) -> Config:
    """Build a Config from a preset plus ``section.key=value`` overrides."""
    cfg = Config()
    if preset:
        if preset not in PRESETS:
            raise KeyError(f"unknown preset '{preset}'; have {list(PRESETS)}")
        for section, values in PRESETS[preset].items():
            sub = getattr(cfg, section)
            for k, v in values.items():
                setattr(sub, k, v)
    for dotted, v in overrides.items():
        section, key = dotted.split(".", 1)
        sub = getattr(cfg, section)
        if not hasattr(sub, key):
            raise KeyError(f"unknown config field {dotted}")
        setattr(sub, key, v)
    return cfg


def _coerce(current, raw: str):
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if current is None:
        try:
            return int(raw)
        except ValueError:
            try:
                return float(raw)
            except ValueError:
                return raw
    return type(current)(raw)


def apply_overrides(cfg: Config, sets: Sequence[str]) -> Config:
    """Apply ``section.key=value`` dotted overrides with type coercion."""
    for kv in sets:
        dotted, raw = kv.split("=", 1)
        section, key = dotted.split(".", 1)
        sub = getattr(cfg, section)
        setattr(sub, key, _coerce(getattr(sub, key), raw))
    return cfg


def parse_cli(
    argv: Optional[Sequence[str]] = None,
) -> Tuple[str, Config, Dict]:
    """``<command> [--preset NAME] [--set section.key=value ...]`` plus the
    shortcuts of the JAX package's ``parse_cli`` (-b, -e, -l, -o,
    --dataset, --data_path, --checkpoint, the sample and export flags),
    with the same commands and the same resulting ``Config``. The port
    adds ``--device`` (default ``cuda``), returned in ``extras`` with the
    other flags that are no config field; ``--platforms`` defaults to
    ``cpu,cuda`` and refuses ``tpu``."""
    p = argparse.ArgumentParser(prog="python -m fastfourierconvolution_tpu_torch.cli")
    p.add_argument(
        "command",
        choices=["train", "sample", "export", "fidelity", "download"],
    )
    p.add_argument("--preset", default=None)
    p.add_argument("--set", action="append", default=[], metavar="K=V")
    p.add_argument("-b", "--batch_size", type=int)
    p.add_argument("-e", "--num_total_steps", type=int)
    p.add_argument("-l", "--lr", type=float)
    p.add_argument("-o", "--dir_logs")
    p.add_argument("--dataset")
    p.add_argument("--data_path")
    p.add_argument("--checkpoint", action="store_true")
    p.add_argument("--num_samples", type=int, default=64,
                   help="sample command: how many images")
    p.add_argument("--per_sample", action="store_true",
                   help="sample command: also save each image as a PNG")
    p.add_argument("--torch_checkpoint", default=None,
                   help="sample/export command: a reference-repo .pth")
    p.add_argument("--exported", default=None,
                   help="sample command: a serving artifact (.ffcx)")
    p.add_argument("--output", default=None,
                   help="export command: artifact path")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="export command: comma-separated platforms the artifact may run "
                        "on (cpu, cuda)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where to train or sample: cuda (the default) or cpu")
    args = p.parse_args(argv)

    cfg = make_config(args.preset)
    if args.batch_size:
        cfg.train.batch_size = args.batch_size
    if args.num_total_steps:
        cfg.train.num_total_steps = args.num_total_steps
    if args.lr:
        cfg.train.lr = args.lr
    if args.dir_logs:
        cfg.log.dir_logs = args.dir_logs
    if args.dataset:
        cfg.data.dataset = args.dataset
    if args.data_path:
        cfg.data.data_dir = args.data_path
    if args.checkpoint:
        cfg.log.checkpoint = True
    apply_overrides(cfg, args.set)
    platforms = tuple(s for s in args.platforms.split(",") if s)
    if "tpu" in platforms:
        raise SystemExit("--platforms tpu: the port's serving artifact runs on the CPU and "
                         "on CUDA cards (--platforms cpu,cuda); a TPU artifact is the JAX "
                         "package's export")
    extras = {"num_samples": args.num_samples,
              "per_sample": args.per_sample,
              "torch_checkpoint": args.torch_checkpoint,
              "exported": args.exported,
              "output": args.output,
              "platforms": platforms,
              "device": args.device}
    return args.command, cfg, extras
