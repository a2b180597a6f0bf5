"""Eval-mode image serving and the serving artifact.

``Generator.generate(z[, labels])`` takes (B, z_size) float32 latents (and
(B,) labels for a class-conditional generator) and returns (B, H, W, C)
uint8 NHWC images, the JAX package's output contract
(``GANTrainer.generate(..., uint8=True)``): BN running statistics, no
noise injection, [-1, 1] -> [0, 255] truncated. It takes any generator of
the zoo (``zoo.build_generator``).

The serving artifact, the JAX package's ``serving.py``:
:func:`export_generator` traces the eval-mode sampling module (``z[,
labels] -> uint8 NHWC``, :class:`Sampler`) once with ``torch.export``,
with a dynamic batch dimension, and serializes it with its weights. The
FourierUnit's eval forward is recorded as the registered op
``ffc_torch::fourier_unit_forward`` (``ops/fourier_unit.py``), so each
call of the artifact on the card launches the hand-written kernel, and on
the CPU runs the plain version. The file is a magic line, ``FFCXT1``, one
JSON metadata line with the JAX package's keys (latent spec, image
geometry, platforms, step) and then ``torch.export.save``'s bytes. The
magic differs from the JAX package's ``FFCX1``, so each package refuses
the other's artifact by name.

Unlike the JAX artifact, which needs only ``jax``, this one needs
``torch`` and this package's op library: :func:`load_exported` imports the
op's registration first, and on the card the CUDA sources are built at the
first call.
"""

from __future__ import annotations

import io
import json
import os
import warnings
from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn

from .models.ffc_gan import FFCGenerator, to_uint8
from .utils.policy import default_dtype, resolve_device, resolve_dtype

MAGIC = b"FFCXT1\n"
# The JAX package's artifact: a StableHLO program the port cannot run.
JAX_MAGIC = b"FFCX1\n"
PLATFORMS = ("cpu", "cuda")
# the largest batch an artifact serves
MAX_BATCH = 65535


class Sampler(nn.Module):
    """``GANTrainer.generate(z[, labels], uint8=True)``'s eval path as a
    module: ``model`` (in eval mode) on latents (and labels where
    ``conditional``) in the compute ``dtype``, NCHW -> NHWC, the uint8
    contract of ``to_uint8``."""

    def __init__(self, model: nn.Module, dtype=torch.float32, conditional: bool = False):
        super().__init__()
        self.model, self.dtype, self.conditional = model, resolve_dtype(dtype), conditional

    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _sample(self.model, z, labels if self.conditional else None, self.dtype, True)


def _sample(model, z, labels, dtype, uint8: bool) -> torch.Tensor:
    """``model`` on z (and labels where given) -> NHWC images, uint8 or in
    ``dtype``."""
    args = (z, dtype, None) + (() if labels is None else (labels,))
    out = model(*args).permute(0, 2, 3, 1)
    return (to_uint8(out) if uint8 else out).contiguous()


class Generator:
    """Serves ``model``, any generator of the zoo, on ``device`` in eval
    mode.

    ``state_dict`` (optional) replaces the model's own weights. The
    compute dtype defaults to bf16 on the card and f32 on the CPU. A model
    with ``num_classes`` > 0 (the conditional generators) makes the server
    class-conditional: ``generate`` then takes labels.
    """

    def __init__(
        self, model: nn.Module, state_dict: Optional[Mapping] = None, *,
        device="cuda", dtype=None,
    ):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else resolve_dtype(dtype)
        self.num_classes = getattr(model, "num_classes", 0)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_preset(
        cls, resolution: int, state_dict: Optional[Mapping] = None, *,
        z_size: int = 128, generator: Optional[torch.Generator] = None,
        device="cuda", dtype=None,
    ) -> "Generator":
        """A server for ``FFCGenerator.for_resolution(resolution)``."""
        model = FFCGenerator.for_resolution(resolution, z_size=z_size, generator=generator)
        return cls(model, state_dict, device=device, dtype=dtype)

    def sampler(self) -> Sampler:
        """The server's sampling module, in its compute dtype."""
        return Sampler(self.model, self.dtype, self.num_classes > 0)

    def generate(self, z, labels=None, uint8: bool = True) -> torch.Tensor:
        """(B, z_size) latents (and (B,) labels for a conditional server) ->
        (B, H, W, C) images on the server's device: uint8, or floats in the
        compute dtype when ``uint8`` is False."""
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)
        if z.dim() != 2 or z.shape[1] != self.model.z_size:
            raise ValueError(
                f"z must be (B, {self.model.z_size}), got {tuple(z.shape)}"
            )
        labels = _labels(labels, z.shape[0], self.num_classes, self.device, "this server")
        with torch.inference_mode():
            return _sample(self.model, z, labels, self.dtype, uint8)


def _labels(labels, batch: int, num_classes: int, device, what: str):
    """``labels`` as (batch,) int64 on ``device``: required where
    ``num_classes`` > 0, refused elsewhere."""
    if num_classes <= 0:
        if labels is not None:
            raise ValueError(f"{what} is unconditional: it takes no labels")
        return None
    if labels is None:
        raise ValueError(f"{what} is class-conditional (num_classes={num_classes}): "
                         f"labels required")
    labels = torch.as_tensor(labels).to(device, torch.int64)
    if tuple(labels.shape) != (batch,):
        raise ValueError(f"labels must be ({batch},), got {tuple(labels.shape)}")
    return labels


def _check_platforms(platforms) -> Tuple[str, ...]:
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(
            f"platforms {list(platforms)}: the port's artifact runs on {list(PLATFORMS)}"
            + (" (a TPU artifact is the JAX package's export)" if "tpu" in unknown else ""))
    return platforms


def export_generator(
    module: nn.Module,
    *,
    z_size: int,
    num_classes: int = 0,
    z_type: str = "normal",
    image_size: int,
    channels: int = 3,
    platforms: Tuple[str, ...] = PLATFORMS,
    step: int = 0,
) -> bytes:
    """Trace ``module(z[, labels]) -> uint8 NHWC`` (e.g. a :class:`Sampler`;
    in eval mode while it is traced, each submodule's training flag
    restored after)
    with ``torch.export`` on the device of its parameters, with a dynamic
    batch dimension (1 to ``MAX_BATCH``) on z and labels, and return the
    artifact's bytes."""
    platforms = _check_platforms(platforms)
    device = next(module.parameters()).device
    # an example batch of 2: export specialises sizes 0 and 1
    args = (torch.zeros(2, z_size, device=device),)
    if num_classes > 0:
        args += (torch.zeros(2, dtype=torch.int64, device=device),)
    # cuDNN's convolutions take batches up to 65,535 (the trace on a card
    # guards the batch there)
    batch = torch.export.Dim("b", min=1, max=MAX_BATCH)
    flags = {m: m.training for m in module.modules()}
    module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(module, args,
                                          dynamic_shapes=tuple({0: batch} for _ in args))
    finally:
        for m, flag in flags.items():
            m.training = flag
    payload = io.BytesIO()
    torch.export.save(program, payload)
    meta = {
        "z_size": int(z_size),
        "z_type": z_type,
        "num_classes": int(num_classes),
        "image_size": int(image_size),
        "channels": int(channels),
        "platforms": list(platforms),
        "step": int(step),
    }
    return MAGIC + json.dumps(meta).encode("utf-8") + b"\n" + payload.getvalue()


def save_exported(path: str, blob: bytes) -> None:
    """Write an artifact atomically (a temporary file, then a rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def read_artifact(path: str) -> Tuple[dict, bytes]:
    """``(meta, payload)`` of an artifact file; raises ValueError for the
    JAX package's artifact and for a file that is none."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(JAX_MAGIC):
        raise ValueError(f"{path} is the JAX package's FFCX1 artifact (a StableHLO program); "
                         f"the port runs only its own FFCXT1 artifacts: export it with "
                         f"the port")
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path} is not an FFCXT1 artifact (bad magic {blob[:7]!r}; "
                         f"expected {MAGIC!r})")
    header_end = blob.index(b"\n", len(MAGIC))
    meta = json.loads(blob[len(MAGIC):header_end].decode("utf-8"))
    return meta, blob[header_end + 1:]


def _device(device) -> torch.device:
    """``device`` (None: ``cuda``) resolved, a card with its index."""
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def load_exported(path: str, device=None):
    """``(call, meta)`` for an artifact: ``call(z[, labels])`` maps (B,
    z_size) latents (and (B,) labels for a conditional artifact) to uint8
    NHWC images on ``device`` (None: ``cuda``), for any batch of 1 to
    ``MAX_BATCH``. A
    device type not among the artifact's platforms is refused; ``cuda``
    without a card raises."""
    from .ops import fourier_unit  # noqa: F401  (registers ffc_torch::fourier_unit_forward)

    device = _device(device)
    meta, payload = read_artifact(path)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not {device.type}")
    with warnings.catch_warnings():
        # the loader reads its tensors out of the payload's immutable bytes
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        program = torch.export.load(io.BytesIO(payload))
    held = {t.device for t in (*program.state_dict.values(), *program.constants.values())
            if isinstance(t, torch.Tensor)}
    if held != {device}:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    module = program.module()

    def call(z, labels=None):
        z = torch.as_tensor(z, dtype=torch.float32).to(device)
        if z.dim() != 2 or z.shape[1] != meta["z_size"]:
            raise ValueError(f"z must be (B, {meta['z_size']}), got {tuple(z.shape)}")
        labels = _labels(labels, z.shape[0], meta["num_classes"], device, path)
        with torch.no_grad():
            return module(z) if labels is None else module(z, labels)

    return call, meta


def to_rgb(images: torch.Tensor) -> torch.Tensor:
    """NHWC images with a gray channel repeated to three (the metrics'
    extractors take RGB)."""
    return images.repeat(1, 1, 1, 3) if images.shape[-1] == 1 else images


def exported_generative_model(path: str, device=None):
    """An artifact as an eval-pipeline
    :class:`~fastfourierconvolution_tpu_torch.eval.pipeline.GenerativeModel`
    on ``device`` (None: ``cuda``): the serving artifact doubles as a
    metric input kind; a gray artifact's channel is repeated to RGB."""
    from .eval.pipeline import GenerativeModel

    device = _device(device)
    call, meta = load_exported(path, device)
    return GenerativeModel(apply=lambda z, labels=None: to_rgb(call(z, labels)),
                           z_size=meta["z_size"], z_type=meta.get("z_type", "normal"),
                           num_classes=meta["num_classes"], device=device)
