"""Scalar logs, loss plots and sample grids, the JAX package's
``utils/logging.py``.

``ScalarLogger`` writes the same ``gan_losses.csv`` rows and
``scalars.jsonl`` records as the JAX logger, and TensorBoard events
through tensorboardX where that package is installed (skipped where it is
not). Grids are written as PNG files by the standard library (``zlib``,
``struct``), so a training run needs no imaging package; the loss plot
imports matplotlib when it is drawn.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np


class ScalarLogger:
    """CSV + JSONL + TensorBoard-event scalar logging.

    The CSV holds the loss rows (step, loss_G, loss_D, lr); every call
    appends a JSONL record with its wall time; TensorBoard events are
    written through tensorboardX when available, skipped otherwise."""

    def __init__(self, dir_logs: str, csv_name: str = "gan_losses.csv",
                 tensorboard: bool = True):
        os.makedirs(dir_logs, exist_ok=True)
        self.csv_path = os.path.join(dir_logs, csv_name)
        self.jsonl_path = os.path.join(dir_logs, "scalars.jsonl")
        self._csv_file = open(self.csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        if self._csv_file.tell() == 0:
            self._csv.writerow(["step", "loss_G", "loss_D", "lr"])
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(logdir=os.path.join(dir_logs, "tb"))

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        # the CSV holds loss rows only; metric and other scalars go to the
        # JSONL stream and the TB events
        if "loss_g" in scalars:
            self._csv.writerow(
                [step, scalars.get("loss_g"), scalars.get("loss_d"), scalars.get("lr")]
            )
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        if self._tb is not None:
            for key, value in scalars.items():
                try:
                    self._tb.add_scalar(key, float(value), step)
                except (TypeError, ValueError):
                    pass

    def log_image_grid(self, step: int, grid_hwc, tag: str = "observations"):
        """A TB image record of a (H, W, C) uint8 grid."""
        if self._tb is not None:
            self._tb.add_image(tag, np.transpose(grid_hwc, (2, 0, 1)), step)

    def flush(self) -> None:
        self._csv_file.flush()
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._csv_file.close()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def save_loss_plot(csv_path: str, out_path: Optional[str] = None) -> str:
    """gan_losses.csv -> gan_losses.png, the G and D loss curves
    (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps, g, d = [], [], []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            if not row.get("loss_G") or not row.get("loss_D"):
                continue  # tolerate partial rows
            steps.append(int(row["step"]))
            g.append(float(row["loss_G"]))
            d.append(float(row["loss_D"]))
    if not steps:
        raise ValueError(f"no loss rows in {csv_path}")
    out_path = out_path or csv_path.replace(".csv", ".png")
    plt.figure(figsize=(10, 5))
    plt.title("Generator and Discriminator Loss During Training")
    plt.plot(steps, g, label="G")
    plt.plot(steps, d, label="D")
    plt.xlabel("iterations")
    plt.ylabel("loss")
    plt.legend()
    plt.savefig(out_path)
    plt.close()
    return out_path


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """Tile (N, H, W, C) images into one (H', W', 3) uint8 grid image
    (torchvision's make_grid). Accepts float [-1,1] or uint8."""
    if images.dtype != np.uint8:
        images = ((np.clip(images, -1.0, 1.0) * 0.5 + 0.5) * 255).astype(np.uint8)
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = r * (h + pad) + pad
        x0 = col * (w + pad) + pad
        grid[y0 : y0 + h, x0 : x0 + w] = images[i]
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # grayscale, RGB, RGBA


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """A (H, W) or (H, W, C) uint8 image (C 1, 3 or 4) as PNG bytes: 8-bit
    samples, no interlace, every row unfiltered, one zlib stream."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in _PNG_COLOR_TYPES:
        raise ValueError(f"want a uint8 (H, W[, 1|3|4]) image, got {image.dtype} "
                         f"{image.shape}")
    h, w, c = image.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # a 0 filter byte leads each row
    rows[:, 1:] = image.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def save_png(image: np.ndarray, path: str) -> str:
    """Write ``image`` (see :func:`encode_png`) to ``path``."""
    data = encode_png(image)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> str:
    """:func:`make_grid` of ``images`` written as a PNG file."""
    return save_png(make_grid(images, nrow), path)
