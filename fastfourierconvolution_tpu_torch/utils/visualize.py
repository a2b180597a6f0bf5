"""Feature-map figure, the JAX package's ``utils/visualize.py``.

Captures each block's output of a generator with forward hooks on its
top-level modules (in place of flax's ``capture_intermediates``) and
renders the channel-mean maps into one figure (needs matplotlib).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def capture_feature_maps(trainer, z, labels=None) -> Dict[str, np.ndarray]:
    """Run ``trainer.generate(z, labels)`` (eval mode) with a forward hook
    on every top-level module of ``trainer.g``. Returns {module name: the
    channel mean of sample 0's (C, H, W) output as an (H, W) f32 map} for
    every 4-D output, in the order the forward reached them, a tuple's
    members as ``name[i]``, and the images themselves as ``__call__``."""
    maps: Dict[str, np.ndarray] = {}

    def keep(name, out):
        if isinstance(out, (tuple, list)):
            for i, member in enumerate(out):
                keep(f"{name}[{i}]" if len(out) > 1 else name, member)
        elif isinstance(out, torch.Tensor) and out.dim() == 4:
            maps[name] = out[0].float().mean(dim=0).cpu().numpy()

    hooks = [module.register_forward_hook(lambda _m, _a, out, name=name: keep(name, out))
             for name, module in trainer.g.named_children()]
    try:
        images = trainer.generate(z, labels)
    finally:
        for hook in hooks:
            hook.remove()
    maps["__call__"] = images[0].float().mean(dim=-1).cpu().numpy()
    return maps


def save_feature_map_figure(maps: Dict[str, np.ndarray], path: str, max_maps: int = 20) -> str:
    """Grid figure of grayscale feature maps, four a row."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    items = list(maps.items())[:max_maps]
    cols = 4
    rows = -(-len(items) // cols)
    fig = plt.figure(figsize=(4 * cols, 4 * rows))
    for i, (name, fm) in enumerate(items):
        ax = fig.add_subplot(rows, cols, i + 1)
        ax.imshow(fm, cmap="gray")
        ax.set_title(name.split("/")[0][:30], fontsize=8)
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
