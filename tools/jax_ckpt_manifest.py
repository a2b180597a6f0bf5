"""Write the layout of a JAX-package checkpoint (``ckpt_{N}_steps.ckpt``,
the flax msgpack of its ``GANState``) as a small JSON manifest: every
entry's path, and each array's dtype and shape, in the order flax writes
them; ``null`` where flax writes nil (a net without BN statistics or
spectral-norm vectors), ``{}`` for an empty map (AdamW's decayed-weights
entry).

    python tools/jax_ckpt_manifest.py [--preset fgan32] [--out FILE]

The trainer is built as the JAX CLI builds it for the preset (its models
through ``zoo.build_models``, its ``GANTrainer`` keywords), and its state
is traced with ``jax.eval_shape``: no array is allocated, so the
full-width preset costs a few seconds on the CPU. ``chip_smoke.py`` packs
a flax-layout file from the committed manifest
(``tools/fgan32_jax_ckpt_manifest.json``) with seeded values, on a machine
without JAX; ``tests/test_torch_jax_checkpoint.py`` regenerates the
manifest and compares.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "fgan32_jax_ckpt_manifest.json")


def state_shapes(preset: str = "fgan32"):
    """The flax state dict of the JAX CLI's ``GANState`` for ``preset``,
    with ``jax.ShapeDtypeStruct`` leaves."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from fastfourierconvolution_tpu.train import GANTrainer
    from fastfourierconvolution_tpu.utils.config import make_config
    from fastfourierconvolution_tpu.zoo import build_models

    cfg = make_config(preset)
    m, t = cfg.model, cfg.train
    g_model, d_model = build_models(cfg)
    # the keywords of the JAX CLI's run_train (cli.py)
    trainer = GANTrainer(
        g_model, d_model, z_size=m.z_size, lr=t.lr, d_lr=t.d_lr,
        total_steps=t.num_total_steps, num_dis_updates=t.num_dis_updates, loss=t.loss,
        optimizer=t.optimizer, b1=t.beta1, b2=t.beta2, conditional=m.conditional,
        num_classes=m.num_classes,
        fused_dis_batch=m.discriminator in ("sn_conv", "cond_sn_conv", "sn_dcgan")
        and not t.aw_method,
        gp_lambda=t.gp_lambda, aw_method=t.aw_method, update_order=t.update_order,
        remat=t.remat, d_progress_arg=m.discriminator == "cond_dcgan")
    sample = jnp.zeros((2, cfg.data.image_size, cfg.data.image_size, cfg.data.channels))
    state = jax.eval_shape(trainer.init, jax.random.PRNGKey(0), sample)
    return serialization.to_state_dict(state)


def manifest(preset: str = "fgan32") -> dict:
    """{"preset", "entries": [[path, spec], ...]}: spec {"dtype", "shape"}
    for an array, None for nil, {} for an empty map."""
    entries = []

    def walk(prefix, node):
        if isinstance(node, dict) and node:
            for key, value in node.items():
                walk(f"{prefix}/{key}" if prefix else str(key), value)
        elif isinstance(node, dict):
            entries.append([prefix, {}])
        elif node is None:
            entries.append([prefix, None])
        else:
            entries.append([prefix, {"dtype": str(node.dtype), "shape": list(node.shape)}])

    walk("", state_shapes(preset))
    return {"preset": preset, "entries": entries}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="fgan32")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    data = manifest(args.preset)
    with open(args.out, "w") as f:
        f.write(f'{{"preset": {json.dumps(data["preset"])}, "entries": [\n')
        f.write(",\n".join(json.dumps(e) for e in data["entries"]))
        f.write("\n]}\n")
    n = sum(1 for _, spec in data["entries"] if spec and "dtype" in spec)
    print(f"{args.out}: {len(data['entries'])} entries, {n} arrays")


if __name__ == "__main__":
    main()
