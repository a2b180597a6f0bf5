"""The serving traffic: one closed-loop client sending requests of
``batch`` latents to ``serving.Generator.generate(z, uint8=True)``.

The latents of request i are drawn on the host from (seed, i), before the
request is timed. A request runs from the call of ``generate`` until its
uint8 NHWC images are in host memory; the client then sends the next.

The state served is the seeded weights with BN and FourierUnit running
statistics set to the batch statistics of one f32 training-mode pass of
the plain reference (no noise) on latents from the seed: images with
spread, as a trained generator gives. The benchmark makes it once and
hands the same tensors to the server and, after the window, to the
reference.

``check_requests`` requests of the window, a uniform sample drawn from
the seed as the window runs (reservoir sampling), are compared with the
reference's uint8 images of the same latents.

Traffic keys: ``batch``, ``warm_requests``, ``trace_requests``,
``check_requests``.
"""

from __future__ import annotations

import gc
import time
from typing import List

import numpy as np
import torch

from ..reference import ffc_gan as ref


# the streams of latents: the window's requests, the warm-up's, the traced ones
WINDOW, WARM, TRACED = 0, 1, 2


def latents(cfg: dict, traffic: dict, seed: int, i: int, stream: int = WINDOW) -> torch.Tensor:
    """Request ``i``'s (B, z_size) f32 latents of ``stream``, drawn on the
    host from (seed, stream, i)."""
    rng = np.random.default_rng([seed, stream, i])
    return torch.from_numpy(rng.standard_normal((traffic["batch"], cfg["z_size"]),
                                                dtype=np.float32))


def served_state(cfg: dict, traffic: dict, seed: int, device) -> ref.Tensors:
    """The generator's seeded weights with calibrated running statistics."""
    gen = torch.Generator(device).manual_seed(seed)
    t = ref.make_leaves(ref.generator_leaves(cfg), gen, device, cfg["noise_weight_std"])
    z = torch.randn((traffic["batch"], cfg["z_size"]), generator=gen, device=device)
    with torch.no_grad(), ref.f32_products():
        ref.generator_forward(t, cfg, z, True, lambda s: torch.zeros(s, device=device),
                              momentum=0.0)
    return t


class Driver:
    """One serving cell on ``device``."""

    spans = ("request", "generate", "to_host")

    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.device = torch.device(device)
        self.dtype = cell.config["serve"]["dtype"]
        self.ref_state = None
        # when each part of set-up ended (time.perf_counter), by name
        self.marks = {}

    def setup(self) -> None:
        from fastfourierconvolution_tpu_torch.models.ffc_gan import FFCGenerator
        from fastfourierconvolution_tpu_torch.serving import Generator

        cfg = self.cfg
        model = FFCGenerator(z_size=cfg["z_size"], ngf=cfg["ngf"], ratio_g=cfg["ratio_g"],
                             mg=cfg["mg"], channel_mults=cfg["channel_mults"],
                             out_channels=cfg["out_channels"])
        self.server = Generator(model, device=self.device, dtype=self.dtype)
        self.marks["models"] = time.perf_counter()
        state = served_state(cfg, self.traffic, self.seed, self.device)
        self.server.model.load_state_dict(state)
        # the reference's copy, off the card until the window has closed
        self.state = {k: v.cpu() for k, v in state.items()}
        del state
        self.marks["state"] = time.perf_counter()
        for i in range(self.traffic["warm_requests"]):
            self.request(latents(cfg, self.traffic, self.seed, i, WARM))
        self.marks["warm"] = time.perf_counter()

    def request(self, z: torch.Tensor):
        """(images on the host, host ms in ``generate``, ms to the images)."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("generate"):
            out = self.server.generate(z, uint8=True)
        t1 = time.perf_counter()
        with torch.profiler.record_function("to_host"):
            images = out.cpu()
        t2 = time.perf_counter()
        return images, (t1 - t0) * 1e3, (t2 - t0) * 1e3

    def window(self, seconds: float) -> dict:
        """Requests back to back for ``seconds``; a uniform sample of
        ``check_requests`` of them kept (reservoir, drawn from the seed)."""
        keep = self.traffic["check_requests"]
        pick = np.random.default_rng([self.seed, 3])
        self.kept: List[tuple] = []
        latency, host = [], []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            z = latents(self.cfg, self.traffic, self.seed, i)
            images, host_ms, ms = self.request(z)
            latency.append(ms)
            host.append(host_ms)
            if i < keep:
                self.kept.append((i, images))
            else:
                j = int(pick.integers(0, i + 1))
                if j < keep:
                    self.kept[j] = (i, images)
            i += 1
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "requests": i, "images": i * self.traffic["batch"],
                "latency_ms": latency, "host_ms": host}

    def traced(self):
        from ..trace import profiled

        z = [latents(self.cfg, self.traffic, self.seed, i, TRACED)
             for i in range(self.traffic["trace_requests"])]

        def call():
            for zi in z:
                with torch.profiler.record_function("request"):
                    self.request(zi)

        return profiled(call, self.spans), {"requests": len(z)}

    def release(self) -> None:
        self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_images(self, z: torch.Tensor, q=ref.F32) -> torch.Tensor:
        """The reference's uint8 NHWC images of latents ``z`` from the served
        state, in f32 (TF32 off) with ``q`` rounding."""
        if self.ref_state is None:
            self.ref_state = {k: v.to(self.device) for k, v in self.state.items()}
        t = self.ref_state
        with torch.no_grad(), ref.f32_products():
            x = ref.generator_forward(t, self.cfg, z.to(self.device), False, q=q)
        return ref.to_uint8(x.permute(0, 2, 3, 1)).cpu()

    def check(self, q=ref.F32) -> List[tuple]:
        return compare([(i, images, self.reference_images(
            latents(self.cfg, self.traffic, self.seed, i), q)) for i, images in self.kept])


def compare(pairs) -> List[tuple]:
    """(name, value, where) of the number compared over the (request,
    served, reference) uint8 image batches: the worst image's mean gap in
    levels (where: "request.image")."""
    gap, at = 0.0, ""
    for i, served, reference in pairs:
        diff = (served.float() - reference.float()).abs().flatten(1).mean(dim=1)
        if float(diff.max()) >= gap:
            gap, at = float(diff.max()), f"{i}.{int(diff.argmax())}"
    return [("image_gap", gap, at)]
