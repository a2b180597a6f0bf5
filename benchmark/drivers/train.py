"""The training traffic: ``GANTrainer.update_steps`` called back to back
on reals made on the device from the seed.

Set-up builds one trainer, puts the seeded state into it, and drives its
first steps through the window's own call, ``update_steps``: one step
(run eagerly, the step then captured as a CUDA graph), two more (replayed),
then ``warm_calls`` calls of ``steps_per_call`` steps. The first three
steps are the ones the plain reference follows: their losses, the first
gradient (from the optimizer's first moment after one step, exp_avg =
(1 - beta1) g) and each parameter's change over the three are read then.
The window calls ``update_steps`` with ``steps_per_call`` steps at a time,
at most two calls in flight, each on the next chunk of a pool of
``pool_calls`` chunks of reals; it ends on a synchronisation.

Traffic keys: ``batch``, ``steps_per_call``, ``pool_calls``,
``warm_calls``, ``trace_steps`` (the steps of the traced call).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..reference import ffc_gan as ref
from ..reference.train_step import TrainStep, run_steps

CHECK_STEPS = 3
# a leaf whose first gradient in the reference is under this share of the
# median leaf's is moved by Adam's round-off alone: its change is not compared
FREE_LEAF_SHARE = 1e-3
# the kernel of ``torch.cuda._sleep``, queued between the traced window's
# lead call and its traced call
MARKER = "spin_kernel"


def seeded_state(cfg: dict, seed: int, device) -> Dict[str, ref.Tensors]:
    """The pair's starting state, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)
    std = cfg["noise_weight_std"]
    return {"g": ref.make_leaves(ref.generator_leaves(cfg), gen, device, std),
            "d": ref.make_leaves(ref.discriminator_leaves(cfg), gen, device, std)}


def reals_chunk(cfg: dict, traffic: dict, seed: int, i: int, steps: int, device):
    """Chunk ``i`` of reals, (steps, B, R, R, C) in [-1, 1], drawn on the
    device from (seed, i): every row differs. (The chunk's generator seed
    is none of the seeds the state and the trainer's draws take.)"""
    gen = torch.Generator(device).manual_seed(seed * 1000 + 500 + i)
    r = cfg["resolution"]
    shape = (steps, traffic["batch"], r, r, cfg["out_channels"])
    return torch.rand(shape, generator=gen, device=device) * 2 - 1


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


class Driver:
    """One training cell on ``device``."""

    spans = ("update_steps", "synchronize")

    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.device = torch.device(device)
        self.readings: Optional[dict] = None
        # when each part of set-up ended (time.perf_counter), by name
        self.marks: Dict[str, float] = {}
        # names of leaves whose first gradients and changes are kept whole
        self.keep: Tuple[str, ...] = ()

    # -- the program ---------------------------------------------------------------

    def setup(self) -> None:
        from fastfourierconvolution_tpu_torch.models.ffc_gan import (FFCGenerator,
                                                                      SNConvDiscriminator)
        from fastfourierconvolution_tpu_torch.train.gan import GANTrainer

        cfg, tr = self.cfg, self.cfg["train"]
        g = FFCGenerator(z_size=cfg["z_size"], ngf=cfg["ngf"], ratio_g=cfg["ratio_g"],
                         mg=cfg["mg"], channel_mults=cfg["channel_mults"],
                         out_channels=cfg["out_channels"])
        d = SNConvDiscriminator.for_resolution(cfg["resolution"])
        self.trainer = GANTrainer(
            g, d, z_size=cfg["z_size"], lr=tr["lr"], total_steps=tr["total_steps"],
            b1=tr["beta1"], b2=tr["beta2"], fused_dis_batch=tr["fused_dis_batch"],
            seed=self.seed, device=self.device, dtype=tr["dtype"])
        self.marks["models"] = time.perf_counter()
        state = seeded_state(cfg, self.seed, self.device)
        self.trainer.g.load_state_dict(state["g"])
        self.trainer.d.load_state_dict(state["d"])
        k = self.traffic["steps_per_call"]
        self.pool = [reals_chunk(cfg, self.traffic, self.seed, i, k, self.device)
                     for i in range(self.traffic["pool_calls"])]
        self._sync()
        self.marks["state"] = time.perf_counter()
        self.readings = self._first_steps(state)
        del state
        self.marks["first_steps"] = time.perf_counter()
        for i in range(self.traffic["warm_calls"]):
            self.trainer.update_steps(self.pool[i % len(self.pool)])
        self._sync()
        self.marks["warm"] = time.perf_counter()

    def _params(self):
        for side in ("g", "d"):
            for name, p in getattr(self.trainer, side).named_parameters():
                yield f"{side}.{name}", p

    def _first_steps(self, state) -> dict:
        """The first three steps through ``update_steps`` (one, then two, on
        rows of the pool's first chunk), read as the reference reads its
        own: losses, first gradients, changes."""
        first = self.pool[0][:CHECK_STEPS]
        out = [self.trainer.update_steps(first[:1])]
        opts = {"g": self.trainer.g_opt, "d": self.trainer.d_opt}
        b1 = self.cfg["train"]["beta1"]
        grads = {}
        for name, p in self._params():
            # no moment: the optimizer received no gradient
            moment = opts[name[0]].state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            grads[name] = moment / (1 - b1)
        out.append(self.trainer.update_steps(first[1:]))
        losses = [(float(g), float(d)) for o in out
                  for g, d in zip(o["loss_g"].tolist(), o["loss_d"].tolist())]
        start = {f"{side}.{k}": v for side in ("g", "d") for k, v in state[side].items()}
        deltas = {name: p.detach() - start[name] for name, p in self._params()}
        return {"losses": losses, "grad_norms": leaf_norms(grads),
                "delta_norms": leaf_norms(deltas), "kept": self._kept(grads, deltas)}

    def _kept(self, grads, deltas) -> Dict[str, tuple]:
        """(first gradient, change) on the host of each leaf whose name
        holds one of :attr:`keep`."""
        return {n: (grads[n].detach().cpu(), deltas[n].detach().cpu()) for n in grads
                if any(k in n for k in self.keep)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        """``update_steps`` back to back for ``seconds`` (at most two calls
        in flight); the images trained over the seconds to the final
        synchronisation."""
        k, b = self.traffic["steps_per_call"], self.traffic["batch"]
        calls, flight, done = 0, [], []
        self._sync()
        t0 = time.perf_counter()
        while True:
            self.trainer.update_steps(self.pool[calls % len(self.pool)])
            calls += 1
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                flight.append(event)
                if len(flight) > 2:
                    flight.pop(0).synchronize()
                    done.append(time.perf_counter())
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        if len(done) > 2:
            # the card's pace call by call: a steady process, or a few stalls
            gaps = sorted(1e3 * (y - x) for x, y in zip(done, done[1:]))
            pick = lambda q: gaps[min(int(q * len(gaps)), len(gaps) - 1)]
            print(f"window {calls} calls, ms between completions: median {pick(0.5):.2f} "
                  f"p05 {pick(0.05):.2f} p95 {pick(0.95):.2f} max {gaps[-1]:.2f}",
                  file=sys.stderr)
        return {"seconds": elapsed, "steps": calls * k, "images": calls * k * b,
                "calls": calls}

    def traced(self):
        """The traced window: a lead call queued first, as the window keeps
        calls in flight, then a marker kernel, then the traced call. The
        trace is read from the marker's end, so it holds the traced call's
        steps on a card that is busy when they start."""
        from ..trace import profiled

        reals = self.pool[0][:self.traffic["trace_steps"]]

        def call():
            self.trainer.update_steps(reals)
            torch.cuda._sleep(1)
            with torch.profiler.record_function("update_steps"):
                self.trainer.update_steps(reals)
            with torch.profiler.record_function("synchronize"):
                self._sync()

        self._sync()
        return profiled(call, self.spans, start_after=MARKER), {"steps": len(reals)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.trainer = self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference and the comparison -------------------------------------------

    def reference_readings(self, q=ref.F32, batch_rows: Optional[int] = None) -> dict:
        """The plain reference's three steps from the same state, reals and
        draws, read as :meth:`_first_steps` reads the program's: in f32 with
        ``q`` rounding (the control), or with losses over the first
        ``batch_rows`` rows only (a planted fault)."""
        state = seeded_state(self.cfg, self.seed, self.device)
        start = {f"{s}.{k}": v.clone() for s in ("g", "d") for k, v in state[s].items()}
        first = reals_chunk(self.cfg, self.traffic, self.seed, 0,
                            self.traffic["steps_per_call"], self.device)[:CHECK_STEPS]
        step = TrainStep(state["g"], state["d"], self.cfg, self.cfg["train"], self.seed,
                         self.device, q, batch_rows)
        with ref.f32_products():
            losses = run_steps(step, list(first))
        grads = {f"{s}.{k}": v for s in ("g", "d") for k, v in step.first_grads[s].items()}
        deltas = {name: state[name[0]][name[2:]] - start[name] for name in grads}
        return {"losses": losses, "grad_norms": leaf_norms(grads),
                "delta_norms": leaf_norms(deltas), "kept": self._kept(grads, deltas)}

    def check(self) -> List[tuple]:
        return compare(self.readings, self.reference_readings())


def _median(values: List[float]) -> float:
    values = sorted(values)
    n = len(values)
    return values[n // 2] if n % 2 else (values[n // 2 - 1] + values[n // 2]) / 2


def leaf_gaps(prog: Dict[str, float], ref_norms: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's |prog - ref| / max(ref, the median leaf's ref)."""
    floor = _median([ref_norms[n] for n in names])
    return {n: abs(prog[n] - ref_norms[n]) / max(ref_norms[n], floor, 1e-30) for n in names}


def compare(prog: dict, reference: dict) -> List[tuple]:
    """(name, value, where) of each number the comparison can hold to a
    limit (the cell's limits file names those it does): the largest loss
    gap over the three steps and the first step's (where: "step.side");
    the worst and the median leaf's gap of first-gradient norms; the worst
    and the median leaf's gap of change norms over the three steps, leaves
    that the reference's first gradient leaves at rounding excluded (where:
    the leaf)."""
    losses = [(abs(a - b), f"{i + 1}.{side}")
              for i, (pa, pb) in enumerate(zip(prog["losses"], reference["losses"]))
              for side, a, b in zip("gd", pa, pb)]
    grads = reference["grad_norms"]
    names = sorted(grads)
    floor = FREE_LEAF_SHARE * _median([grads[n] for n in names])
    moved = [n for n in names if grads[n] >= floor]
    out = [("loss_gap", *max(losses)), ("loss1_gap", *max(losses[:2]))]
    for name, gaps in (("grad", leaf_gaps(prog["grad_norms"], grads, names)),
                       ("change", leaf_gaps(prog["delta_norms"], reference["delta_norms"],
                                            moved))):
        ranked = sorted((v, n) for n, v in gaps.items())
        out.append((f"{name}_gap", *ranked[-1]))
        out.append((f"{name}_median_gap", *ranked[len(ranked) // 2]))
    return out
