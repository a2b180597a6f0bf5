"""Data parallelism over ``torch.distributed``, the JAX package's
``parallel/mesh.py`` and the multi-process launch of its ``cli.py``.

The JAX trainer runs data-parallel on a ("dp", "tp") device mesh: the
batch is sharded over "dp", the parameters are replicated, XLA inserts the
gradient all-reduce, and the BatchNorm statistics are those of the whole
logical batch (sync-BN). The port runs one process per card, each on its
slice of the global batch, and keeps the same contract: a step of N
processes computes what one process computes on the global batch.

- Joining: :func:`initialize` reads the JAX CLI's environment
  (``FFC_TPU_COORDINATOR``, ``FFC_TPU_NUM_PROCESSES``,
  ``FFC_TPU_PROCESS_ID``: ``init_method="tcp://..."``; or
  ``FFC_TPU_DISTRIBUTED=auto``: torchrun's ``env://``). Each process takes
  ``cuda:<local rank % device count>`` (``LOCAL_RANK`` under torchrun, else
  the rank). Host values travel over a gloo group; tensors on the card
  over NCCL where every process has a card of its own, else (processes
  that share a card) over the same gloo group. The choice is made from the
  device plan, printed, and never changed after a failure.
- Statistics: the FourierUnit op, the fused packed BN and the plain
  BatchNorms take their sums over the global batch. The kernels' per-item
  partial rows are gathered in rank order (:func:`all_gather_rows`) and
  reduced by ``fu_reduce`` with the global count, so the statistic has the
  bits of one process's on the global batch; sums taken in PyTorch are
  summed over the processes by :func:`sum_over_processes`, which autograd
  differentiates (its backward sums the cotangents), and
  :func:`batch_moments` turns them into the global mean and variance.
- Gradients: a backward sum that is also a parameter's gradient is the
  global sum over N (:func:`param_share`), and the trainer averages every
  gradient over the processes in one bucketed all-reduce per network and
  phase (:func:`average_`), so the averaged gradient is the global batch's.
- Random draws: :func:`global_draw` draws for the global batch from the
  process's generator (the same state in every process) and keeps the
  process's rows, so an item's latents and noise do not depend on the
  process count.
- :func:`process_index`, :func:`process_count`, :func:`mp_and` (JAX
  ``eval/pipeline.py::_mp_and``), :func:`shard_full_batch` (JAX
  ``shard_full_batch``), :func:`broadcast_module_`.
- ``collectives`` and ``collective_bytes`` count the tensor collectives
  and the bytes each process puts in, by kind ("gather", "sum" forward
  and backward alike, "average"), as the kernel wrappers count their
  launches.

No counterpart: ``make_mesh``, ``batch_sharding``, ``replicated``,
``put_global_batch``, ``put_global_tree``, ``replicate_tree``,
``params_shardings`` and ``state_shardings``. Every process holds whole
parameters (made from one seed, or broadcast from rank 0), and its batch
is its slice already (``data.DataLoader`` shards at the source), so there
is nothing to place or to gather back. The "tp" axis, which JAX uses to
shard the FourierUnit mix kernels' out-features, needs a rectangular-mix
FourierUnit kernel: ROADMAP queue 1 item 10b.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

ENV_COORDINATOR = "FFC_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "FFC_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "FFC_TPU_PROCESS_ID"
ENV_DISTRIBUTED = "FFC_TPU_DISTRIBUTED"


@dataclasses.dataclass
class _Group:
    rank: int
    size: int
    device: torch.device
    backend: str  # of the tensors on the card: "nccl" or "gloo"
    device_group: Optional[object]  # the NCCL group, None for the default (gloo)


_GROUP: Optional[_Group] = None
collectives: collections.Counter = collections.Counter()
collective_bytes: collections.Counter = collections.Counter()


def launch_env() -> Optional[dict]:
    """The process group the environment asks for: ``{"init_method",
    "world_size", "rank"}`` from ``FFC_TPU_COORDINATOR``,
    ``FFC_TPU_NUM_PROCESSES`` and ``FFC_TPU_PROCESS_ID`` (all three, or
    ValueError naming the missing ones), ``{"init_method": "env://"}`` with
    ``FFC_TPU_DISTRIBUTED=auto`` (torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), or None for a single process."""
    names = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)
    given = {k: os.environ.get(k) for k in names if os.environ.get(k)}
    if given:
        missing = [k for k in names if k not in given]
        if missing:
            raise ValueError(f"{', '.join(sorted(given))} set without {', '.join(missing)}: "
                             f"a multi-process launch needs all of {', '.join(names)}")
        address = given[ENV_COORDINATOR]
        return {"init_method": address if "://" in address else f"tcp://{address}",
                "world_size": int(given[ENV_NUM_PROCESSES]),
                "rank": int(given[ENV_PROCESS_ID])}
    auto = os.environ.get(ENV_DISTRIBUTED)
    if auto:
        if auto != "auto":
            raise ValueError(f"{ENV_DISTRIBUTED}={auto!r}: the only value is 'auto'")
        return {"init_method": "env://"}
    return None


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> torch.device:
    """Join the process group (``init_method`` and the rest, else the
    environment's, :func:`launch_env`) and return this process's device:
    ``cpu``, or ``cuda:<local rank % device count>``, made current. Without
    a group to join, ``device`` as it is. Prints the device plan."""
    global _GROUP
    if init_method is None:
        launch = launch_env()
        if launch is None:
            return torch.device(device)
        init_method = launch["init_method"]
        world_size, rank = launch.get("world_size"), launch.get("rank")
    if _GROUP is not None:
        raise RuntimeError("this process has joined a process group already")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    kwargs = {} if world_size is None else {"world_size": world_size, "rank": rank}
    dist.init_process_group("gloo", init_method=init_method, **kwargs)
    rank, size = dist.get_rank(), dist.get_world_size()
    backend, device_group, why = "gloo", None, "the CPU"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        plan: List[tuple] = [None] * size
        dist.all_gather_object(plan, (socket.gethostname(), device.index))
        if len(set(plan)) == size:
            backend, why = "nccl", "a card per process"
            device_group = dist.new_group(backend="nccl")
        else:
            why = "processes share a card"
    _GROUP = _Group(rank, size, device, backend, device_group)
    print(f"[parallel] process {rank} of {size} on {device}: {backend} ({why})", flush=True)
    return device


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _GROUP
    if _GROUP is None:
        return
    _GROUP = None
    dist.destroy_process_group()


def active() -> bool:
    """Whether this process has joined a group (:func:`initialize`)."""
    return _GROUP is not None


def process_index() -> int:
    return 0 if _GROUP is None else _GROUP.rank


def process_count() -> int:
    return 1 if _GROUP is None else _GROUP.size


def backend() -> Optional[str]:
    """The backend of the tensors on the card, or None without a group."""
    return None if _GROUP is None else _GROUP.backend


def global_count(local: int) -> int:
    """The global batch's count of a per-process count (equal slices)."""
    return local * process_count()


def _group_of(t: torch.Tensor):
    return _GROUP.device_group if t.is_cuda else None


def _count(kind: str, t: torch.Tensor) -> None:
    collectives[kind] += 1
    collective_bytes[kind] += t.numel() * t.element_size()


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (rows, ...) stacked along dim 0 in rank order,
    (N·rows, ...); ``t`` itself without a group. Every process must pass
    the same shape. NCCL gathers into one tensor; gloo gathers host
    tensors, and a card's tensor as a sum of zero-filled buffers in which
    each process wrote its rows (gloo sums tensors on the card but does not
    gather them), which adds only zeros, so the rows keep their bits."""
    if _GROUP is None:
        return t
    t = t.contiguous()
    n, rows = _GROUP.size, t.shape[0]
    _count("gather", t)
    if t.is_cuda and _GROUP.backend == "nccl":
        out = t.new_empty((n * rows,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=_GROUP.device_group)
        return out
    if t.is_cuda:
        out = t.new_zeros((n * rows,) + tuple(t.shape[1:]))
        out[_GROUP.rank * rows:(_GROUP.rank + 1) * rows] = t
        dist.all_reduce(out)
        return out
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


class _SumOverProcesses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        _count("sum", out)
        dist.all_reduce(out, group=_group_of(out))
        return out

    @staticmethod
    def backward(ctx, g):  # every process's output is the sum: the cotangents add up
        return _SumOverProcesses.apply(g.contiguous())


def sum_over_processes(t: torch.Tensor) -> torch.Tensor:
    """The sum of every process's ``t``, differentiable (twice: a gradient
    penalty differentiates it again); ``t`` itself without a group."""
    return t if _GROUP is None else _SumOverProcesses.apply(t.contiguous())


def batch_moments(xf: torch.Tensor):
    """(mean, biased variance E[x²] − E[x]²) of each channel of ``xf`` (B,
    C, H, W) over (B, H, W), in xf's dtype, no clamp; under a group over
    the global batch: the per-channel sums and sums of squares summed over
    the processes (:func:`sum_over_processes`) over the global count."""
    if _GROUP is None:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
    n = global_count(xf.shape[0]) * xf.shape[2] * xf.shape[3]
    s1, s2 = sum_over_processes(torch.stack([xf.sum(dim=(0, 2, 3)),
                                             (xf * xf).sum(dim=(0, 2, 3))])) / n
    return s1, s2 - s1 * s1


def param_share(t: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient from a sum over the global batch: the sum
    over N, this process's share of it (the trainer's average over the
    processes then gives the global batch's gradient); ``t`` without a
    group."""
    return t if _GROUP is None else t / _GROUP.size


def average_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every process's tensors averaged over the processes, in one
    all-reduce of one flat f32 bucket (the tensors are f32); the tensors
    themselves without a group."""
    tensors = list(tensors)
    if _GROUP is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _count("average", flat)
    dist.all_reduce(flat, group=_group_of(flat))
    flat.div_(_GROUP.size)
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def global_draw(draw, shape, segments: int = 1) -> torch.Tensor:
    """``draw(shape)`` for this process's rows: without a group the draw
    itself; under one, ``draw`` of the global batch's shape (every process
    from the same generator state, which then advances as one process's
    would) and this process's rows of it. ``segments``: the batch is that
    many equal parts, each this process's rows of the global batch's part
    (D's fused pass on ``cat([fake, real])``)."""
    shape = tuple(shape)
    if _GROUP is None:
        return draw(shape)
    n, k = _GROUP.size, segments
    full = draw((shape[0] * n,) + shape[1:])
    return full.view((k, n, shape[0] // k) + shape[1:])[:, _GROUP.rank].reshape(shape)


def shard_full_batch(batch):
    """This process's rows of a batch every process holds whole (seeded
    samplers, full local datasets): rows [rank·B/N, (rank+1)·B/N); the
    batch itself without a group. B must divide over the processes."""
    if _GROUP is None:
        return batch
    per, rem = divmod(len(batch), _GROUP.size)
    if rem:
        raise ValueError(f"a batch of {len(batch)} does not divide over {_GROUP.size} processes")
    return batch[_GROUP.rank * per:(_GROUP.rank + 1) * per]


def mp_and(flag: bool) -> bool:
    """The AND of every process's ``flag`` (a cache hit counts only where
    every process has the file, so that all of them take the same path);
    ``flag`` without a group."""
    if _GROUP is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def all_equal(value: int) -> bool:
    """Whether every process passed the same integer (a resume step)."""
    if _GROUP is None:
        return True
    t = torch.tensor([value, -value])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0]) == value and int(t[1]) == -value


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers into every process's
    ``module``, in place; nothing without a group."""
    if _GROUP is None:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src, group=_group_of(t))


def barrier() -> None:
    """Wait for every process (over the host group); nothing without one."""
    if _GROUP is not None:
        dist.barrier()
