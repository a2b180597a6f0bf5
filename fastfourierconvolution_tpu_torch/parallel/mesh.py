"""Data and tensor parallelism over ``torch.distributed``, the JAX
package's ``parallel/mesh.py`` and the multi-process launch of its
``cli.py``.

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
  and backward alike, "average"; under tp "tp_gather" and "tp_sum"), as
  the kernel wrappers count their launches.

Tensor parallelism (``initialize(..., tp=T)``, the JAX mesh's "tp" axis):
N = D·T processes form a dp x tp grid laid out as JAX lays out its
devices, rank d·T + t, so a tp group is T consecutive ranks (which must
sit on one host) and a dp group the ranks with one t. Everything above
(statistics, sums, counts, draws, averages, the batch's slices) runs over
the dp group: tp peers hold the same rows. Each tp peer owns out-channel
slice t of every FourierUnit mix whose channels T divides (JAX shards a
mix's out-features only where T divides them; its slice is contiguous,
this one takes the real and imaginary columns of the same channels, since
the inverse transform needs both: ``ops.fourier_unit.out_columns``; the
difference never leaves a process). The unit transforms all C input
channels, mixes, normalises and inverts its Co = C/T, and the tp
Functions below join the slices: y's channel slices gathered in rank
order, x's partial gradients summed in rank order, the BN vectors'
slices and gradients split and gathered. ``GANTrainer.state_dict``
gathers the sliced mixes and their moments whole and ``load_state_dict``
slices them again (JAX's ``replicate_tree`` and ``put_global_tree``), so
a checkpoint is the same file at every T. The eval forward of
``GANTrainer.generate`` (the in-loop eval, the sample grid) runs on the
whole mixes, gathered over the tp group at the call by every process of
the group, so the serving artifacts and ``sample``, ``export`` and
``fidelity``, which read checkpoints, stay tp = 1 programs; it computes
the function of JAX's sharded ``generate``.

No counterpart: ``make_mesh``, ``batch_sharding``, ``replicated``,
``put_global_batch``, ``params_shardings`` and ``state_shardings``. Every
process holds whole parameters but its mix slices (made from one seed, or
broadcast from rank 0, before the slicing), and its batch is its slice
already (``data.DataLoader`` shards at the source by dp index), so there
is nothing to place.
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
class _Sub:
    """A dp or tp group: this process's index in it, its size, its gloo
    group for host tensors (None: the default group) and the group of the
    tensors on the card (its NCCL group; under gloo the host group)."""
    rank: int
    size: int
    host: Optional[object] = None
    device: Optional[object] = None


@dataclasses.dataclass
class _Group:
    rank: int
    size: int
    device: torch.device
    backend: str  # of the tensors on the card: "nccl" or "gloo"
    device_group: Optional[object]  # the NCCL group, None for the default (gloo)
    dp: _Sub
    tp: _Sub


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


def _check_tp(tp: int, size: int) -> None:
    if tp < 1 or size % tp:
        raise ValueError(f"train.tp={tp} must divide the process count {size}: the processes "
                         f"form a dp x tp grid")


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               tp: int = 1) -> torch.device:
    """Join the process group (``init_method`` and the rest, else the
    environment's, :func:`launch_env`) and return this process's device:
    ``cpu``, or ``cuda:<local rank % device count>``, made current. Without
    a group to join, ``device`` as it is. ``tp``: the tensor-parallel width
    T, which must divide the process count (ValueError, also for a single
    process with T > 1); its groups must each sit on one host. Prints the
    device plan."""
    global _GROUP
    if init_method is None:
        launch = launch_env()
        if launch is None:
            _check_tp(tp, 1)
            return torch.device(device)
        init_method = launch["init_method"]
        world_size, rank = launch.get("world_size"), launch.get("rank")
    if _GROUP is not None:
        raise RuntimeError("this process has joined a process group already")
    if world_size is not None:
        _check_tp(tp, world_size)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    kwargs = {} if world_size is None else {"world_size": world_size, "rank": rank}
    dist.init_process_group("gloo", init_method=init_method, **kwargs)
    rank, size = dist.get_rank(), dist.get_world_size()
    try:
        _check_tp(tp, size)
        local = int(os.environ.get("LOCAL_RANK", rank))
        index = local % torch.cuda.device_count() if device.type == "cuda" else -1
        plan: List[tuple] = [None] * size
        dist.all_gather_object(plan, (socket.gethostname(), index))
        for d in range(size // tp):
            hosts = {host for host, _ in plan[d * tp:(d + 1) * tp]}
            if len(hosts) > 1:
                raise ValueError(f"tp group {d} (processes {d * tp}-{(d + 1) * tp - 1}) spans "
                                 f"the hosts {sorted(hosts)}: a tp group must sit on one host")
    except ValueError:
        dist.destroy_process_group()
        raise
    backend, device_group, why = "gloo", None, "the CPU"
    if device.type == "cuda":
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        if len(set(plan)) == size:
            backend, why = "nccl", "a card per process"
            device_group = dist.new_group(backend="nccl")
        else:
            why = "processes share a card"
    dp = _Sub(rank // tp, size // tp, None, device_group)
    tpg = _Sub(rank % tp, tp)
    if tp > 1:
        # every process makes every group, in one order: the tp groups of
        # consecutive ranks, then the dp groups of the ranks with one t
        for members, sub in [*[(list(range(d * tp, (d + 1) * tp)), tpg)
                               for d in range(size // tp)],
                             *[(list(range(t, size, tp)), dp) for t in range(tp)]]:
            host = dist.new_group(members, backend="gloo")
            card = dist.new_group(members, backend="nccl") if backend == "nccl" else host
            if rank in members:
                sub.host, sub.device = host, card
    _GROUP = _Group(rank, size, device, backend, device_group, dp, tpg)
    grid = f", dp {dp.rank} of {dp.size} x tp {tpg.rank} of {tp}" if tp > 1 else ""
    print(f"[parallel] process {rank} of {size} on {device}: {backend} ({why}){grid}",
          flush=True)
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


def dp_index() -> int:
    """This process's index d in its dp group (rank = d·T + t): the slice of
    every global batch it takes."""
    return 0 if _GROUP is None else _GROUP.dp.rank


def dp_count() -> int:
    """The processes over which the batch is split: N / T."""
    return 1 if _GROUP is None else _GROUP.dp.size


def tp_index() -> int:
    """This process's index t in its tp group: its out-channel slice."""
    return 0 if _GROUP is None else _GROUP.tp.rank


def tp_count() -> int:
    """The tensor-parallel width T (1 without a group)."""
    return 1 if _GROUP is None else _GROUP.tp.size


def backend() -> Optional[str]:
    """The backend of the tensors on the card, or None without a group."""
    return None if _GROUP is None else _GROUP.backend


def global_count(local: int) -> int:
    """The global batch's count of a per-process count (equal slices over
    the dp group)."""
    return local * dp_count()


def _group_of(t: torch.Tensor, sub: Optional[_Sub] = None):
    sub = _GROUP.dp if sub is None else sub
    return sub.device if t.is_cuda else sub.host


def _count(kind: str, t: torch.Tensor) -> None:
    collectives[kind] += 1
    collective_bytes[kind] += t.numel() * t.element_size()


def _gather(t: torch.Tensor, sub: _Sub) -> torch.Tensor:
    """Every member's ``t`` of the group ``sub`` stacked along a new dim 0 in
    rank order, (size, ...). NCCL gathers into one tensor; gloo gathers host
    tensors, and a card's tensor as a sum of zero-filled buffers in which
    each process wrote its part (gloo sums tensors on the card but does not
    gather them), which adds only zeros, so the parts keep their bits."""
    t = t.contiguous()
    if t.is_cuda and _GROUP.backend == "nccl":
        out = t.new_empty((sub.size,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t, group=sub.device)
        return out
    if t.is_cuda:
        out = t.new_zeros((sub.size,) + tuple(t.shape))
        out[sub.rank] = t
        dist.all_reduce(out, group=sub.device)
        return out
    parts = [torch.empty_like(t) for _ in range(sub.size)]
    dist.all_gather(parts, t, group=sub.host)
    return torch.stack(parts)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every dp peer's ``t`` (rows, ...) stacked along dim 0 in rank order,
    (N/T·rows, ...); ``t`` itself without a group. Every process must pass
    the same shape."""
    if _GROUP is None:
        return t
    _count("gather", t)
    return _gather(t, _GROUP.dp).flatten(0, 1)


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
    """The sum of every dp peer's ``t``, differentiable (twice: a gradient
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
    over the N/T dp peers, this process's share of it (the trainer's
    average over the dp group then gives the global batch's gradient); ``t``
    without a group."""
    return t if _GROUP is None else t / _GROUP.dp.size


def average_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every process's tensors averaged over its dp group, in one
    all-reduce of one flat f32 bucket (the tensors are f32); the tensors
    themselves without a group."""
    tensors = list(tensors)
    if _GROUP is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _count("average", flat)
    dist.all_reduce(flat, group=_group_of(flat))
    flat.div_(_GROUP.dp.size)
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
    n, k = _GROUP.dp.size, segments
    full = draw((shape[0] * n,) + shape[1:])
    return full.view((k, n, shape[0] // k) + shape[1:])[:, _GROUP.dp.rank].reshape(shape)


def shard_full_batch(batch):
    """This process's rows of a batch every process holds whole (seeded
    samplers, full local datasets): rows [d·B/D, (d+1)·B/D) of its dp index
    d of D (tp peers take the same rows); the batch itself without a group.
    B must divide over the dp group."""
    if _GROUP is None:
        return batch
    d, n = _GROUP.dp.rank, _GROUP.dp.size
    per, rem = divmod(len(batch), n)
    if rem:
        raise ValueError(f"a batch of {len(batch)} does not divide over {n} processes")
    return batch[d * per:(d + 1) * per]


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
            dist.broadcast(t.data, src, group=_GROUP.device_group if t.is_cuda else None)


def barrier() -> None:
    """Wait for every process (over the host group); nothing without one."""
    if _GROUP is not None:
        dist.barrier()


# --- tensor parallelism: the tp group's collectives ------------------------------
#
# Every tp peer holds the same rows and computes the same loss; each owns one
# out-channel slice of a FourierUnit's mix. The four Functions are the
# conjugate pairs of that layout (each one's backward is the other), so a
# gradient of a gradient (the penalty of wgan-gp) goes through them too:
# copy (identity; its backward sums the peers' partial cotangents) against
# sum, and gather (the slices concatenated; its backward takes the peer's
# own slice of the cotangent, which every peer holds whole) against split.
# A sum is the gather followed by an addition in rank order, so every peer
# holds the same bits. Without a group, or at T = 1, each is the identity
# or the tensor itself.


def _tp_parts(t: torch.Tensor, kind: str) -> torch.Tensor:
    _count(kind, t)
    return _gather(t, _GROUP.tp)


def _tp_sum(t: torch.Tensor) -> torch.Tensor:
    parts = _tp_parts(t, "tp_sum")
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _tp_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(list(_tp_parts(t, "tp_gather").unbind(0)), dim=dim)


def _tp_split(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.chunk(_GROUP.tp.size, dim=dim)[_GROUP.tp.rank].contiguous()


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _TpSum.apply(g)


class _TpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _tp_sum(t)

    @staticmethod
    def backward(ctx, g):
        return _TpCopy.apply(g)


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim = dim
        return _tp_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return _TpSplit.apply(g, ctx.dim), None


class _TpSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim = dim
        return _tp_split(t, dim)

    @staticmethod
    def backward(ctx, g):
        return _TpGather.apply(g.contiguous(), ctx.dim), None


def _tp_on() -> bool:
    return _GROUP is not None and _GROUP.tp.size > 1


def tp_copy(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient is the sum over the tp group of the peers'
    partial gradients (the input of an out-channel slice)."""
    return _TpCopy.apply(t) if _tp_on() else t


def tp_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The tp peers' ``t`` concatenated along ``dim`` in rank order; its
    gradient is this peer's slice of the cotangent."""
    return _TpGather.apply(t.contiguous(), dim) if _tp_on() else t


def tp_split_channels(v: torch.Tensor) -> torch.Tensor:
    """This peer's out-channel slice of a [re; im] vector or stack of them
    (..., 2C) -> (..., 2C/T): the entries ``ops.fourier_unit.out_columns``
    names, differentiably."""
    if not _tp_on():
        return v
    lead = v.shape[:-1]
    return _TpSplit.apply(v.reshape(*lead, 2, v.shape[-1] // 2), -1).reshape(*lead, -1)


def tp_gather_channels(v: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`tp_split_channels`: the peers' (..., 2C/T)
    slices -> (..., 2C), differentiably; a (2C, 2C/T) mix slice gives the
    whole (2C, 2C) mix."""
    if not _tp_on():
        return v
    lead = v.shape[:-1]
    return tp_gather(v.reshape(*lead, 2, v.shape[-1] // 2), -1).reshape(*lead, -1)
