"""Data parallelism over ``torch.distributed`` (``mesh.py``)."""

from .mesh import (  # noqa: F401
    active,
    all_equal,
    all_gather_rows,
    average_,
    backend,
    barrier,
    batch_moments,
    broadcast_module_,
    global_count,
    global_draw,
    initialize,
    launch_env,
    mp_and,
    param_share,
    process_count,
    process_index,
    shard_full_batch,
    shutdown,
    sum_over_processes,
)
