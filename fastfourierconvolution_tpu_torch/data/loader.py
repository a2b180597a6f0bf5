"""Batch loading, the JAX package's ``data/loader.py``: shuffling,
normalisation to [-1, 1], background prefetch.

  * epoch permutation with a seeded numpy RNG, the same draws as the JAX
    loader's, so the same seed yields the same batches and resuming with
    ``skip_batches`` continues a run's data order exactly;
  * whole batches gathered as one ndarray: uint8 with ``raw_uint8`` (the
    training CLI normalises on the device), else normalised on the host:
    an in-memory store through the native batcher (``native.py``,
    ``x * float32(1/127.5) - 1`` on C++ threads, one per 4 MiB of the
    batch: ``native.loader_threads``) where it loads, as the JAX loader
    does, and otherwise with numpy, ``x/127.5 - 1`` in f32;
  * a background thread keeps ``prefetch`` batches in flight;
  * infinite iteration over epochs (``epochs``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from . import native


def normalize_to_unit(x: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1]."""
    return x.astype(np.float32) / 127.5 - 1.0


class DataLoader:
    """Minimal epoch-shuffled batch loader over a __len__/__getitem__
    dataset, yielding (images f32 [-1,1] NHWC, labels i64)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        raw_uint8: bool = False,
        decode_threads: Optional[int] = None,
    ):
        """``batch_size`` is the GLOBAL batch. With ``process_count > 1``
        every process draws the same seeded epoch permutation and yields
        only its ``batch_size / process_count`` slice of each global
        batch.

        ``decode_threads``: per-item datasets (file/tar readers that
        decode lazily) are gathered through a thread pool (PIL's decode
        releases the interpreter lock). Default (None): 8 threads when
        the dataset has no contiguous in-memory store, 0 (serial)
        otherwise."""
        if batch_size % max(process_count, 1):
            raise ValueError(f"the global batch ({batch_size}) must divide evenly across "
                             f"{process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self.raw_uint8 = raw_uint8
        self.local_batch = batch_size // self.process_count
        in_memory = hasattr(dataset, "images") and hasattr(dataset, "labels")
        if decode_threads is None:
            decode_threads = 0 if in_memory else 8
        self.decode_threads = decode_threads
        self._pool = None  # created lazily (keeps pickling/fork simple)
        self._start_batch = 0

    def _items(self, idx: np.ndarray):
        """Gather dataset items, decoding through the thread pool when
        enabled."""
        ds = self.dataset
        if self.decode_threads > 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self.decode_threads,
                    thread_name_prefix="ffc-decode",
                )
            return list(self._pool.map(lambda i: ds[int(i)], idx))
        return [ds[int(i)] for i in idx]

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def _gather(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        # raw mode: ship uint8 and let the device normalise, 4x less
        # host->device traffic (x/127.5 - 1 is the same f32 op either side)
        ds = self.dataset
        in_memory = hasattr(ds, "images") and hasattr(ds, "labels")
        if in_memory and not self.raw_uint8:
            batch_bytes = len(idx) * int(np.prod(ds.images.shape[1:])) * 4
            out = native.gather_normalize(ds.images, idx,
                                          n_threads=native.loader_threads(batch_bytes))
            if out is not None:
                return out, np.asarray(ds.labels)[idx]
        if in_memory:
            imgs, labels = np.ascontiguousarray(ds.images[idx]), np.asarray(ds.labels)[idx]
        else:
            items, labels = zip(*self._items(idx))
            imgs, labels = np.stack(items), np.asarray(labels, np.int64)
        return (imgs if self.raw_uint8 else normalize_to_unit(imgs)), labels

    def skip_batches(self, n: int) -> None:
        """Fast-forward the epoch-permutation stream by ``n`` global
        batches WITHOUT gathering any data — the resume path: a
        restored run replays the seeded shuffles (cheap rng work only)
        so the post-resume data order matches an uninterrupted run
        exactly. Call before iteration starts."""
        if n < 0:
            raise ValueError(f"cannot skip {n} batches")
        self._start_batch = int(n)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._epoch_order()
        n_full = len(order) // self.batch_size
        has_partial = (
            not self.drop_last
            and self.process_count == 1
            and n_full * self.batch_size < len(order)
        )
        # resume fast-forward: whole skipped epochs advance the seeded
        # rng by one shuffle each; the remainder offsets into this
        # epoch's order
        skip = 0
        if self._start_batch:
            per_epoch = n_full + (1 if has_partial else 0)
            skip = self._start_batch
            self._start_batch = 0
            while skip >= per_epoch:
                skip -= per_epoch
                order = self._epoch_order()
            n_full_new = len(order) // self.batch_size
            assert n_full_new == n_full  # dataset size is fixed
        ends = n_full * self.batch_size
        lo = self.process_index * self.local_batch
        hi = lo + self.local_batch
        for i in range(skip * self.batch_size, ends, self.batch_size):
            yield self._gather(order[i + lo : i + hi])
        if not self.drop_last and ends < len(order):
            if self.process_count > 1:
                # a partial global batch cannot be split evenly across
                # hosts (some would get empty/short slices and desync
                # the pod) — drop it, like drop_last
                return
            yield self._gather(order[ends:])

    def epochs(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite batch stream with background prefetch: a thread named
        ``ffc-prefetch`` keeps up to ``prefetch`` batches ready.

        The producer uses a timed ``put`` so that when the consumer goes
        away (``stop`` set from the ``finally``) it can never stay
        blocked on a full queue; closing the generator stops and joins
        the thread. An exception in the producer (a dataset that fails to
        read) is raised to the consumer.
        """
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failed = []
        # bind locally: at interpreter shutdown the module global
        # ``queue`` may already be cleared when the producer still spins
        full_exc = queue.Full

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except full_exc:
                    continue
            return False

        def produce():
            try:
                while not stop.is_set():
                    for batch in self:
                        if not put(batch):
                            return
            except Exception as e:  # noqa: BLE001 - raised again by the consumer
                failed.append(e)
                put(_FAILED)

        t = threading.Thread(target=produce, name="ffc-prefetch", daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is _FAILED:
                    raise RuntimeError("the data loader's prefetch thread failed") from failed[0]
                yield batch
        finally:
            stop.set()
            # drain so the producer's in-flight put can complete, then
            # join. The broad except covers interpreter-shutdown
            # finalization, where queue/thread internals misbehave,
            # but an operator interrupt (KeyboardInterrupt/SystemExit)
            # raised mid-drain must still propagate once the stop event
            # is set.
            try:
                while True:
                    q.get_nowait()
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException:  # noqa: BLE001 - shutdown-time safety
                pass
            try:
                t.join(timeout=2.0)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException:  # noqa: BLE001 - shutdown-time safety
                pass


# what the prefetch thread puts on its queue when it fails
_FAILED = object()
