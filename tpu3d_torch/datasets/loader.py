"""Prefetching host-side batch loader (replaces torch DataLoader workers),
and the staging of its batches onto the card.

The port's copy of ``tpu3d/datasets/loader.py``'s ``BatchLoader``, held equal
to it batch for batch by ``tests/test_torch_data.py``; ``device_prefetch``
stages through pinned memory and a side CUDA stream instead of
``jax.device_put``.

Samples are built by a worker pool while the previous batch trains on device;
batches are fixed-shape numpy dicts ready for a single host->device transfer.

Two worker modes (reference: torch DataLoader num_workers,
pointrcnn/tools/train_rcnn.py:79-90):
- "thread" (default): a ThreadPoolExecutor. Sample building is numpy-heavy
  and releases the GIL in spurts, but the python glue serializes — one core
  of sample building at best — and always safe.
- "process": a fork-based pool; children inherit the dataset through fork
  (no pickling) and return built samples over pipes. Scales with host
  cores. The pool forks EAGERLY in __init__ (main thread,
  loader-construction time) so the fork happens before the parent's first
  CUDA call — the CLIs create their loaders before the model — and never
  from the producer thread; the children build samples with numpy alone
  and never touch the card.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device

# fork-inherited dataset handle for process workers (set in the parent right
# before the pool forks; children read it by index)
_FORK_DATASET = None


def _fork_get(args):
    """(idx, epoch) -> sample; the epoch rides along with every work item so
    forked children stay in sync with parent set_epoch calls."""
    idx, epoch = args
    if getattr(_FORK_DATASET, "epoch", epoch) != epoch:
        _FORK_DATASET.epoch = epoch
    return _FORK_DATASET[idx]


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False, seed: int = 0,
                 prefetch: int = 2, worker_mode: str = "thread"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        self.epoch = 0
        self._pool = None
        if worker_mode == "process":
            # fork NOW, from the caller's (main) thread, before the model /
            # CUDA context exists — forking later from the producer thread
            # would inherit live runtime threads and locks into children
            self._process_pool()

    def _process_pool(self):
        """Fork the worker pool once (kept across epochs)."""
        if self._pool is None:
            global _FORK_DATASET
            _FORK_DATASET = self.dataset
            ctx = multiprocessing.get_context("fork")
            self._pool = ctx.Pool(self.num_workers)
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        for i in range(0, len(order), self.batch_size):
            idx = order[i: i + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            # pad the final short batch by repeating (fixed device shapes);
            # callers can mask via 'batch_valid'
            valid = np.ones(self.batch_size, dtype=bool)
            if len(idx) < self.batch_size:
                valid[len(idx):] = False
                idx = np.concatenate(
                    [idx, np.full(self.batch_size - len(idx), idx[-1])])
            yield idx, valid

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            tpool = None
            try:
                if self.worker_mode == "process":
                    pool = self._process_pool()
                    map_fn = lambda idx: pool.map(
                        _fork_get, [(int(i), self.epoch) for i in idx])
                else:
                    tpool = ThreadPoolExecutor(self.num_workers)
                    map_fn = lambda idx: list(
                        tpool.map(self.dataset.__getitem__, idx))
                for idx, valid in self._batches():
                    batch = self.dataset.collate_batch(map_fn(idx))
                    batch["batch_valid"] = valid
                    q.put(batch)
                q.put(sentinel)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                if tpool is not None:
                    tpool.shutdown(wait=False)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def device_prefetch(iterable, size: int = 2, keys=None, device="cuda"):
    """Background-thread host->device staging for loader batches.

    Pulls batches from ``iterable`` on a producer thread and stages each one
    onto ``device`` (default ``cuda``; raises without a card unless the
    caller passes ``device="cpu"``):

    - on the card, each array is pinned (``pin_memory``) and copied with
      ``non_blocking=True`` on a side CUDA stream, and an event is recorded
      on that stream after the batch's last copy. When the consumer takes
      the batch, its stream waits on that event (the batch's part of the
      side stream's work), and every tensor is ``record_stream``-ed onto
      it, so the step never reads a buffer before its copy ends and the
      caching allocator does not reuse a buffer while the step still reads
      it. The copies overlap the previous step;
    - on the CPU the staging is ``torch.from_numpy`` and nothing else.

    The reference's torch loop gets the same overlap from DataLoader
    workers + non_blocking CUDA copies
    (tools/train_utils/train_utils.py:170-240).

    :param iterable: yields dict-of-numpy batches (e.g. a BatchLoader)
    :param size: bounded queue depth (batches in flight beyond the one
        being consumed); 2 is enough to hide one transfer behind one step
    :param keys: optional key subset to keep (drops non-array entries like
        sample ids that cannot be staged)
    :param device: where the batches go
    """
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        if side is None:
            return {k: torch.from_numpy(v) for k, v in batch.items()}, None
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(v).pin_memory().to(
                dev, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()

    def produce():
        try:
            for batch in iterable:
                if keys is not None:
                    batch = {k: batch[k] for k in keys if k in batch}
                q.put(put(batch))
            q.put(sentinel)
        except BaseException as e:  # surface producer errors to the consumer
            q.put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        if isinstance(item, BaseException):
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            for v in batch.values():
                v.record_stream(stream)
        yield batch
