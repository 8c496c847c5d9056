"""Dataset and loader factories: the JAX package's ``data/loader.py``
(reference data/__init__.py:7-61).

The loaders yield numpy batches ``(B, T, H, W, 3)`` (float32, or uint8
from the packed dataset's ``output_uint8``); the model moves them to the
device (``parallel/dist.py:frames_to_device``). The batch order is the JAX
loader's: indices shuffled by ``np.random.default_rng(seed + epoch)``, or a
sampler's. A training rank takes ``batch_size // world_size`` clips and
drops the last short batch. ``torch.utils.data`` is not used.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .datasets import (LQGTVIDAugDataset, LQGTVIDBicubicDataset, LQGTVIDConsecutiveDataset,
                       LQGTVIDDataset, LQGTVIDSRDataset)


def create_dataset(dataset_opt):
    mode = dataset_opt["mode"]
    if mode == "LQGTVID":
        return LQGTVIDDataset(dataset_opt)
    if mode == "LQGTVID_Aug":
        return LQGTVIDAugDataset(dataset_opt)
    if mode == "LQGTVID_packed":
        from .packed import LQGTVIDPackedDataset

        return LQGTVIDPackedDataset(dataset_opt)
    if mode in ("LQGTVID_Conseutive", "LQGTVID_Consecutive"):
        return LQGTVIDConsecutiveDataset(dataset_opt)
    if mode == "LQGTVID_SR":
        return LQGTVIDSRDataset(dataset_opt)
    if mode == "LQGTVID_bicubic":
        return LQGTVIDBicubicDataset(dataset_opt)
    if mode == "UVG":
        from .uvg_dataset import UVGDataset

        return UVGDataset(dataset_opt)
    if mode in ("LQ", "LQGT", "LRHR_seg_bg"):
        from .image_datasets import LQDataset, LQGTDataset, LRHRSegBGDataset

        return {"LQ": LQDataset, "LQGT": LQGTDataset, "LRHR_seg_bg": LRHRSegBGDataset}[mode](dataset_opt)
    raise NotImplementedError(f"dataset mode {mode!r} not recognized")


def _collate(items):
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray) else vals
    return out


class DataLoader:
    """A prefetching loader: batches, optional shuffling or sampler,
    drop_last for training. One thread pool for the loader's lifetime and
    at most ``2 * num_workers`` batches in flight, each dropped as soon as
    it is handed on (a pool a epoch, or every batch's future kept to the
    epoch's end, grew the JAX run's host memory until it was killed)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, sampler=None, num_workers=4,
                 drop_last=False, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed
        self._pool = None

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(idx)
        return idx.tolist()

    def _batches(self):
        self._epoch += 1
        if hasattr(self.dataset, "epoch"):   # the key of a seeded item's draws
            self.dataset.epoch = self._epoch
        indices = self._indices()
        batches = [indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        batches = self._batches()
        q: queue.Queue = queue.Queue(maxsize=2 * self.num_workers)
        stop = threading.Event()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.num_workers)
        pool = self._pool

        def produce():
            inflight: deque = deque()
            it = iter(batches)

            def submit_next():
                b = next(it, None)
                if b is not None:
                    try:
                        inflight.append(pool.submit(lambda b=b: _collate([self.dataset[i] for i in b])))
                    except RuntimeError:
                        # the pool is shutting down (the trainer is exiting): stop producing
                        stop.set()

            for _ in range(2 * self.num_workers):
                submit_next()
            while inflight:
                if stop.is_set():
                    break
                f = inflight.popleft()
                try:
                    item = f.result()
                except Exception as e:  # handed to the consumer, which raises it
                    item = e
                del f
                q.put(item)
                submit_next()
            for f in inflight:
                f.cancel()
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer parked on a full queue (an early exit)
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def close(self):
        """Shut the worker pool down."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


def _proc_worker_main(dataset, task_q, res_q, seed):
    """The loop of a ``ProcessDataLoader`` worker (module-level for spawn)."""
    import random as _random

    r = getattr(dataset, "rng", None)
    if isinstance(r, _random.Random):
        r.seed(seed)
    if getattr(dataset, "np_rng", None) is not None:
        dataset.np_rng = np.random.default_rng(seed)
    while True:
        task = task_q.get()
        if task is None:
            break
        gen, epoch, bi, batch_idx = task
        if hasattr(dataset, "epoch"):
            dataset.epoch = epoch
        try:
            res_q.put((gen, bi, _collate([dataset[i] for i in batch_idx])))
        except Exception as e:  # handed to the consumer, which raises it
            res_q.put((gen, bi, e))


class ProcessDataLoader(DataLoader):
    """Decode and augmentation in spawned worker processes (started once,
    kept across epochs), batches put back in index order. Results carry an
    epoch tag so batches left in flight by an early exit are dropped, not
    replayed."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._procs = None
        self._task_q = None
        self._res_q = None
        self._gen = 0

    def _ensure_workers(self):
        import multiprocessing as mp

        if self._procs is not None and all(p.is_alive() for p in self._procs):
            return
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._res_q = ctx.Queue(maxsize=4 * self.num_workers)
        self._procs = [
            ctx.Process(target=_proc_worker_main,
                        args=(self.dataset, self._task_q, self._res_q,
                              self._seed + 977 * self._epoch + w),
                        daemon=True)
            for w in range(self.num_workers)]
        for p in self._procs:
            p.start()

    def __iter__(self):
        batches = self._batches()
        if not batches:
            return
        self._ensure_workers()
        self._gen += 1
        gen = self._gen
        for bi, b in enumerate(batches):
            self._task_q.put((gen, self._epoch, bi, b))
        try:
            pending = {}
            nxt = 0
            while nxt < len(batches):
                rgen, bi, item = self._res_q.get()
                if rgen != gen:  # in-flight leftover of an early exit
                    continue
                pending[bi] = item
                while nxt in pending:
                    out = pending.pop(nxt)
                    nxt += 1
                    if isinstance(out, Exception):
                        raise out
                    yield out
        finally:
            # an early exit: tasks not started must not take worker time
            try:
                while True:
                    self._task_q.get_nowait()
            except (queue.Empty, OSError, ValueError):
                pass

    def close(self):
        """Stop the workers: the result queue is drained while each is
        joined, and a worker still alive after 5 s is terminated."""
        if not self._procs:
            return
        for _ in self._procs:
            self._task_q.put(None)
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            while p.is_alive() and time.monotonic() < deadline:
                try:
                    self._res_q.get(timeout=0.1)
                except queue.Empty:
                    pass
                p.join(timeout=0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = None


def create_dataloader(dataset, dataset_opt, opt=None, sampler=None):
    phase = dataset_opt["phase"]
    cls = ProcessDataLoader if dataset_opt.get("use_process_loader") else DataLoader
    if phase == "train":
        world_size = (opt or {}).get("world_size") or 1
        num_workers = (dataset_opt["n_workers"] or 2) * len(dataset_opt.get("gpu_ids") or [1])
        batch_size = (dataset_opt["batch_size"] or 1) // world_size
        shuffle = sampler is None and bool(dataset_opt["use_shuffle"])
        return cls(dataset, batch_size=batch_size, shuffle=shuffle, sampler=sampler,
                   num_workers=num_workers, drop_last=True)
    return cls(dataset, batch_size=dataset_opt["batch_size"] or 1, shuffle=False, num_workers=8)
