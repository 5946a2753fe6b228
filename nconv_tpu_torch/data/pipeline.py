"""Batching and the device feed.

:func:`collate` and :class:`Loader` are the JAX package's
(``nconv_tpu/data/pipeline.py``): deterministic shuffling, optional thread
pool decode with readahead. :func:`prefetch_to_device` takes the place of
its JAX prefetcher: batches are pinned and copied host-to-device on a side
stream ``depth`` batches ahead, so the copies overlap the current step.
"""
from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    """Stack sample dicts into batched arrays (keys present in all)."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in sorted(keys)}


class Loader:
    """Indexable-dataset batch loader.

    ``for batch in Loader(ds, 4, shuffle=True, seed=epoch): ...``
    Re-iterating reshuffles (seed advances per pass). ``num_workers`` > 0
    decodes samples through a thread pool with readahead.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0, readahead: int = 4,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.readahead = readahead
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> list[list[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size].tolist() for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self._epoch += 1
        if self.num_workers <= 0:
            for b in batches:
                yield collate([self.dataset[i] for i in b])
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            ahead = max(1, self.readahead)
            submit = lambda b: [pool.submit(self.dataset.__getitem__, i) for i in b]
            futures = [submit(b) for b in batches[:ahead]]
            for j in range(len(batches)):
                if j + ahead < len(batches):
                    futures.append(submit(batches[j + ahead]))
                yield collate([f.result() for f in futures[j]])


def to_tensors(batch: dict) -> dict[str, torch.Tensor]:
    """The array entries of a batch as CPU tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()
            if hasattr(v, "shape")}


def prefetch_to_device(iterable: Iterable[dict], device: torch.device | str,
                       depth: int = 2) -> Iterator[dict[str, torch.Tensor]]:
    """Yield the batches of ``iterable`` as tensors on ``device``. On a CUDA
    device each batch is pinned and copied on a side stream ``depth``
    batches ahead; a yielded batch is ready on the current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterable:
            yield {k: t.to(device) for k, t in to_tensors(batch).items()}
        return
    side = torch.cuda.Stream(device)

    def stage(batch):
        host = {k: t.pin_memory() for k, t in to_tensors(batch).items()}
        with torch.cuda.stream(side):
            staged = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        return staged, done

    it = iter(iterable)
    queue = collections.deque(stage(b) for b in itertools.islice(it, depth))
    while queue:
        staged, done = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in staged.values():
            t.record_stream(current)
        nxt = next(it, None)
        if nxt is not None:
            queue.append(stage(nxt))
        yield staged
