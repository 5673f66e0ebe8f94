"""Host-side batch loader feeding the device-resident training steps.

The port's copy of the JAX package's ``data/loader.py``:

- ``DataLoader`` stacks numpy batches, in the sampler's order or a seeded
  shuffle, with ``drop_last`` for static shapes; ``iter_raw()`` bypasses
  the dataset's per-item transform and yields raw uint8 NHWC batches (the
  hot path: augmentation runs batched on the device); ``num_workers > 0``
  decodes in a background thread, ``num_workers + 1`` batches ahead.
- ``prefetch_to_device`` moves batches to the device ``size`` ahead of
  their use.  On a GPU each batch is copied into pinned host memory and
  sent with a non-blocking copy on a stream of its own, so the copy of
  batch N+1 runs under the compute of batch N; the compute stream waits on
  an event recorded after each batch's copy.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import Subset


def _unwrap_raw(dataset, idx: int):
    """Fetch the *untransformed* sample, unwrapping Subset views."""
    while isinstance(dataset, Subset):
        idx = dataset.indices[idx]
        dataset = dataset.dataset
    if hasattr(dataset, "load_raw"):
        return dataset.load_raw(idx)
    return dataset[idx]


def _stack(samples):
    """Stack a list of samples (arrays or tuples of arrays) into batch arrays."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


class DataLoader:
    """Minimal batching iterator over a dataset.

    Args:
        dataset: anything with ``__len__``/``__getitem__`` (DroneDataset,
            Subset, or a dataset with ``load_raw``).
        batch_size: samples per batch.
        shuffle: reshuffle order each epoch (ignored when ``sampler`` given).
        sampler: optional index sampler (e.g. ``WeightedRandomSampler``).
        drop_last: drop the trailing partial batch (keeps shapes static).
        num_workers: >0 enables background prefetching of ``num_workers + 1``
            batches (thread-based; decode releases the GIL).
        seed: shuffle seed.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        sampler=None,
        drop_last: bool = False,
        num_workers: int = 0,
        seed: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.sampler = sampler
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    # ------------------------------------------------------------------
    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = self._rng.permutation(idx)
        return idx.tolist()

    def _batched_indices(self):
        idx = self._indices()
        nb = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)
        for b in range(nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if chunk:
                yield chunk

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # ------------------------------------------------------------------
    def _iter_batches(self, fetch) -> Iterator:
        self._epoch += 1
        batches = self._batched_indices()
        if self.num_workers <= 0:
            for chunk in batches:
                yield _stack([fetch(self.dataset, i) for i in chunk])
            return

        q: queue.Queue = queue.Queue(maxsize=self.num_workers + 1)
        _SENTINEL = object()
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone, so an
            abandoned iterator does not leave its producer thread blocked."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for chunk in batches:
                    if not _put(_stack([fetch(self.dataset, i) for i in chunk])):
                        return
                _put(_SENTINEL)
            except BaseException as e:  # surface decode errors to the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # runs on normal exhaustion AND GeneratorExit (abandonment)
            stop.set()

    def __iter__(self):
        """Yield batches with the dataset's transform applied."""
        return self._iter_batches(lambda ds, i: ds[i])

    def iter_raw(self):
        """Yield raw uint8 batches, transform bypassed (device-augment hot path)."""
        return self._iter_batches(_unwrap_raw)


def prefetch_to_device(iterator, device, size: int = 2, cast_masks_uint8: bool = True):
    """Yield the host batches of ``iterator`` as tensors on ``device``,
    copied ``size`` batches ahead of their use.

    A batch is an array or a tuple of arrays (``None`` entries pass
    through).  Integer arrays (masks) are sent as uint8 when the first
    batch's values lie in [0, 256) -- 4x fewer bytes over the host link;
    the steps widen them on the device -- and every later narrowed batch
    is checked: a value outside [0, 256) raises ValueError instead of
    wrapping into a valid label.

    On a GPU: each array is copied into pinned host memory (PyTorch's
    caching host allocator hands a pinned block out again only after the
    copies recorded on it have finished), then sent with a non-blocking
    copy on a side stream; the device tensors are yielded after the
    current (compute) stream has been made to wait on an event recorded
    behind the copy, and are marked as used by that stream.  On the CPU the
    arrays are wrapped as tensors.
    """
    device = torch.device(device)
    narrow: dict = {}

    def host(pos, a):
        a = np.asarray(a)
        if cast_masks_uint8 and a.dtype in (np.int32, np.int64):
            in_range = bool(a.size and a.min() >= 0 and a.max() < 256)
            if pos not in narrow:
                narrow[pos] = in_range
            if narrow[pos]:
                if not in_range:
                    raise ValueError(
                        "mask batch has values outside [0, 256) after "
                        "uint8 narrowing was enabled from the first "
                        "batch; pass cast_masks_uint8=False or fix the "
                        "dataset's label range")
                a = a.astype(np.uint8)
        return np.ascontiguousarray(a)

    def as_tuple(item):
        return (item, False) if isinstance(item, tuple) else ((item,), True)

    if device.type == "cuda":
        copy_stream = torch.cuda.Stream(device)

        def ship(item):
            arrays, single = as_tuple(item)
            pinned = [None if a is None else torch.from_numpy(host(i, a)).pin_memory()
                      for i, a in enumerate(arrays)]
            with torch.cuda.stream(copy_stream):
                out = [None if p is None else p.to(device, non_blocking=True)
                       for p in pinned]
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, single, done, pinned

        def release(entry):
            out, single, done, _pinned = entry
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for t in out:
                if t is not None:
                    t.record_stream(compute)
            return out[0] if single else tuple(out)
    else:
        def ship(item):
            arrays, single = as_tuple(item)
            out = [None if a is None else torch.from_numpy(host(i, a)).to(device)
                   for i, a in enumerate(arrays)]
            return out[0] if single else tuple(out)

        def release(entry):
            return entry

    pending = collections.deque()
    it = iter(iterator)
    for item in it:
        pending.append(ship(item))
        if len(pending) >= size:
            yield release(pending.popleft())
    while pending:
        yield release(pending.popleft())
