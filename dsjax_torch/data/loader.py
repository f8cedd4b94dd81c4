"""Data pipeline: threaded prefetch of collated batches, and a prefetcher
that copies batches to the device ahead of the step.

A copy of dsjax/data/loader.py for one process (no shard quantum). It
replaces the reference's torch DataLoader + worker
processes (loader/data_loader.py:273-279): a small thread pool parses
samples (numpy and the FFT release the GIL), batches are collated to
bucketed shapes and prefetched ahead of the training step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dsjax_torch.data.dataset import Batch, SpectrogramDataset, collate, collate_audio
from dsjax_torch.data.sampler import BucketBatchSampler
from dsjax_torch.trace import span


class DataPipeline:
    def __init__(self, dataset: SpectrogramDataset, sampler: BucketBatchSampler,
                 bucket_frames: int = 64, bucket_labels: int = 64,
                 num_workers: int = 2, prefetch: int = 2,
                 pad_to_batch: Optional[int] = None,
                 ragged_split: int = 1):
        self.dataset = dataset
        self.sampler = sampler
        self.bucket_frames = bucket_frames
        self.bucket_labels = bucket_labels
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.pad_to_batch = pad_to_batch
        # >1: emit each batch as that many length-quantile sub-batches
        # (a list) — the trainer sums their grads into ONE optimizer step
        # (DataConfig.ragged_split); each block pads to its own max
        self.ragged_split = max(1, ragged_split)

    def __len__(self) -> int:
        return len(self.sampler)

    def _collate(self, samples, pad_to):
        if getattr(self.dataset, "device_features", False):
            return collate_audio(samples, self.dataset.extractor.hop, self.bucket_frames,
                                 self.bucket_labels, pad_to)
        return collate(samples, self.bucket_frames, self.bucket_labels, pad_to)

    def _load_batch(self, indices):
        samples = [self.dataset[i] for i in indices]
        k = self.ragged_split
        if k <= 1 or len(samples) < 2 * k:
            return self._collate(samples, self.pad_to_batch)
        # sort once (collate would anyway), then contiguous length blocks
        key = ((lambda s: s[1]) if getattr(self.dataset, "device_features", False)
               else (lambda s: s[0].shape[1]))
        samples = sorted(samples, key=key, reverse=True)
        sub = -(-len(samples) // k)
        pad_to = None if self.pad_to_batch is None else -(-self.pad_to_batch // k)
        return [self._collate(samples[i:i + sub], pad_to)
                for i in range(0, len(samples), sub)]

    def __iter__(self) -> Iterator[Batch]:
        batch_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    from collections import deque

                    window: deque = deque()
                    it = iter(self.sampler)
                    # keep a bounded window of in-flight batch loads
                    depth = self.num_workers + self.prefetch
                    for idx in it:
                        window.append(pool.submit(self._load_batch, idx))
                        if len(window) >= depth:
                            batch_queue.put(window.popleft().result())
                    while window:
                        batch_queue.put(window.popleft().result())
            except BaseException as e:  # propagate into consumer
                batch_queue.put(e)
            finally:
                batch_queue.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = batch_queue.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


class Staged(NamedTuple):
    """Host arrays copied to the device; ``ready`` is the event that ends
    their copy on a side stream (None when no copy is in flight)."""
    tensors: Tuple[torch.Tensor, ...]
    ready: Optional[torch.cuda.Event]

    def wait(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The tensors, safe to use on the device's current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.ready)
            for t in self.tensors:
                t.record_stream(stream)
        return self.tensors


def stage(arrays: Sequence[np.ndarray], device: torch.device,
          copy_stream: Optional[torch.cuda.Stream] = None) -> Staged:
    """Copy host arrays to ``device``. With a CUDA ``copy_stream`` the arrays
    are pinned and copied without blocking on that stream, so a
    DevicePrefetcher thread can stage a batch ahead of its use."""
    with span("data.stage"):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if copy_stream is None:
            return Staged(tuple(t.to(device) for t in host), None)
        with torch.cuda.stream(copy_stream):
            tensors = tuple(t.pin_memory().to(device, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return Staged(tensors, ready)


class DevicePrefetcher:
    """Overlap the host-to-device copy with device compute.

    Wraps a batch iterable: a background thread runs ``put_fn(batch)``
    (``Trainer.put_batch`` or evaluate's staging, both through ``stage``:
    pinned host memory, copies issued on a side stream) up to ``depth``
    batches ahead, so the copy of batch i+1 rides
    under the device step on batch i. Yields ``(batch, staged)`` pairs;
    ``staged`` is None for list-valued items (ragged_split sub-batch lists
    go through the accumulation path, which stages per sub-batch).
    """

    def __init__(self, iterable, put_fn, depth: int = 2):
        self.iterable = iterable
        self.put_fn = put_fn
        self.depth = max(1, depth)
        self._stop = False

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()

        def producer():
            try:
                for batch in self.iterable:
                    if self._stop:
                        break
                    staged = None if isinstance(batch, list) else self.put_fn(batch)
                    q.put((batch, staged))
                    if self._stop:
                        break
            except BaseException as e:
                q.put(e)
            finally:
                # never block forever on the sentinel: after close() the
                # consumer is gone, so make room by discarding staged
                # items (only then — a live consumer still wants them)
                while True:
                    try:
                        q.put(sentinel, timeout=0.2)
                        break
                    except queue.Full:
                        if self._stop:
                            try:
                                q.get_nowait()
                            except queue.Empty:
                                pass

        t = threading.Thread(target=producer, daemon=True)
        self._thread = t  # exposed for tests / joining
        t.start()
        try:
            while True:
                with span("data.wait"):
                    item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop = True
            # unblock a producer stuck on a full queue
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
