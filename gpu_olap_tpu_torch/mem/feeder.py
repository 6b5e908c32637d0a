"""Multi-buffered host->device feeder — the transfer-queue analogue.

Port of ``gpu_olap_tpu/mem/feeder.py``.  The reference overlaps transfers
with compute via CUDA streams, async memcpy and semaphore flow control
(``transfer_queue.rs:36-139``).  Here, on a CUDA device, each host chunk is
copied on a copy stream of the feeder's own (``non_blocking`` from pinned
staging memory), and an event recorded behind the copy is what the
consuming stream waits on before it reads the chunk: the host never blocks
on a transfer.  The feeder keeps ``num_buffers`` transfers in flight ahead
of the consumer (the semaphore, ``transfer_queue.rs:49``).  On the CPU a
chunk's arrays become tensors that alias the host memory.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch



def _tree_map(fn, tree):
    """``fn`` over the numpy arrays of a chunk (nested tuples, lists and
    dicts); every other leaf (a row count, a tensor) passes through."""
    if isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


class DeviceFeeder:
    """Stream host chunks to ``device`` ``num_buffers`` ahead of consumption.

    Usage::

        feeder = DeviceFeeder(num_buffers=2, device="cuda")
        for dev_chunk in feeder.feed(host_chunk_iter):
            consume(dev_chunk)   # transfers of chunks i+1..i+k in flight

    A yielded chunk is ready for work queued on the current stream; its
    host arrays may be overwritten only once that work has finished (the
    caller's business: on the CPU the tensors alias them)."""

    def __init__(self, num_buffers: int = 2, device=None):
        if num_buffers < 1:
            raise ValueError("num_buffers must be >= 1")
        self.num_buffers = num_buffers
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self._copy_stream = None

    def _put(self, host_chunk):
        """Start the transfer of one chunk: (device chunk, copy-done event
        or None)."""
        if self.device.type != "cuda":
            return _tree_map(torch.from_numpy, host_chunk), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = _tree_map(
                lambda a: torch.from_numpy(a).to(self.device, non_blocking=True),
                host_chunk)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev, done

    def _ready(self, staged):
        dev, done = staged
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            # allocated on the copy stream, read on this one: the caching
            # allocator must not hand the memory out again before this
            # stream's work on it has finished
            for t in _tensors(dev):
                t.record_stream(stream)
        return dev

    def feed(self, chunks: Iterable) -> Iterator:
        """Yield device-resident chunks with a bounded in-flight window."""
        window = collections.deque()
        it = iter(chunks)
        try:
            for _ in range(self.num_buffers):
                window.append(self._put(next(it)))
        except StopIteration:
            pass
        while window:
            try:
                window.append(self._put(next(it)))  # start the next transfer
            except StopIteration:
                pass
            yield self._ready(window.popleft())


def pad_chunk(arr: np.ndarray, bucket_rows: int) -> np.ndarray:
    """Pad a host chunk to the bucket shape."""
    if arr.shape[0] == bucket_rows:
        return arr
    out = np.zeros((bucket_rows,) + arr.shape[1:], dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def stream_reduce(chunks: Iterable, step: Callable, init, num_buffers: int = 2,
                  device=None):
    """Out-of-core streamed reduction: ``state = step(state, chunk)`` with
    transfers overlapped against ``step`` — the unified-memory /
    oversubscription replacement (README.md:338-352 streaming contract).

    ``chunks`` yields host chunks (numpy arrays, possibly nested in tuples,
    lists or dicts); ``step`` takes the state and one device chunk.  A chunk's
    host arrays must stay untouched until ``step`` has consumed them."""
    feeder = DeviceFeeder(num_buffers=num_buffers, device=device)
    state = init
    for dev_chunk in feeder.feed(chunks):
        state = step(state, dev_chunk)
    return state
