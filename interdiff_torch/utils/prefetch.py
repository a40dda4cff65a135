"""Host-side batch prefetching (`interdiff_tpu/utils/prefetch.py`) for the
diffusion trainers.

Two pieces compose:

  * :func:`threaded_batches` builds the upcoming batches on background
    threads, so that the host's clips may overlap the consumer;
  * :func:`device_prefetch` keeps ``size`` batches already on the device
    (a pinned-memory copy, ``non_blocking``, on the current stream).

Threads share the interpreter lock: a worker building clips in numpy runs
while the main thread waits on the device or in native code that releases
the lock, not while it dispatches Python.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from interdiff_torch import resolve_device

POLL_S = 0.1  # how often a blocked worker looks for the consumer's stop
WORKER_NAME = "threaded_batches"


def threaded_batches(make_iterator: Callable[[], Iterable], *,
                     num_workers: int = 2, buffer: int = 4) -> Iterator:
    """Run ``make_iterator()`` on ``num_workers`` background threads and
    yield its items in order, up to ``buffer`` prepared ahead.

    The workers pull from one iterator under a lock, so the items are built
    one at a time and in order (a shared `np.random.Generator` draws as it
    would without the threads); the workers overlap the building with the
    consumer, not with each other.  An exception of the source is raised in
    the consumer at its place in the order.  When the consumer stops early
    (it raises, or closes the generator) the workers stop within
    ``POLL_S`` and drop what they hold."""
    src = iter(make_iterator())
    out: "queue.PriorityQueue" = queue.PriorityQueue(maxsize=buffer)
    lock = threading.Lock()
    stop = threading.Event()
    seq = [0]
    end = object()

    def put(entry) -> bool:
        while not stop.is_set():
            try:
                out.put(entry, timeout=POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        while True:
            with lock:
                if stop.is_set():
                    return
                my_seq = seq[0]
                seq[0] += 1
                try:
                    item = next(src)
                except StopIteration:
                    put((my_seq, end))
                    return
                except BaseException as e:  # raised in the consumer
                    put((my_seq, ("__error__", e)))
                    return
            if not put((my_seq, item)):
                return

    for _ in range(num_workers):
        threading.Thread(target=worker, name=WORKER_NAME,
                         daemon=True).start()

    expect, hold = 0, {}
    try:
        while True:
            while expect not in hold:
                s, item = out.get()
                hold[s] = item
            item = hold.pop(expect)
            expect += 1
            if item is end:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] == "__error__"):
                raise item[1]
            yield item
    finally:
        stop.set()


def place_batch(batch: Dict[str, np.ndarray], device,
                keys: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
    """The arrays of ``batch`` (those named by ``keys``, all when None) as
    tensors on ``device``: a numpy array bound for a CUDA device is copied
    through pinned memory, ``non_blocking`` on the current stream (the
    pinned block is not reused before the copy completes); a tensor moves
    with ``Tensor.to``; on the CPU an array is shared, not copied."""
    device = torch.device(device)

    def place(value):
        if isinstance(value, torch.Tensor):
            return value.to(device, non_blocking=True)
        if device.type != "cuda":
            return torch.as_tensor(value, device=device)
        return torch.from_numpy(np.ascontiguousarray(value)).pin_memory().to(
            device, non_blocking=True)

    return {k: place(batch[k]) for k in (batch if keys is None else keys)}


def device_prefetch(batches: Iterable, *, size: int = 2,
                    place: Optional[Callable] = None,
                    device=None) -> Iterator:
    """Keep ``size`` batches placed ahead of consumption.

    ``place`` maps a host batch to device tensors; by default
    :func:`place_batch` onto ``device`` (CUDA unless given)."""
    if place is None:
        device = resolve_device(device)
        place = lambda b: place_batch(b, device)  # noqa: E731
    it = iter(batches)
    ahead = []
    try:
        for _ in range(size):
            ahead.append(place(next(it)))
    except StopIteration:
        pass
    for batch in it:
        ahead.append(place(batch))
        yield ahead.pop(0)
    yield from ahead
