"""Asynchronous host-to-device prefetch (port of ``ctpa/data/prefetch.py``):
keeps the card fed while the host loads bytes.

A worker thread runs the source iterator ``depth`` batches ahead.  On a
CUDA device it does so on a side stream: the batch's host arrays go
through pinned memory with ``non_blocking`` copies, any device work the
source itself enqueues (the loader's preprocessing) runs there too, and an
event marks the batch's end.  ``__next__`` makes the consumer's current
stream wait on that event and ``record_stream``s every tensor of the batch
on it, so the caching allocator does not hand their memory out again while
the consumer still reads it.  A loader exception is raised again at
``__next__``.

Data parallelism: with a ``sharding`` (``core/mesh.py:batch_sharding``)
the source yields global batches and this rank's rows of each go to the
device (sliced on the host, before the pinned copy); with
``process_local`` the source yields this rank's rows already (e.g. off a
``datasets.ProcessShard``), and they go to the device as they are.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


def to_device(x, device, non_blocking: bool = True):
    """An array or tensor on ``device``; a host array bound for a card goes
    through pinned memory and is copied without blocking the host.  Other
    values (strings, lists) are returned as they are."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not torch.is_tensor(x):
        return x
    device = torch.device(device)
    if device.type != "cuda" or x.device.type == "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=non_blocking)


class PrefetchIterator:
    """Wrap a batch iterator (dicts of arrays or tensors); overlap loading
    and transfer with the consumer.  ``depth``: batches staged ahead (2 is
    the classic double buffer)."""

    def __init__(self, source: Iterator, device="cuda", depth: int = 2,
                 name: str = "prefetch", sharding=None, process_local: bool = False):
        if process_local and sharding is None:
            raise ValueError("process_local prefetch requires a sharding")
        # process-local rows are this rank's already
        self._rows = None if sharding is None or process_local else sharding.rows
        self._source = source
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name=name, daemon=True)
        self._thread.start()

    def _stage(self, batch: dict) -> dict:
        if self._rows is not None:
            batch = {k: self._rows(v) for k, v in batch.items()}
        return {k: to_device(v, self._device) for k, v in batch.items()}

    def _worker(self):
        try:
            source = iter(self._source)
            ctx = torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()
            while True:
                with ctx:
                    try:
                        batch = self._stage(next(source))
                    except StopIteration:
                        break
                    event = torch.cuda.Event() if self._cuda else None
                    if event is not None:
                        event.record(self._stream)
                self._q.put((batch, event))
        except BaseException as e:  # propagate loader failures loudly
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is self._done:
            # leave the sentinel for any later call, which then stops too
            self._q.put(self._done)
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for v in batch.values():
                if torch.is_tensor(v) and v.device.type == "cuda":
                    v.record_stream(consumer)
        return batch
