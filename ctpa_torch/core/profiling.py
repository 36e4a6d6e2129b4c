"""Tracing and profiling hooks (port of ``ctpa/core/profiling.py``) on
``torch.profiler``: ``trace(dir)`` writes a Chrome trace of the enclosed
block into ``dir`` (the device's kernels too where there is a card),
``annotate(name)`` names a range in it, ``save_device_memory_profile`` dumps
the CUDA caching allocator's snapshot, and ``StepTimer`` keeps a rolling
steps/s and a per-stage breakdown on the host clock."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A profiler trace over the enclosed block, written to
    ``log_dir/trace.json``; nothing when ``log_dir`` is None or empty (so a
    ``--profile-dir`` flag can be passed through unconditionally)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named range that shows in the trace's timeline."""
    return torch.profiler.record_function(name)


def save_device_memory_profile(path: str) -> None:
    """The CUDA caching allocator's snapshot (segments, blocks, and the
    allocation history where it is recorded) as a pickle at ``path``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device memory profile is the CUDA caching allocator's "
                           "snapshot, and there is no CUDA device")
    torch.cuda.memory._dump_snapshot(path)


class StepTimer:
    """Rolling steps/s and a per-stage breakdown (host wall clock)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._stage_acc: dict[str, float] = {}
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with annotate(name):
            yield
        self._stage_acc[name] = self._stage_acc.get(name, 0.0) + time.perf_counter() - t0

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    def stage_summary(self) -> dict[str, float]:
        out = dict(self._stage_acc)
        self._stage_acc = {}
        return out
