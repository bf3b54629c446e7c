"""Profiling: step timers and device traces.

The port's counterpart of ``ecog2txt_tpu/utils/profiling.py``:

* :func:`trace_to`, a context manager around ``torch.profiler`` that
  writes a Chrome trace (CPU activity, and the card's kernels on a CUDA
  machine) into a directory;
* :func:`force_result`, which synchronises and reads a scalar, so that a
  wall-clock timer sees asynchronous device work finished;
* :class:`StepTimer`, (duration, items) laps and their throughput.  On a
  CUDA device a lap is the time between two CUDA events recorded on the
  current stream (read after the second one completes); on the CPU it is
  ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from ..convert import tree_leaves


@contextlib.contextmanager
def trace_to(log_dir: str):
    """``with trace_to(dir): step(...)`` → ``dir/trace.json``, a
    ``torch.profiler`` Chrome trace (CUDA activity included where a GPU
    is present)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def force_result(tree) -> float:
    """Synchronise the device of the tree's first leaf and read its sum."""
    leaves = tree_leaves(tree)
    if not leaves:
        return 0.0
    leaf = leaves[0]
    if torch.is_tensor(leaf):
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        return float(leaf.detach().float().sum())
    return float(leaf)


@dataclass
class StepTimer:
    """Accumulates (duration, items) laps; reports throughput.  ``device``
    picks the clock: CUDA events on a CUDA device, ``time.perf_counter``
    otherwise."""

    device: str | torch.device = "cpu"
    laps: list = field(default_factory=list)
    _t0: object = None

    def __post_init__(self):
        self.device = torch.device(self.device)

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
            return event
        return time.perf_counter()

    def start(self) -> None:
        self._t0 = self._mark()

    def lap(self, items: int = 1, result=None) -> float:
        """Close a lap of ``items`` items (``result`` is read first, as
        :func:`force_result` does); returns its seconds and starts the
        next."""
        if self._t0 is None:
            raise RuntimeError("call start() before lap()")
        if result is not None:
            force_result(result)
        end = self._mark()
        if self.device.type == "cuda":
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = end - self._t0
        self.laps.append((dt, items))
        self._t0 = self._mark()
        return dt

    @property
    def total_seconds(self) -> float:
        return sum(d for d, _ in self.laps)

    @property
    def total_items(self) -> int:
        return sum(n for _, n in self.laps)

    @property
    def items_per_second(self) -> float:
        t = self.total_seconds
        return self.total_items / t if t > 0 else 0.0

    def summary(self) -> dict:
        durations = [d for d, _ in self.laps]
        return {
            "laps": len(self.laps),
            "total_s": self.total_seconds,
            "mean_lap_s": sum(durations) / len(durations) if durations else 0.0,
            "items_per_second": self.items_per_second,
        }
