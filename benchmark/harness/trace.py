"""Reading a ``torch.profiler`` trace of a window into what the metrics need.

The traced window is one ``record_function`` range around whole steps
(or calls) that end in a read-back, so every kernel they launched has run
inside it.  Busy time is the union of the device intervals (kernels,
copies, sets) inside the window; the device-side copies of host ranges
(user annotations such as the window itself or ``Optimizer.step``) are
not device work.  An idle gap is named by the innermost host operation
running at its middle, CUDA runtime calls and the profiler's own ranges
left out.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "benchmark.traced_window"
TOP = 10
NOT_HOST_OPS = {WINDOW, "Activity Buffer Request"}


@dataclass
class Trace:
    window_s: float
    busy_s: float
    units: int  # steps or calls inside the window
    kernels: list = field(default_factory=list)  # (name, seconds) per device event
    gaps: dict = field(default_factory=dict)  # host op → idle seconds

    def seconds(self, keep) -> float:
        return sum(s for n, s in self.kernels if keep(n))

    def count(self, keep) -> int:
        return sum(1 for n, _ in self.kernels if keep(n))

    def breakdown(self) -> dict:
        """The device operations and the idle gaps (by host op) that took
        the most time, in seconds a step (or call)."""
        by_name: dict[str, float] = {}
        for n, s in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + s
        top = lambda d: [[k[:160], v / self.units]  # noqa: E731
                         for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_name), "idle_gaps": top(self.gaps)}


@contextlib.contextmanager
def traced():
    """Profile the body; yields a list that holds the profiler afterwards."""
    holder = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
    holder.append(prof)


def summarize(prof, units: int) -> Trace:
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    device = sorted(
        (max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
        for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and e.name not in host_names and e.time_range.end > w0 and e.time_range.start < w1)
    busy, gaps, cursor = 0.0, [], w0
    for start, end, _ in device:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if cursor < w1:
        gaps.append((cursor, w1))
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name not in NOT_HOST_OPS
            and not e.name.startswith("cuda") and w0 <= e.time_range.start <= w1]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    names = [e.name for e in host]
    by_op: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = ("(host between ops)" if not len(inside)
                else names[inside[np.argmin(ends[inside] - starts[inside])]])
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, units=units,
                 kernels=[(n, (e - s) * 1e-6) for s, e, n in device], gaps=by_op)


def cuda_synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
