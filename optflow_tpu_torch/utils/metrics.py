"""Lightweight per-stage timing and throughput counters.

The reference's only observability is stdout progress lines
(src/optflow.cpp:94) and debug prints (SURVEY.md §5). Here the runner
accounts decode / solve / postprocess / sink time and pairs/s, and
a torch.profiler trace can be enabled around the job for deep dives.

Work on a CUDA device is enqueued, not run, inside a ``with`` block, so the
host clock of a device stage measures the enqueue. :meth:`StageTimer.device_stage`
brackets such a stage with CUDA events as well; the events are read later,
at a point where the caller waits for the device anyway
(:meth:`StageTimer.read_device_events`), so timing adds no synchronisation.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # seconds the device spent in each device stage, by CUDA events
        self.device_totals: Dict[str, float] = defaultdict(float)
        self._events: List[Tuple[str, object, object]] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t
            self.counts[name] += 1

    @contextlib.contextmanager
    def device_stage(self, name: str, device):
        """:meth:`stage`, and on a CUDA ``device`` also a pair of events on
        its current stream around the block, read by
        :meth:`read_device_events`. On the CPU it is :meth:`stage` alone."""
        import torch

        device = torch.device(device)
        if device.type != "cuda":
            with self.stage(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(device)
        with self.stage(name):
            start.record(stream)
            try:
                yield
            finally:
                end.record(stream)
                self._events.append((name, start, end))

    def read_device_events(self, wait: bool = False) -> None:
        """Add the device time of every bracket whose end the device has
        passed to ``device_totals``; with ``wait`` block for the rest too.
        Call it right after a readback, when the device has caught up."""
        pending = []
        for name, start, end in self._events:
            if wait:
                end.synchronize()
            if wait or end.query():
                self.device_totals[name] += start.elapsed_time(end) / 1e3
            else:
                pending.append((name, start, end))
        self._events = pending

    def summary(self, pairs: int = 0) -> Dict[str, float]:
        self.read_device_events(wait=True)
        wall = time.perf_counter() - self._t0
        out = {f"{k}_s": round(v, 4) for k, v in self.totals.items()}
        out.update(
            {f"{k}_device_s": round(v, 4) for k, v in self.device_totals.items()}
        )
        out["wall_s"] = round(wall, 4)
        if pairs and wall > 0:
            out["pairs_per_s"] = round(pairs / wall, 4)
        return out


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a block in a torch.profiler trace when log_dir is set (a no-op
    otherwise). The Chrome trace lands in ``log_dir/trace.json``."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
