"""Phase timing (counterpart of ``sparsetpu/utils/timing.py``): the
reference's ``getTimestamp()`` wall clock, named phase durations printed in
its format, and a ``torch.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


def get_timestamp() -> float:
    """Microsecond-resolution wall clock (util.cpp:3-8 analogue), in
    seconds."""
    return time.perf_counter()


@dataclass
class PhaseTimer:
    """Collects named phase durations, like the reference's printf
    timers."""

    phases: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = get_timestamp()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                get_timestamp() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def ms(self, name: str) -> float:
        return 1e3 * self.phases.get(name, 0.0)

    def report(self) -> str:
        # the reference's print format: "<phase> execution time <ms> msec"
        lines = [f"{name} execution time {1e3 * sec:.3f} msec"
                 for name, sec in self.phases.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_profiler_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, CPU and (where a card is
    present) CUDA activities, written as a Chrome trace
    ``trace-<pid>-<ns>.json`` under ``trace_dir``; yields the profiler, so
    a caller can read ``key_averages()``.  With ``trace_dir`` None it does
    nothing at all and yields None."""
    if trace_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
