"""Phase timing (counterpart of ``sparsetpu/utils/timing.py``): the
reference's ``getTimestamp()`` wall clock, named phase durations printed in
its format, and a ``torch.profiler`` trace context; and the port's own
instrumentation:

  ``span(name)``  a host range ``sparsetpu.<name>`` on the profiler's clock,
                  opened only while a ``torch.profiler`` runs: the SpMV
                  call (``spmv``, ``spmm``), the device module's
                  (``device.spmv``), each kernel wrapper's
                  (``launch.<kernel>``) and the solver's (``pcg``,
                  ``pcg.capture``, ``pcg.iter``, ``pcg.check``,
                  ``pcg.replay``; ``cg`` the same);
  ``SETUP``       the process's set-up phases, always on: ``pack`` (the
                  host packs, the route's row scan, the host finish
                  build), ``upload`` (the device constructors),
                  ``final_rows`` (the final level's builds), ``live_slots``
                  (``LiveSlots.build``) and ``csrc`` (the kernels'
                  library, built or loaded).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

SPAN_PREFIX = "sparsetpu."

# A host range of scope FUNCTION: ``record_function`` opens one of scope
# USER, which the card's profiler also returns as a CUDA-typed event over
# the kernels it encloses (``is_user_annotation``), so a device list that
# keeps every CUDA-typed event would count the span as device time.
_emit = torch._C._profiler._RecordFunctionFast
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over a host range ``sparsetpu.<name>``, on the
    profiler's clock beside the device events.  Spans nest: a call's
    ranges lie inside its root.  With no profiler running it is one flag
    test and a shared no-op context."""
    if not _profiling():
        return _OFF
    return _emit(SPAN_PREFIX + name)


def get_timestamp() -> float:
    """Microsecond-resolution wall clock (util.cpp:3-8 analogue), in
    seconds."""
    return time.perf_counter()


@dataclass
class PhaseTimer:
    """Collects named phase durations, like the reference's printf
    timers.  A phase opened inside another (on the same thread) is taken
    out of the outer one's time, so nested phases add up to the wall time
    they cover and none is counted twice."""

    phases: Dict[str, float] = field(default_factory=dict)
    _open: threading.local = field(default_factory=threading.local,
                                   repr=False, compare=False)

    @contextlib.contextmanager
    def phase(self, name: str):
        stack = getattr(self._open, "inner", None)
        if stack is None:
            stack = self._open.inner = []     # the open phases' inner time
        stack.append(0.0)
        t0 = get_timestamp()
        try:
            yield
        finally:
            dt = get_timestamp() - t0
            self.record(name, dt - stack.pop())
            if stack:
                stack[-1] += dt

    def record(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def ms(self, name: str) -> float:
        return 1e3 * self.phases.get(name, 0.0)

    def report(self) -> str:
        # the reference's print format: "<phase> execution time <ms> msec"
        lines = [f"{name} execution time {1e3 * sec:.3f} msec"
                 for name, sec in self.phases.items()]
        return "\n".join(lines)


# the process's set-up phases (see the module's docstring)
SETUP = PhaseTimer()


@contextlib.contextmanager
def maybe_profiler_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, CPU and (where a card is
    present) CUDA activities, written as a Chrome trace
    ``trace-<pid>-<ns>.json`` under ``trace_dir``, the port's ``span``
    ranges among its host events; yields the profiler, so a caller can
    read ``key_averages()``.  With ``trace_dir`` None it does
    nothing at all and yields None."""
    if trace_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
