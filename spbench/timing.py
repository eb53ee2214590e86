"""Device timing and trace reading, frozen here so that a later change to
the program cannot move the yardstick.

``held_ms`` is ``sparsetpu_torch/bench/harness.py:stream_ms``'s pattern: a
spin kernel holds the card while the host queues the calls, so host launch
gaps drop out of the CUDA-event interval.  ``traced`` is
``chip_smoke.py:traced``'s: the card's profiler drops device events near a
trace's start, so the traced work sits a pad of host time inside the
window, between ``MARKS`` spin kernels on each side, and the record counts
as whole only when every marker is in place, the leading ones before all of
the work's events and the trailing ones after.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np

MARKS = 4
PADS_S = (0.25, 1.0, 4.0)
SPIN = "spin_kernel"


def held_ms(torch, fn: Callable[[], object], calls: int) -> float:
    """Device ms a call of ``fn`` with ``calls`` calls back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(calls * 1_000_000)    # ~0.5 ms a call at ~2 GHz
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    """The device and host events of one traced call of ``fn``: device
    events between the markers, host (CPU-side) events, the window between
    the last leading marker's end and the first trailing marker's start,
    and whether the device record was whole."""
    device: List[Event]
    host: List[Event]
    window_us: tuple
    whole: bool


def traced(torch, fn: Callable[[], object], pads=PADS_S,
           agree: Optional[Callable[[bool], bool]] = None) -> Trace:
    """Profile ``fn()`` bracketed by spin kernels; tries ``pads`` in turn
    and returns the first whole trace, else the last.  ``agree``: on ranks,
    ``Run.agree``, so that every rank tries again while any rank's trace
    is not whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trace = None
    for pad in pads:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(MARKS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            for _ in range(MARKS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad)
        ev = sorted((Event(e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.start_us)
        spin = [i for i, e in enumerate(ev) if SPIN in e.name]
        n = len(ev)
        whole = spin == [*range(MARKS), *range(n - MARKS, n)]
        host = [Event(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == DeviceType.CPU]
        work = [e for e in ev if SPIN not in e.name]
        window = ((ev[MARKS - 1].end_us, ev[n - MARKS].start_us) if whole
                  else (min((e.start_us for e in work), default=0.0),
                        max((e.end_us for e in work), default=0.0)))
        trace = Trace(work, host, window, whole)
        if (whole if agree is None else agree(whole)):
            break
    return trace


def busy_us(events: List[Event], lo: float, hi: float) -> float:
    """Length of the union of the events' intervals inside [lo, hi]."""
    spans = sorted((max(e.start_us, lo), min(e.end_us, hi)) for e in events
                   if e.end_us > lo and e.start_us < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: Trace) -> List[tuple]:
    """The device's idle gaps inside the window, each (label, us): the
    label names what the host was doing, the innermost host event that
    covers the gap's middle (``python`` where none does) and the last host
    event that ended before the gap began."""
    lo, hi = trace.window_us
    spans = sorted((e.start_us, e.end_us) for e in trace.device)
    gaps, cur = [], lo
    for s, e in spans:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    if not gaps or not trace.host:
        return [("host: python", b - a) for a, b in gaps]
    hs = np.array([e.start_us for e in trace.host])
    he = np.array([e.end_us for e in trace.host])
    names = [e.name for e in trace.host]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        inner = (names[cover[np.argmin(he[cover] - hs[cover])]]
                 if cover.size else "python")
        before = np.flatnonzero(he <= a)
        last = names[before[np.argmax(he[before])]] if before.size else "-"
        out.append((f"host: {inner} after {last}", b - a))
    return out


def top(pairs, n: int = 10) -> List[list]:
    """The ``n`` largest totals of (name, us) pairs summed by name, as
    [name, seconds]."""
    tot = {}
    for name, us in pairs:
        tot[name] = tot.get(name, 0.0) + us
    return [[k, v * 1e-6] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
