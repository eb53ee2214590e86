"""The port's own spans in a traced slice: host ranges named
``sparsetpu.<name>`` (``sparsetpu_torch/utils/timing.py:span``), on the
profiler's clock beside the device events, and the host runtime's
enqueues of device work.  A program without the spans has none of these
names in its trace, and every reader built on them then returns None."""

import bisect
import re

PREFIX = "sparsetpu."
ENQUEUES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync",
                      "cudaGraphLaunch"})
_VERSION = re.compile(r"_v\d+$")     # a runtime call's API version suffix


class Events:
    """Host events of one kind sorted by start, for the queries below."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e.start_us)
        self.starts = [e.start_us for e in self.events]

    def __len__(self):
        return len(self.events)

    def starting_in(self, outer):
        """The events that start inside ``outer``."""
        lo = bisect.bisect_left(self.starts, outer.start_us)
        hi = bisect.bisect_left(self.starts, outer.end_us)
        return self.events[lo:hi]

    def inside(self, outer):
        """The events that lie wholly inside ``outer``."""
        return [e for e in self.starting_in(outer) if e.end_us <= outer.end_us]


def named(trace, name: str) -> Events:
    """The spans ``sparsetpu.<name>``."""
    return Events(e for e in trace.host if e.name == PREFIX + name)


def prefixed(trace, prefix: str) -> Events:
    """The spans whose name starts ``sparsetpu.<prefix>``."""
    return Events(e for e in trace.host
                  if e.name.startswith(PREFIX + prefix))


def enqueues(trace) -> Events:
    """The host runtime's calls that put work on the device: kernel
    launches, memsets, copies and graph launches."""
    return Events(e for e in trace.host
                  if _VERSION.sub("", e.name) in ENQUEUES)


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def minus(a, b) -> list:
    """The sorted disjoint intervals ``a`` less the sorted disjoint
    intervals ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def less_children(outers: Events, children: Events) -> float:
    """Mean over ``outers`` of each one's length less the union of the
    ``children`` that lie inside it; None where there are no outers."""
    if not len(outers):
        return None
    return sum(o.end_us - o.start_us
               - length(merged((c.start_us, c.end_us)
                               for c in children.inside(o)))
               for o in outers.events) / len(outers)


def enqueues_per(outers: Events, trace) -> float:
    """Runtime enqueues starting inside ``outers``, over their number;
    None where there are no outers."""
    if not len(outers):
        return None
    runtime = enqueues(trace)
    return sum(len(runtime.starting_in(o)) for o in outers.events) / len(
        outers)
