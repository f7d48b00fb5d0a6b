"""The program's own spans in a traced run, and the device's idle time
inside them.

The port opens a ``rankfm.*`` range at each of its layer boundaries while a
profiler records (``rankfm_tpu_torch.utils.observe.span``): ``rankfm.fit``
and its phases, the epoch graphs' ``rankfm.graph.*``, ``rankfm.recommend``
and its phases. They reach the readers among ``Trace.host_ops``, on the
clock of the device's kernels. `Spans` takes them from there and gives, per
span name, the union of its intervals and the device's idle time inside
it, and per span its self time: its interval less the part its child spans
cover. A child is a span that its parent's interval holds (one thread
opens them all, nested).

Every interval operation here is exact, over sorted intervals, whatever
the number of host operations inside a span (a graph capture records
thousands); the idle time inside an interval is found by bisection among
the window's idle gaps, so a window of hundreds of thousands of kernels
and thousands of spans reads in seconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from fmbench.trace import merged

PREFIX = "rankfm."


def complement(intervals, lo, hi):
    """``[lo, hi)`` less the sorted disjoint ``intervals``."""
    out, t = [], lo
    for a, b in intervals:
        if a > t:
            out.append([t, min(a, hi)])
        t = max(t, b)
        if t >= hi:
            break
    if hi > t:
        out.append([t, hi])
    return out


def length_ns(intervals):
    return sum(b - a for a, b in intervals)


class Spans:
    """The ``rankfm.*`` spans of a `fmbench.trace.Trace`, clipped to its
    window: ``name[k]``, ``start[k]``, ``end[k]`` and ``kids[k]`` (the
    indices of the spans whose innermost holder is span ``k``), sorted by
    start; ``idle`` is the device's idle intervals in the window."""

    def __init__(self, trace):
        lo, hi = trace.window_ns
        rows = sorted((max(a, lo), -min(b, hi), n)
                      for n, a, b in trace.host_ops
                      if n.startswith(PREFIX) and b > lo and a < hi)
        self.name = [n for _, _, n in rows]
        self.start = [a for a, _, _ in rows]
        self.end = [-b for _, b, _ in rows]
        self.kids = [[] for _ in rows]
        stack = []
        for k in range(len(rows)):
            while stack and self.end[stack[-1]] < self.end[k]:
                stack.pop()
            if stack:
                self.kids[stack[-1]].append(k)
            stack.append(k)
        busy = merged((a, b) for _, a, b in trace.kernels)
        self.idle = complement(busy, lo, hi)
        self.idle_ends = [b for _, b in self.idle]

    def find(self, name):
        """The indices of the spans named ``name``."""
        return [k for k, n in enumerate(self.name) if n == name]

    def union(self, name):
        """The union of the intervals of the spans named ``name``."""
        return merged((self.start[k], self.end[k]) for k in self.find(name))

    def idle_in(self, intervals):
        """Device idle time inside the disjoint ``intervals``."""
        total = 0
        for a, b in intervals:
            j = bisect.bisect_right(self.idle_ends, a)
            while j < len(self.idle) and self.idle[j][0] < b:
                total += min(b, self.idle[j][1]) - max(a, self.idle[j][0])
                j += 1
        return total

    def idle_ns(self, name):
        """Device idle time inside the union of the spans named ``name``."""
        return self.idle_in(self.union(name))

    def kids_ns(self, k, name=None):
        """The part of span ``k`` that its children (those named ``name``,
        or all) cover."""
        return length_ns(merged((self.start[c], self.end[c])
                                for c in self.kids[k]
                                if name is None or self.name[c] == name))

    def own(self, k):
        """Span ``k``'s interval less its children's: its self time."""
        kids = merged((self.start[c], self.end[c]) for c in self.kids[k])
        return complement(kids, self.start[k], self.end[k])

    def by_self(self):
        """``{name: (self ns, device idle ns in the self time)}``, summed
        over the spans of each name. The self times of a span and of all
        spans under it add up to its interval."""
        out = defaultdict(lambda: [0, 0])
        for k, n in enumerate(self.name):
            own = self.own(k)
            out[n][0] += length_ns(own)
            out[n][1] += self.idle_in(own)
        return {n: tuple(v) for n, v in out.items()}
