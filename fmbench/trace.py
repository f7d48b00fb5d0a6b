"""The traced run: `torch.profiler` around the measured window, reduced to
device intervals, kernel sums and idle gaps.

`busy_union` is a copy of `chip_smoke.py`'s. The window is traced whole
(CPU and CUDA activity), and the trace is read from the profiler's raw
event list, which stays fast for the hundreds of thousands of kernels of a
window of whole fits. The harness marks its own calls with
``record_function`` ranges named ``fmbench.<what>``; an idle gap of the
device is put down to the innermost of them, and to the innermost host
operation, that covers the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

PROFILE_MARGIN_S = 0.005   # idle time left at both ends of the traced window
WINDOW_RANGE = "fmbench.window"
TOP = 10


def busy_union(spans):
    """The length of the union of the ``(start, end)`` intervals."""
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is not None and a <= cur[1]:
            cur[1] = max(cur[1], b)
            continue
        if cur is not None:
            total += cur[1] - cur[0]
        cur = [a, b]
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def merged(spans):
    """The union of the ``(start, end)`` intervals as sorted disjoint
    intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@contextlib.contextmanager
def profiled(enabled):
    """Trace the block with `torch.profiler` when ``enabled``; yields a
    holder whose ``prof`` is the profiler (None when not tracing). The
    block's own work sits inside a ``fmbench.window`` range, with
    `PROFILE_MARGIN_S` of idle time at both ends (the tracer drops device
    records that fall outside its window)."""
    import time
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    # the CPU-only branch serves the harness's own tests
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        with record_function(WINDOW_RANGE):
            yield holder
            sync()
        time.sleep(PROFILE_MARGIN_S)
    holder.prof = prof


class Trace:
    """What the metric readers read of a traced window: ``kernels``
    ``[(name, start_ns, end_ns)]`` of device activity inside the window,
    ``window_ns`` its ``(start, end)``, ``ranges`` the harness's
    ``fmbench.*`` ranges ``[(name, start_ns, end_ns)]`` and ``host_ops``
    every other host operation."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.kernels, self.ranges, self.host_ops = [], [], []
        window = None
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns()
            b = a + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                # the device-side copy of a host range is no device work
                if not (e.is_user_annotation()
                        or e.name().startswith("fmbench.")):
                    self.kernels.append((e.name(), a, b))
            elif e.name() == WINDOW_RANGE:
                window = (a, b)
            elif e.name().startswith("fmbench."):
                self.ranges.append((e.name(), a, b))
            else:
                self.host_ops.append((e.name(), a, b))
        if window is None:
            raise RuntimeError("the trace holds no fmbench.window range")
        self.window_ns = window
        lo, hi = window
        self.kernels = [(n, max(a, lo), min(b, hi))
                        for n, a, b in self.kernels if b > lo and a < hi]

    @property
    def window_s(self):
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self):
        """Seconds in which a device operation ran: the union of their
        intervals."""
        return busy_union((a, b) for _, a, b in self.kernels) / 1e9

    def device_s(self, match=None):
        """Summed device seconds of the operations whose name holds
        ``match`` (all, if None)."""
        return sum(b - a for n, a, b in self.kernels
                   if match is None or match in n) / 1e9

    def device_ops(self, top=TOP):
        """``[[name, seconds], ...]``: the device operations that took most
        time, summed by name."""
        by = defaultdict(int)
        for n, a, b in self.kernels:
            by[n] += b - a
        rows = sorted(by.items(), key=lambda r: -r[1])[:top]
        return [[n, ns / 1e9] for n, ns in rows]

    def idle_gaps(self, top=TOP):
        """``[[what the host was doing, seconds], ...]``: the device's idle
        time inside the window, summed by the innermost harness range and
        host operation that cover each gap's middle, longest first."""
        lo, hi = self.window_ns
        busy = merged((a, b) for _, a, b in self.kernels)
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        ranges, ops = _Spans(self.ranges), _Spans(self.host_ops)
        by = defaultdict(int)
        for a, b in gaps:
            mid = (a + b) // 2
            label = " > ".join(x for x in (ranges.innermost(mid),
                                           ops.innermost(mid)) if x)
            by[label or "idle"] += b - a
        rows = sorted(by.items(), key=lambda r: -r[1])[:top]
        return [[n, ns / 1e9] for n, ns in rows]


class _Spans:
    """Named ``(name, start, end)`` spans, sorted by start, for lookups of
    the innermost span that covers a time."""

    LOOKBACK = 64

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda r: r[1])
        self.starts = [s[1] for s in self.spans]

    def innermost(self, t):
        """The name of the shortest span that covers ``t`` among the
        `LOOKBACK` spans that start last before it, or None."""
        k = bisect.bisect_right(self.starts, t)
        best = None
        for name, a, b in self.spans[max(0, k - self.LOOKBACK):k]:
            if a <= t < b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else None
