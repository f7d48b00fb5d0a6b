"""``serve.host_ms``: a request's host path outside its wait for the
device: the duration of the program's ``rankfm.recommend`` span less the
part its ``rankfm.recommend.sync`` children cover (each the wait for the
device and the copy back of one chunk of users), in ms, the median over
the traced window's requests.

Prints to standard error the median ms a request of each of the
request's phases and of the span's own time. None when the trace holds
no ``rankfm.recommend`` span."""

import sys

import numpy as np

from fmbench.spans import Spans

REQUEST = "rankfm.recommend"
SYNC = "rankfm.recommend.sync"


def read(run):
    if run.trace is None or not len(run.record.get("latency_s", ())):
        return None
    sp = Spans(run.trace)
    reqs = sp.find(REQUEST)
    if not reqs:
        return None
    host = [sp.end[k] - sp.start[k] - sp.kids_ns(k, SYNC) for k in reqs]
    split = {}
    for k in reqs:
        by = {"self": sp.end[k] - sp.start[k] - sp.kids_ns(k)}
        for c in sp.kids[k]:
            by[sp.name[c]] = by.get(sp.name[c], 0) + sp.end[c] - sp.start[c]
        for name, ns in by.items():
            split.setdefault(name, []).append(ns)
    for name, v in split.items():
        ms = float(np.median(v)) / 1e6
        print(f"serve.host_ms {name}: median {ms!r} ms a request "
              f"({len(v)} requests)", file=sys.stderr)
    return float(np.median(host)) / 1e6
