"""``graph.capture_ms``: the device's idle time inside the program's
``rankfm.graph.capture`` spans, in ms per fit of the traced window: what
capturing the epoch graphs costs a fit. The capture's first step waits
for the epochs already queued, with the device busy, so that wait does
not count.

Prints to standard error the captures a fit and the idle time of each of
the capture's phases, by self time. None when the trace holds no
``rankfm.fit`` span; 0 when fits ran and captured nothing."""

import sys

from fmbench.spans import Spans

CAPTURE = "rankfm.graph.capture"


def read(run):
    fits = run.record.get("fits")
    if run.trace is None or not fits:
        return None
    sp = Spans(run.trace)
    if not sp.find("rankfm.fit"):
        return None
    n = len(fits)
    print(f"graph.capture_ms captures a fit: {len(sp.find(CAPTURE)) / n!r}",
          file=sys.stderr)
    for name, (own, idle) in sorted(sp.by_self().items()):
        if name.startswith("rankfm.graph.") and name != "rankfm.graph.replay":
            print(f"graph.capture_ms {name}: idle {idle / 1e6 / n!r} ms of "
                  f"self {own / 1e6 / n!r} ms a fit", file=sys.stderr)
    return sp.idle_ns(CAPTURE) / 1e6 / n
