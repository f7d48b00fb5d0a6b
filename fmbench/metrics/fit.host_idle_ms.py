"""``fit.host_idle_ms``: the device's idle time inside the program's own
``rankfm.fit`` spans, in ms per fit: the idle time of the traced window
that falls inside a fit, summed, over the window's fits. The harness's
relabelling and its reading of the outputs lie outside these spans
(``fit.idle_share`` counts them).

Prints to standard error the same idle time split by the program's span
names, each by its self time (`fmbench.spans`), so that a traced run
shows in which phase of a fit the device waits. None when the trace holds
no ``rankfm.fit`` span (a program that records none)."""

import sys

from fmbench.spans import Spans


def read(run):
    fits = run.record.get("fits")
    if run.trace is None or not fits:
        return None
    sp = Spans(run.trace)
    if not sp.find("rankfm.fit"):
        return None
    n = len(fits)
    for name, (own, idle) in sorted(sp.by_self().items(),
                                    key=lambda r: -r[1][1]):
        print(f"fit.host_idle_ms {name}: idle {idle / 1e6 / n!r} ms of "
              f"self {own / 1e6 / n!r} ms a fit", file=sys.stderr)
    return sp.idle_ns("rankfm.fit") / 1e6 / n
