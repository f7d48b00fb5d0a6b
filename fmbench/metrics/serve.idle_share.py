"""``serve.idle_share``: the share of the traced window of requests in which
no operation ran on the device (one minus the union of the device
intervals over the window)."""


def read(run):
    if run.trace is None or not len(run.record.get("latency_s", ())):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
