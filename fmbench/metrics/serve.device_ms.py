"""``serve.device_ms``: the device time of the traced window of requests
(scoring, top-k and the copies), summed over its operations, per
request."""


def read(run):
    n = len(run.record.get("latency_s", ()))
    if run.trace is None or not n:
        return None
    return 1e3 * run.trace.device_s() / n
