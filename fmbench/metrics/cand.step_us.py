"""``cand.step_us``: the device's busy time in the traced window over the
batch steps the program ran in it (its ``training.STEPS`` counter, which a
graph replay advances by the steps its capture recorded), in µs a step.
None when the run counted no steps (a program without the counter)."""


def read(run):
    steps = run.record.get("steps")
    if run.trace is None or not steps:
        return None
    return 1e6 * run.trace.busy_s() / sum(steps.values())
