"""``train_rows_per_s``: training rows times epochs of every whole fit of
the window, over the window's wall time (host clock, from the first
relabelling to the synced end of the last fit)."""


def read(run):
    rec = run.record
    if "fits" not in rec or not rec["fits"]:
        return None
    return rec["rows"] * rec["epochs"] * len(rec["fits"]) / rec["wall_s"]
