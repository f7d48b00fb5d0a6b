"""``fit.prep_ms``: the program's own host time before a fit's first epoch,
``last_fit_timing_['ingest_s'] + ['prep_s']`` (id maps, history, weight
init, record layouts), in milliseconds, the mean over the window's fits.
The program rounds each to 0.01 s."""


def read(run):
    fits = run.record.get("fits")
    if not fits:
        return None
    t = [f["timing"]["ingest_s"] + f["timing"].get("prep_s", 0.0)
         for f in fits]
    return 1e3 * sum(t) / len(t)
