"""``b3_roofline``: the sorted table-update kernel B3 (``inplace_update``)
against its roofline: the least time the card could take for the B3 work of
the window's candidate steps, over B3's device time in the traced window.

A candidate step of ``B`` rows updates the item table with ``2B`` update
rows (each row's positive and negative) and the user table with ``B``;
in the ``webscale`` configuration both take B3 (the 910k-row item table is
past B2's accumulator, and the 100,000-row user table is 49 tiles of the
JAX rule with 8,192 updates). Its bytes, each input read once and each
output written once: every update row (``F + 2`` floats and its 4-byte
index) read, and each touched table row read and written (``F + 1``
floats an item row with its bias, ``F`` a user row). The rows a step
touches are the expected count of distinct rows among its draws, from the
configuration's data: a row of a user or an item with share ``p`` of the
training rows is missed by ``B`` rows with probability ``(1 - p)^B``, and
an item also by ``B`` negatives drawn uniformly from the catalog. The
operations (an add per update element, a multiply and an add per touched
element) take some thirty times less than the bytes at the card's peaks,
so the bound is the bytes'. None when the run counted no steps (a program
without the ``training.STEPS`` counter) or traced no B3."""

import numpy as np

from fmbench.counts import PEAK_BYTES

KERNEL = "inplace_update"


def touched(shares, draws, miss=1.0):
    """Expected distinct rows hit by ``draws`` draws from ``shares``, each
    row also missed with probability ``miss`` by other draws."""
    return float(np.sum(1.0 - (1.0 - shares) ** draws * miss))


def step_bytes(shape, batch):
    """Bytes of one candidate step's two table updates."""
    F, n, I = shape["factors"], shape["rows"], shape["items"]
    items = touched(shape["item_rows"] / n, batch, (1.0 - 1.0 / I) ** batch)
    users = touched(shape["user_rows"] / n, batch)
    per_update = 4 + (F + 2) * 4
    return (3 * batch * per_update + 2 * items * (F + 1) * 4
            + 2 * users * F * 4)


def read(run):
    steps = run.record.get("steps")
    fits = run.record.get("fits")
    if run.trace is None or not steps or not fits:
        return None
    device = run.trace.device_s(KERNEL)
    n = sum(v for k, v in steps.items() if k[0] == "candidate")
    if device <= 0 or not n:
        return None
    batch = fits[0]["plan"].xla_batch
    return 100.0 * n * step_bytes(run.shape, batch) / PEAK_BYTES / device
