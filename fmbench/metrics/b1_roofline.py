"""``b1_roofline``: the fused chunk kernel B1 (``fused_batch_kernel``)
against its roofline: the least time the card could take for B1's work in
the window, over B1's device time in the traced window.

B1's work is every interaction-epoch that a fit's plan gave the fused engine
(``n_main`` epochs, and the tail epochs when the plan widens the window
instead of running the candidate step), at the operations and bytes that
`fmbench.counts` counts from the configuration's shapes."""

from fmbench.counts import (PEAK_BYTES, PEAK_F32_OPS, bytes_per_epoch,
                            flops_per_row)

KERNEL = "fused_batch_kernel"


def b1_epochs(plan):
    if not plan.fused:
        return 0
    return plan.n_main + (plan.n_tail if plan.tail_windows else 0)


def bound_s(shape, epochs):
    s = shape
    ops = flops_per_row(s["factors"], s["max_samples"], s["if_nnz_per_item"])
    nbytes = bytes_per_epoch(s["users"], s["items"], s["factors"],
                             s["item_features"], s["rows"], s["nnz_hist"])
    return epochs * max(s["rows"] * ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def read(run):
    fits = run.record.get("fits")
    if run.trace is None or not fits:
        return None
    device = run.trace.device_s(KERNEL)
    if device <= 0:
        return None
    epochs = sum(b1_epochs(f["plan"]) for f in fits)
    return 100.0 * bound_s(run.shape, epochs) / device
