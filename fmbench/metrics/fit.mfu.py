"""``fit.mfu``: the model FLOPs of the window's fits over the window's wall
time, as a share of the card's f32 peak outside the tensor cores (the
tables' precision). FLOPs and peak: `fmbench.counts`, from the
configuration's shapes, never from how the program lays the work out."""

import sys

from fmbench.counts import PEAK_F32_OPS, flops_per_row


def read(run):
    fits = run.record.get("fits")
    if not fits:
        return None
    s = run.shape
    flops = (flops_per_row(s["factors"], s["max_samples"],
                           s["if_nnz_per_item"])
             * s["rows"] * run.record["epochs"] * len(fits))
    share = 100.0 * flops / run.record["wall_s"] / PEAK_F32_OPS
    print(f"fit.mfu {share!r}% of {PEAK_F32_OPS:.3g} FLOP/s; card "
          f"{run.card}", file=sys.stderr)
    return share
