"""The work of a fit, counted from the configuration's shapes, and the
card's peaks: what ``fit.mfu`` and ``b1_roofline`` divide by. Counted the
same whatever window, chunk or block the program chooses.

- operations per training row and epoch: ``2 F (M + 1)`` for the utilities
  of the positive and of at most ``M`` scored negatives, the same again for
  each nonzero item feature of an item, and ``6 F`` for the update;
- bytes per epoch of the fused kernel: the user, item and item-feature
  tables read once and written once (``F`` floats a user row, ``F + 1`` an
  item or feature row), the records (user, item, weight: 12 bytes a row)
  and the history (a 4-byte item id per distinct pair, and the users'
  offsets) read once.

Peaks: the card's data sheet (H100 SXM: f32 outside the tensor cores, the
tables' precision, 67 TFLOP/s; HBM3, 3.35 TB/s)."""

PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12


def flops_per_row(factors, max_samples, if_nnz_per_item):
    return (2 * factors * (max_samples + 1) * (1 + if_nnz_per_item)
            + 6 * factors)


def bytes_per_epoch(U, I, F, Q, rows, nnz_hist):
    tables = 4 * (U * F + (I + Q) * (F + 1))
    return 2 * tables + 12 * rows + 4 * nnz_hist + 4 * (U + 1)
