"""Offline ranking-metric evaluation — same function signatures and metric
definitions as the reference (etlundquist/rankfm, `rankfm/evaluation.py:9-175`).

All metrics share one shape: build a test user -> item-set mapping, generate
top-k recommendations with ``cold_start='drop'``, then aggregate per-user.
Unlike the reference (per-user Python set intersections), the aggregation is
a vectorized membership matrix, so each metric is one `recommend` call +
O(users * k) numpy. Each standalone function retrieves independently (the
reference contract); use :func:`compute` to evaluate many metrics off a
SINGLE retrieval pass — ~5x cheaper for the usual 5-metric report.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from rankfm_tpu_torch.utils.data import get_data


def _test_user_items(test_interactions):
    df = pd.DataFrame(get_data(test_interactions), columns=["user_id", "item_id"])
    return df.groupby("user_id")["item_id"].apply(set).to_dict()


def _recs_and_hits(model, test_interactions, k, filter_previous):
    """common core: top-k recs for test users + per-user hit mask [n_users, k]
    (plus the recs themselves, which `diversity` aggregates instead of hits)

    Membership is fully vectorized: test pairs and recommendation cells are
    encoded as (user-row, item-code) int64 keys over a shared item
    vocabulary, and the hit mask is one `np.searchsorted` pass —
    O((T + U*k) log T) with no per-row Python, so million-user test sets
    evaluate in seconds (the reference loops Python sets per user,
    `evaluation.py:32`)."""
    assert model.is_fit, "you must fit the model prior to evaluating hold-out metrics"
    test_user_items = _test_user_items(test_interactions)
    test_users = list(test_user_items.keys())
    # cold_start='nan' + drop only ALL-NaN rows, NOT the reference's
    # cold_start='drop': this package defines exhausted filter_previous
    # slots as NaN (the reference returns uninitialized memory there,
    # `_rankfm.pyx:448-456`), so a row-wise dropna would silently remove
    # KNOWN users with fewer than k unseen items from the metric. Unknown
    # users produce all-NaN rows — dropping exactly those matches the
    # reference's user coverage; partial NaN slots count as misses.
    test_recs = model.recommend(
        users=test_users, n_items=k, filter_previous=filter_previous,
        cold_start="nan"
    )
    test_recs = test_recs[~test_recs.isna().all(axis=1).values]
    comm_users = test_recs.index.values
    rec_np = test_recs.to_numpy()          # rows align with comm_users
    # recommend clamps its column count to the catalog size, so reshape to
    # what actually came back (k > I would otherwise crash every metric);
    # NaN cells (exhausted filter_previous slots) count as misses
    k_eff = rec_np.shape[1]

    df = pd.DataFrame(get_data(test_interactions), columns=["user_id", "item_id"])
    rec_flat = pd.Series(rec_np.ravel())
    # shared vocabulary over both sides: pd.concat unifies dtypes (int test
    # ids vs a float/object rec column when NaN slots are present) so id
    # equality matches the reference's Python-set semantics
    vocab = pd.Index(pd.unique(pd.concat(
        [df["item_id"], rec_flat.dropna()], ignore_index=True)))
    n_codes = np.int64(len(vocab) + 1)
    upos = pd.Index(comm_users).get_indexer(df["user_id"]).astype(np.int64)
    icode = vocab.get_indexer(df["item_id"]).astype(np.int64)
    pair_ok = (upos >= 0) & (icode >= 0)   # drop cold-start users' test rows
    test_keys = np.unique(upos[pair_ok] * n_codes + icode[pair_ok])

    rec_codes = vocab.get_indexer(rec_flat).astype(np.int64)  # NaN cell -> -1
    rows = np.repeat(np.arange(len(comm_users), dtype=np.int64), k_eff)
    cell_keys = rows * n_codes + rec_codes
    hits = np.zeros(len(cell_keys), dtype=bool)
    valid = rec_codes >= 0
    if len(test_keys) and valid.any():
        pos = np.searchsorted(test_keys, cell_keys[valid])
        pos = np.minimum(pos, len(test_keys) - 1)
        hits[valid] = test_keys[pos] == cell_keys[valid]
    hits = hits.reshape(len(comm_users), k_eff)
    return test_recs, comm_users, hits, test_user_items


def _agg_hit_rate(comm, hits, tui, k):
    return float(np.mean(hits.any(axis=1)))


def _agg_reciprocal_rank(comm, hits, tui, k):
    any_hit = hits.any(axis=1)
    first = np.argmax(hits, axis=1)
    return float(np.mean(np.where(any_hit, 1.0 / (first + 1), 0.0)))


def _agg_dcg(comm, hits, tui, k):
    gains = hits / np.log2(np.arange(hits.shape[1]) + 2)[None, :]
    return float(np.mean(gains.sum(axis=1)))


def _agg_precision(comm, hits, tui, k):
    # divide by the REQUESTED k, not the effective column count. The
    # reference divides by the length of each user's recommendation list,
    # and its recommend always returns k columns, so its divisor is
    # effectively k; a 5-item catalog at k=10 therefore caps precision at
    # 0.5. Pinned for the JAX package by
    # tests/test_rankfm.py::test_precision_small_catalog_divides_by_k.
    return float(np.mean(hits.sum(axis=1) / k))


def _agg_recall(comm, hits, tui, k):
    denom = np.array([len(tui[u]) for u in comm], dtype=np.float64)
    return float(np.mean(hits.sum(axis=1) / denom))


_AGGREGATORS = {
    "hit_rate": _agg_hit_rate,
    "reciprocal_rank": _agg_reciprocal_rank,
    "discounted_cumulative_gain": _agg_dcg,
    "precision": _agg_precision,
    "recall": _agg_recall,
}


def _agg_diversity(model, test_recs, comm):
    """vectorized diversity aggregation (`evaluation.py:146-175` semantics):
    one `value_counts` over the flattened rec cells (NaN cells from exhausted
    filter_previous catalogs simply count nowhere), reindexed to the FULL
    training catalog, sorted by user count descending."""
    rec_flat = pd.Series(test_recs.to_numpy().ravel()).dropna()
    user_counts = (
        rec_flat.value_counts()
        .reindex(model.item_id.values, fill_value=0)
        .rename_axis("item_id")
        .to_frame("cnt_users")
        .sort_values("cnt_users", ascending=False)
        .reset_index()
    )
    user_counts["pct_users"] = user_counts["cnt_users"] / len(comm)
    return user_counts


def compute(model, test_interactions, metrics=None, k=10, filter_previous=False):
    """Evaluate several ranking metrics off ONE shared retrieval pass.

    ``metrics`` is an iterable of metric names (default: the five scalar
    metrics); returns a ``{name: value}`` dict. Identical definitions to the
    standalone functions (and the reference's `evaluation.py:9-175`), but the
    expensive `model.recommend` call runs once instead of once per metric.
    ``"diversity"`` may be requested too — its value is the per-item user
    count DataFrame rather than a scalar.
    """
    metrics = tuple(_AGGREGATORS) if metrics is None else tuple(metrics)
    known = set(_AGGREGATORS) | {"diversity"}
    unknown = [m for m in metrics if m not in known]
    assert not unknown, f"unknown metrics {unknown}; choose from {sorted(known)}"
    recs, comm, hits, tui = _recs_and_hits(model, test_interactions, k, filter_previous)
    return {m: _agg_diversity(model, recs, comm) if m == "diversity"
            else _AGGREGATORS[m](comm, hits, tui, k) for m in metrics}


def hit_rate(model, test_interactions, k=10, filter_previous=False):
    """proportion of test users with at least one relevant recommended item
    (`evaluation.py:9-33`)"""
    return compute(model, test_interactions, ("hit_rate",), k,
                   filter_previous)["hit_rate"]


def reciprocal_rank(model, test_interactions, k=10, filter_previous=False):
    """mean inverse rank of the first relevant recommended item
    (`evaluation.py:36-61`)"""
    return compute(model, test_interactions, ("reciprocal_rank",), k,
                   filter_previous)["reciprocal_rank"]


def discounted_cumulative_gain(model, test_interactions, k=10, filter_previous=False):
    """mean sum of 1/log2(rank+2) over relevant recommended items
    (`evaluation.py:64-89`)"""
    return compute(model, test_interactions, ("discounted_cumulative_gain",),
                   k, filter_previous)["discounted_cumulative_gain"]


def precision(model, test_interactions, k=10, filter_previous=False):
    """mean |relevant ∩ recommended| / k (`evaluation.py:92-116`)"""
    return compute(model, test_interactions, ("precision",), k,
                   filter_previous)["precision"]


def recall(model, test_interactions, k=10, filter_previous=False):
    """mean |relevant ∩ recommended| / |relevant| (`evaluation.py:119-143`)"""
    return compute(model, test_interactions, ("recall",), k,
                   filter_previous)["recall"]


def diversity(model, test_interactions, k=10, filter_previous=False):
    """cnt/pct of users recommended each unique item (`evaluation.py:146-175`);
    shares the retrieval pass and vectorized aggregation with :func:`compute`
    (pre-round-4 this ran its own `recommend` + a pandas stack/groupby)"""
    return compute(model, test_interactions, ("diversity",), k,
                   filter_previous)["diversity"]
