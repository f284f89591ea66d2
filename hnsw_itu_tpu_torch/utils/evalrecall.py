"""Recall@k evaluation (numpy only; a copy of
hnsw_itu_tpu/utils/evalrecall.py::recall_at_k, so the port needs no JAX)."""

from __future__ import annotations

import numpy as np


def recall_at_k(result_ids, truth_ids, k: int | None = None) -> float:
    """Mean |result ∩ truth| / k per query. Arrays are [nq, >=k] id matrices
    (any base, as long as both use the same).

    Vectorized: sort each truth row and binary-search the result ids into
    it (one searchsorted pass for the whole matrix); duplicate ids within a
    row — only the padding sentinel can repeat — are counted once."""
    result_ids = np.asarray(result_ids)
    truth_ids = np.asarray(truth_ids)
    if k is None:
        k = result_ids.shape[1]
    nq = result_ids.shape[0]
    if nq == 0:
        return 0.0
    # sort result rows and blank within-row duplicates so each id counts once
    r = np.sort(result_ids[:, :k].astype(np.int64), axis=1)
    r[:, 1:][r[:, 1:] == r[:, :-1]] = -1
    t = np.sort(truth_ids[:, :k].astype(np.int64), axis=1)
    # row-offset both sides into one flat sorted space so a single
    # searchsorted handles every query at once
    span = max(int(t.max()), int(r.max()), 0) + 2
    off = (np.arange(nq, dtype=np.int64) * span)[:, None]
    flat_t = (t + off).ravel()
    flat_r = np.where(r >= 0, r + off, -1).ravel()
    pos = np.searchsorted(flat_t, flat_r)
    hit = (flat_r >= 0) & (pos < flat_t.size) & (
        flat_t[np.minimum(pos, flat_t.size - 1)] == flat_r
    )
    return int(hit.sum()) / (nq * k)
