"""Recall@k evaluation (numpy only; a copy of
hnsw_itu_tpu/utils/evalrecall.py, so the port needs no JAX). Ids are
1-based in result and ground-truth files (main.rs:277)."""

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


def recall_files(result_path, truth_path, k: int | None = None) -> float:
    """``recall_at_k`` of a result file's ``knns`` against a ground-truth
    file's."""
    from .dataset import BufferedDataset

    with BufferedDataset.open(result_path, "knns") as res:
        r = res.read_all()
    with BufferedDataset.open(truth_path, "knns") as tru:
        t = tru.read_all()
    if k is None:
        k = r.shape[1]
    return recall_at_k(r, t[:, : r.shape[1]], k)


def recall_tie_tolerant(result_dists, truth_dists, k: int | None = None
                        ) -> float:
    """Distance-threshold recall: a returned neighbor counts as a hit iff
    its true distance is at most the oracle's k-th distance. Id-set recall
    undercounts when the k boundary falls inside a set of equal distances
    and the index breaks ties otherwise than the oracle (as after a BFS
    reorder); this one does not.

    Args:
      result_dists: [nq, >=k] true distances of the returned neighbors.
      truth_dists: [nq, >=k] oracle distances, ascending.
    """
    result_dists = np.asarray(result_dists)
    truth_dists = np.asarray(truth_dists)
    if k is None:
        k = result_dists.shape[1]
    nq = result_dists.shape[0]
    if nq == 0:
        return 0.0
    thresh = truth_dists[:, k - 1 : k].astype(np.int64)
    hits = (result_dists[:, :k].astype(np.int64) <= thresh).sum()
    return int(hits) / (nq * k)
