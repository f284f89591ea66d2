"""What decides ``correct``: answers and graphs held to the plain
reference (``exact.py``, ``graph.py``).

Each check returns numbers that are compared with limits; a run is
correct when every number is at most its limit.
"""

from __future__ import annotations

import torch

from .exact import INF, hamming


def bad_answer_rows(points, queries, ids, dists, n: int) -> int:
    """Query rows whose answer is not k distinct ids in [0, n), ascending
    by distance, each with its exact Hamming distance."""
    ids = torch.as_tensor(ids, device=points.device)
    dists = torch.as_tensor(dists, device=points.device)
    valid = (ids >= 0) & (ids < n)
    d = hamming(points, queries, torch.where(valid, ids, 0))
    ok = valid.all(1) & (d == dists).all(1)
    ok &= (dists[:, 1:] >= dists[:, :-1]).all(1)
    s = torch.sort(ids, dim=1).values
    ok &= (s[:, 1:] != s[:, :-1]).all(1)
    return int((~ok).sum())


def recall(ids, gt_ids) -> torch.Tensor:
    """Per-query id-set recall@k of ``ids`` against the exact ``gt_ids``
    (float64[B]); slots of ``gt_ids`` past the population do not count."""
    ids = torch.as_tensor(ids, device=gt_ids.device).long()
    gt = gt_ids.long()
    hit = (ids[:, :, None] == gt[:, None, :]) & (gt[:, None, :] != INF)
    found = hit.any(1).sum(1).double()
    return found / (gt != INF).sum(1).clamp(min=1).double()
