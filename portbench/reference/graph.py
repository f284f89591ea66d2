"""The plain reference's view of a built graph: its invariants, and a
beam search over it that uses nothing of the program.

A padded adjacency ``adj`` int32[rows, M] with degrees ``deg`` int32[rows]
is sound over its first ``n`` rows when each of them holds 1 to M
neighbors in its first ``deg`` slots, each in [0, n), none itself, none
twice, and -1 in every other slot; rows from ``n`` on hold nothing.

A graph built at full precision links a row to its nearest earlier row
whenever its build search finds that row: the neighbor selection keeps
the nearest candidate first. ``nearest_gaps`` measures how often it does.
"""

from __future__ import annotations

import torch

from .exact import INF, exact_topk, hamming


def bad_rows(adj: torch.Tensor, deg: torch.Tensor, n: int,
             block: int = 1 << 20) -> int:
    """Rows of ``adj`` that break the invariants above."""
    rows, M = adj.shape
    col = torch.arange(M, device=adj.device)
    bad = 0
    for s in range(0, rows, block):
        a = adj[s : s + block].long()
        g = deg[s : s + block].long()
        ids = torch.arange(s, s + a.shape[0], device=adj.device)
        live = ids < n
        inside = col < g[:, None]
        ok = torch.where(inside, (a >= 0) & (a < n) & (a != ids[:, None]),
                         a == -1).all(1)
        srt = torch.sort(torch.where(inside, a, -1 - col), dim=1).values
        ok &= (srt[:, 1:] != srt[:, :-1]).all(1)
        ok &= torch.where(live, (g >= 1) & (g <= M), g == 0)
        bad += int((~ok).sum())
    return bad


def strided_entry(points, queries, n: int, sample: int) -> torch.Tensor:
    """Per query, the nearest of ``sample`` rows strided evenly over
    [0, n) (ties to the lower sample position)."""
    ids = (torch.arange(sample, device=points.device, dtype=torch.int64)
           * n // sample).clamp(max=n - 1)
    best = torch.zeros(queries.shape[0], dtype=torch.int64,
                       device=points.device)
    best_d = torch.full_like(best, INF)
    for s in range(0, sample, 4096):
        cand = ids[s : s + 4096].expand(queries.shape[0], -1)
        d = hamming(points, queries, cand).long()
        j = torch.argmin(d, dim=1)
        dj = d.gather(1, j[:, None])[:, 0]
        take = dj < best_d
        best = torch.where(take, cand.gather(1, j[:, None])[:, 0], best)
        best_d = torch.where(take, dj, best_d)
    return best.to(torch.int32)


def beam_search(points, adj, queries, entry, *, n: int, ef: int, k: int,
                max_steps: int):
    """Best-first beam search of width ``ef`` over the first ``n`` rows:
    expand the nearest unexpanded node of each query's beam, add its
    neighbors not already in the beam, keep the ``ef`` best by (distance,
    id), until every beam entry is expanded or ``max_steps`` expansions.
    Returns (dists, ids) int32[B, k]."""
    B, dev = queries.shape[0], points.device
    key_inf = (INF << 32) | INF
    d0 = hamming(points, queries, entry[:, None].long())
    key = torch.full((B, ef), key_inf, dtype=torch.int64, device=dev)
    key[:, 0] = (d0[:, 0].long() << 32) | entry.long()
    done = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    rowsel = torch.arange(B, device=dev)
    for _ in range(max_steps):
        open_ = (~done) & (key != key_inf)
        if not bool(open_.any()):
            break
        j = torch.argmin(torch.where(open_, key, key_inf), dim=1)
        has = open_.any(1)
        done[rowsel, j] |= has
        node = (key[rowsel, j] & 0xFFFFFFFF).clamp(max=n - 1)
        nb = adj[node].long()
        nb = torch.where(has[:, None] & (nb >= 0) & (nb < n), nb, -1)
        ids = key & 0xFFFFFFFF
        seen = (nb[:, :, None] == ids[:, None, :]).any(2)
        dn = hamming(points, queries, torch.where(nb >= 0, nb, 0)).long()
        nk = torch.where((nb >= 0) & ~seen, (dn << 32) | nb.clamp(min=0),
                         key_inf)
        allk = torch.cat([key, nk], dim=1)
        alld = torch.cat([done, torch.zeros_like(nk, dtype=torch.bool)], 1)
        o = torch.argsort(allk, dim=1, stable=True)[:, :ef]
        key, done = allk.gather(1, o), alld.gather(1, o)
    top = key[:, :k]
    return ((top >> 32).to(torch.int32),
            torch.where(top == key_inf, INF, top & 0xFFFFFFFF)
            .to(torch.int32))


def nearest_gaps(points, adj, rows: torch.Tensor, limits: torch.Tensor):
    """Per row of ``rows``: the exact distance from the row to its nearest
    listed neighbor among the first ``limits[r]`` points, less its exact
    distance to the nearest of those points (int64; INF where the row
    lists none of them). ``limits[r]`` is the number of rows inserted
    before the row's chunk, which its build search could reach."""
    q = points[rows.long()]
    nb = adj[rows.long()].long()
    lim = limits.long()[:, None]
    nb = torch.where((nb >= 0) & (nb < lim), nb, -1)
    listed = hamming(points, q, nb).min(1).values.long()
    best, _ = exact_topk(points, q, 1, limits=limits.to(torch.int32))
    best = best[:, 0].long()
    return torch.where(listed == INF, INF, listed - best)
