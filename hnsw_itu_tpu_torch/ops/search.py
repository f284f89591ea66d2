"""Beam searches, plain PyTorch (port of hnsw_itu_tpu/ops/search.py).

Two functions, each the plain version of one CUDA kernel: the function the
kernel computes, written as whole-batch tensor steps. The kernel's wrapper
runs it for CPU tensors; the tests hold it against the JAX reference, and
``chip_smoke.py`` holds the kernel against it on the card. Both take an
optional ``stats`` dict that accumulates ``rows`` (expansions) and
``edges`` (valid neighbors read), the data-dependent work that bounds the
kernels' memory traffic.

``beam_search_packed`` (kernel ``csrc/fused_beam_search.cu``) is
``_beam_search_packed`` with ``expand=1``, ``dedup="beam"`` and
``tie_bits=0``, batched over queries as a Python step loop with a
per-query done mask (the JAX package's ``vmap`` of a ``while_loop``):

* the beam holds ``ef`` int32 keys ``(d << id_bits) | id``, ascending,
  with one "expanded" flag per slot; ``KEY_INF = (max_d + 1) << id_bits``
  fills empty slots;
* a step expands the best unexpanded key, reads the node's neighbor ids
  and neighbor sketches from its fused-table row, and makes candidate
  keys, with distances clamped to ``max_d`` as the kernel clamps them;
* a candidate equal to a beam key, or to an earlier candidate, is a
  duplicate: it is dropped and not counted in ``visited``;
* the rest merge into the beam, which is cut back to ``ef``;
* a query stops when no unexpanded key is below ``KEY_INF`` (and at most
  ``beam[ef-1]``), or after ``max_steps`` expansions.

``beam_search_two_plane`` (kernel ``csrc/mini_beam_search.cu``) is the
two-key branch of ``beam_search`` (``:126-252``) with ``expand=1`` and
``dedup="beam"``, run on the mini table's prefix sketches
(``ops/mini_search.py``): the contract the JAX package holds its TPU mini
kernels to (``tests/test_dma_search.py::test_mini_matches_xla_on_prefix``).

``beam_search_gather`` (kernel ``csrc/dma_beam_search.cu``) is the same
two-key search over a plain adjacency array, each neighbor's full sketch
gathered from the point array (through a node map on the upper HNSW
levels): the build's search, and the function of the JAX package's
``dma_beam_search``.
"""

from __future__ import annotations

import torch

from .metrics import popcount_sum


def _count(stats, live, ok) -> None:
    if stats is not None:
        stats["rows"] = stats.get("rows", 0) + int(live.sum())
        stats["edges"] = stats.get("edges", 0) + int(ok.sum())


def beam_search_packed(ids: torch.Tensor, data: torch.Tensor,
                       queries: torch.Tensor, init_keys: torch.Tensor, *,
                       ef: int, id_bits: int, max_d: int, max_steps: int,
                       stats: dict | None = None):
    """Search every query from its packed entry key.

    Args:
      ids: int32[cap, W] neighbor ids per node, < 0 = no edge.
      data: int32[cap, W, words] the neighbors' sketches per node.
      queries: int32[B, words].
      init_keys: int32[B] packed entry keys (distance pre-clamped).
      ef: beam width.
      id_bits: bits of the id field of a key.
      max_d: distance clamp; KEY_INF = (max_d + 1) << id_bits.
      max_steps: expansion bound per query.
      stats: optional dict; accumulates ``rows`` and ``edges`` read.

    Returns (keys int32[B, ef], visited int32[B], steps int32[B]).
    """
    dev = queries.device
    B = queries.shape[0]
    cap, W = ids.shape
    kinf = (max_d + 1) << id_bits
    mask = (1 << id_bits) - 1
    bk = torch.full((B, ef), kinf, dtype=torch.int32, device=dev)
    bk[:, 0] = init_keys
    bx = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    vis = torch.ones(B, dtype=torch.int32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    is_cand = torch.cat([torch.zeros(ef, dtype=torch.bool, device=dev),
                         torch.ones(W, dtype=torch.bool, device=dev)])
    q = queries.unsqueeze(1)  # [B, 1, words]
    for _ in range(max_steps):
        frontier = (~bx) & (bk < kinf) & (bk <= bk[:, ef - 1 : ef])
        live = frontier.any(dim=1)
        if not bool(live.any()):
            break
        # beam is sorted: the first unexpanded slot holds the best key
        pos = frontier.to(torch.int8).argmax(dim=1)
        bx[rows, pos] = bx[rows, pos] | live
        steps += live.to(torch.int32)
        e = (bk[rows, pos] & mask).clamp(max=cap - 1).long()

        nbr = ids[e]  # [B, W]
        cd = popcount_sum(data[e] ^ q).clamp(max=max_d)  # [B, W]
        ok = (nbr >= 0) & live[:, None]
        _count(stats, live, ok)
        ck = torch.where(ok, (cd << id_bits) | nbr, kinf)

        mk = torch.cat([bk, ck], dim=1)
        mx = torch.cat([bx, torch.zeros_like(ck, dtype=torch.bool)], dim=1)
        # sort by (key, not-expanded): equal keys sit together with the
        # expanded (or the beam's) copy first; every later copy is a dup
        o = torch.argsort(mk.to(torch.int64) * 2 + (~mx).to(torch.int64),
                          dim=1, stable=True)
        mk, mx = mk.gather(1, o), mx.gather(1, o)
        cand = is_cand.expand(B, -1).gather(1, o)
        dup = torch.zeros_like(mx)
        dup[:, 1:] = mk[:, 1:] == mk[:, :-1]
        vis += ((~dup) & cand & (mk < kinf)).sum(dim=1, dtype=torch.int32)
        mk = torch.where(dup, kinf, mk)
        mx = mx & ~dup
        o = torch.argsort(mk, dim=1, stable=True)[:, :ef]
        bk, bx = mk.gather(1, o), mx.gather(1, o)
    return bk, vis, steps


def beam_search_two_plane(table: torch.Tensor, queries: torch.Tensor,
                          init_keys: torch.Tensor, *, ef: int,
                          max_steps: int, tie_bits: int = 0,
                          stats: dict | None = None):
    """Search every query over the mini table from its seed keys.

    Args:
      table: int32[cap, W, 1 + mw] the mini table (``ops/mini_search.py``).
      queries: int32[B, words >= mw]; the first mw words are used.
      init_keys: int64[B, E] seed keys ``d << 32 | id`` (prefix distance,
        tie-encoded id), ascending and distinct; E <= ef.
      ef: beam width.
      max_steps: expansion bound per query.
      tie_bits: > 0 holds ``bitrev_ids(id, tie_bits)`` in the id plane.
      stats: optional dict; accumulates ``rows`` and ``edges`` read.

    Returns (keys int64[B, ef], visited int32[B], steps int32[B]); keys
    are ascending, empty slots ``KEY_INF``, ids tie-encoded.

    Per step, as the XLA two-key merge does: expand the best unexpanded
    key; candidates are the row's valid neighbors with their prefix
    distances; a candidate whose id is in the beam, or repeats an earlier
    candidate of the row, is a duplicate (dropped, not counted in
    ``visited``); the rest merge into the beam, cut back to ``ef``.
    ``visited`` starts at the number of seeds.
    """
    from .mini_search import IINF, KEY_INF, bitrev_ids

    dev = queries.device
    B, E = init_keys.shape
    cap, W, mv = table.shape
    low = 0xFFFFFFFF
    bk = torch.full((B, ef), KEY_INF, dtype=torch.int64, device=dev)
    bk[:, :E] = init_keys
    bx = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    vis = ((init_keys & low) < IINF).sum(dim=1, dtype=torch.int32)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    is_cand = torch.cat([torch.zeros(ef, dtype=torch.bool, device=dev),
                         torch.ones(W, dtype=torch.bool, device=dev)])
    q = queries[:, None, : mv - 1]  # [B, 1, mw]
    for _ in range(max_steps):
        frontier = (~bx) & (bk < KEY_INF) & (bk <= bk[:, ef - 1 : ef])
        live = frontier.any(dim=1)
        if not bool(live.any()):
            break
        # beam is sorted: the first unexpanded slot holds the best key
        pos = frontier.to(torch.int8).argmax(dim=1)
        bx[rows, pos] = bx[rows, pos] | live
        steps += live.to(torch.int32)
        e = bk[rows, pos] & low
        if tie_bits:
            e = bitrev_ids(e.clamp(max=(1 << tie_bits) - 1), tie_bits)
        r = table[e.clamp(max=cap - 1)]  # [B, W, 1 + mw]
        nbr = r[:, :, 0]
        cd = popcount_sum(r[:, :, 1:] ^ q).to(torch.int64)  # [B, W]
        ok = (nbr >= 0) & live[:, None]
        _count(stats, live, ok)
        if tie_bits:
            nbr = bitrev_ids(nbr, tie_bits)
        ck = torch.where(ok, (cd << 32) | nbr.to(torch.int64), KEY_INF)
        bk, bx, fresh = _merge_by_id(bk, bx, ck, is_cand, ef)
        vis += fresh
    return bk, vis, steps


def _merge_by_id(bk, bx, ck, is_cand, ef: int):
    """The XLA two-key merge (``ops/search.py:222-244`` of the JAX
    package): candidate keys ``ck`` int64[B, C] (``KEY_INF`` = none) into
    the beam ``bk``/``bx`` [B, ef]. A candidate whose id is in the beam, or
    repeats an earlier candidate, is a duplicate. Returns (beam keys, beam
    flags, int32[B] fresh candidates)."""
    from .mini_search import IINF, KEY_INF

    B = bk.shape[0]
    mk = torch.cat([bk, ck], dim=1)
    mx = torch.cat([bx, torch.zeros_like(ck, dtype=torch.bool)], dim=1)
    # sort by (id, not-expanded): equal ids sit together with the
    # expanded (or the beam's) copy first; every later copy is a dup
    mi = mk & 0xFFFFFFFF
    o = torch.argsort(mi * 2 + (~mx).to(torch.int64), dim=1, stable=True)
    mk, mx, mi = mk.gather(1, o), mx.gather(1, o), mi.gather(1, o)
    cand = is_cand.expand(B, -1).gather(1, o)
    dup = torch.zeros_like(mx)
    dup[:, 1:] = mi[:, 1:] == mi[:, :-1]
    fresh = ((~dup) & cand & (mi < IINF)).sum(dim=1, dtype=torch.int32)
    mk = torch.where(dup, KEY_INF, mk)
    mx = mx & ~dup
    o = torch.argsort(mk, dim=1, stable=True)[:, :ef]
    return mk.gather(1, o), mx.gather(1, o), fresh


def beam_search_gather(adj: torch.Tensor, points: torch.Tensor,
                       node_map: torch.Tensor | None, queries: torch.Tensor,
                       init_d: torch.Tensor, init_i: torch.Tensor, *,
                       ef: int, max_steps: int, stats: dict | None = None):
    """Search every query over an adjacency array, gathering each
    neighbor's point: the XLA ``beam_search(..., dedup="beam", expand=1)``
    of the JAX package for an index without a table (the build's search).

    Args:
      adj: int32[cap, W] neighbor ids per node, < 0 = no edge.
      points: int32[cap_pts, words] sketches.
      node_map: int32[>= cap] graph-local id -> point row, or None for the
        identity (the base layer; the upper HNSW levels map).
      queries: int32[B, words].
      init_d / init_i: int32[B] or [B, E] seed distances and (graph-local)
        ids, E distinct seeds per query, any order.
      ef: beam width.
      max_steps: expansion bound per query.
      stats: optional dict; accumulates ``rows`` and ``edges`` read.

    Returns (keys int64[B, ef], visited int32[B], steps int32[B]); keys
    ``d << 32 | id`` ascending, empty slots ``KEY_INF``. Per step, as the
    XLA two-key merge does: expand the best unexpanded key; candidates are
    the row's valid neighbors (ids >= 0) with their distances; a candidate
    whose id is in the beam, or repeats an earlier candidate of the row, is
    a duplicate (dropped, not counted in ``visited``); the rest merge into
    the beam, cut back to ``ef``. ``visited`` starts at the number of
    seeds.
    """
    from .mini_search import IINF, KEY_INF, seed_keys

    dev = queries.device
    init_keys = seed_keys(init_d, init_i, 0)
    B, E = init_keys.shape
    cap, W = adj.shape
    low = 0xFFFFFFFF
    bk = torch.full((B, ef), KEY_INF, dtype=torch.int64, device=dev)
    bk[:, :E] = init_keys
    bx = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    vis = ((init_keys & low) < IINF).sum(dim=1, dtype=torch.int32)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    is_cand = torch.cat([torch.zeros(ef, dtype=torch.bool, device=dev),
                         torch.ones(W, dtype=torch.bool, device=dev)])
    q = queries[:, None, :]  # [B, 1, words]
    for _ in range(max_steps):
        frontier = (~bx) & (bk < KEY_INF) & (bk <= bk[:, ef - 1 : ef])
        live = frontier.any(dim=1)
        if not bool(live.any()):
            break
        # beam is sorted: the first unexpanded slot holds the best key
        pos = frontier.to(torch.int8).argmax(dim=1)
        bx[rows, pos] = bx[rows, pos] | live
        steps += live.to(torch.int32)
        e = (bk[rows, pos] & low).clamp(max=cap - 1)
        nbr = adj[e]  # [B, W]
        g = nbr.long().clamp(0, cap - 1)
        if node_map is not None:
            g = node_map[g].long()
        cd = popcount_sum(points[g.clamp(0, points.shape[0] - 1)] ^ q)
        ok = (nbr >= 0) & live[:, None]
        _count(stats, live, ok)
        ck = torch.where(ok, (cd.to(torch.int64) << 32) | nbr.to(torch.int64),
                         KEY_INF)
        bk, bx, fresh = _merge_by_id(bk, bx, ck, is_cand, ef)
        vis += fresh
    return bk, vis, steps
