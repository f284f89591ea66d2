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

``batched_beam_search`` (and ``greedy_search`` on it) is of another kind:
the port of the JAX package's XLA search, no kernel's yardstick. It takes
any ``ef``, ``expand``, adjacency width and capacity, both dedup modes
and both of the JAX key branches, and runs as plain PyTorch on CPU and
CUDA tensors alike. It serves what the kernels cannot: the build's
searches past kernel #6's limits, the query-time greedy descent on wide
levels, and queries no table serves (``models/hnsw.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.instrument import masked, sync
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


# -- the general beam search (port of the XLA search, not of a kernel) -------

ID_INF = 0x7FFFFFFF  # the empty id slot (``models/base.py`` ID_INF)


class SearchResult(NamedTuple):
    """Fixed-shape search output, as in the JAX package: [B, ef] ascending
    (distance, id), padded with (``metric.inf``, ``ID_INF``); ``visited``
    and ``steps`` int32[B]."""

    dists: torch.Tensor
    ids: torch.Tensor
    visited: torch.Tensor
    steps: torch.Tensor


def _tie_enc(ids: torch.Tensor, tie_bits: int, valid) -> torch.Tensor:
    """Bit-reversed ids where ``valid`` (an involution: also the decode)."""
    if not tie_bits:
        return ids
    from .mini_search import bitrev_ids

    return torch.where(valid, bitrev_ids(ids, tie_bits), ids)


def _sort2(k1: torch.Tensor, k2: torch.Tensor, *rest: torch.Tensor):
    """Stable sort of each row by (k1, k2), the other tensors carried
    along: two stable planes (by k2, then by k1), so keys of any dtype
    sort without packing them into one integer."""
    o = torch.argsort(k2, dim=1, stable=True)
    o = o.gather(1, torch.argsort(k1.gather(1, o), dim=1, stable=True))
    return [t.gather(1, o) for t in (k1, k2, *rest)]


def _first_dup(x: torch.Tensor) -> torch.Tensor:
    """bool mask of the entries equal to their left neighbor in a row."""
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[:, 1:] = x[:, 1:] == x[:, :-1]
    return dup


def _select(bx: torch.Tensor, finite: torch.Tensor, E: int):
    """The E best unexpanded beam slots (the beam is sorted): their mask,
    and their positions int64[b, E] ascending, padded with ``ef + 1``
    (the JAX cumsum rank and ``top_k``)."""
    ef = bx.shape[1]
    unexp = ~bx
    rank = unexp.to(torch.int32).cumsum(dim=1) - 1
    sel = unexp & (rank < E) & finite
    pos = torch.arange(ef, device=bx.device).expand_as(bx)
    score = torch.where(sel, pos, ef + 1)
    return sel, score.sort(dim=1).values[:, :E]


def _run(state: dict, live_fn, step_fn, max_steps: int,
         outputs: tuple[str, ...]) -> dict:
    """Step every query until it stops: ``live_fn(state)`` -> bool[b],
    ``step_fn(state)`` advances every row of ``state`` once. A query
    leaves the working set (its ``outputs`` rows are written out) when it
    stops, so later steps touch only the queries still running. Every
    value of ``state`` is a tensor with the batch as dimension 0. Each
    step's tests and boolean indexes make the host wait for the card, in
    ``sync`` ranges (``utils/instrument.py``)."""
    q = state["q"]
    out = {k: torch.empty_like(state[k]) for k in outputs}
    act = torch.arange(q.shape[0], device=q.device)
    for step in range(max_steps + 1):
        live = live_fn(state) if step < max_steps else \
            torch.zeros_like(act, dtype=torch.bool)
        with sync():
            done = not bool(live.all())
        if done:
            fin = ~live
            rows = masked(act, fin)
            for k in outputs:
                out[k][rows] = masked(state[k], fin)
            with sync():
                stop = not bool(live.any())
            if stop:
                break
            state = {k: masked(v, live) for k, v in state.items()}
            act = masked(act, live)
        step_fn(state)
        state["steps"] += 1
    return out


def batched_beam_search(get_points, adj: torch.Tensor, queries: torch.Tensor,
                        eps, *, ef: int, metric, capacity: int,
                        expand: int = 1, max_steps: int = 2048,
                        dedup: str = "bitmask",
                        tie_bits: int = 0) -> SearchResult:
    """The JAX ``batched_beam_search`` (``hnsw_itu_tpu/ops/search.py``
    ``beam_search`` over a batch): search one graph layer for every query,
    bit for bit the JAX contract on dists, ids, visited and steps.

    Args:
      get_points: ids (int64 tensor, clamped in range) -> points
        [..., words] of the same leading shape.
      adj: int32[>= capacity, W] padded adjacency; entries < 0 are "no edge".
      queries: [B, words].
      eps: int32[B] entries, or int32[B, E0] distinct seeds per query
        (E0 <= ef).
      ef: beam width (result size).
      metric: the JAX ``Metric`` interface (``ops/metrics.py`` Hamming).
      expand: E, the unexpanded beam entries expanded per step (C = E * W
        candidates); a beam holds at most ``ef``, so E is cut to ef (the
        JAX ``top_k`` refuses E > ef).
      max_steps: expansion bound per query.
      dedup: "bitmask" keeps one visited bit-vector per query
        (``ops/bitset.py``, int32[B, ceil(capacity / 32)]); "beam" dedups
        by id inside the merge.
      tie_bits: > 0 orders equal distances by bit-reversed id.

    The JAX ``get_nbr_pts`` (inline neighbor rows) is not ported: those
    rows are a TPU memory layout that changes where points are read, never
    which, and its one effect on results is that it forces
    ``dedup="beam"``, which callers pass instead.

    Two branches, as in JAX: the packed int32 key ``(d << id_bits) | id``
    when the metric has a ``max_distance``, ``dedup == "beam"`` and the key
    fits 31 bits; else the two-key ``(d, id)`` merge, sorted as two stable
    planes. Queries run as a step loop over the batch; each stops when no
    unexpanded entry is left or after ``max_steps`` expansions, and then
    leaves the working set.
    """
    if dedup not in ("bitmask", "beam"):
        raise ValueError(f"unknown dedup {dedup!r}")
    if tie_bits and capacity > (1 << tie_bits):
        raise ValueError(f"capacity={capacity} > 2**tie_bits")
    if ef < 1:
        raise ValueError(f"ef={ef} < 1")
    B = queries.shape[0]
    eps = (eps[:, None] if eps.dim() == 1 else eps).to(torch.int32)
    if eps.shape[0] != B or not 1 <= eps.shape[1] <= ef:
        raise ValueError(f"eps of shape {tuple(eps.shape)} for {B} queries "
                         f"at ef={ef}")
    kw = dict(ef=ef, metric=metric, capacity=capacity,
              E=max(1, min(expand, ef)), max_steps=max_steps,
              tie_bits=tie_bits)
    if dedup == "beam":
        max_d = metric.max_distance(queries)
        if max_d is not None:
            id_bits = max(1, (capacity - 1).bit_length())
            if id_bits + (max_d + 1).bit_length() <= 31:
                return _beam_packed(get_points, adj, queries, eps,
                                    max_d=max_d, id_bits=id_bits, **kw)
    return _beam_two_key(get_points, adj, queries, eps, dedup=dedup, **kw)


def _candidates(adj, sel_raw, ok, capacity, fill):
    """Neighbor ids [b, E * W] of the selected nodes, ``fill`` where a
    slot holds no edge or no node was selected."""
    nbr = adj[sel_raw.long().clamp(0, capacity - 1)]  # [b, E, W]
    nbr = torch.where((nbr >= 0) & ok[:, :, None], nbr, fill)
    return nbr.reshape(nbr.shape[0], -1)


def _beam_two_key(get_points, adj, qs, eps, *, ef, metric, capacity, E,
                  max_steps, dedup, tie_bits) -> SearchResult:
    """The two-key branch (``hnsw_itu_tpu/ops/search.py:126-252``)."""
    from . import bitset

    dev = qs.device
    B, E0 = eps.shape
    inf = metric.inf
    d0 = metric.one_to_many(qs, get_points(eps.long()))
    i0 = _tie_enc(eps, tie_bits, torch.ones_like(eps, dtype=torch.bool))
    d0, i0 = _sort2(d0, i0)
    state = {
        "q": qs,
        "bd": torch.full((B, ef), inf, dtype=metric.dist_dtype, device=dev),
        "bi": torch.full((B, ef), ID_INF, dtype=torch.int32, device=dev),
        "bx": torch.zeros((B, ef), dtype=torch.bool, device=dev),
        "nvis": torch.full((B,), E0, dtype=torch.int32, device=dev),
        "steps": torch.zeros(B, dtype=torch.int32, device=dev),
    }
    state["bd"][:, :E0] = d0
    state["bi"][:, :E0] = i0
    if dedup == "bitmask":
        state["vis"] = bitset.insert(
            bitset.make(capacity, (B,), device=dev), eps,
            torch.ones_like(eps, dtype=torch.bool))

    def live(s):
        bd = s["bd"]
        front = (~s["bx"]) & (bd <= bd[:, ef - 1 : ef]) & (bd < inf)
        return front.any(dim=1)

    def step(s):
        bd, bi, bx, q = s["bd"], s["bi"], s["bx"], s["q"]
        b = bd.shape[0]
        sel, pos = _select(bx, bd < inf, E)
        ok = pos < ef
        bx = bx | sel
        sel_ids = torch.where(ok, bi.gather(1, pos.clamp(max=ef - 1)), ID_INF)
        sel_raw = _tie_enc(sel_ids, tie_bits, sel_ids != ID_INF)
        nid = _candidates(adj, sel_raw, ok, capacity, ID_INF)
        C = nid.shape[1]
        if dedup == "bitmask":
            # dedup within the step (sorted: equal-to-previous are dupes),
            # then against the visited set
            nid = nid.sort(dim=1).values
            fresh = (nid < capacity) & ~_first_dup(nid) \
                & ~bitset.contains(s["vis"], nid)
            s["vis"] = bitset.insert(s["vis"], nid, fresh)
            s["nvis"] += fresh.sum(dim=1, dtype=torch.int32)
            cd = metric.one_to_many(q, get_points(nid.long().clamp(
                0, capacity - 1)))
            cd = torch.where(fresh, cd, inf)
            ci = _tie_enc(torch.where(fresh, nid, ID_INF), tie_bits, fresh)
            md, mi, mx = _sort2(torch.cat([bd, cd], dim=1),
                                torch.cat([bi, ci], dim=1),
                                torch.cat([bx, torch.zeros_like(cd,
                                           dtype=torch.bool)], dim=1))
        else:
            # visited-free: dedup by id inside the merge, keeping the
            # expanded (or the beam's) copy first
            valid = nid < capacity
            cd = metric.one_to_many(q, get_points(nid.long().clamp(
                0, capacity - 1)))
            cd = torch.where(valid, cd, inf)
            ci = _tie_enc(torch.where(valid, nid, ID_INF), tie_bits, valid)
            mx = torch.cat([bx, torch.zeros_like(cd, dtype=torch.bool)], 1)
            is_cand = torch.ones((b, ef + C), dtype=torch.bool, device=dev)
            is_cand[:, :ef] = False
            mi, _, md, mx, is_cand = _sort2(
                torch.cat([bi, ci], dim=1), (~mx).to(torch.int32),
                torch.cat([bd, cd], dim=1), mx, is_cand)
            dup = _first_dup(mi)
            s["nvis"] += ((~dup) & is_cand & (mi != ID_INF)).sum(
                dim=1, dtype=torch.int32)
            md = torch.where(dup, inf, md)
            mi = torch.where(dup, ID_INF, mi)
            md, mi, mx = _sort2(md, mi, mx & ~dup)
        s["bd"], s["bi"], s["bx"] = md[:, :ef], mi[:, :ef], mx[:, :ef]

    out = _run(state, live, step, max_steps, ("bd", "bi", "nvis", "steps"))
    bi = out["bi"]
    return SearchResult(out["bd"], _tie_enc(bi, tie_bits, bi != ID_INF),
                        out["nvis"], out["steps"])


def _beam_packed(get_points, adj, qs, eps, *, ef, metric, capacity, E,
                 max_steps, tie_bits, max_d, id_bits) -> SearchResult:
    """The packed-key branch (``hnsw_itu_tpu/ops/search.py:253-362``):
    one int32 key ``(d << id_bits) | id`` per entry; equal id means equal
    distance, so the dedup runs on the whole key."""
    dev = qs.device
    B, E0 = eps.shape
    mask = (1 << id_bits) - 1
    kinf = (max_d + 1) << id_bits
    d0 = metric.one_to_many(qs, get_points(eps.long())).to(torch.int32)
    i0 = _tie_enc(eps, tie_bits, torch.ones_like(eps, dtype=torch.bool))
    bk = torch.full((B, ef), kinf, dtype=torch.int32, device=dev)
    bk[:, :E0] = ((d0 << id_bits) | i0).sort(dim=1).values
    state = {
        "q": qs,
        "bk": bk,
        "bx": torch.zeros((B, ef), dtype=torch.bool, device=dev),
        "nvis": torch.full((B,), E0, dtype=torch.int32, device=dev),
        "steps": torch.zeros(B, dtype=torch.int32, device=dev),
    }

    def live(s):
        bk = s["bk"]
        front = (~s["bx"]) & (bk <= bk[:, ef - 1 : ef]) & (bk < kinf)
        return front.any(dim=1)

    def step(s):
        bk, bx, q = s["bk"], s["bx"], s["q"]
        b = bk.shape[0]
        sel, pos = _select(bx, bk < kinf, E)
        ok = pos < ef
        bx = bx | sel
        sel_keys = bk.gather(1, pos.clamp(max=ef - 1))
        sel_ids = torch.where(ok & (sel_keys < kinf), sel_keys & mask, ID_INF)
        sel_raw = _tie_enc(sel_ids, tie_bits, sel_ids != ID_INF)
        nid = _candidates(adj, sel_raw, sel_ids != ID_INF, capacity, -1)
        C = nid.shape[1]
        cd = metric.one_to_many(q, get_points(nid.long().clamp(
            0, capacity - 1))).to(torch.int32)
        nid_o = _tie_enc(nid, tie_bits, nid >= 0)
        ck = torch.where(nid >= 0, (cd << id_bits) | nid_o, kinf)
        mk = torch.cat([bk, ck], dim=1)
        mx = torch.cat([bx, torch.zeros_like(ck, dtype=torch.bool)], dim=1)
        is_cand = torch.ones((b, ef + C), dtype=torch.bool, device=dev)
        is_cand[:, :ef] = False
        # sort by (key, not-expanded): the expanded (or the beam's) copy of
        # an equal key comes first; every later copy is a dup
        o = torch.argsort(mk.to(torch.int64) * 2 + (~mx).to(torch.int64),
                          dim=1, stable=True)
        mk, mx, is_cand = mk.gather(1, o), mx.gather(1, o), is_cand.gather(1, o)
        dup = _first_dup(mk)
        s["nvis"] += ((~dup) & is_cand & (mk < kinf)).sum(
            dim=1, dtype=torch.int32)
        mk = torch.where(dup, kinf, mk)
        o = torch.argsort(mk, dim=1, stable=True)[:, :ef]
        s["bk"], s["bx"] = mk.gather(1, o), (mx & ~dup).gather(1, o)

    out = _run(state, live, step, max_steps, ("bk", "nvis", "steps"))
    bk = out["bk"]
    valid = bk < kinf
    ids = _tie_enc(torch.where(valid, bk & mask, ID_INF), tie_bits, valid)
    dists = torch.where(valid, bk >> id_bits, metric.inf)
    return SearchResult(dists, ids, out["nvis"], out["steps"])


def greedy_search(get_points, adj: torch.Tensor, queries: torch.Tensor, eps,
                  *, metric, capacity: int, max_steps: int = 512):
    """ef=1 greedy descent (the JAX ``greedy_search``): (dist, id) int32[B]
    of each query's local minimum. The bitmask dedup it runs gives the
    same nodes as ``dedup="beam"``: with one slot the beam's key only
    falls, so a node it left can never come back."""
    r = batched_beam_search(get_points, adj, queries, eps, ef=1,
                            metric=metric, capacity=capacity, expand=1,
                            max_steps=max_steps)
    return r.dists[:, 0], r.ids[:, 0]
