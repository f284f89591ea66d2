"""Packed-key beam search, plain PyTorch (port of
hnsw_itu_tpu/ops/search.py::_beam_search_packed).

This is the plain version of the fused CUDA kernel
(``csrc/fused_beam_search.cu``): the function the kernel computes, written
as whole-batch tensor steps. ``ops/fused_search.py`` runs it for CPU
tensors; the tests hold it against the JAX reference, and ``chip_smoke.py``
holds the kernel against it on the card.

It is ``_beam_search_packed`` with ``expand=1``, ``dedup="beam"`` and
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
"""

from __future__ import annotations

import torch

from .metrics import popcount_sum


def beam_search_packed(ids: torch.Tensor, data: torch.Tensor,
                       queries: torch.Tensor, init_keys: torch.Tensor, *,
                       ef: int, id_bits: int, max_d: int, max_steps: int):
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
