from .entry import sampled_entry, sampled_entry_topk, strided_sample_ids
from .fused_search import (FusedTable, fused_beam_search, fused_width,
                           key_clamp, materialize_fused)
from .metrics import HAMMING, Hamming, as_sketches, get_metric, popcount
from .mini_search import (bitrev_ids, materialize_mini, mini_beam_search,
                          rerank_exact, rerank_onehop)
from .search import (SearchResult, batched_beam_search, beam_search_packed,
                     beam_search_two_plane, greedy_search)
from .topk import inverse_permutation, merge_min_k, min_k, sort_by_dist

__all__ = [
    "sampled_entry",
    "sampled_entry_topk",
    "strided_sample_ids",
    "FusedTable",
    "fused_beam_search",
    "fused_width",
    "key_clamp",
    "materialize_fused",
    "HAMMING",
    "Hamming",
    "as_sketches",
    "get_metric",
    "popcount",
    "bitrev_ids",
    "materialize_mini",
    "mini_beam_search",
    "rerank_exact",
    "rerank_onehop",
    "SearchResult",
    "batched_beam_search",
    "beam_search_packed",
    "beam_search_two_plane",
    "greedy_search",
    "inverse_permutation",
    "merge_min_k",
    "min_k",
    "sort_by_dist",
]
