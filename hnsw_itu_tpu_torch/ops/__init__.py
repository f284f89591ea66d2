from .entry import sampled_entry, strided_sample_ids
from .fused_search import (FusedTable, fused_beam_search, fused_width,
                           key_clamp, materialize_fused)
from .metrics import HAMMING, Hamming, as_sketches, get_metric, popcount
from .search import beam_search_packed
from .topk import inverse_permutation, merge_min_k, min_k, sort_by_dist

__all__ = [
    "sampled_entry",
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
    "beam_search_packed",
    "inverse_permutation",
    "merge_min_k",
    "min_k",
    "sort_by_dist",
]
