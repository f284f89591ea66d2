from .base import ID_INF, IndexOptions, KnnResult, rng_seed
from .bruteforce import Bruteforce
from .hnsw import HNSW, HNSWBuilder
from .nsw import NSW, NSWBuilder

__all__ = [
    "ID_INF",
    "IndexOptions",
    "KnnResult",
    "rng_seed",
    "Bruteforce",
    "HNSW",
    "HNSWBuilder",
    "NSW",
    "NSWBuilder",
]
