from .evalrecall import recall_at_k
from .serialize import ResultAttrs, from_numpy, load_index, save_index
from .synth import make_dataset

__all__ = [
    "recall_at_k",
    "ResultAttrs",
    "from_numpy",
    "load_index",
    "save_index",
    "make_dataset",
]
