from . import logging
from .dataset import BUFFER_SIZE, BufferedDataset
from .evalrecall import recall_at_k, recall_files, recall_tie_tolerant
from .instrument import SearchStats
from .serialize import (ResultAttrs, builder_from_numpy, from_numpy,
                        load_index, save_index)
from .synth import make_dataset

__all__ = [
    "logging",
    "BUFFER_SIZE",
    "BufferedDataset",
    "recall_at_k",
    "recall_files",
    "recall_tie_tolerant",
    "SearchStats",
    "ResultAttrs",
    "builder_from_numpy",
    "from_numpy",
    "load_index",
    "save_index",
    "make_dataset",
]
