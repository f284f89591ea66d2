from . import logging
from .dataset import BUFFER_SIZE, BufferedDataset
from .evalrecall import recall_at_k, recall_files, recall_tie_tolerant
from .instrument import SearchStats
from .synth import make_dataset

# ``serialize`` imports the models, and the models import ``instrument``
# from this package: its names load at first use
_SERIALIZE = ("ResultAttrs", "builder_from_numpy", "from_numpy",
              "load_index", "save_index")


def __getattr__(name):
    if name in _SERIALIZE:
        from . import serialize

        return getattr(serialize, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
