"""A user metric through ``register_metric`` (port of
examples/custom_metric.py).

The reference's generic path takes any point type with an integer
distance. Here that is a ``Metric`` subclass registered by name: it gives
``one_to_many`` (q [..., D] against pts [..., C, D] -> [..., C]), may
override the dense blocks, and is registered; the name then works in the
builders, ``Bruteforce`` and ``.npz`` files. This example registers
Manhattan (L1) distance over int32 vectors, builds an HNSW index with it
and checks the 5-NN against the exact scan of the same metric.

Run: python -m hnsw_itu_tpu_torch.examples.custom_metric (on the GPU);
``main(device="cpu")`` runs it on the CPU.
"""

import numpy as np
import torch

from hnsw_itu_tpu_torch import Metric, register_metric, require_cuda
from hnsw_itu_tpu_torch.models import Bruteforce, IndexOptions
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder


class ManhattanInt(Metric):
    """Integer L1 distance, sum(|a_i - b_i|), in int32."""

    def __init__(self):
        super().__init__(name="l1int")

    def one_to_many(self, q, pts):
        d = pts.to(torch.int32) - q.to(torch.int32).unsqueeze(-2)
        return d.abs().sum(dim=-1, dtype=torch.int32)


def main(device=None):
    """(approximate, exact) 5-NN distances of one query on ``device``
    (None: the GPU)."""
    device = require_cuda() if device is None else device
    register_metric(ManhattanInt(), overwrite=True)

    rng = np.random.default_rng(0)
    points = rng.integers(-50, 50, size=(2000, 8), dtype=np.int32)
    query = rng.integers(-50, 50, size=(8,), dtype=np.int32)
    k, ef = 5, 32

    builder = HNSWBuilder(
        IndexOptions(connections=8, ef_construction=32, max_connections=16,
                     size=len(points), host_warmup=0),
        metric="l1int", device=device,
    )
    builder.extend_batched(points)
    approx = builder.build().search(query, k, ef)

    bf = Bruteforce("l1int", device=device)
    bf.extend(points)
    exact = bf.build().search(query, k, ef)

    a, e = approx.dists.cpu().numpy(), exact.dists.cpu().numpy()
    print("approx:", a.tolist())
    print("exact :", e.tolist())
    return a, e


if __name__ == "__main__":
    main()
