"""Point3D example: the generic-distance path past Hamming (port of
examples/point3d.py).

A 10x10x10 integer grid with squared-Euclidean distance (``l2int``); the
10-NN of (2, 4, 16) at k=10, ef=20 have distances 49, 50, 50, 50, 50, 51,
51, 51, 51, 53, the reference's golden output.

Run: python -m hnsw_itu_tpu_torch.examples.point3d (on the GPU; exits 1
unless the output matches). ``main(device="cpu")`` runs it on the CPU.
"""

import sys

import numpy as np

from hnsw_itu_tpu_torch import require_cuda
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder

EXPECTED = [49, 50, 50, 50, 50, 51, 51, 51, 51, 53]


def main(device=None) -> np.ndarray:
    """Build the grid's index on ``device`` (None: the GPU), print the
    10-NN of (2, 4, 16) and return their distances."""
    device = require_cuda() if device is None else device
    points = np.array(
        [(x, y, z) for x in range(10) for y in range(10) for z in range(10)],
        dtype=np.int32,
    )
    builder = HNSWBuilder(
        IndexOptions(connections=8, ef_construction=24, max_connections=32,
                     size=len(points)),
        metric="l2int", device=device,
    )
    builder.extend_batched(points)
    index = builder.build()

    query = np.array([2, 4, 16], dtype=np.int32)
    result = index.search(query, 10, 20)
    dists, ids = result.dists.cpu().numpy(), result.ids.cpu().numpy()
    print("Distance : Point")
    for d, i in zip(dists, ids):
        print(f"{d} : Point3D{tuple(int(v) for v in points[i])}")
    return dists


if __name__ == "__main__":
    if main().tolist() == EXPECTED:
        print("\nOK: matches the reference golden output")
    else:
        print(f"\nMISMATCH: expected {EXPECTED}")
        sys.exit(1)
