"""The port at the JAX 10M runner's scale (benches/run_10m.py), checked by
arithmetic on shapes and streams alone: no 10M-row builder, table or
point array is allocated on either side.

* The level draw: the port's ``rng_seed`` and ``_random_level`` stream at
  the runner's options equal the JAX package's, and the level sizes that
  stream gives equal the constants ``chip_smoke.py`` holds its device
  builds to (phase 18 at 10,120,192 points).
* The table policy at 10,120,192 rows: the JAX package's default budget
  gives (W=32, mini_words=7), a 78 GB budget (W=32, mini_words=31), and
  both packages give the same pair at the same budget; on the card the
  budget counts PyTorch's cached blocks as free.
* The sampled entry: its query x sample block is split by query rows
  without changing an entry, and its sample ids stay exact where the JAX
  module's int32 product wraps (ROADMAP §3).
"""

import importlib.util
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models import nsw as jax_nsw
from hnsw_itu_tpu.models.base import rng_seed as jax_rng_seed
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxBuilder
from hnsw_itu_tpu.ops.entry import sampled_entry as jax_sampled_entry
from hnsw_itu_tpu.ops.entry import sampled_entry_topk as jax_topk
from hnsw_itu_tpu.ops.entry import strided_sample_ids as jax_sample_ids
from hnsw_itu_tpu.ops.metrics import get_metric as jax_metric
from hnsw_itu_tpu_torch.models import IndexOptions, rng_seed
from hnsw_itu_tpu_torch.models import nsw as port_nsw
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.models.nsw import _mini_config_for
from hnsw_itu_tpu_torch.ops import entry as port_entry
from hnsw_itu_tpu_torch.ops.metrics import HAMMING, as_sketches
from hnsw_itu_tpu_torch.ops.mini_search import mini_subrows
from hnsw_itu_tpu_torch.utils import make_dataset
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N10M = 10_120_192  # benches/results_10m.json n_points
WORDS = 32


def _chip_smoke():
    """chip_smoke.py at the repository root, imported as a module (it
    imports nothing but the standard library at load time)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _runner_options(n, batch_size):
    """The runner's (and the bench's) build options at ``n`` points in
    both packages, every other field at its default."""
    kw = dict(ef_construction=96, connections=24, max_connections=64,
              size=n, batch_size=batch_size, host_warmup=min(50_000, n))
    return IndexOptions(**kw), JaxOptions(**kw)


def _levels(draws: np.ndarray) -> list[int]:
    """Level sizes of the upper layers: level l holds every point whose
    draw is at least l (point 0 takes no draw)."""
    return [int((draws >= lv).sum()) for lv in range(1, int(draws.max()) + 1)]


@pytest.mark.parametrize("n,batch_size", [(100_000, 256), (1_000_000, 256),
                                          (N10M, 1024)])
def test_level_draw_matches_jax(n, batch_size):
    """One draw per point after the first, in id order: the port's and
    the JAX builder's ``_random_level`` give the same stream from the same
    seed, the stream vectorized gives it too (no draw lies within 1e-9 of
    a level boundary, so the last bit of a logarithm cannot move one), and
    its level sizes are chip_smoke.py's JAX_LEVEL_NS[n]."""
    popts, jopts = _runner_options(n, batch_size)
    seed = rng_seed(popts)
    assert seed == jax_rng_seed(jopts)
    ml = 1.0 / math.log(24)
    # each package's own draw function on its own stream; builders made at
    # a small size give the function and its scale, the seed is n's
    small_p, small_j = _runner_options(2_000, batch_size)
    port = HNSWBuilder(small_p, device="cpu")
    jaxb = JaxBuilder(small_j)
    assert port._ml == jaxb._ml == ml
    port._rng = np.random.RandomState(seed)
    jaxb._rng = np.random.RandomState(seed)
    head = 50_000
    p_head = np.array([port._random_level() for _ in range(head)])
    j_head = np.array([jaxb._random_level() for _ in range(head)])
    np.testing.assert_array_equal(p_head, j_head)

    u = np.maximum(np.random.RandomState(seed).random_sample(n - 1), 1e-12)
    x = -np.log(u) * ml
    draws = x.astype(np.int64)
    np.testing.assert_array_equal(draws[:head], j_head)
    assert np.abs(x - np.rint(x)).min() > 1e-9
    assert _levels(draws) == CS.JAX_LEVEL_NS[n]


def _meta(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("budget,want", [(int(1.1e10), (32, 7)),
                                         (int(78e9), (32, 31)),
                                         (int(30e9) - (2 << 30), (32, 19))])
def test_flagship_table_policy_matches_jax(budget, want, monkeypatch):
    """(W, mini_words) at 10,120,192 rows of 32 words, a graph 64 wide:
    the JAX default budget (1.1e10 B) picks W=32/mw=7 (10.36 GB), 78 GB
    picks W=32/mw=31 (41.45 GB; W=64 needs 82.9 GB at mw=31 and takes
    mw=29 at 77.7 GB, which ranks lower), 30 GB free less the query margin
    mw=19; the JAX policy picks the same pair from the same budget."""
    got = _mini_config_for(_meta((N10M, WORDS)), _meta((N10M, 64)), HAMMING,
                           budget)
    assert got == want
    W, mw = got
    assert N10M * mini_subrows(W, mw) * 512 <= budget
    monkeypatch.setenv("HNSW_TPU_MINI_INTERPRET", "1")
    monkeypatch.setenv("HNSW_TPU_INLINE_QUERY_BYTES", str(budget))
    jgot = jax_nsw._mini_config_for(
        jax.ShapeDtypeStruct((N10M, WORDS), jnp.uint32),
        jax.ShapeDtypeStruct((N10M, 64), jnp.int32), jax_metric("hamming"))
    assert jgot == got


def test_table_budget_counts_cached_blocks(monkeypatch):
    """On the card the policy's budget is the driver's free memory plus
    what PyTorch's allocator holds cached but unused, less the query
    margin: 30 GB free beside 45 GB cached (5 GB of it in use) picks the
    41.45 GB W=32/mw=31 table at 10M, where the driver's count alone
    would pick mw=19; the 2.2M index of chip_smoke.py phase 7 keeps its
    W=64/mw=31 pick."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (int(30e9), int(85e9)))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: int(45e9))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: int(5e9))
    dev = torch.device("cuda", 0)
    assert port_nsw._free_device_bytes(dev) == int(70e9)

    def card(shape):  # shape and device: all the policy reads
        return types.SimpleNamespace(shape=shape, device=dev)

    assert _mini_config_for(card((N10M, WORDS)), card((N10M, 64)),
                            HAMMING) == (32, 31)
    assert _mini_config_for(card((2_200_000, WORDS)), card((2_200_000, 64)),
                            HAMMING) == (64, 31)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    assert _mini_config_for(card((N10M, WORDS)), card((N10M, 64)),
                            HAMMING) == (32, 19)


@pytest.mark.parametrize("block_rows", [1, 7, 64])
def test_entry_blocks_match_jax(block_rows, monkeypatch):
    """The sampled entry in query blocks of ``block_rows`` rows gives the
    entries (and top-4 ids and distances) of the JAX functions, which
    compute the whole [B, S] block at once."""
    pts, qs = make_dataset(3, 3000, 150)
    S, n = 512, 3000
    monkeypatch.setattr(port_entry, "_ENTRY_BLOCK_ELEMS", block_rows * S)
    p, q = as_sketches(pts, "cpu"), as_sketches(qs, "cpu")
    got = port_entry.sampled_entry(p, q, n, sample_size=S, metric=HAMMING)
    jm = jax_metric("hamming")
    want = jax_sampled_entry(jnp.asarray(pts), jnp.asarray(qs), n,
                             sample_size=S, metric=jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gi, gd = port_entry.sampled_entry_topk(p, q, n, sample_size=S, beams=4,
                                           metric=HAMMING)
    wi, wd = jax_topk(jnp.asarray(pts), jnp.asarray(qs), n, sample_size=S,
                      beams=4, metric=jm)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    empty = port_entry.sampled_entry(p, q[:0], n, sample_size=S,
                                     metric=HAMMING)
    assert empty.shape == (0,)


@pytest.mark.parametrize("n,sample", [(2_000_000, 1024), (2_200_000, 1024),
                                      (N10M, 1024), (N10M, 65_536)])
def test_strided_sample_departs_from_jax_past_int32(n, sample):
    """The port's sample ids are ``floor(s * n / S)`` for every s: distinct
    and ascending. The JAX ids equal them while ``(S - 1) * n`` fits int32
    (2M at S=1024) and wrap past it: at 10,120,192 points 811 of 1024 ids
    differ (600 distinct) and 65,323 of 65,536 (10,540 distinct)."""
    got = port_entry.strided_sample_ids(n, sample, device="cpu").numpy()
    exact = (np.arange(sample, dtype=np.int64) * n) // sample
    np.testing.assert_array_equal(got, exact)
    assert (np.diff(got) > 0).all()
    jax_ids = np.asarray(jax_sample_ids(n, sample))
    wraps = (sample - 1) * n >= 2**31
    assert (not np.array_equal(jax_ids, exact)) == wraps
    if (n, sample) == (N10M, 1024):
        assert (jax_ids != exact).sum() == 811
        assert len(np.unique(jax_ids)) == 600
    if (n, sample) == (N10M, 65_536):
        assert (jax_ids != exact).sum() == 65_323
        assert len(np.unique(jax_ids)) == 10_540
