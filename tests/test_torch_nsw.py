"""The port's NSW index and builder, the ``nsw`` and ``bruteforce`` kinds of
``.npz`` persistence, and ``Bruteforce.add``/``search``, against the JAX
package on CPU tensors, bit-exact (tolerance 0).

The JAX ``NSWBuilder`` runs on its gather route
(``HNSW_TPU_INLINE_BUILD_BYTES=0``), the search the port's build always
runs."""

import numpy as np
import pytest

from hnsw_itu_tpu.models import Bruteforce as JaxBruteforce
from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models.nsw import NSWBuilder as JaxNSWBuilder
from hnsw_itu_tpu.utils import load_index as jax_load
from hnsw_itu_tpu.utils import save_index as jax_save
from hnsw_itu_tpu_torch.models import Bruteforce, IndexOptions
from hnsw_itu_tpu_torch.models.nsw import NSW, NSWBuilder
from hnsw_itu_tpu_torch.ops.fused_search import fused_beam_search
from hnsw_itu_tpu_torch.utils import load_index, make_dataset, save_index
from test_torch_build import gather_route
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N, NQ, K, EF = 900, 32, 10, 32
OPTS = dict(ef_construction=48, connections=12, max_connections=24, size=N,
            batch_size=16, host_warmup=200, entry_sample=64, scan_group=4)


@pytest.fixture(scope="module")
def data():
    return make_dataset(21, N, NQ)


_BUILT = {}


def built(pts, expand=1):
    """(JAX builder, JAX index, port builder, port index), once per
    ``expand``."""
    if expand not in _BUILT:
        with gather_route():
            jb = JaxNSWBuilder(JaxOptions(**OPTS, expand=expand))
            jb.extend_batched(pts)
            jidx = jb.build()
        pb = NSWBuilder(IndexOptions(**OPTS, expand=expand), device="cpu")
        sizes = []
        pb.extend_batched(pts, progress=sizes.append)
        assert sizes[0] == OPTS["host_warmup"] and sizes[-1] == N
        _BUILT[expand] = (jb, jidx, pb, pb.build())
    return _BUILT[expand]


def assert_same_nsw(pb, jb):
    assert pb.n == jb.n and pb.ep == jb.ep
    np.testing.assert_array_equal(pb.graph.adj.numpy(), np.asarray(jb.graph.adj))
    np.testing.assert_array_equal(pb.graph.deg.numpy(), np.asarray(jb.graph.deg))
    np.testing.assert_array_equal(pb.spill[:-1].numpy(),
                                  np.asarray(jb.spill)[:-1])
    assert pb.total_edge_drops() == jb.total_edge_drops()


@pytest.mark.parametrize("expand", [1, 2])
def test_nsw_build_matches_jax(data, expand):
    """Host warmup, progressive chunks (a scanned group of four as four
    chunk steps), build(): the same graph, entry point and edge drops."""
    jb, _, pb, pidx = built(data[0], expand)
    assert_same_nsw(pb, jb)
    assert isinstance(pidx, NSW) and pidx.size() == N


def test_nsw_extend_matches_jax(data):
    """Sequential inserts (chunks of one, add) past the preallocated size
    (the graph grows to the next power of two)."""
    pts = data[0][:40]
    opts = dict(OPTS, size=24, host_warmup=0, entry_sample=16)
    with gather_route():
        jb = JaxNSWBuilder(JaxOptions(**opts))
        jb.extend(pts[:39])
        jb.add(pts[39])
    pb = NSWBuilder(IndexOptions(**opts), device="cpu")
    pb.extend(pts[:39])
    pb.add(pts[39])
    assert pb.opts.size == jb.opts.size == 48
    assert_same_nsw(pb, jb)


def _run(idx, qs, ef, **attrs):
    for k, v in attrs.items():
        setattr(idx, k, v)
    r = idx.knns(qs, K, ef)
    return (np.asarray(r.dists), np.asarray(r.ids),
            np.asarray(idx.last_stats["visited_q"]),
            np.asarray(idx.last_stats["steps_q"]))


# (ef, query settings, the port's route); without enable_inline both
# indexes run the general route with bitmask dedup
QUERIES = [
    (EF, dict(query_entry_sample=0), "general"),
    (EF, dict(query_entry_sample=64), "general"),
    (EF, dict(query_entry_sample=0, query_dedup="beam"), "general"),
    (160, dict(query_entry_sample=0), "general"),
    (EF, dict(query_entry_sample=0, query_expand=2), "general"),
]


@pytest.mark.parametrize("ef,attrs,route", QUERIES)
def test_nsw_knns_general_matches_jax(data, ef, attrs, route):
    _, jidx, _, pidx = built(data[0])
    base = dict(query_entry_sample=0, query_dedup="bitmask", query_expand=1)
    try:
        got = _run(pidx, data[1], ef, **{**base, **attrs})
        want = _run(jidx, data[1], ef, **{**base, **attrs})
    finally:  # the indexes are shared by the cases
        for idx in (pidx, jidx):
            for k, v in base.items():
                setattr(idx, k, v)
    assert pidx.last_route == route
    for name, g, w in zip(("dists", "ids", "visited", "steps"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("sample", [0, 64])
def test_nsw_knns_fused_matches_jax(data, tmp_path, sample):
    """After enable_inline the port serves from the fused table (its
    kernel's plain version on CPU tensors), the JAX package on CPU from
    its inline rows on the packed XLA search: the same function."""
    _, jidx, _, pidx = built(data[0])
    path = tmp_path / "nsw.npz"
    jax_save(str(path), jidx)
    jfresh, _ = jax_load(str(path))
    pfresh, _ = load_index(str(path), "cpu")
    jfresh.enable_inline()
    pfresh.enable_inline()
    assert jfresh.adj_pts is not None and pfresh.fused is not None
    calls = fused_beam_search.plain_calls
    got = _run(pfresh, data[1], EF, query_entry_sample=sample)
    assert fused_beam_search.plain_calls == calls + 1
    assert pfresh.last_route == "fused"
    want = _run(jfresh, data[1], EF, query_entry_sample=sample)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    one = pfresh.search(data[1][2], K, EF)
    np.testing.assert_array_equal(one.ids.numpy(), got[1][2])


def test_nsw_save_load_both_ways(data, tmp_path):
    """A port-saved NSW loads in the JAX package and in the port with the
    same arrays; queries on the loaded index equal the built one's."""
    _, _, _, pidx = built(data[0])
    path = tmp_path / "port_nsw.npz"
    save_index(str(path), pidx)
    jidx, attrs = jax_load(str(path))
    assert attrs.data == "hamming" and jidx.ep == pidx.ep and jidx.n == N
    np.testing.assert_array_equal(np.asarray(jidx.points),
                                  pidx.points.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jidx.graph.adj),
                                  pidx.graph.adj.numpy())
    back, _ = load_index(str(path), "cpu")
    assert isinstance(back, NSW) and back.opts == pidx.opts
    np.testing.assert_array_equal(back.graph.deg.numpy(),
                                  pidx.graph.deg.numpy())
    for g, w in zip(_run(back, data[1], EF), _run(pidx, data[1], EF)):
        np.testing.assert_array_equal(g, w)


def test_bruteforce_add_search_and_npz(data, tmp_path):
    """Bruteforce.add/search against the JAX index, and the bruteforce
    kind of .npz saved by each package and loaded by the other."""
    pts, qs = data
    want = JaxBruteforce("hamming")
    got = Bruteforce("hamming", device="cpu")
    for b in (want, got):
        b.extend(pts[:500])
        for p in pts[500:510]:
            b.add(p)
        b.build()
    assert got.size() == want.size() == 510
    g1, w1 = got.search(qs[0], K), want.search(qs[0], K)
    np.testing.assert_array_equal(g1.dists.numpy(), np.asarray(w1.dists))
    np.testing.assert_array_equal(g1.ids.numpy(), np.asarray(w1.ids))
    jpath, ppath = tmp_path / "jax_bf.npz", tmp_path / "port_bf.npz"
    jax_save(str(jpath), want)
    save_index(str(ppath), got)
    from_jax, _ = load_index(str(jpath), "cpu")
    from_port, _ = jax_load(str(ppath))
    assert isinstance(from_jax, Bruteforce) and from_jax.size() == 510
    ref = want.knns(qs, K)
    for r in (from_jax.knns(qs, K), from_port.knns(qs, K)):
        np.testing.assert_array_equal(np.asarray(r.dists),
                                      np.asarray(ref.dists))
        np.testing.assert_array_equal(np.asarray(r.ids), np.asarray(ref.ids))
