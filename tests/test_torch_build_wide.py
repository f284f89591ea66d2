"""Builds and queries past kernel #6's limits on CPU tensors, bit-exact
(tolerance 0) against the JAX package's gather route
(``HNSW_TPU_INLINE_BUILD_BYTES=0``): rows 256 wide (the JAX CLI's
default ``-M 256``), ``ef_construction`` 160 and ``expand`` 2, where the
port's build searches on the general beam search; then ``HNSW.knns`` on
the 256-wide index, on the general route at every setting the JAX
``_hnsw_query_step`` takes.

The JAX builder refuses ``expand`` > 1 once an index has levels: its
ef=1 descent asks ``top_k`` for E > ef entries (ROADMAP §3). The port
expands one entry of a one-slot beam; the expand=2 build is compared with
the JAX builder whose descent is given expand=1, the same search."""

import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_itu_tpu.models import IndexOptions as JaxOptions
from hnsw_itu_tpu.models import _build as jbuild
from hnsw_itu_tpu.models.hnsw import HNSWBuilder as JaxBuilder
from hnsw_itu_tpu_torch.models import IndexOptions
from hnsw_itu_tpu_torch.models import _build as pbuild
from hnsw_itu_tpu_torch.models.hnsw import HNSWBuilder
from hnsw_itu_tpu_torch.ops.dma_search import dma_beam_search
from hnsw_itu_tpu_torch.utils import make_dataset
from test_torch_build import assert_same_builder, gather_route
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

N, NQ, K = 600, 32, 10
OPTS = dict(connections=24, size=N, batch_size=16, host_warmup=400,
            entry_sample=64)
BUILDS = {"M256": dict(max_connections=256, ef_construction=96),
          "efc160": dict(max_connections=64, ef_construction=160),
          # a short warmup: the first device chunks descend the levels
          "expand2": dict(max_connections=24, ef_construction=48, expand=2,
                          host_warmup=20)}


@pytest.fixture(scope="module")
def data():
    return make_dataset(13, N, NQ)


_BUILT = {}


def built(name, pts):
    """(JAX builder, JAX index, port builder, port index, the port's plain
    calls of kernel #6 during its build), built once per name."""
    if name not in _BUILT:
        opts = {**OPTS, **BUILDS[name]}
        with gather_route(), pytest.MonkeyPatch.context() as mp:
            orig = jbuild.level_descend_step
            mp.setattr(jbuild, "level_descend_step",
                       lambda *a, **kw: orig(*a, **{**kw, "expand": 1}))
            jb = JaxBuilder(JaxOptions(**opts))
            jb.extend_batched(pts)
            jidx = jb.build()
        calls = dma_beam_search.plain_calls
        pb = HNSWBuilder(IndexOptions(**opts), device="cpu")
        pb.extend_batched(pts)
        pidx = pb.build()
        _BUILT[name] = (jb, jidx, pb, pidx,
                        dma_beam_search.plain_calls - calls)
    return _BUILT[name]


@pytest.mark.parametrize("name", list(BUILDS))
def test_wide_build_matches_jax(data, name):
    """Graph, levels, entry point and edge drops equal the JAX build's;
    kernel #6 ran only the searches it serves (the ef=1 descents at
    widths up to 128)."""
    jb, jidx, pb, pidx, calls = built(name, data[0])
    assert_same_builder(pb, jb)
    assert pidx.level_ns == jidx.level_ns and sum(pidx.level_ns) > 0
    W = BUILDS[name]["max_connections"]
    efc = BUILDS[name]["ef_construction"]
    assert pb.base.width == W
    assert pbuild.search_route(pb.base.adj, pb.points, efc,
                               BUILDS[name].get("expand", 1)) == "general"
    if W > 128:
        assert calls == 0  # every search of the build was general
    else:
        assert 0 < calls  # the descents ran on the kernel's route


def test_jax_descent_refuses_expand():
    """The reference's fault the port departs from: the JAX ef=1 descent
    step raises at expand=2."""
    pts = jnp.zeros((8, 4), jnp.uint32)
    adj = jnp.full((8, 4), -1, jnp.int32)
    with pytest.raises(ValueError, match="top_k"):
        jbuild.level_descend_step(
            pts, jnp.arange(8, dtype=jnp.int32), adj,
            jnp.zeros(8, jnp.int32), pts[:2], jnp.zeros(2, jnp.int32),
            jnp.int32(2), S=2, metric_name="hamming", expand=2)


def _run(idx, qs, ef, **attrs):
    for k, v in attrs.items():
        setattr(idx, k, v)
    r = idx.knns(qs, K, ef)
    return (np.asarray(r.dists), np.asarray(r.ids),
            np.asarray(idx.last_stats["visited_q"]),
            np.asarray(idx.last_stats["steps_q"]))


# (ef, query settings, enable_inline on both indexes)
QUERIES = [
    (48, dict(query_entry_sample=0), False),
    (48, dict(query_entry_sample=0, query_dedup="beam"), False),
    (160, dict(query_entry_sample=0), False),
    (48, dict(query_entry_sample=0, query_expand=2), False),
    (48, dict(query_entry_sample=64), False),
    (48, dict(query_entry_sample=0), True),
    (160, dict(query_entry_sample=0, query_expand=3), True),
]


@pytest.mark.parametrize("ef,attrs,inline", QUERIES)
def test_wide_knns_matches_jax(data, ef, attrs, inline):
    """knns on the 256-wide index: no table serves it, so every call takes
    the general route (the greedy descent on the general greedy search, as
    the levels are 256 wide too); after enable_inline both packages
    search with beam dedup (the JAX inline rows)."""
    _, jidx, _, pidx, _ = built("M256", data[0])
    base = dict(query_entry_sample=0, query_dedup="bitmask", query_expand=1)
    if inline:
        jidx.enable_inline()
        pidx.enable_inline()
        assert jidx.adj_pts is not None and pidx.inline_rows
    calls = dma_beam_search.plain_calls
    try:
        got = _run(pidx, data[1], ef, **{**base, **attrs})
        want = _run(jidx, data[1], ef, **{**base, **attrs})
    finally:  # the indexes are shared by the cases
        for idx in (pidx, jidx):
            for k, v in base.items():
                setattr(idx, k, v)
    assert pidx.last_route == "general" and pidx.fused is None
    assert dma_beam_search.plain_calls == calls
    for name, g, w in zip(("dists", "ids", "visited", "steps"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_wide_search_one_query(data):
    _, jidx, _, pidx, _ = built("M256", data[0])
    for idx in (jidx, pidx):
        idx.query_entry_sample = 0
    got, want = pidx.search(data[1][5], K, 32), jidx.search(data[1][5], K, 32)
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
