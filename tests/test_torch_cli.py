"""The port's CLI (``hnsw_itu_tpu_torch.cli``) through ``main(argv,
device="cpu")``, mirroring tests/test_io_cli.py and the stats test of
tests/test_instrument.py, then against the JAX CLI on the same HDF5 files:
for Hamming the ``knns`` and ``dists`` datasets are equal (tolerance 0)
and the attributes too, apart from the build and query times; an index
file written by either package's ``index`` serves the other's
``query-index`` with the same result."""

import logging

import h5py
import numpy as np
import pytest

from hnsw_itu_tpu.cli import main as jax_main
from hnsw_itu_tpu_torch.cli import format_size_string, main
from hnsw_itu_tpu_torch.ops.metrics import sketches_to_u64
from hnsw_itu_tpu_torch.utils import (BufferedDataset, load_index,
                                      recall_files)
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)


def cli(*argv):
    return main(list(argv), device="cpu")


def _write_h5(path, rows, name="hamming"):
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=rows)


@pytest.fixture()
def data(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.integers(0, 2**63, size=(300, 16), dtype=np.uint64)
    qs = pts[:20] ^ np.uint64(3)  # queries near known points
    d, q = tmp_path / "data.h5", tmp_path / "queries.h5"
    _write_h5(d, pts)
    _write_h5(q, qs)
    return d, q, tmp_path


def _read(path):
    with h5py.File(path) as f:
        return ({k: f[k][...] for k in f}, dict(f.attrs))


def test_buffered_dataset_roundtrip_and_sizes(tmp_path):
    p = tmp_path / "x.h5"
    rows = np.arange(64, dtype=np.uint64).reshape(4, 16)
    ds = BufferedDataset.create(p, (4, 16), "hamming")
    ds.write_rows(rows, 0)
    ds.add_attr("data", "hamming")
    ds.close()
    with BufferedDataset.open(p, "hamming") as ds2:
        assert ds2.size() == 4 and ds2.shape == (4, 16)
        chunks = list(ds2.iter_chunks(chunk=3))
        assert [c.shape[0] for c in chunks] == [3, 1]
        np.testing.assert_array_equal(np.concatenate(chunks), rows)
        assert ds2.get_attr("data") == "hamming"
    assert format_size_string(100_000) == "100K"
    assert format_size_string(10_120_191) == "10M"
    assert format_size_string(42) == "42"


def test_cli_query_groundtruth_evaluate(data, capsys):
    d, q, tmp = data
    res, gt = tmp / "result.h5", tmp / "gt.h5"
    assert cli("-q", "query", "-d", str(d), "-Q", str(q), "-o", str(res),
               "-k", "5", "-e", "32", "-c", "32", "-m", "8", "-M", "16",
               "--sort") == 0
    assert cli("-q", "ground-truth", "-d", str(d), "-Q", str(q),
               "-o", str(gt), "-k", "5") == 0
    r, attrs = _read(res)
    assert r["knns"].shape == (20, 5) and r["knns"].dtype == np.uint64
    assert r["knns"].min() >= 1  # 1-based ids
    assert attrs["algo"] == "Hnsw" and attrs["size"] == "300"
    assert "efc=32" in attrs["params"] and "query=(ef=32)" in attrs["params"]
    g, _ = _read(gt)
    assert g["knns"].shape == g["dists"].shape == (20, 5)
    # queries flip 2 bits in each of 16 words: exact NN distance == 32
    assert (g["dists"][:, 0] == 32).all()
    assert recall_files(res, gt, 5) >= 0.8
    assert cli("evaluate", str(res), str(gt), "-k", "5") == 0
    assert "recall@5" in capsys.readouterr().out

    res2 = tmp / "result_d.h5"
    assert cli("-q", "query", "-d", str(d), "-Q", str(q), "-o", str(res2),
               "-k", "5", "-e", "32", "-c", "32", "-m", "8", "-M", "16",
               "--sort", "--write-dists") == 0
    assert _read(res2)[0]["dists"].shape == (20, 5)
    assert cli("evaluate", str(res2), str(gt), "-k", "5",
               "--tie-tolerant") == 0
    out = capsys.readouterr().out
    rec_id = float(out.split("recall@5:")[1].split()[0])
    rec_tt = float(out.split("tie-tolerant recall@5:")[1].split()[0])
    assert rec_tt >= rec_id >= 0.8


def test_cli_index_query_index_inspect(data, capsys):
    d, q, tmp = data
    idxf, res = tmp / "index.idx", tmp / "r2.h5"
    assert cli("-q", "index", "-d", str(d), "-o", str(idxf),
               "-c", "16", "-m", "4", "-M", "8", "-a", "nsw") == 0
    assert cli("-q", "query-index", "-i", str(idxf), "-Q", str(q),
               "-o", str(res), "-k", "3", "-e", "16") == 0
    assert _read(res)[0]["knns"].shape == (20, 3)
    capsys.readouterr()
    assert cli("-q", "inspect", str(idxf)) == 0
    out = capsys.readouterr().out
    assert "base has 300 nodes" in out and "p50" in out
    assert "query on whole index returned" in out
    # the same layer statistics and reachability as the JAX inspect
    assert jax_main(["-q", "inspect", str(idxf)]) == 0
    assert out.split("\n")[1:] == capsys.readouterr().out.split("\n")[1:]


def test_cli_inspect_hnsw_layers(data, capsys):
    d, _, tmp = data
    idxf = tmp / "h.idx"
    assert cli("-q", "index", "-d", str(d), "-o", str(idxf), "-c", "16",
               "-m", "4", "-M", "8") == 0
    assert cli("-q", "inspect", str(idxf)) == 0
    out = capsys.readouterr().out
    assert "layer0 has" in out and "base has 300 nodes" in out


def test_cli_index_start_len(data):
    d, _, tmp = data
    idxf = tmp / "slice.idx"
    assert cli("-q", "index", "-d", str(d), "-o", str(idxf),
               "-b", "100", "-l", "50", "-a", "bruteforce") == 0
    idx, attrs = load_index(str(idxf), "cpu")
    assert idx.size() == 50 and attrs.format_size is False


def test_cli_metric_l2_end_to_end(tmp_path):
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(240, 24)).astype(np.float32)
    qs = pts[:16] + rng.normal(scale=0.01, size=(16, 24)).astype(np.float32)
    d, q = tmp_path / "l2.h5", tmp_path / "l2q.h5"
    _write_h5(d, pts, "l2")
    _write_h5(q, qs, "l2")
    res, gt = tmp_path / "res.h5", tmp_path / "gt.h5"
    assert cli("-q", "query", "--metric", "l2", "-d", str(d), "-Q", str(q),
               "-o", str(res), "-k", "5", "-e", "32", "-c", "32",
               "-m", "8", "-M", "16", "--sort") == 0
    assert cli("-q", "ground-truth", "--metric", "l2", "-d", str(d),
               "-Q", str(q), "-o", str(gt), "-k", "5") == 0
    g, _ = _read(gt)
    assert g["dists"].dtype == np.float64
    assert (g["dists"][:, 0] < 0.1).all()
    assert _read(res)[1]["data"] == "l2"
    assert recall_files(res, gt, 5) >= 0.9


def test_cli_single_threaded_l2_rejected(tmp_path):
    d = tmp_path / "l2.h5"
    _write_h5(d, np.zeros((10, 4), np.float32), "l2")
    with pytest.raises(SystemExit):
        cli("-q", "query", "--metric", "l2", "-S", "-d", str(d),
            "-Q", str(d), "-o", str(tmp_path / "r.h5"))


def test_cli_reorder_keeps_original_ids(data):
    """--reorder: the index is relabeled, results come back in the
    dataset's ids (each query's source point is its nearest)."""
    d, q, tmp = data
    res, idxf = tmp / "r.h5", tmp / "r.idx"
    assert cli("-q", "query", "-d", str(d), "-Q", str(q), "-o", str(res),
               "-i", str(idxf), "-k", "5", "-e", "32", "-c", "32", "-m", "8",
               "-M", "16", "--reorder", "--write-dists") == 0
    r, _ = _read(res)
    assert (r["knns"][:, 0] == np.arange(1, 21)).all()
    assert (r["dists"][:, 0] == 32).all()
    idx, _ = load_index(str(idxf), "cpu")
    assert idx.id_map is not None


def test_cli_query_hop_warning(data, caplog):
    d, q, tmp = data
    with caplog.at_level(logging.WARNING, logger="hnsw_itu_tpu_torch.cli"):
        assert cli("query", "-d", str(d), "-Q", str(q), "-o",
                   str(tmp / "r.h5"), "-k", "5", "-e", "32", "-c", "32",
                   "-m", "8", "-M", "16", "--query-hop", "4") == 0
    assert "--query-hop only applies to the mini-table path" in caplog.text
    assert "the fused kernel" in caplog.text


def test_cli_reports_stats(tmp_path, caplog):
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 2**32, size=(300, 32), dtype=np.uint32)
    data, quer = tmp_path / "d.h5", tmp_path / "q.h5"
    _write_h5(data, sketches_to_u64(pts))
    _write_h5(quer, sketches_to_u64(pts[:16]))
    with caplog.at_level(logging.INFO, logger="hnsw_itu_tpu_torch.cli"):
        assert cli("query", "-d", str(data), "-Q", str(quer),
                   "-o", str(tmp_path / "r.h5"), "-k", "5", "-e", "32",
                   "-c", "32", "-m", "8", "-M", "16") == 0
    assert "visited stats" in caplog.text and "visited_p99" in caplog.text
    assert "Total query time" in caplog.text


def test_main_needs_a_card_without_device(data):
    d, _, tmp = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-q", "index", "-d", str(d), "-o", str(tmp / "x.idx")])


QUERY = ["-k", "5", "-e", "32", "-c", "32", "-m", "8", "--sort",
         "--write-dists"]


@pytest.mark.parametrize("flags", [["-M", "16"], [], ["-M", "16", "-S"],
                                   ["-M", "16", "-a", "nsw"],
                                   ["-a", "bruteforce"]],
                         ids=["M16", "defaults", "single", "nsw", "bf"])
def test_cli_results_equal_jax(data, flags):
    """The same HDF5 input and flags: equal knns and dists datasets, and
    equal attributes apart from the build and query times."""
    d, q, tmp = data
    argv = ["-q", "query", "-d", str(d), "-Q", str(q), *QUERY, *flags]
    assert cli(*argv, "-o", str(tmp / "port.h5")) == 0
    assert jax_main([*argv, "-o", str(tmp / "jax.h5")]) == 0
    (pr, pa), (jr, ja) = _read(tmp / "port.h5"), _read(tmp / "jax.h5")
    assert sorted(pr) == sorted(jr) == ["dists", "knns"]
    for k in pr:
        np.testing.assert_array_equal(pr[k], jr[k], err_msg=k)
    for a in (pa, ja):
        del a["buildtime"], a["querytime"]
    assert pa == ja


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_files_cross_packages(data, writer):
    """An index written by one package's ``index`` is read by the other's
    ``query-index``; both packages' result files are equal."""
    d, q, tmp = data
    idxf = tmp / "x.idx"
    build = ["-q", "index", "-d", str(d), "-o", str(idxf), "-c", "32",
             "-m", "8", "-M", "16"]
    assert (jax_main(build) if writer == "jax" else cli(*build)) == 0
    argv = ["-q", "query-index", "-i", str(idxf), "-Q", str(q), "-k", "5",
            "-e", "32", "--sort", "--write-dists"]
    assert cli(*argv, "-o", str(tmp / "port.h5")) == 0
    assert jax_main([*argv, "-o", str(tmp / "jax.h5")]) == 0
    pr, jr = _read(tmp / "port.h5")[0], _read(tmp / "jax.h5")[0]
    for k in ("knns", "dists"):
        np.testing.assert_array_equal(pr[k], jr[k], err_msg=k)
