"""The port's examples on the CPU: point3d prints the reference's golden
distances, as the JAX package's does; custom_metric builds on a
registered metric and agrees with the JAX example's output."""

import numpy as np
import pytest

import hnsw_itu_tpu.ops.metrics as jax_metrics_mod
import hnsw_itu_tpu_torch.ops.metrics as metrics_mod
from hnsw_itu_tpu_torch.examples import custom_metric, point3d
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)


def test_point3d_golden(capsys):
    dists = point3d.main(device="cpu")
    assert dists.tolist() == point3d.EXPECTED \
        == [49, 50, 50, 50, 50, 51, 51, 51, 51, 53]
    assert "49 : Point3D(2, 4, 9)" in capsys.readouterr().out


@pytest.fixture
def registry():
    yield
    metrics_mod._REGISTRY.pop("l1int", None)
    jax_metrics_mod._REGISTRY.pop("l1int", None)


def test_custom_metric_example_matches_jax(registry, capsys):
    import examples.custom_metric as jax_example

    approx, exact = custom_metric.main(device="cpu")
    assert approx[0] == exact[0]
    assert "approx:" in capsys.readouterr().out
    ja, je = jax_example.main()
    np.testing.assert_array_equal(exact, np.asarray(je))
    np.testing.assert_array_equal(approx, np.asarray(ja))
