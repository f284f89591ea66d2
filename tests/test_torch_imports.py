"""The port imports without JAX: every module of ``hnsw_itu_tpu_torch``
loads in a process where ``import jax`` fails, and none of them pulls in
``hnsw_itu_tpu``, ``triton`` or ``h5py`` or builds a kernel. The modules
that port code of a JAX module (the mini-table search, the build's
kernels, select-neighbors, the graph mutations, the build steps, the
visited bitmask, the general beam search, the NSW index, the sharded
indexes and their mesh, the metrics, the reorder, the CLI, its helpers and
the examples) are also checked alone."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import hnsw_itu_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("hnsw_itu_tpu", "triton", "h5py"))
assert not bad, bad
from hnsw_itu_tpu_torch.ops import _kernels
assert not _kernels._LIBS and not _kernels.BUILD_INFO  # nothing built
print(len(names))
"""


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15  # every module was visited


_ALONE = r"""
import importlib, sys
sys.modules["jax"] = None
importlib.import_module(sys.argv[1])
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "hnsw_itu_tpu", "triton"))
assert not bad, bad
"""


def _imports_alone(module: str) -> None:
    r = subprocess.run([sys.executable, "-c", _ALONE,
                        f"hnsw_itu_tpu_torch.{module}"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    path = os.path.join(REPO, "hnsw_itu_tpu_torch", *module.split(".")) + ".py"
    with open(path) as f:
        heads = [ln.split() for ln in f if ln.startswith(("import ", "from "))]
    assert all(h[1].split(".")[0] not in ("jax", "hnsw_itu_tpu")
               for h in heads), heads


def test_mini_search_imports_alone_without_jax():
    _imports_alone("ops.mini_search")


@pytest.mark.parametrize("module", ["ops.dma_search", "ops.hamming",
                                    "ops.select", "graph", "models._build",
                                    "ops.bitset", "ops.search",
                                    "models.nsw", "parallel.mesh",
                                    "parallel.sharded"])
def test_build_modules_import_alone_without_jax(module):
    _imports_alone(module)


@pytest.mark.parametrize("module", ["ops.metrics", "ops.reorder", "cli",
                                    "utils.dataset", "utils.instrument",
                                    "utils.logging", "utils.evalrecall",
                                    "examples.point3d",
                                    "examples.custom_metric"])
def test_cli_modules_import_alone_without_jax(module):
    """The metrics, the reorder, the CLI and its helpers, and the
    examples: no jax, no hnsw_itu_tpu (and, through the probe above, no
    h5py at import)."""
    _imports_alone(module)
