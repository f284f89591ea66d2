"""The port imports without JAX: every module of ``hnsw_itu_tpu_torch``
loads in a process where ``import jax`` fails, and none of them pulls in
``hnsw_itu_tpu``, ``triton`` or ``h5py`` or builds a kernel."""

import os
import subprocess
import sys

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
