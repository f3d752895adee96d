"""The port stands alone: every module of weaviate_tpu_torch, and
chip_smoke.py, imports with ``jax`` and ``weaviate_tpu`` blocked, and the
port's native host libraries build from its own sources into its
git-ignored ``_build/`` directory."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["weaviate_tpu"] = None
import weaviate_tpu_torch
names = ["weaviate_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(weaviate_tpu_torch.__path__,
                                          "weaviate_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("ops.sparse", "ops.fusion", "query.fusion", "query.explorer",
             "query.aggregator", "query.autocut", "query.sorter",
             "query.groupby", "query.legacy_group", "ops.rerank",
             "modules.base", "modules.device.base", "modules.device.maxsim",
             "modules.device.linear", "modules.device.store",
             "index.multivector", "query.multi_target", "ops.hfresh",
             "index.hfresh", "index.geo", "inverted.segmented"):
    assert "weaviate_tpu_torch." + name in names, name
import chip_smoke
import os
from weaviate_tpu_torch import native
for lib in ("segment_merge", "bm25_wand"):
    native.load(lib)
    assert os.path.dirname(native.library_path(lib)) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("weaviate_tpu_torch",
                                                  "_build"))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "weaviate_tpu",
                                       "ml_dtypes") and sys.modules[m])
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module was imported, slices 7b's and 6b's among them
    assert int(out.stdout.split()[-1]) >= 87
