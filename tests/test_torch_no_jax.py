"""Every module of the port imports where jax cannot.

A subprocess installs a meta-path finder that refuses jax, flax, optax,
orbax, sklearn and dualmessagepassing_tpu, then imports every module of
dualmessagepassing_tpu_torch and chip_smoke.py — the machine with the
H100 has none of the refused packages.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
           "dualmessagepassing_tpu")
# imported by name as well, so that a module missing from the package
# fails here rather than dropping out of the walk
REQUIRED = [f"dualmessagepassing_tpu_torch.{m}" for m in (
    "native", "ops.build", "ops.segment_kernel", "ops.scatter_kernels",
    "unc.data", "unc.model", "unc.driver", "train.checkpoint",
    "cli.unc_train", "bench.kernel_bench")]

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    import dualmessagepassing_tpu_torch as pkg
    names = ["dualmessagepassing_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names + {required!r}:
        importlib.import_module(name)
    importlib.import_module("chip_smoke")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names))
""").format(blocked=BLOCKED, required=REQUIRED)


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the package, its subpackages and every module of slices 1 and 2
    assert int(proc.stdout.split()[-1]) >= 22
