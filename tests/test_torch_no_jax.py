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
    "ops.encoding", "models.compgcn", "unc.data", "unc.model",
    "unc.driver", "unc.linear_svc", "unc.evaluate", "unc.transform",
    "train.checkpoint", "cli.unc_train", "cli.unc_evaluate",
    "cli.unc_transform", "bench.kernel_bench",
    # the SCM flagship
    "graph", "data.subiso", "data.synthetic", "data.dataset", "ops.scatter",
    "ops.spectral", "utils.act", "utils.init", "models.layers",
    "models.embed", "models.filter", "models.dmpnn", "models.pred",
    "models.basemodel", "models.scm_models", "train.losses",
    "train.schedules", "train.samplers", "train.scm_driver",
    # the SCM command lines and the learning gates
    "utils.log", "utils.io", "cli.config", "cli.scm_train",
    "cli.scm_evaluate", "data.dual", "gates.scm_convergence",
    "gates.unc_convergence",
    # the SCM graph networks
    "models.rgnn", "models.lrp", "data.lrp",
    # the SCM sequence networks
    "models.edgeseq",
    # the attention predict nets
    "models.pred_attn",
    # scale-out over torch.distributed
    "parallel", "parallel.dist", "parallel.dp", "parallel.ep_unc",
    # owner-sharded (halo) training and the north-star gate
    "parallel.halo_unc", "gates.northstar",
    # the demonstration layer, the halo library, its benches, the dry run
    "parallel.edge_partition", "parallel.halo", "bench.halo_bench",
    "bench.partition_bench", "dryrun",
    # the SCM learning run and its spread
    "bench.scm_learn_spread",
    # the examples
    "examples", "examples.quickstart_scm", "examples.multichip_dp",
    "examples.edge_parallel", "examples.performance_levers")]

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
    # the package, its subpackages and every module listed above
    assert int(proc.stdout.split()[-1]) >= 60
