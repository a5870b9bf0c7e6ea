"""The port's public API against the JAX package's: every name that an
__init__.py of dualmessagepassing_tpu exports (the top level, data,
models, ops, parallel, train, unc, utils) has a counterpart in the same
subpackage of dualmessagepassing_tpu_torch, by the same name or through
RENAMES, the places where the port's idiom replaced a JAX name. A
renamed name is not exported under its JAX name as well, and the port's
__init__ docstring names both. The top-level imports work where jax
cannot be imported.
"""

import importlib
import subprocess
import sys
import textwrap
import types

import pytest

from test_torch_no_jax import BLOCKED, ROOT

SUBPACKAGES = ("", "data", "models", "ops", "parallel", "train", "unc",
               "utils")
# (subpackage, JAX name) -> the port's counterpart in that subpackage
RENAMES = {
    # the model and the optimizer hold the training state
    ("train", "TrainState"): "SCMOptimizer",
    # a process group's rank holds its share and a replicated copy: no
    # mesh or sharding object
    ("parallel", "make_dp_mesh"): "launch",
    ("parallel", "batch_sharding"): "World",
    ("parallel", "replicated"): "World",
    # the forward itself, called on each rank with its World
    ("parallel", "make_edge_parallel_dmp_apply"): "edge_parallel_dmp_apply",
}


def module(pkg, sub):
    return importlib.import_module(pkg + ("." + sub if sub else ""))


def jax_exports(sub):
    """The names the JAX __init__.py binds, submodules left out."""
    mod = module("dualmessagepassing_tpu", sub)
    names = {k for k, v in vars(mod).items()
             if not k.startswith("_") and not isinstance(v, types.ModuleType)
             and k != "annotations"}
    if hasattr(mod, "__version__"):
        names.add("__version__")
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_every_jax_export_has_a_port_counterpart(sub):
    port = module("dualmessagepassing_tpu_torch", sub)
    names = jax_exports(sub)
    assert names, sub
    missing = []
    for name in sorted(names):
        new = RENAMES.get((sub, name))
        if new is None:
            if not hasattr(port, name):
                missing.append(name)
            continue
        assert hasattr(port, new), (sub, name, new)
        # no alias that pretends to be the JAX API
        assert not hasattr(port, name), (sub, name)
        assert name in port.__doc__ and new in port.__doc__, (sub, name)
    assert not missing, f"{sub or 'top level'}: no counterpart of {missing}"
    # what the port lists is there
    for name in getattr(port, "__all__", ()):
        assert hasattr(port, name), (sub, name)


def test_renames_name_real_jax_exports():
    for (sub, name) in RENAMES:
        assert name in jax_exports(sub), (sub, name)


def test_top_level_matches_the_jax_package():
    import dualmessagepassing_tpu as jp
    import dualmessagepassing_tpu_torch as tp
    assert tp.__version__ == jp.__version__
    assert sorted(tp.__all__) == sorted(jp.__all__)


def test_top_level_imports_without_jax():
    script = textwrap.dedent(f"""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError(f"blocked import: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        from dualmessagepassing_tpu_torch import (ModelConfig, batch_graphs,
                                                  build_model, single_graph)
        from dualmessagepassing_tpu_torch.unc import train_unc
        from dualmessagepassing_tpu_torch.parallel import World, launch
        g = batch_graphs([single_graph(3, [0, 1], [1, 2], v_max=4,
                                       e_max=4)])
        cfg = ModelConfig(max_ngv=4, max_ngvl=2, max_nge=4, max_ngel=2,
                          max_npv=4, max_npvl=2, max_npe=4, max_npel=2,
                          hid_dim=8)
        out = build_model(cfg, device="cpu")(g, g)
        print(tuple(out["pred_c"].shape))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("(1, 1)"), proc.stdout
