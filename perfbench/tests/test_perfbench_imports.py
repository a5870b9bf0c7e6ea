"""Nothing the harness loads has jax, jaxlib, flax, optax or the JAX
package (dualmessagepassing_tpu) as its top-level module name. The
names are compared whole: the port's name, dualmessagepassing_tpu_torch,
begins with the JAX package's."""

from __future__ import annotations

import subprocess
import sys

from perfbench.core.manifest import ROOT
from perfbench.run import BANNED, banned_modules

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
from perfbench.core.manifest import catalog, resolve
import perfbench.run, perfbench.tools.readings, perfbench.tools.faults
for w in catalog()["workloads"]:
    resolve(w["name"])
from perfbench.run import banned_modules
print(banned_modules())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_banned_names_are_whole_top_level_names():
    assert "dualmessagepassing_tpu" in BANNED
    sys.modules.setdefault("dualmessagepassing_tpu_torch_probe", sys)
    assert "dualmessagepassing_tpu_torch_probe" not in banned_modules()


def test_the_harness_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c",
                           LOAD_ALL.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    banned, loaded = proc.stdout.strip().splitlines()[-2:]
    assert banned == "[]"
    assert "dualmessagepassing_tpu_torch" in loaded


def test_no_source_imports_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                top = words[1].split(".")[0].rstrip(",")
                assert top not in BANNED, f"{path}: {line}"
