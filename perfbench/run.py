"""Run one benchmark cell once, on the machine this starts on.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix,
loop, reference, counts, limits and metrics are found by name from
BENCHMARK.json (perfbench/core/manifest.py). --trace 0 prints the
cell's end-to-end metrics, --trace 1 its per-layer metrics from spans
and one torch.profiler window. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers the
correctness check compared, each beside its limit.

Exit codes: 0 a result was printed; 2 the cards the cell asks for are
not there; 3 a JAX module was loaded; 4 the cell or one of its files
cannot be resolved. Build and kernel caches stay inside the checkout
(build/).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "dualmessagepassing_tpu")


def set_environment() -> None:
    """Caches inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def banned_modules() -> list:
    """Loaded modules whose whole top-level name is a JAX one."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def card_line(torch) -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi not available"
    return (f"card: {smi} | torch {torch.__version__} cuda "
            f"{torch.version.cuda} | matmul.allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32 "
            f"{torch.backends.cudnn.allow_tf32}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    set_environment()
    import torch

    from perfbench.core.harness import run_cell
    from perfbench.core.manifest import ManifestError, resolve

    try:
        cell = resolve(args.workload)
    except (ManifestError, ImportError) as e:
        print(f"cannot resolve {args.workload}: {e}", file=sys.stderr)
        return 4
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    print(card_line(torch), flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = banned_modules()
    if found:
        print(f"JAX modules loaded in the measuring process: {found}: no "
              "result", file=sys.stderr)
        return 3
    for line in result.pop("_log"):
        print(line, file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
