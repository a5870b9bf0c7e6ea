"""The readings the limits of `correct` are set from, on the card at the
cell's own size:

    python perfbench/tools/readings.py --workload <name> \
        --seeds 11,12,... --fault-seeds 21,22,23 [--out FILE]

For each seed: the program's numbers (set-up, for an answer cell a
short window at the cell's load, then the check) and the control's
(the reference with TF32 matmuls against the float32 reference, on the
same inputs). For each fault seed: the numbers of the program with each
fault of the cell's loop planted (tools/faults.py). One JSON line per
reading, and all of them in --out. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ANSWER_WINDOW_S = 2.0


def readings(cell, seed: int, device, fault: str = None) -> dict:
    import torch

    from perfbench.core.harness import Context
    from perfbench.core.trace import Tracer
    from perfbench.tools.faults import planted

    loop = cell.loop
    ctx = Context(cell, seed, device, Tracer(False))
    t0 = time.perf_counter()
    name = cell.traffic["loop"]
    with (planted(name, fault) if fault else contextlib.nullcontext()):
        st = loop.setup(ctx)
        if hasattr(st, "kept"):
            loop.window(st, ANSWER_WINDOW_S, ctx)
    loop.release(st)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "fault": fault, "program": loop.check(st, ctx)}
    if fault is None:
        out["control"] = loop.control(st, ctx)
    if hasattr(st, "last_ref"):
        from perfbench.core.compare import training_detail
        out["detail"] = training_detail(st.losses, st.grad1, st.after,
                                        st.last_ref)
        if hasattr(st, "last_control"):
            low, ref = st.last_control
            out["control_detail"] = training_detail(
                low["losses"], low["grad1"], low["after"], ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import set_environment
    set_environment()
    import torch

    from perfbench.core.manifest import resolve
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    traffic = dict(cell.traffic)
    if "batches" in traffic and "check_steps" in traffic:
        # only the checked steps' batches are read: sample no more
        traffic["batches"] = traffic["check_steps"]
    cell = dataclasses.replace(cell, traffic=traffic)
    rows = []
    seeds = [int(s) for s in args.seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    jobs = [(s, None) for s in seeds] + [
        (s, f) for s in fault_seeds for f in cell.loop.FAULTS]
    for seed, fault in jobs:
        row = readings(cell, seed, device, fault)
        row["workload"] = args.workload
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
