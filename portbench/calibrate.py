"""The readings the limits of a cell are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \
        --control-seeds 201-203 --seconds 1 [--out FILE]

In one process: the program's run of the cell on each of ``--seeds``, then
the control's (the kind's ``Control``: the plain reference in the next
precision below the configuration's, in the program's place) on each of
``--control-seeds``, every run a short window of the cell's own traffic at
its own sizes, with the sampled answers checked against the float64
reference as in a benchmark run. Prints a JSON line a run and, last, the
largest reading of the program and the smallest of the control for each
number compared. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(root: Path, cell: str, program_seeds, control_seeds, seconds: float,
             device: str = "cuda", emit=print) -> dict:
    """{number: {"program_max", "control_min"}} over the runs, and each run
    emitted as it ends."""
    bench = harness.load_bench(root)
    summary: dict = {}
    runs = [(False, s) for s in program_seeds] + [(True, s) for s in control_seeds]
    for control, seed in runs:
        t0 = time.perf_counter()
        result, _ = harness.run_cell(root, bench, cell, seed, seconds, False, device, t0,
                                     control=control)
        side = "control" if control else "program"
        values = {k: c["value"] for k, c in result["checks"].items()}
        emit(json.dumps({"cell": cell, "system": side, "seed": seed, "checks": values,
                         "correct": result["correct"], "units": result["attempted"],
                         "seconds": time.perf_counter() - t0}))
        for k, v in values.items():
            v = float("inf") if v is None else v
            entry = summary.setdefault(k, {"program_max": 0.0, "control_min": float("inf")})
            if control:
                entry["control_min"] = min(entry["control_min"], v)
            else:
                entry["program_max"] = max(entry["program_max"], v)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    lines = []

    def emit(line):
        lines.append(line)
        print(line, flush=True)

    summary = readings(ROOT, args.workload, seeds(args.seeds), seeds(args.control_seeds),
                       args.seconds, emit=emit)
    emit(json.dumps({"cell": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
