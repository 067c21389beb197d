"""The port's benchmark and diagnosis scripts.

The counterparts of the JAX package's ``benchmarks/`` scripts, on the
port and on one CUDA card. Each module has ``main(argv=None)``, runs as
``python -m cfd_tpu_torch.benchmarks.<name>`` and takes ``--device``
(``cuda`` by default; ``cpu`` runs the plain versions, as the tests do).
Each prints one JSON object a line, holds every case to its gate before
it times it, and writes a file only where ``--out`` says. A failed gate,
or a case that raises, ends the script with a nonzero exit once its rows
are printed. Times on the card are device times (``utils.time_ms``:
CUDA events, every call queued; the ``diag_*`` step scripts read the
profiler's device timeline); times on the CPU are the host's, and say so.

* ``diag_lane`` — copy floors of each access pattern (K14) and K1 at
  lines of 256 and 512 points;
* ``diag_dfdz`` — the dfdz kernel's stages (K15: copy, rolls, dots,
  dots_default), then K2's dfdz and the dense route;
* ``run_single`` — the solve-only sweep, the full derivatives, d2 and a
  filter, gated against float64;
* ``run_distributed`` — the distributed dfdx on ``Config.from_env()``'s
  mesh, its shards on one device;
* ``diag_axes``, ``diag_rk3``, ``diag_ns`` — the axis derivatives and the
  Laplacian, the fused and generic RK3 steps, the Navier–Stokes step.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

import torch

from ..utils import device_op_time_ms, time_ms

__all__ = ["Report", "parser", "device_of", "device_name", "bench_ms", "timeline_ms"]


def parser(description: str) -> argparse.ArgumentParser:
    """The arguments every script takes: ``--device`` and ``--out``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the plain versions run")
    ap.add_argument("--out", default=None, help="write the rows to this JSON file")
    return ap


def device_of(name: str) -> torch.device:
    """The device ``--device`` names; a CUDA device that is not there
    raises, it never falls back to the CPU. Float32 products on the card
    stay in full float32 (no TF32)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device here (use --device cpu)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's name."""
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    if shutil.which("nvidia-smi"):
        done = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        if done.returncode == 0 and done.stdout.strip():
            name = done.stdout.strip().splitlines()[0]
    return name


def bench_ms(fn, dev: torch.device) -> float:
    """Median ms of one ``fn()`` call (``utils.time_ms``); a few calls on
    the CPU, where the scripts run at test sizes."""
    if dev.type == "cuda":
        return time_ms(fn, dev)
    return time_ms(fn, dev, warmup=1, iters=3)


def timeline_ms(fn, x: torch.Tensor, *, captures: int, iters: int = 8):
    """``(ms, floor_ms, clock)`` of ``fn(x)``: on the card the least
    device time of a call over ``captures`` profiler captures with a
    complete device timeline, with the in-capture copy floor
    (``utils.device_op_time_ms``); a capture without one is taken again,
    up to ``captures`` more times. Where fewer come back complete, the
    case is timed with queued CUDA events instead (``utils.time_ms``: the
    call and, as its floor, the one-read, one-write scale of x), and
    ``clock`` says so. On the CPU the host's median, with no floor."""
    if x.device.type != "cuda":
        return bench_ms(lambda: fn(x), x.device), None, "host clock"
    best = floor = float("inf")
    complete = 0
    for _ in range(2 * captures):
        ms, floor_ms, n = device_op_time_ms(fn, x, iters=iters)
        if n:
            best, floor, complete = min(best, ms), min(floor, floor_ms), complete + 1
        if complete == captures:
            return best, floor, "device timeline"
    clock = (f"cuda events, queued ({complete} of {captures} profiler captures had a "
             "device timeline)")
    return (time_ms(lambda: fn(x), x.device), time_ms(lambda: x * 1.000001, x.device), clock)


class Report:
    """A script's rows: each is printed as it comes; ``fail`` marks the
    run failed; ``finish`` writes ``--out`` and exits nonzero on a failure."""

    def __init__(self, script: str, dev: torch.device):
        self.script = script
        self.device = device_name(dev)
        self.rows = []
        self.failed = []
        clock = "cuda events, queued" if dev.type == "cuda" else "host clock"
        self.emit({"script": script, "device": self.device, "clock": clock})

    def emit(self, row: dict) -> dict:
        self.rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    def fail(self, row: dict, why: str) -> dict:
        self.failed.append(f"{row.get('case', row)}: {why}")
        return self.emit({**row, "gate": "failed", "why": why})

    def error(self, case: str, exc: BaseException) -> dict:
        self.failed.append(f"{case}: {type(exc).__name__}")
        return self.emit({"case": case, "error": f"{type(exc).__name__}: {str(exc)[:300]}"})

    def finish(self, out: str = None) -> list:
        if out:
            with open(out, "w") as fh:
                json.dump({"script": self.script, "device": self.device, "results": self.rows},
                          fh, indent=1)
                fh.write("\n")
        if self.failed:
            print(f"{self.script}: {len(self.failed)} failed: {self.failed}", file=sys.stderr)
            raise SystemExit(1)
        return self.rows
