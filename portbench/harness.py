"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run finds everything by name: the cell's entry in ``BENCHMARK.json``
names its configuration (``configs`` entry, whose ``file`` holds it) and
its traffic mix (``portbench/traffic/<traffic>.json``, whose ``kind``
names the module ``portbench/traffic/<kind>.py`` that drives it); the
cell's limits are in ``portbench/workloads/<cell>.json``; each per-layer
metric is read by ``portbench/metrics/<metric>.py``. A later cell, mix or
metric is added by adding files and entries, with no edit here.

In order: make the inputs on the card from the seed; build the program;
warm up the cell's own shapes; run the traffic for ``--seconds`` with the
host dispatching ahead, and synchronise once; with ``--trace 1``, a traced
sub-window of the same traffic (``trace.py``), with the launch counters
that the cell's metrics name read around it; read the memory peak; check
what the window produced against the plain reference; print the result as
the last line of standard output, and each number compared beside its
limit as the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from . import readers
from .trace import capture

__all__ = ["main", "run_cell", "load_bench", "cell_files", "BANNED"]

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "cfd_tpu")  # top-level module names


def load_bench(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _entry(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _module(root: Path, folder: str, name: str):
    """``portbench/<folder>/<name>.py`` under ``root``, loaded by path; its
    relative imports resolve inside the ``portbench`` package."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    mod_name = f"portbench.{folder}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def cell_files(root: Path, bench: dict, name: str):
    """(entry, configuration, mix, kind module, limits) of a cell."""
    root = Path(root)
    entry = _entry(bench["workloads"], name, "workload")
    config = _entry(bench["configs"], entry["config"], "configuration")
    cfg = json.loads((root / config["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    kind = _module(root, "traffic", mix["kind"])
    limits = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())["limits"]
    return entry, cfg, mix, kind, limits


def _for_cell(metrics: List[dict], cell: str, reported: Optional[set] = None) -> List[dict]:
    """The metrics a cell reports: those that list it, and those with no
    list whose end-to-end metric the cell reports (all, for end-to-end
    metrics with no list)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def run_cell(root: Path, bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, *, control: bool = False,
             wrap: Optional[Callable] = None) -> Tuple[dict, List[str]]:
    """One run of cell ``name``: ``(result, check_lines)``.

    ``control`` puts the kind's ``Control`` (the reference in a lower
    precision) in the program's place; ``wrap(sut)`` replaces the system
    under test (a broken one, in the tests).
    """
    import torch

    entry, cfg, mix, kind, limits = cell_files(root, bench, name)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks = [time.perf_counter()]
    inputs = kind.make_inputs(cfg, mix, seed, device)
    sync()
    marks.append(time.perf_counter())
    sut = (kind.Control if control else kind.Program)(cfg, mix, device)
    if wrap is not None:
        sut = wrap(sut)
    marks.append(time.perf_counter())
    kind.warm_up(sut, inputs, mix)
    sync()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    parts = zip(("imports", "inputs", "program", "warm-up"), [t_start] + marks, marks)
    print("portbench: set-up s: " + ", ".join(f"{n} {b - a:.3f}" for n, a, b in parts),
          file=sys.stderr)

    window = kind.run_window(sut, inputs, mix, seconds, sync)
    if trace:
        e2e = {m["name"] for m in _for_cell(bench["end_to_end"], name)}
        per_layer = _for_cell(bench["per_layer"], name, e2e)
        mods = {m["name"]: _module(root, "metrics", m["name"]) for m in per_layer}
        counters = {n: mod.COUNTER for n, mod in mods.items() if hasattr(mod, "COUNTER")}
        first: Dict[str, Optional[int]] = {}

        def marked(marker, start):
            def started():
                start()
                first.update((n, readers.read_counter(c)) for n, c in counters.items())

            units = kind.run_marked(sut, window, inputs, mix, marker, started)
            last = {n: readers.read_counter(c) for n, c in counters.items()}
            return units, {n: None if first.get(n) is None or last[n] is None
                           else last[n] - first[n] for n in counters}

        timeline, (units, launches) = capture(marked)
        if timeline.attempts > 1:
            print(f"portbench: the profiler's capture took {timeline.attempts} attempts",
                  file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window.state.clear()  # the program's last state: the check needs none of it
    del sut
    if cuda:
        torch.cuda.empty_cache()

    readings = kind.check(window, inputs, cfg, mix, device)
    checks, failed_units, lines = _judge(readings, limits)
    result = {"correct": not failed_units and bool(checks), "attempted": window.units,
              "failed": len(failed_units)}
    if trace:
        shape = tuple(int(n) for n in cfg["grid"])
        reading = readers.Reading(shape, mix, timeline, units, launches)
        metrics = {}
        for m in per_layer:
            value = mods[m["name"]].read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(kind.end_to_end(window, cfg, mix), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in _for_cell(bench["end_to_end"], name)}
    result["metrics"] = metrics
    result["device"] = _device(torch, cuda, entry["chips"], peak, timeline if trace else None)
    if trace:
        result["breakdown"] = timeline.breakdown()
    result["checks"] = checks
    return result, lines


def _judge(readings: Dict[int, Dict[str, float]], limits: Dict[str, float]):
    """Each number compared (the worst over the sampled units) beside its
    limit, the sampled units out of a limit, and the lines that say so."""
    worst: Dict[str, float] = {}
    failed = set()
    for unit, values in readings.items():
        for key, value in values.items():
            value = value if math.isfinite(value) else math.inf
            if key not in limits or not value <= limits[key]:
                failed.add(unit)
            worst[key] = max(worst.get(key, value), value)
    # a gap that is not a number is no number: null in the result
    checks = {k: {"value": v if math.isfinite(v) else None, "limit": limits.get(k)}
              for k, v in sorted(worst.items())}
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return checks, sorted(failed), lines


def _device(torch, cuda: bool, chips: int, peak: int, timeline) -> dict:
    if cuda:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(chips),
               "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if timeline is not None:
        out["busy_s"] = timeline.busy_s
        out["window_s"] = timeline.window_s
    return out


def banned_modules() -> List[str]:
    """The modules of ``BANNED`` this process holds, by top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = load_bench(ROOT)
    entry = _entry(bench["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, lines = run_cell(ROOT, bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start)
    banned = banned_modules()
    if banned:
        print(f"portbench: this process holds {banned}; the run measures the port alone",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
