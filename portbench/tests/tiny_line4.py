"""A copy of the benchmark with a tiny four-shard ``dist_derivs`` cell, for
CPU tests.

``tiny_line4_root(dest)`` copies ``BENCHMARK.json`` and ``portbench/`` to
``dest`` and adds, by files and entries alone, the configuration
``tiny-line4`` (``upstream-dfdx-2048-line4`` at a local block of (4, 6, 128),
on the same (1, 1, 4) mesh), its mix ``tiny-x-line4`` and the cell
``tiny-line4.x``, which reports the metrics of ``dfdx-2048-line4.x``. On the
CPU every shard sits on the one device and the distributed layer takes its
float32 PCR route; its gap from the reference at this size reads 7.9e-7
(largest of three seeds), the TF32 control 1.25 and more, and a call with
no reduced system (each shard an independent bounded line) 1.6e-4.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny-line4.x"
STANDS_FOR = "dfdx-2048-line4.x"
LIMITS = {"dfdx_gap": 1e-5}


def _json(path: Path):
    return json.loads(path.read_text())


def _put(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def tiny_line4_root(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    pb = dest / "portbench"
    bench = _json(dest / "BENCHMARK.json")
    big = next(w for w in bench["workloads"] if w["name"] == STANDS_FOR)
    cfg = _json(pb / "configs" / f"{big['config']}.json")
    cfg["name"], cfg["grid"] = "tiny-line4", [4, 6, 512]
    _put(pb / "configs" / "tiny-line4.json", cfg)
    entry = dict(next(c for c in bench["configs"] if c["name"] == big["config"]))
    entry.update(name="tiny-line4", file="portbench/configs/tiny-line4.json")
    bench["configs"].append(entry)
    mix = _json(pb / "traffic" / f"{big['traffic']}.json")
    mix["sample_below"] = 20
    _put(pb / "traffic" / "tiny-x-line4.json", mix)
    bench["workloads"].append({"name": CELL, "config": "tiny-line4", "traffic": "tiny-x-line4",
                               "chips": 4, "why": "a CPU test's cell"})
    _put(pb / "workloads" / f"{CELL}.json", {"limits": LIMITS})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if STANDS_FOR in m.get("workloads", ()):
            m["workloads"].append(CELL)
    _put(dest / "BENCHMARK.json", bench)
    return dest
