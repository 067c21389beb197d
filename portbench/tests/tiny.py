"""A copy of the benchmark with tiny cells added as files, for CPU tests.

``tiny_root(dest)`` copies ``BENCHMARK.json`` and ``portbench/`` to
``dest`` and adds, by files and entries alone, the configurations
``tiny-tgv`` (16^3) and ``tiny-dfdx`` (24^3), their mixes and the cells
``tiny-tgv.dns``, ``tiny-tgv.stats``, ``tiny-tgv.spectra`` (the stats mix
with the energy spectrum logged too), ``tiny-dfdx.x`` and
``tiny-dfdx.grad``, with limits for the plain CPU path at these sizes; each
tiny cell reports the metrics of the cell it stands for.
The CPU runs the port's plain versions (dense operators, CPU FFTs), whose
float32 gaps from the reference at 16^3 read 6e-7 (a step), 7e-8 (kinetic
energy), 2.5e-7 (enstrophy), 2e-7 (dissipation), 5e-8 (spectrum) and at
24^3 5e-6 (a derivative); the TF32 control reads 4.6e-4, 1e-6, 2e-6,
5e-6, 4e-6 and 6e-2.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_LIMITS = {
    "tiny-tgv.dns": {"step_gap": 1e-5, "ke_gap": 4e-7, "enstrophy_gap": 1e-6},
    "tiny-tgv.stats": {"step_gap": 1e-5, "ke_gap": 4e-7, "enstrophy_gap": 1e-6,
                       "dissipation_gap": 1e-6},
    "tiny-tgv.spectra": {"step_gap": 1e-5, "ke_gap": 4e-7, "enstrophy_gap": 1e-6,
                         "dissipation_gap": 1e-6, "spectrum_gap": 1e-6},
    "tiny-dfdx.x": {"dfdx_gap": 1e-4},
    "tiny-dfdx.grad": {"dfdx_gap": 1e-4, "dfdy_gap": 1e-4, "dfdz_gap": 1e-4},
}

STANDS_FOR = {"tiny-tgv.spectra": "tgv1600-512.stats"}


def _json(path: Path):
    return json.loads(path.read_text())


def _put(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def tiny_root(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    pb = dest / "portbench"
    bench = _json(dest / "BENCHMARK.json")
    for big, small, grid in (("tgv-re1600-512", "tiny-tgv", 16), ("upstream-dfdx-512", "tiny-dfdx", 24)):
        cfg = _json(pb / "configs" / f"{big}.json")
        cfg["name"], cfg["grid"] = small, [grid] * 3
        _put(pb / "configs" / f"{small}.json", cfg)
        entry = dict(next(c for c in bench["configs"] if c["name"] == big))
        entry.update(name=small, file=f"portbench/configs/{small}.json")
        bench["configs"].append(entry)
    for big, small, below in (("dns", "tiny-dns", 40), ("stats", "tiny-stats", 30),
                              ("x", "tiny-x", 20), ("grad", "tiny-grad", 20)):
        mix = _json(pb / "traffic" / f"{big}.json")
        mix["sample_below"] = below
        _put(pb / "traffic" / f"{small}.json", mix)
    mix = _json(pb / "traffic" / "tiny-stats.json")
    mix["log_every"]["energy_spectrum"] = 1
    _put(pb / "traffic" / "tiny-spectra.json", mix)
    for cell, limits in TINY_LIMITS.items():
        config, traffic = cell.split(".")
        bench["workloads"].append({"name": cell, "config": config, "traffic": f"tiny-{traffic}",
                                   "chips": 1, "why": "a CPU test's cell"})
        _put(pb / "workloads" / f"{cell}.json", {"limits": limits})
        big = STANDS_FOR.get(cell) or cell.replace("tiny-tgv", "tgv1600-512").replace(
            "tiny-dfdx", "dfdx-512")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if big in m.get("workloads", ()):
                m["workloads"].append(cell)
    _put(dest / "BENCHMARK.json", bench)
    return dest
