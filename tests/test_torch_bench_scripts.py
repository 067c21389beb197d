"""The port's benchmark scripts (``cfd_tpu_torch.benchmarks``) on the CPU.

Each script's ``main`` runs in process with ``--device cpu`` at a small
size (n <= 32; diag_dfdz at n = 128, since its dots stages take 128-row
blocks; run_distributed on a (2, 2, 2) mesh of ``"cpu"`` shards): every
expected row is printed, no gate fails, and nothing is written unless
``--out`` names a file. A failed gate ends a script with a nonzero exit
after its rows. The gates themselves are the JAX scripts' (each script's
doc); here they hold the plain versions, which the scripts run on the
CPU. ``utils.profiling.device_op_time_ms`` returns ``(inf, inf, 0)`` on
the CPU, as the JAX version does without a device timeline, and
``utils.profiling.trace`` writes a Chrome trace.
"""

import importlib
import json
import math
from pathlib import Path

import pytest
import torch

from cfd_tpu_torch.utils import device_op_time_ms

ROOT = Path(__file__).resolve().parent.parent

SCRIPTS = {
    # name: (argv, environment, cases every run prints)
    "diag_lane": (["--n", "32", "--passes", "1"], {}, [
        "copy (1024,32) rows=1024", "copy (512,64) rows=512", "copy (32,1024) cols=512",
        "copy 3d (32,8,32)", "copy 3d (32,32,32)", "copy 3d (8,32,32)", "K1 n=32 B=1024",
        "K1 n=64 B=512", "K1 (8,8,64)", "K1 64^3"]),
    "diag_dfdz": (["--n", "128", "--passes", "1"], {}, [
        f"{m} C={C}" for C in (1024, 2048) for m in ("copy", "rolls", "dots", "dots_default")]
        + ["K2 dfdz", "matmul dfdz"]),
    "run_single": (["--sizes", "16,32"], {}, [
        f"{b} {n}^3" for n in (16, 32) for b in (
            "pcr", "k12_lines", "torch.matmul(dense inverse)", "dfdx", "dfdy", "dfdz",
            "d2fdx2", "d2fdz2", "filter_x")]),
    "run_distributed": ([], {"CFD_MESH": "2,2,2", "CFD_GRID": "32,32,32", "CFD_SPACING": "0.1"},
                        ["distributed_dfdx 2x2x2"]),
    "diag_axes": (["--n", "32"], {},
                  ["dfdx", "dfdy", "dfdz", "laplacian"]),
    "diag_rk3": (["--n", "32"], {}, [
        "advection-diffusion fused vs generic step", "generic step", "fused step",
        "advection_pair (K13)", "lap_rhs (K9)", "adv_lap_rhs merged (K3)", "rk3_mega (K4)",
        "dfdz mul + acc (K2)", "rk3 solve + update (K2 rk)", "burgers fused vs generic step",
        "burgers generic step", "burgers fused step"]),
    "diag_ns": (["--n", "32"], {}, [
        "post-step max|div u| / max|u| (compact, projected)",
        "poisson (torch.fft, float32) vs host float64 FFT", "NS step (3 stages)",
        "projection (1 of 3)", "poisson (torch.fft)", "poisson matmul-DFT"]),
}


def _case(row):
    """A row's case name: ``case``, or run_single's and run_distributed's
    (bench, solver/op, grid/mesh)."""
    if "case" in row:
        return row["case"]
    label = row.get("solver") or row.get("op") or row["bench"]
    return f"{label} {row.get('grid') if 'solver' in row or 'op' in row else row['mesh']}"


def _run(name, argv, env, monkeypatch, capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rows = importlib.import_module(f"cfd_tpu_torch.benchmarks.{name}").main(
        argv + ["--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    return rows, printed


def _results_dir_state():
    results = ROOT / "benchmarks" / "results"
    return sorted((p.name, p.stat().st_mtime_ns) for p in results.iterdir())


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_prints_every_row_and_writes_nothing(name, monkeypatch, capsys, tmp_path):
    argv, env, expected = SCRIPTS[name]
    monkeypatch.chdir(tmp_path)
    results = _results_dir_state()
    rows, printed = _run(name, argv, env, monkeypatch, capsys)
    assert printed == rows
    assert rows[0] == {"script": name, "device": "cpu", "clock": "host clock"}
    cases = {_case(r) for r in rows[1:]}
    assert set(expected) <= cases, set(expected) - cases
    for row in rows:
        assert "error" not in row and row.get("gate") != "failed", row
    timed = [r for r in rows if "ms" in r]
    assert timed and all(r["ms"] > 0 for r in timed)
    assert list(tmp_path.iterdir()) == []
    assert _results_dir_state() == results


def test_out_writes_the_rows(monkeypatch, capsys, tmp_path):
    out = tmp_path / "lane.json"
    rows, _ = _run("diag_lane", ["--n", "16", "--passes", "1", "--quick", "--out", str(out)], {},
                   monkeypatch, capsys)
    saved = json.loads(out.read_text())
    assert saved["script"] == "diag_lane" and saved["device"] == "cpu"
    assert saved["results"] == rows


def test_failed_gate_exits_nonzero_after_its_rows(monkeypatch, capsys):
    from cfd_tpu_torch.benchmarks import diag_dfdz

    monkeypatch.setattr(diag_dfdz, "DOTS_GATE", 0.0)
    with pytest.raises(SystemExit) as done:
        diag_dfdz.main(["--n", "128", "--passes", "1", "--device", "cpu"])
    assert done.value.code == 1
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    failed = [r["case"] for r in printed if r.get("gate") == "failed"]
    assert failed == ["dots C=1024", "dots C=2048"]
    assert any(r.get("case") == "rolls C=2048" and "ms" in r for r in printed)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default device is taken")
    from cfd_tpu_torch.benchmarks import diag_lane

    with pytest.raises(SystemExit, match="no CUDA device"):
        diag_lane.main(["--n", "16", "--quick"])


def test_device_op_time_ms_on_cpu_has_no_timeline():
    assert device_op_time_ms(lambda t: t * 2.0, torch.ones(4, 4, 4), iters=2) == \
        (math.inf, math.inf, 0)


def test_timeline_ms_takes_the_event_clock_after_incomplete_captures(monkeypatch):
    """Where the profiler returns fewer complete captures than asked, after
    twice as many tries, the case is timed with queued CUDA events
    (``utils.time_ms``) and its clock says so; it does not fail."""
    import cfd_tpu_torch.benchmarks as bench

    tries, timed = [], []
    monkeypatch.setattr(bench, "device_op_time_ms",
                        lambda fn, x, iters: tries.append(iters) or (math.inf, math.inf, 0))
    monkeypatch.setattr(bench, "time_ms", lambda fn, dev: timed.append(dev) or 0.25)

    class OnCard:  # the wrapper reads only the tensor's device here
        device = torch.device("cuda", 0)

    ms, floor_ms, clock = bench.timeline_ms(lambda x: x, OnCard(), captures=3)
    assert tries == [8] * 6 and timed == [OnCard.device] * 2
    assert (ms, floor_ms) == (0.25, 0.25)
    assert clock.startswith("cuda events, queued") and "0 of 3" in clock
    # complete captures keep the device timeline
    monkeypatch.setattr(bench, "device_op_time_ms", lambda fn, x, iters: (0.5, 0.1, iters))
    assert bench.timeline_ms(lambda x: x, OnCard(), captures=3) == (0.5, 0.1, "device timeline")


def test_trace_writes_a_chrome_trace(tmp_path):
    from cfd_tpu_torch.utils import trace

    with trace(str(tmp_path / "t")):
        torch.ones(8, 8).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("aten::sum" in str(e.get("name")) for e in events)
