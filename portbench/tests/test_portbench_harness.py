"""The harness's logic on the CPU: finding cells, configurations, mixes and
metrics by name; the window's arithmetic; the traced window's reading."""

from __future__ import annotations

import json
import re
import time

import pytest

from portbench import harness, readers, trace
from portbench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seconds=0.3, trace_=False, **kw):
    bench = harness.load_bench(root)
    return harness.run_cell(root, bench, cell, 3_000_000_019, seconds, trace_, "cpu",
                            time.perf_counter(), **kw)


def _fake_capture(run):
    # the profiler's capture as the card would give it: a marker kernel
    # for each marker issued from the first measured one, and a kernel
    # named by the marker's label between each and the next
    labels, first = [], []
    result = run(lambda label="unit": labels.append(label), lambda: first.append(len(labels)))
    measured = labels[first[0]:]
    events = []
    for i, label in enumerate(measured):
        events.append((trace.MARKER, float(i), i + 0.01))
        if i + 1 < len(measured):
            events.append((f"void {label}_kernel(float*)", i + 0.02, i + 0.9))
    return trace.from_intervals(events, measured), result


@pytest.mark.parametrize("cell", ["tiny-tgv.dns", "tiny-tgv.stats", "tiny-tgv.spectra",
                                  "tiny-dfdx.x", "tiny-dfdx.grad"])
def test_cells_added_as_files_run(root, cell):
    # cells, configurations and mixes that exist only as added files and
    # BENCHMARK.json entries run with no edit to the harness
    result, lines = _run(root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    names = {m["name"] for m in harness._for_cell(harness.load_bench(root)["end_to_end"], cell)}
    assert set(result["metrics"]) == names and "setup_s" in names and len(names) >= 2
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"  # the numbers compared come last
    assert lines == [f"check {k}: {c['value']!r} limit {c['limit']!r}"
                     for k, c in result["checks"].items()]
    json.dumps(result, allow_nan=False)


def test_a_metric_added_as_a_file_is_read(root, monkeypatch):
    bench = harness.load_bench(root)
    bench["per_layer"].append({"name": "throwaway.units", "unit": "count", "better": "higher",
                               "source": "device_trace", "layer": "device", "moves": "step_ms",
                               "workloads": ["tiny-tgv.dns"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "metrics" / "throwaway.units.py").write_text(
        "COUNTER = ('adv_lap', 'LAUNCHES3', None)\n"
        "def read(r):\n    return float(r.traced_units + 1000 * r.launches['throwaway.units'])\n")
    monkeypatch.setattr(harness, "capture", _fake_capture)
    result, _ = _run(root, "tiny-tgv.dns", trace_=True)
    mix = json.loads((root / "portbench" / "traffic" / "tiny-dns.json").read_text())
    steps = mix["trace_units"]
    # the plain path launches no kernel: its counter reads 0 over the steps
    assert result["metrics"]["throwaway.units"]["value"] == steps
    # every step logs the kinetic energy: a diagnostics segment (0.99 s from
    # its marker to the next) and a step segment, each one kernel
    assert mix["log_every"]["kinetic_energy"] == 1
    assert result["metrics"]["diag_ms_per_step"]["value"] == pytest.approx(990.0)
    assert result["metrics"]["kernel_launches_per_step"]["value"] == 2
    # a roofline whose kernels are not on the timeline is left out
    assert "k5_roofline_pct" not in result["metrics"]
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_metric_counter_is_one_the_program_has(root):
    bench = harness.load_bench(root)
    for m in bench["per_layer"]:
        module = harness._module(root, "metrics", m["name"])
        if hasattr(module, "COUNTER"):
            assert readers.read_counter(module.COUNTER) is not None, (m["name"], module.COUNTER)
    assert readers.read_counter(("lane", "NO_SUCH_COUNTER", None)) is None
    assert readers.read_counter(("no_such_module", "LAUNCHES", None)) is None
    assert readers.read_counter(("lane", "MODE_LAUNCHES", "no_such_mode")) is None


def test_unknown_names_raise(root):
    bench = harness.load_bench(root)
    with pytest.raises(KeyError):
        harness.cell_files(root, bench, "no-such.cell")


def test_metrics_for_a_cell():
    metrics = [{"name": "a", "moves": "x", "workloads": ["c1"]},
               {"name": "b", "moves": "x"}, {"name": "c", "moves": "y"}]
    assert [m["name"] for m in harness._for_cell(metrics, "c1", {"x"})] == ["a", "b"]
    assert [m["name"] for m in harness._for_cell(metrics, "c2", {"x"})] == ["b"]
    assert [m["name"] for m in harness._for_cell(metrics, "c2")] == ["b", "c"]


def test_judge_keeps_the_worst_and_fails_units():
    checks, failed, lines = harness._judge(
        {0: {"g": 1e-7}, 5: {"g": 3e-6}, 9: {"g": float("nan")}}, {"g": 1e-6})
    assert checks == {"g": {"value": None, "limit": 1e-6}}
    assert failed == [5, 9]
    checks, failed, _ = harness._judge({0: {"g": 1e-7, "h": 2.0}}, {"g": 1e-6})
    assert failed == [0] and checks["h"]["limit"] is None  # a number with no limit fails


def test_union_of_intervals():
    assert trace.union_s([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == pytest.approx(3.0)
    assert trace.union_s([]) == 0.0


def _marks(n, t0=0.0, step=1.0):
    return [(trace.MARKER, t0 + i * step, t0 + i * step + 0.01) for i in range(n)]


def test_timeline_from_synthetic_intervals():
    # three steps after a lead step; each step a kernel of 0.5 s after its marker
    marks = _marks(5)
    kernels = [("void k(float*)", i + 0.2, i + 0.7) for i in range(4)]
    labels = ["step"] * 3 + ["end"]
    tl = trace.from_intervals(marks + kernels, labels)
    assert tl.start == pytest.approx(1.01) and tl.end == pytest.approx(4.0)
    assert tl.busy_s == pytest.approx(1.5)
    assert 100 * (1 - tl.busy_s / tl.window_s) == pytest.approx(100 * (1 - 1.5 / 2.99))
    assert tl.labelled_s("step") == pytest.approx(3 * 0.99)
    bd = tl.breakdown()
    assert bd["device_ops"] == [["k", pytest.approx(1.5)]]
    assert bd["idle_gaps"][0][0] == "idle before k"
    assert trace.from_intervals(marks[:3] + kernels, labels) is None  # too few markers
    assert trace.from_intervals(marks, labels) is None  # no activity


def test_segments_split_a_step_into_its_parts():
    # steps of diagnostics (0.3 s) then the step (0.6 s); the second step logs nothing
    ev = [(trace.MARKER, 0.0, 0.01), ("void diag(float*)", 0.01, 0.3),
          (trace.MARKER, 0.31, 0.32), ("void step(float*)", 0.32, 0.9),
          (trace.MARKER, 0.92, 0.93), ("void step(float*)", 0.93, 1.5),
          (trace.MARKER, 1.5, 1.51)]
    tl = trace.from_intervals(ev, ["diagnostics", "step", "step", "end"])
    assert [s[0] for s in tl.segments] == ["diagnostics", "step", "step"]
    assert tl.labelled_s("diagnostics") == pytest.approx(0.30)
    assert tl.window_s == pytest.approx(1.49)


def _reading(events, units=2, launches=None, shape=(4, 4, 4), mix=None):
    tl = trace.Timeline(events, 0.0, 10.0)
    return readers.Reading(shape, mix or {}, tl, units, launches or {})


def test_kernel_share_holds_the_timeline_against_the_counter():
    ev = [("void compact_lane_kernel<1, false>(...)", 0.0, 2.0),
          ("void compact_lane_kernel<1, false>(...)", 3.0, 5.0)]
    r = _reading(ev, launches={"m": 2})
    pat = re.compile(r"\bcompact_lane_kernel\b")
    share = readers.single_kernel_share(r, "m", pat, 3.35e12, 0.0, 1)
    assert share == pytest.approx(100 * 2 * 1.0 / 4.0)
    r = _reading(ev, launches={"m": 3})  # a launch the timeline lacks
    assert readers.single_kernel_share(r, "m", pat, 1.0, 0.0, 1) is None
    r = _reading(ev, launches={"m": None})  # a counter the program no longer has
    assert readers.single_kernel_share(r, "m", pat, 1.0, 0.0, 1) is None


def test_k5_pairs_its_y_phase_with_the_paired_x_phase(root):
    k5 = harness._module(root, "metrics", "k5_roofline_pct")
    y = "(anonymous namespace)::xy_y_kernel(XYArgs)"
    ev = [(y, 0.0, 1.0), ("(anonymous namespace)::xy_chain_x_kernel<1, 2>(XYArgs, int)", 1.0, 2.0),
          (y, 3.0, 4.0), ("(anonymous namespace)::xy_chain_x_kernel<1, 0>(XYArgs, int)", 4.0, 5.0),
          ("rk3_mega_kernel<1>", 5.0, 6.0)] * 3
    r = _reading(ev, units=1, launches={"k5_roofline_pct": 3}, shape=(8, 8, 8))
    share = k5.read(r)
    assert share == pytest.approx(100 * 3 * 36 * 512 / 3.35e12 / 6.0)
    r = _reading(ev, units=2, launches={"k5_roofline_pct": 3}, shape=(8, 8, 8))
    assert k5.read(r) is None  # 6 launches expected for two steps


def test_kernel_launches_count_kernels_not_copies(root):
    ev = [("void a(float*)", 0.0, 1.0), ("Memcpy DtoD (Device -> Device)", 1.0, 2.0),
          ("void b(float*)", 2.0, 3.0), ("Memset (Device)", 3.0, 3.5)]
    m = harness._module(root, "metrics", "kernel_launches_per_step")
    assert m.read(_reading(ev, units=2)) == 1.0


@pytest.mark.parametrize("op,nbytes", [("dfdx", 8), ("gradient", 16)])
def test_call_mfu_counts_the_call_from_its_shape(root, op, nbytes):
    # two calls in 1 s of traced window on 4^3 points
    tl = trace.Timeline([("k", 0.0, 1.0)], 0.0, 1.0)
    r = readers.Reading((4, 4, 4), {"op": op}, tl, 2, {})
    mfu = harness._module(root, "metrics", "call_mfu_pct").read(r)
    assert mfu == pytest.approx(100 * 64 * nbytes / 3.35e12 / 0.5)
