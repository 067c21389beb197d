"""The benchmark's ``dist_derivs`` kind on the CPU.

Through a tiny copy of the benchmark (``portbench/tests/tiny_line4.py``:
the ``dfdx-2048-line4.x`` cell's configuration at a local block of (4, 6,
128) on the same (1, 1, 4) mesh, every shard on the CPU): the cell runs and
is correct; the TF32 control in the program's place is not, on three seeds;
nor is a timed path broken in each of three ways: the input returned, one
shard left out, every shard solved as an independent bounded line with no
reduced system (the fault that shows the check sees the coupling between
shards). The cell's four per-layer metrics read what they should from a
timeline made up here, and leave out what the parent program lacks.
"""

from __future__ import annotations

import json
import re
import time

import numpy as np
import pytest
import torch

from portbench import harness, readers, trace
from portbench.tests.tiny_line4 import CELL, LIMITS, tiny_line4_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_line4_root(tmp_path_factory.mktemp("bench"))


def _run(root, seed=3_000_000_029, **kw):
    bench = harness.load_bench(root)
    result, _ = harness.run_cell(root, bench, CELL, seed, 0.2, False, "cpu",
                                 time.perf_counter(), **kw)
    return result


@pytest.mark.parametrize("seed", [3_200_000_001, 3_200_000_002])
def test_the_tiny_cell_is_correct(root, seed):
    result = _run(root, seed)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(LIMITS)
    assert set(result["metrics"]) == {"gpts_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("seed", [3_100_000_001, 3_100_000_002, 3_100_000_003])
def test_the_control_is_not_correct(root, seed):
    result = _run(root, seed, control=True)
    assert not result["correct"], result["checks"]


class Broken:
    """The system under test with one fault in its timed path."""

    def __init__(self, sut, fault, h, scheme):
        self.sut, self.fault, self.h, self.scheme = sut, fault, h, scheme

    def call(self, blocks):
        from cfd_tpu_torch.ops import derivatives

        out = self.sut.call(blocks)
        if self.fault == "input":
            return tuple(blocks)
        if self.fault == "shard_left_out":
            return out[:1] + (torch.zeros_like(out[1]),) + out[2:]
        if self.fault == "no_reduced_system":
            return tuple(derivatives.dfdx(b, self.h, self.scheme) for b in blocks)
        return out


@pytest.mark.parametrize("fault", ["input", "shard_left_out", "no_reduced_system", None])
def test_a_broken_timed_path_is_not_correct(root, fault):
    from portbench.traffic import scheme_named

    cfg = json.loads((root / "portbench" / "configs" / "tiny-line4.json").read_text())
    h = cfg["length"] / (cfg["grid"][2] // cfg["mesh"][2] - 1)
    result = _run(root, wrap=lambda sut: Broken(sut, fault, h, scheme_named(cfg["scheme"])))
    if fault is None:
        assert result["correct"], result["checks"]
    else:
        assert not result["correct"], (fault, result["checks"])
        assert result["failed"] >= 1


def _fake_capture(run):
    # a marker kernel for each marker issued from the first measured one,
    # and between each and the next a K11 launch on each of the four cards
    # and two copies between cards
    labels, first = [], []
    result = run(lambda label="unit": labels.append(label), lambda: first.append(len(labels)))
    measured = labels[first[0]:]
    events = []
    for i in range(len(measured)):
        events.append((trace.MARKER, float(i), i + 0.01))
        if i + 1 < len(measured):
            events += [("void lane_dist_kernel<1>(float const*)", i + 0.1, i + 0.6)] * 4
            events += [("Memcpy PtoP (Device -> Device)", i + 0.6, i + 0.7)] * 2
    return trace.from_intervals(events, measured), result


def test_the_program_is_the_solvers_own_dfdx(root, monkeypatch):
    # the cell times DistributedCompactSolver.dfdx as any caller runs it
    from cfd_tpu_torch.parallel import DistributedCompactSolver

    calls = []
    plain = DistributedCompactSolver.dfdx

    def counted(self, f):
        calls.append(f.shape)
        return plain(self, f)

    monkeypatch.setattr(DistributedCompactSolver, "dfdx", counted)
    result = _run(root)
    assert result["correct"], result["checks"]
    assert len(calls) >= result["attempted"] > 0
    assert set(calls) == {(4, 6, 512)}


def test_the_mix_and_the_mesh_agree_on_the_cards(root):
    from portbench.traffic import dist_derivs

    cfg = json.loads((root / "portbench" / "configs" / "tiny-line4.json").read_text())
    mix = json.loads((root / "portbench" / "traffic" / "tiny-x-line4.json").read_text())
    with pytest.raises(ValueError, match="cards"):
        dist_derivs.make_inputs(cfg, dict(mix, cards=2), 1, "cpu")


@pytest.mark.parametrize("control", [False, True])
def test_the_warm_up_holds_the_program_to_the_closed_loop(root, monkeypatch, control):
    # the program's call is run once on each field under the sync debug
    # mode after the warm-up; the control, a reference, is not held to it
    _, cfg, mix, kind, _ = harness.cell_files(root, harness.load_bench(root), CELL)
    held = []
    monkeypatch.setattr(kind, "issues_ahead",
                        lambda call, fields, devices: held.append((len(fields), devices)))
    inputs = kind.make_inputs(cfg, mix, 3_000_000_037, "cpu")
    kind.warm_up((kind.Control if control else kind.Program)(cfg, mix, "cpu"), inputs, mix)
    assert held == ([] if control else [(3, (torch.device("cpu"),) * 4)])


@pytest.mark.gpu
def test_a_call_that_waits_on_a_card_stops_the_warm_up():
    # a call that only queues work passes; one that copies from pageable
    # host memory, as a table made anew on every call does, stops
    from portbench.traffic import dist_derivs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    fields = [(torch.ones(64, device=card),) for _ in range(3)]
    dist_derivs.issues_ahead(lambda b: (b[0] * 2,), fields, [card])
    rows = np.ones(64)
    with pytest.raises(RuntimeError, match="waits on a card"):
        dist_derivs.issues_ahead(
            lambda b: (b[0] * torch.as_tensor(rows, dtype=b[0].dtype, device=card),),
            fields, [card])
    dist_derivs.issues_ahead(lambda b: (b[0] * 2,), fields, [card])  # the mode was reset


def test_a_traced_run_reads_what_the_program_has(root, monkeypatch):
    # on the CPU no K11 runs and no copy crosses devices: the counters read
    # 0 over the traced calls, so K11's share (4 launches a call on the
    # timeline, none counted) is left out
    monkeypatch.setattr(harness, "capture", _fake_capture)
    bench = harness.load_bench(root)
    result, _ = harness.run_cell(root, bench, CELL, 3_000_000_031, 0.2, True, "cpu",
                                 time.perf_counter())
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert "k11_roofline_pct" not in metrics
    assert metrics["peer_copies_per_call"] == 0
    assert metrics["exchange_ms_per_call"] == pytest.approx(2 * 100.0)
    assert metrics["dist_call_mfu_pct"] > 0


def _reading(root, name, events, units, launches, shape=(512, 512, 2048), cards=4):
    tl = trace.Timeline(events, 0.0, 10.0)
    reading = readers.Reading(shape, {"op": "dfdx", "cards": cards}, tl, units,
                              {name: launches})
    return harness._module(root, "metrics", name).read(reading)


def test_k11_share_counts_a_launch_on_its_shard(root):
    k11 = [("void lane_dist_kernel<1>(float const*)", 0.0, 1e-3)] * 8
    other = [("void compact_strided_dist_kernel<1>(float const*)", 0.0, 1.0)]
    least = 8 * 512 ** 3 / 3.35e12  # bytes over the card's memory rate
    share = _reading(root, "k11_roofline_pct", k11 + other, 2, 8)
    assert share == pytest.approx(100 * least / 1e-3)
    assert _reading(root, "k11_roofline_pct", k11, 2, 7) is None  # a launch not counted
    assert _reading(root, "k11_roofline_pct", k11, 3, 8) is None  # 12 expected
    assert _reading(root, "k11_roofline_pct", k11, 2, None) is None  # no counter
    # the mix's cards set the launches a call and a launch's shard
    share = _reading(root, "k11_roofline_pct", k11, 4, 8, cards=2)
    assert share == pytest.approx(100 * 2 * least / 1e-3)


def test_the_call_share_spreads_the_grid_over_four_cards(root):
    # 10 s of window over 4 calls: 2.5 s a call
    least = 8 * 512 * 512 * 2048 / 3.35e12 / 4
    share = _reading(root, "dist_call_mfu_pct", [("k", 0.0, 1.0)], 4, None)
    assert share == pytest.approx(100 * least / 2.5)
    share = _reading(root, "dist_call_mfu_pct", [("k", 0.0, 1.0)], 4, None, cards=2)
    assert share == pytest.approx(100 * 2 * least / 2.5)


def test_exchange_time_is_everything_but_k11(root):
    # everything but K11 and the replay's copies within a card
    events = [("void lane_dist_kernel<1>(float const*)", 0.0, 1.0),
              ("Memcpy PtoP (Device -> Device)", 1.0, 1.5),
              ("Memcpy DtoD (Device -> Device)", 1.5, 2.5),
              ("void at::native::elementwise_kernel<128, 2>()", 0.5, 0.75)]
    assert _reading(root, "exchange_ms_per_call", events, 2, None) == pytest.approx(375.0)


def test_peer_copies_per_call(root):
    assert _reading(root, "peer_copies_per_call", [], 4, 72) == 18
    assert _reading(root, "peer_copies_per_call", [], 4, None) is None


def test_the_new_counters_are_ones_the_program_has(root):
    for name in ("k11_roofline_pct", "peer_copies_per_call"):
        module = harness._module(root, "metrics", name)
        assert readers.read_counter(module.COUNTER) is not None


def test_the_cell_entry_is_well_formed():
    bench = harness.load_bench(harness.ROOT)
    cell = next(w for w in bench["workloads"] if w["name"] == "dfdx-2048-line4.x")
    assert cell["chips"] == 4 and cell["traffic"] == "x-line4"
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    names = [m["name"] for m in bench["per_layer"] if "dfdx-2048-line4.x" in m.get("workloads", ())]
    assert names == ["k11_roofline_pct", "dist_call_mfu_pct", "exchange_ms_per_call",
                     "peer_copies_per_call"]
    e2e = [m["name"] for m in bench["end_to_end"] if "dfdx-2048-line4.x" in m.get("workloads", ())]
    assert e2e == ["gpts_per_s"]
    for m in bench["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", m["name"])
