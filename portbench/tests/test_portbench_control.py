"""The comparison that decides ``correct`` fails what it has to fail.

On the CPU, at sizes a test run holds (``tiny.py``'s cells): the control
(the plain reference in TF32 in the program's place) comes out not correct
on three seeds, and so does a run whose timed path is broken underneath in
each way these cells can be: a step or call that returns its input
unchanged, half of the field left out (of a step, of a derivative, of the
kinetic energy's mean), an answer altered where it is produced. On the
card (``gpu``), a short run of each cell comes out correct.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import TINY_LIMITS, tiny_root

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=3_000_000_029, **kw):
    bench = harness.load_bench(root)
    result, _ = harness.run_cell(root, bench, cell, seed, 0.2, False, "cpu",
                                 time.perf_counter(), **kw)
    return result


@pytest.mark.parametrize("cell", sorted(TINY_LIMITS))
@pytest.mark.parametrize("seed", [3_100_000_001, 3_100_000_002, 3_100_000_003])
def test_the_control_is_not_correct(root, cell, seed):
    result = _run(root, cell, seed, control=True)
    assert not result["correct"], result["checks"]


def _half(out, like):
    n = out.shape[0] // 2
    return torch.cat([out[:n], like[n:]])


def _altered(out):
    out = out.clone()
    out.view(-1)[7] += 1e-3 * float(out.abs().max())
    return out


class Broken:
    """The system under test with one fault in its timed path."""

    def __init__(self, sut, fault):
        self.sut, self.fault = sut, fault

    def __getattr__(self, name):
        return getattr(self.sut, name)

    def step(self, u):
        out = self.sut.step(u)
        if self.fault == "unchanged":
            return tuple(u)
        if self.fault == "half":
            return tuple(_half(o, c) for o, c in zip(out, u))
        if self.fault == "altered":
            return (_altered(out[0]), *out[1:])
        return out

    def kinetic_energy(self, u):
        if self.fault == "ke_half":
            n = u[0].shape[0] // 2
            return 0.5 * sum(torch.mean(c[:n] * c[:n]) for c in u)
        return self.sut.kinetic_energy(u)

    def call(self, f):
        out = self.sut.call(f)
        if self.fault == "unchanged":
            return tuple(f for _ in out)
        if self.fault == "half":
            return tuple(_half(o, torch.zeros_like(o)) for o in out)
        if self.fault == "altered":
            return (_altered(out[0]), *out[1:])
        return out


@pytest.mark.parametrize("cell,fault", [
    ("tiny-tgv.dns", "unchanged"), ("tiny-tgv.dns", "half"), ("tiny-tgv.dns", "altered"),
    ("tiny-tgv.dns", "ke_half"), ("tiny-tgv.stats", "altered"),
    ("tiny-dfdx.x", "unchanged"), ("tiny-dfdx.x", "half"), ("tiny-dfdx.x", "altered"),
    ("tiny-dfdx.grad", "half"), ("tiny-dfdx.grad", "altered"),
])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    result = _run(root, cell, wrap=lambda sut: Broken(sut, fault))
    assert not result["correct"], (fault, result["checks"])
    assert result["failed"] >= 1


def test_the_unbroken_path_is_correct(root):
    result = _run(root, "tiny-tgv.dns", wrap=lambda sut: Broken(sut, None))
    assert result["correct"], result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tgv1600-512.dns", "dfdx-512.x", "dfdx-512.grad",
                                  "tgv1600-512.stats"])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "3300000001", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
