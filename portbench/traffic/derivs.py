"""Traffic kind ``derivs``: derivative calls back to back on a bounded box.

A closed loop: the host issues call after call, each on the next of a few
fields made from the seed, and runs ahead of the card until the window's
time is up, then waits once for the card.

The configuration gives the grid, the box's edge ``length`` (points at
``i * length / (n - 1)``), the scheme and the field's form; the seed draws
each field's coefficients, f = x cos(a x y) + sin(b z + c) y. The mix
gives:

- ``op``: ``dfdx`` (one derivative a call) or ``gradient`` (three);
- ``fields``: how many distinct fields the calls take in turn;
- ``samples``, ``sample_below``: the calls the check compares, drawn from
  the seed below ``sample_below``;
- ``warm_calls``; ``trace_lead``, ``trace_units``: the traced sub-window,
  calls that fill the queue and then the calls it measures.

The check compares each sampled call's output, every point, with the
float64 dense operator applied to the same field.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict

import torch

from ..reference.ops import FLOAT64, TF32, bounded_d1, bounded_d1_apply, bounded_d1_gap
from . import scheme_named

AXES = {"dfdx": (2,), "gradient": (2, 1, 0)}  # of (nz, ny, nx): x, then y, then z
GAP = {2: "dfdx_gap", 1: "dfdy_gap", 0: "dfdz_gap"}


def _grid(cfg):
    shape = tuple(int(n) for n in cfg["grid"])
    return shape, float(cfg["length"]) / (shape[-1] - 1)


def make_inputs(cfg, mix, seed: int, device) -> dict:
    shape, h = _grid(cfg)
    rng = random.Random(seed)
    field = cfg["field"]
    c = torch.arange(shape[-1], dtype=torch.float32, device=device) * h
    z, y, x = c[:, None, None], c[None, :, None], c[None, None, :]
    fields = []
    for _ in range(int(mix["fields"])):
        a, b, phase = (rng.uniform(*field[key]) for key in ("a", "b", "c"))
        fields.append((x * torch.cos(a * x * y) + torch.sin(b * z + phase) * y).contiguous())
    choices = range(int(mix["sample_below"]))
    samples = sorted(rng.sample(choices, int(mix["samples"])))
    return {"fields": fields, "samples": samples}


class Program:
    """The system under test: ``cfd_tpu_torch.ops.derivatives``."""

    def __init__(self, cfg, mix, device):
        from cfd_tpu_torch.ops import derivatives

        _, h = _grid(cfg)
        scheme = scheme_named(cfg["scheme"])
        if mix["op"] == "dfdx":
            self.call = lambda f: (derivatives.dfdx(f, h, scheme),)
        else:
            self.call = lambda f: derivatives.gradient(f, (h, h, h), scheme)


class Control:
    """The reference in the program's place, in TF32 (see reference/ops.py)."""

    def __init__(self, cfg, mix, device):
        shape, h = _grid(cfg)
        d = bounded_d1(shape[-1], h, TF32, device)
        axes = AXES[mix["op"]]
        self.call = lambda f: tuple(bounded_d1_apply(f, d, ax, TF32) for ax in axes)


def warm_up(sut, inputs, mix) -> None:
    for i in range(int(mix["warm_calls"])):
        sut.call(inputs["fields"][i % len(inputs["fields"])])


@dataclasses.dataclass
class Window:
    units: int
    seconds: float
    held: dict
    state: dict


def run_window(sut, inputs, mix, seconds: float, sync) -> Window:
    fields = inputs["fields"]
    samples = set(inputs["samples"])
    last = max(samples)
    held = {}
    k = 0
    t0 = time.perf_counter()
    while k <= last or time.perf_counter() - t0 < seconds:
        out = sut.call(fields[k % len(fields)])
        if k in samples:
            held[k] = out
        k += 1
    sync()
    return Window(k, time.perf_counter() - t0, held, {"k": k})


def run_marked(sut, window: Window, inputs, mix, marker, start) -> int:
    """The traced sub-window's calls: a marker before each call and after
    the last, and ``start()`` once the lead calls are issued; returns the
    measured calls."""
    fields = inputs["fields"]
    lead, measured = int(mix["trace_lead"]), int(mix["trace_units"])
    k = window.state["k"]
    for i in range(lead + measured):
        if i == lead:
            start()
        marker()
        sut.call(fields[k % len(fields)])
        k += 1
    marker()
    window.state["k"] = k
    return measured


def end_to_end(window: Window, cfg, mix) -> dict:
    shape, _ = _grid(cfg)
    points = shape[0] * shape[1] * shape[2] * len(AXES[mix["op"]])
    return {"gpts_per_s": window.units * points / window.seconds / 1e9}


def check(window: Window, inputs, cfg, mix, device) -> Dict[int, Dict[str, float]]:
    """Each sampled call's largest gap from the float64 reference over the
    reference's largest value, by axis."""
    shape, h = _grid(cfg)
    d = bounded_d1(shape[-1], h, FLOAT64, device)
    fields = inputs["fields"]
    out: Dict[int, Dict[str, float]] = {}
    for k, outs in sorted(window.held.items()):
        f = fields[k % len(fields)]
        out[k] = {}
        for ax, got in zip(AXES[mix["op"]], outs):
            gap, top = bounded_d1_gap(f, got, d, ax)
            out[k][GAP[ax]] = gap / top
    return out
