#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cfd_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing the final line:

1. device  — a CUDA card must be present; its name and power limit as
             nvidia-smi reports them; TF32 off for every float32 product.
2. build   — nvcc builds kernels K1 (compact_lane) and K2 (compact_strided)
             for sm_90a from cfd_tpu_torch/csrc/.
3. kernels — each kernel against its plain PyTorch version (the dense
             operator, float64, on the same float32 input) at 256^3 for the
             four first-derivative schemes, on a seeded random field and a
             smooth one; K1 also at n=512 and both on ragged shapes. Gate:
             max|err| <= 1e-5 * max|ref|.
4. accuracy — dfdx of sin(x) at 256^3 against cos(x): max|err| < 5e-4.
5. slice   — 5 RK3 advection–diffusion steps at 256^3 float32 through
             method="auto" (the kernels), against the same steps on the
             plain float64 path, with the kernels' launch counts.
6. times   — CUDA-event medians at 256^3: dfdx/dfdy/dfdz kernel and plain
             float32 times, a copy floor and one RK3 step; dfdx kernel and
             plain times at (64, 64, 512).

The second-to-last line is the per-kernel summary; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.models import (
    AdvectionDiffusion,
    Derivs,
    benchmark_field,
    coordinates,
    sine_field,
    taylor_green,
)
from cfd_tpu_torch.ops import _native, lane, strided
from cfd_tpu_torch.utils import cuda_time_ms

N = 256
N512 = (64, 64, 512)  # K1 in pallas_lane's roll-form regime (n > 256)
GATE = 1e-5  # kernel vs plain float64, relative to max|ref| (f32 recurrence)
SIN_GATE = 5e-4  # absolute, d/dx sin = cos at 256^3
SCHEMES = [ct.SCHEME4, ct.SCHEME4_PERIODIC, ct.SCHEME6, ct.SCHEME6_PERIODIC]
# 5 RK3 steps in float32 against float64: each of the 15 substeps rounds
# the O(1) state (~6e-8) and adds dt * rhs with the kernels' <= 1e-5
# relative error on an O(1) rhs (1e-8 at dt = 1e-3), so the expected gap is
# ~1e-6 of max|f|; the gate leaves a factor of 10 above that.
SLICE_GATE = 1e-5
STEPS, DT, NU = 5, 1e-3, 1e-3

KERNELS = {
    "compact_lane": {
        "source": "cfd_tpu_torch/csrc/compact_lane.cu",
        "replaces": "cfd_tpu/ops/pallas_lane.py:351 (_lane_fold_kernel); "
        "cfd_tpu/ops/pallas_lane.py:475 (_lane_kernel)",
    },
    "compact_strided": {
        "source": "cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_sublane.py:71 (_sublane_kernel); "
        "cfd_tpu/ops/pallas_leading.py:157 (_leading_kernel, plain d1)",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the float32 plain path is a matrix product: keep it in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "allow_tf32": False,
    })
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _native.build()
    _native.library()
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "library": lib.name,
        "sources": [f"cfd_tpu_torch/csrc/{s}" for s in _native.SOURCES],
        "nvcc_flags": list(_native.NVCC_FLAGS),
    })


def _compare(stats, kernel, label, got, ref, failures):
    torch.cuda.synchronize()
    abs_err = (got.double() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    rel = abs_err / ref_max
    ok = rel <= GATE and got.shape == ref.shape
    emit({"phase": "kernels", "kernel": kernel, "case": label, "max_abs_err": abs_err,
          "max_abs_ref": ref_max, "rel_err": rel, "gate": GATE, "ok": ok})
    s = stats[kernel]
    s["max_abs_err"] = max(s["max_abs_err"], abs_err)
    s["max_rel_err"] = max(s["max_rel_err"], rel)
    if not ok:
        failures.append(f"{kernel} {label}: rel {rel:.3e}")


def phase_kernels(dev) -> dict:
    stats = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNELS}
    failures = []
    g = torch.Generator(device=dev).manual_seed(20261016)
    c = coordinates(N, device=dev)
    dx = 2 * math.pi / N
    fields = {
        "random": torch.randn((N, N, N), generator=g, device=dev),
        "smooth": benchmark_field(c, c, c)[0],
    }
    for scheme in SCHEMES:
        for fname, f in fields.items():
            f64 = f.double()
            _compare(stats, "compact_lane", f"dfdx {scheme.name} {fname} {N}^3",
                     lane.lane_derivative(f, dx, scheme),
                     lane.lane_derivative_ref(f64, dx, scheme), failures)
            for axis, name in ((1, "dfdy"), (0, "dfdz")):
                _compare(stats, "compact_strided", f"{name} {scheme.name} {fname} {N}^3",
                         strided.strided_derivative(f, dx, scheme, axis),
                         strided.strided_derivative_ref(f64, dx, scheme, axis), failures)
        del f64
    extra = [
        ("compact_lane", N512, -1),  # n > 256: pallas_lane's roll-form regime
        ("compact_lane", (3, 37, 256), -1),  # 111 lines: a ragged last block
        ("compact_strided", (5, 256, 100), 1),
        ("compact_strided", (100, 7, 9), 0),
    ]
    for kernel, shape, axis in extra:
        f = torch.randn(shape, generator=g, device=dev)
        for scheme in SCHEMES:
            label = f"axis {axis} {scheme.name} {tuple(shape)}"
            if kernel == "compact_lane":
                got = lane.lane_derivative(f, 0.01, scheme)
                ref = lane.lane_derivative_ref(f.double(), 0.01, scheme)
            else:
                got = strided.strided_derivative(f, 0.01, scheme, axis)
                ref = strided.strided_derivative_ref(f.double(), 0.01, scheme, axis)
            _compare(stats, kernel, label, got, ref, failures)
    if failures:
        raise AssertionError("kernel vs plain over the gate: " + "; ".join(failures))
    return stats


def phase_accuracy(dev) -> None:
    c = coordinates(N, device=dev)
    dx = 2 * math.pi / N
    f, exact = sine_field(c, c, c)
    err = (ct.dfdx(f, dx, ct.SCHEME4) - exact).abs().max().item()
    emit({"phase": "accuracy", "case": f"dfdx sin(x) SCHEME4 {N}^3 f32",
          "max_abs_err": err, "gate": SIN_GATE, "ok": err < SIN_GATE})
    if not err < SIN_GATE:
        raise AssertionError(f"sin->cos error {err:.3e} >= {SIN_GATE}")


def _slice_setup(dev, method, dtype):
    c = coordinates(N, device=dev)
    u = taylor_green(c, c, c)
    f0 = sine_field(c, c, c)[0]
    model = AdvectionDiffusion(
        Derivs.single_device(2 * math.pi / N, ct.SCHEME4_PERIODIC, method), nu=NU
    )
    return model, f0.to(dtype), tuple(v.to(dtype) for v in u)


def phase_slice(dev) -> dict:
    model, f0, u = _slice_setup(dev, "auto", torch.float32)
    torch.cuda.synchronize()
    lane.LAUNCHES = 0
    strided.LAUNCHES = 0
    t0 = time.perf_counter()
    f = model.run(f0, u, DT, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"compact_lane": lane.LAUNCHES, "compact_strided": strided.LAUNCHES}

    ref_model, f0_64, u_64 = _slice_setup(dev, "matmul", torch.float64)
    f_ref = ref_model.run(f0_64, u_64, DT, STEPS)
    err = (f.double() - f_ref).abs().max().item()
    rel = err / f_ref.abs().max().item()
    finite = bool(torch.isfinite(f).all().item())
    want = {"compact_lane": 6 * STEPS, "compact_strided": 12 * STEPS}
    ok = (finite and f.shape == (N, N, N) and f.dtype == torch.float32
          and rel <= SLICE_GATE and launches == want)
    emit({"phase": "slice", "case": f"AdvectionDiffusion SCHEME4_PERIODIC {N}^3 f32, "
          f"{STEPS} RK3 steps dt={DT} nu={NU}", "method": "auto",
          "max_abs_err_vs_f64_plain": err, "rel_err": rel, "gate": SLICE_GATE,
          "finite": finite, "launches": launches, "launches_expected": want,
          "wall_s_incl_first_calls": wall, "ok": ok})
    if not ok:
        raise AssertionError("slice failed: see the slice line")
    return launches


def _turns(plain, kernel) -> dict:
    """CUDA-event medians in turns (plain, kernel, kernel, plain), averaged."""
    p1 = cuda_time_ms(plain)
    k1 = cuda_time_ms(kernel)
    k2 = cuda_time_ms(kernel)
    p2 = cuda_time_ms(plain)
    return {"kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "kernel_readings_ms": [k1, k2], "plain_readings_ms": [p1, p2]}


def phase_times(dev, smi) -> dict:
    g = torch.Generator(device=dev).manual_seed(7)
    f = torch.randn((N, N, N), generator=g, device=dev)
    dx = 2 * math.pi / N
    scheme = ct.SCHEME4_PERIODIC
    times = {}
    for axis, name in ((-1, "dfdx"), (-2, "dfdy"), (-3, "dfdz")):
        def run(method, axis=axis):
            return lambda: ct.derivative(f, dx, scheme, axis=axis, method=method)
        times[name] = _turns(run("matmul"), run("kernel"))
    # K1 at n = 512, pallas_lane's roll-form regime, at phase 3's shape
    f512 = torch.randn(N512, generator=g, device=dev)
    times["dfdx_512"] = _turns(
        lambda: ct.dfdx(f512, 0.01, scheme, method="matmul"),
        lambda: ct.dfdx(f512, 0.01, scheme, method="kernel"),
    )
    times["dfdx_512"]["shape"] = list(N512)
    out = torch.empty_like(f)
    copy_ms = cuda_time_ms(lambda: out.copy_(f))
    model, f0, u = _slice_setup(dev, "auto", torch.float32)
    step_ms = cuda_time_ms(lambda: model.step(f0, u, DT), warmup=2, iters=10)
    plain_model, _, _ = _slice_setup(dev, "matmul", torch.float32)
    plain_step_ms = cuda_time_ms(lambda: plain_model.step(f0, u, DT), warmup=2, iters=10)
    pts = N**3
    emit({
        "phase": "times", "device": smi, "scheme": scheme.name, "shape": [N, N, N],
        "dtype": "float32", **times, "copy_floor_ms": copy_ms,
        "dfdx_points_per_s": pts / (times["dfdx"]["kernel_ms"] * 1e-3),
        "copy_GB_per_s": 2 * 4 * pts / (copy_ms * 1e-3) / 1e9,
        "rk3_step_ms": step_ms, "rk3_step_plain_f32_ms": plain_step_ms,
    })
    return times


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    stats = phase_kernels(dev)
    phase_accuracy(dev)
    launches = phase_slice(dev)
    times = phase_times(dev, smi)
    ms = {
        "compact_lane": (times["dfdx"]["kernel_ms"], times["dfdx"]["plain_ms"]),
        # K2 serves dfdy and dfdz equally often in the step: the mean of both
        "compact_strided": (
            (times["dfdy"]["kernel_ms"] + times["dfdz"]["kernel_ms"]) / 2,
            (times["dfdy"]["plain_ms"] + times["dfdz"]["plain_ms"]) / 2,
        ),
    }
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    emit({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "max_rel_err": stats[name]["max_rel_err"],
         "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name in KERNELS
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
