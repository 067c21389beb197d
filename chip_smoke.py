#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cfd_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line per case; any failure raises and the
script exits non-zero without printing the final line:

1. device   — a CUDA card must be present; its name and power limit as
              nvidia-smi reports them; TF32 off for every float32 product.
2. build    — nvcc builds kernels K1 (compact_lane), K2 (compact_strided),
              K3 (adv_lap), K4 (rk3_mega), K5 (adv_lap3), K6 (div_rhs), K7
              (gradient_pair), K8 (d2_sum), K9 (lap_rhs), K10 (curl_rhs), K11
              (lane_dist), K12 (strided_dist), K13 (adv_pair), K14
              (diag_copy) and K15 (diag_dfdz) for sm_90a from
              cfd_tpu_torch/csrc/, one nvcc per source, in parallel.
3. kernels  — each kernel against its plain PyTorch version (dense
              operators, float64, on the same float32 inputs):
              K1/K2 at 256^3 for the four first- and the four
              second-derivative schemes, on a seeded random field and a
              smooth one, and on ragged shapes; K3 and K4 at 256^3 for the
              two periodic scheme pairs (K4 on the first, a middle and the
              last substep, at nu = 1e-3 and at dt * nu = 1, where the
              Laplacian is O(1) of the update) and at (40, 96, 200); K2's
              solve_only, acc and mul modes for the four first-derivative
              schemes, K5 and K6 for the two periodic pairs (K5 also
              against three K3 launches) and pair_subtract (K1 + K2 with
              acc) for the two periodic d1 schemes, at 256^3 and at
              (40, 96, 200); K1 and K2 in filter mode for the four filters
              get_filter(4|6, 0.45, periodic=False|True) as K1/K2 above; K7
              for the four d1 schemes, K8 for the four d2 schemes, K9 for
              the two periodic d2 schemes, K10 for the two periodic d1
              schemes and K2's acc mode for the two non-periodic d2
              schemes, at 256^3 and at (40, 96, 200); K11 (x) and K12 (y, z),
              with the interface update, on the 128^3 shards of 256^3 over
              (2, 2, 2) (first and last), an interior shard of 256^3 over 4,
              an interior ragged (40, 96, 200) shard and the last of three
              96^3 shards, and K12 without it
              on the flat 64-point lines of 256^3 over 4 (first, interior,
              last), for a d1, a d2 and a filter scheme each periodic and
              not; K13 for the four d1 schemes at (64, 128, 8192), 256^3
              and (40, 96, 200), and K2's rk mode for the four d2 schemes
              at (64, 128, 8192) and 256^3 (first, middle and last
              substep, at nu = 1e-3 and at dt * nu = 1); K1's chains on
              lines of 512, 1024 and 8192 points and on lines of 257 and
              63 (one chain, the whole line) at ragged line counts, every
              scheme and filter but at 8192 (a d1, d2 and filter each
              periodic and not), with and without its acc epilogue; K9
              (the two periodic d2 schemes) and K6 (the two periodic d1
              schemes) at (64, 128, 8192), (5, 8, 8191) and (5, 8, 12278)
              and K13 (the four d1 schemes) at (3, 8, 8191) and (2, 8,
              12278): their x phase in sub-block chains on long lines, a
              prime one (one chain) and 14 chains of 877 rows (opted-in
              shared memory); K5 (both periodic pairs) at (5, 8, 257) (one
              chain) and (5, 8, 6134) (two chains of 3067 rows, opted in):
              its paired x phase; K4 (both periodic pairs and SCHEME4 with
              SCHEME4_D2, the three substeps at dt * nu = 1) on z-lines of
              64 (two chains), 42 and the prime 257 (one chain): its staged
              z-tile chains; and K3 (both periodic pairs) at (16, 64, 6134):
              its paired chained x phase in opted-in shared memory. The
              float64 plain versions on lines of
              more than 1024 points take their x derivative from the banded
              solve of the same compact system (``dense.dense_derivative``),
              not from a dense operator. Gate:
              max|err| <= 1e-5 * max|ref|, 5e-5 for second derivatives
              with closure rows; K11/K12 at the JAX dist kernels' gates (2e-6; 2e-5 d2
              with closures; 5e-6 periodic filters, 1e-4 filters with
              closures).
4. accuracy — dfdx of sin(x) against cos(x) (5e-4) and d2fdx2 of sin(x)
              against -sin(x) (2e-3), at 256^3; laplacian of (sin x + sin
              y + sin z) / 3 against minus itself on the periodic (K9) and
              the non-periodic (K8) route (6e-3: three d2 operators at
              2e-3); curl of the Taylor–Green
              field against its analytic curl (5e-4); filter_field of sin(m
              x) + sin(m y) + sin(m z) against the filter's transfer
              function times it (1e-5 of max|f|); the float32 Poisson solve
              (cuFFT) against a host float64 FFT (1e-5 of max|p|,
              benchmarks/diag_ns.py's gate), max|div(project(u))| / max|u|
              (1e-4, the same script's) and 2 nu enstrophy against
              dissipation on the projected field (1e-4, tests/test_spectra.py's
              tolerance), at 256^3.
5. slices   — 5 RK3 steps at 256^3 float32 through method="auto", each
              against the same steps on the plain float64 path (gates 1e-5
              * max|f| and 1e-3 * max|increment|), with the kernels' launch
              counts, zeroed before each slice: advection–diffusion slice 1
              (first derivatives, K1 + K2), slice 2 fused
              (SCHEME4_PERIODIC with the compact-d2 Laplacian: K3 + K4) at
              nu = 1e-3 and at nu = 0.05 (where the diffusion moves f well
              past the gate), slice 2 generic (that configuration without
              its fused substep: K7 + K2 for the gradient, K9 + K2's solve
              for the Laplacian), slice 2 non-periodic (SCHEME4 with the d2
              Laplacian: no fused substep; K7 + K2, K8 + K2 acc); Burgers
              (K5 + K4) at nu = 1e-2 and on its generic route (K7 + K2, K9
              + K2's solve); Navier–Stokes (K5 + K4, the projection's K6,
              K2 solve, pair_subtract, K2 acc) at nu = 1e-3 and at nu =
              0.05; the vector-calculus slice: gradient (SCHEME4_PERIODIC:
              K7 + K2; SCHEME4: K7 + K2), curl (K10 + two K2 solves),
              laplacian (K9 + K2's solve; SCHEME4_D2: K8 + K2 acc) and
              filter_field (get_filter(6, 0.45), non-periodic and
              periodic: K1 + two K2 in filter mode) on random inputs,
              each against the plain float64 path at the kernels' gates;
              the diagnostics slice: 5 Navier–Stokes steps, then
              enstrophy (K10 + two K2 solves), dissipation (K7 + K2 per
              component) and energy_spectrum (cuFFT and a fixed-order shell
              sum), gated against the float64 plain path (1e-5 of the
              scalars and of max E(k)); a second energy_spectrum call on
              the same field must give the same bits.
6. distributed paths — DistributedCompactSolver at 256^3 f32 on meshes
              of shards all on this card, each path with its launch counts:
              dfdx/dfdy/dfdz of sin x + sin y + sin z on (2, 2, 2) (SCHEME4,
              SCHEME4_PERIODIC: K11, K12) against cos (5e-4) and against
              the single-device K1/K2 result (1e-5 relative); phipsi
              against substructuring (2e-6); dfdx with method="kernel" on
              (1, 1, 4) (64-point shard lines: the generic route, K12 on
              flat lines); the distributed gradient on (4, 1, 1) (K7 and
              K12) against the single-device gradient (1e-5); filter_field
              (1e-5) and the d2 derivatives (2e-3) on (2, 2, 2) against
              their single-device counterparts; then 5 RK3 steps of
              AdvectionDiffusion(Derivs.distributed(solver, d2_solver)) on
              (2, 2, 2) (K11, K12) and (1, 2, 2) (K11, K12, K4) at nu =
              1e-3 and 0.05, at the slices' gates, with launch counts.
   long x   — the stepwise fused substep (ops/fused_step.py's
              stepwise_head and stepwise_tail: K13 + K9 + K2 mul+acc + K2
              rk), the three substeps of one step at (64, 128, 8192) and
              256^3, each against the plain float64 substep and against the
              K3/K13 + K4 substep (f' at 1e-5, q' at 1e-3); 5 steps of
              AdvectionDiffusion (second_derivative=True), Burgers and
              NavierStokes at (64, 128, 8192) f32 (spacing 2 pi / 128:
              x-lines too long for K3 and K5, so K13 + K9 + K4 per
              substep) against plain float64, at the slices' gates, with
              launch counts.
7. times    — CUDA-event medians at 256^3, in turns, of the kernels no
              other script times: K2 along y and z and in its solve, acc,
              mul and filter modes, pair_subtract, K7, K8 and K10, each
              against its plain float32 version (and a single PyTorch call
              where one computes the same function); K5 against three K3
              launches, K7 against K1 + K2, K8 against two d2 calls and a
              sum, the Laplacian's two routes and the fused curl against
              the single derivatives and sums they replace, a copy floor,
              the Poisson round trip, one projection, the diagnostics, and
              the step of each configuration; the distributed dfdx, dfdy,
              dfdz on (2, 2, 2) whole and split into halo, faces, gather +
              reduced solve and kernels, beside the single-device
              derivative; the distributed step on (2, 2, 2) and (1, 2, 2)
              in turns with the single-device fused step. Shards that share
              one card measure the distributed algorithm's overhead, not
              its scaling. At (64, 128, 8192) and 256^3: K13 and K2 rk with
              their unfused compositions, K2 rk with its plain version; at
              (64, 128, 8192) the stepwise tail against K4 and each model's
              step in turns with its generic step. lane_times.py times K1,
              K3, K4, K5, K6, K9 and K13, and dist_kernel_times.py K11 and
              K12 per launch: each kernel's device time is taken by one
              script.
8. diag     — the benchmark harness's kernels against their plain versions
              at 256^3: K14 (diag_copy: copy2d over (1024, 256) tiles of
              (65536, 256) and (256, C) tiles of the (256, 65536) dfdz
              layout, copy3d over (256, 8|32, 256) and (8, 256, 256) slabs)
              bitwise; K15 (diag_dfdz) on (256, 65536) at C = 1024 and 2048:
              copy and rolls bitwise, dots within 3e-6 of max|ref| of
              float64, dots_default within 1e-5 of its bf16-operand plain
              version and 1e-2 of float64. Then their device times
              (queued), each in turns with its plain version, beside its
              bound and its library call (Tensor.copy_; torch.matmul in
              float32; torch.bmm of bf16 casts with a float32 output; rolls:
              its unfused torch.roll form).
9. bench_scripts — each ported benchmark script's main
              (cfd_tpu_torch/benchmarks/) on the card, in this process, with
              the launch counts zeroed before and read after each: diag_lane
              (copy floors, K1 at n = 256, 512, (64, 64, 512), 512^3),
              diag_dfdz (the K15 ladder, K2's dfdz, the dense route) at
              256^3, run_single at 64^3 and 256^3, run_distributed on
              (2, 2, 2) at 256^3, diag_axes, diag_rk3 and diag_ns at 128^3.
              A failed gate or an error row fails the run; so does a script
              that launched none of its path's kernels.
10. y_phase — the launches of K3, K5, K6, K9 and K13 on the paths above,
              whose y phase ran as staged y-tile chains
              (csrc/xy_phase.cuh xy_y_kernel).

The second-to-last line is the per-kernel summary; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.models import (
    AdvectionDiffusion,
    Burgers,
    Derivs,
    NavierStokes,
    benchmark_field,
    coordinates,
    sine_field,
    taylor_green,
)
from cfd_tpu_torch.ops import (
    _native, adv_lap, dense, diag, dist, fused_step, lane, megastep, pair, poisson, spectra,
    strided, vec,
)
from cfd_tpu_torch.ops.rhs import closure_ghosts
from cfd_tpu_torch.parallel import DistributedCompactSolver, Grid, make_mesh
from cfd_tpu_torch.parallel import compact as pcompact
from cfd_tpu_torch.parallel.dist_tables import shard_blocks
from cfd_tpu_torch.parallel.fused import make_gradient_distributed
from cfd_tpu_torch.benchmarks import diag_dfdz as bench_dfdz
from cfd_tpu_torch.benchmarks.diag_dfdz import BF16_F64_GATE, BF16_GATE, DOTS_GATE
from cfd_tpu_torch.utils import cuda_time_ms
# The card's published rates (NVIDIA H100 SXM data sheet, at 700 W). The
# bound of a kernel is the larger of its least bytes over HBM and its
# operations over the peak for their type.
from cfd_tpu_torch.utils.timing import F32_FLOPS_PER_S, HBM_BYTES_PER_S

N = 256
N512 = (64, 64, 512)  # K1 in pallas_lane's roll-form regime (n > 256)
RAGGED = (40, 96, 200)  # no multiple of 32 or 128 on any axis
GATE = 1e-5  # kernel vs plain float64, relative to max|ref| (f32 recurrence)
# Second derivatives with closure rows (pade4_d2, lele6_d2): rounding the
# exact RHS once to float32 and solving in float64 already leaves ~1.1e-5 of
# max|f''| on a smooth field at n = 256, because the corner of T^{-1} (LHS
# closures (1, 11) and (1, 137/13), pivots -0.1 and -0.05 on row 1)
# amplifies the wall rows' rounding ~15x (tests/test_torch_kernels.py).
# On phase 3's smooth field (benchmark_field, f'' up to 245) the split reads 1.5e-5
# (SCHEME6_D2) from that rounding, 2.8e-5 with the float32 sweeps and 4.8e-5
# with the RHS formed in float32 too (numpy transcription of the kernels,
# `python tests/test_torch_kernels.py`).
# They take the gate the JAX package's fold kernels meet on d2 (5e-5).
D2_WALL_GATE = 5e-5
SIN_GATE = 5e-4  # absolute, d/dx sin = cos at 256^3
# Absolute, d2/dx2 sin = -sin at 256^3 (SCHEME4_D2_PERIODIC): the operator's
# infinity-norm is 4 * 1.2 / (1 - 0.2) / dx^2 ~ 1.0e4 and float32 input
# rounding is <= 3e-8, so input rounding moves the result by < 3e-4; the
# gate leaves room for the kernel's own rounding (truncation is ~1e-8).
SIN2_GATE = 2e-3
# Absolute, the Laplacian of (sin x + sin y + sin z) / 3 = minus itself at
# 256^3: three d2 operators, each at SIN2_GATE (K9's route also rounds h =
# T_z f before D2x and D2y). Its line prints the plain float32 path's error
# on the same input beside the kernels'.
LAP_GATE = 3 * SIN2_GATE
D1_SCHEMES = [ct.SCHEME4, ct.SCHEME4_PERIODIC, ct.SCHEME6, ct.SCHEME6_PERIODIC]
D2_SCHEMES = [ct.SCHEME4_D2, ct.SCHEME4_D2_PERIODIC, ct.SCHEME6_D2, ct.SCHEME6_D2_PERIODIC]
FILTERS = [ct.get_filter(order, 0.45, periodic) for order in (4, 6) for periodic in (False, True)]
FUSED_PAIRS = [
    (ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC),
    (ct.SCHEME6_PERIODIC, ct.SCHEME6_D2_PERIODIC),
]
# 5 RK3 steps in float32 against float64: each of the 15 substeps rounds
# the O(1) state (~6e-8) and adds dt * rhs with the kernels' <= 1e-5
# relative error on an O(1) rhs (1e-8 at dt = 1e-3), so the expected gap is
# ~1e-6 of max|f|; the gate leaves a factor of 10 above that.
SLICE_GATE = 1e-5
# The same gap against what the 5 steps changed, max|f - f_ref| / max|f_ref -
# f0| (the increment is ~5e-3 at dt = 1e-3), at tests/test_models.py's gate
# for the fused step.
INC_GATE = 1e-3
STEPS, DT, NU = 5, 1e-3, 1e-3
# At NU the diffusion moves f by ~5e-6 in 5 steps, under SLICE_GATE: a
# second fused slice runs at a viscosity where nu * lap f (0.05 sin x) is
# 5% of the advection term's peak (u . grad f = cos^2 x sin y sin z) and
# moves f by ~2.5e-4 over 5 steps, 25x the gate.
# RK3 stays stable: nu * dt * 18 / dx^2 (the d2 operator's largest
# eigenvalue, 6 / dx^2 per axis) is 1.5, under 2.5.
NU_VISCOUS = 0.05
# Burgers and Navier–Stokes: the JAX package's viscosities (burgers.py's
# default, benchmarks/diag_ns.py's nu), and a Navier–Stokes slice at
# NU_VISCOUS, where nu * lap u moves u by ~7e-4 over 5 steps, 70x the gate.
NU_BURGERS = 1e-2
NU_NS = 1e-3
POISSON_GATE = 1e-5  # benchmarks/diag_ns.py:88, against a host float64 FFT
DIV_GATE = 1e-4  # max|div u| / max|u| after a projection, diag_ns.py:59
# 2 nu enstrophy against dissipation on a solenoidal field: equal for the
# commuting circulant operators up to rounding and div u (tests/test_spectra.py
# holds them at rtol 1e-4, truncation included)
IDENTITY_GATE = 1e-4
FIELD_SEED = 20261017  # the smooth perturbation of the Navier–Stokes probe
RK3_MID = dict(a=-5.0 / 9.0, b=15.0 / 16.0, dt=DT, nu=NU)  # the second substep's
# K4 with dt * nu = 1: the Laplacian's share of q' and f' is O(1), so a
# wrong d2 solve fails the gate (at NU it is ~2e-6 of max|q'|).
RK3_DIFFUSIVE = dict(RK3_MID, nu=1.0 / DT)

KERNELS = {
    "compact_lane": {
        "source": "cfd_tpu_torch/csrc/compact_lane.cu",
        "replaces": "cfd_tpu/ops/pallas_lane.py:351 (_lane_fold_kernel, d1 and d2); "
        "cfd_tpu/ops/pallas_lane.py:475 (_lane_kernel, d1)",
    },
    "compact_strided": {
        "source": "cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_sublane.py:71 (_sublane_kernel, d1); "
        "cfd_tpu/ops/pallas_sublane.py:231 (_sublane_fold_kernel, d2); "
        "cfd_tpu/ops/pallas_leading.py:157 (_leading_kernel, plain d1 and d2)",
    },
    "adv_lap": {
        "source": "cfd_tpu_torch/csrc/adv_lap.cu",
        "replaces": "cfd_tpu/ops/pallas_lap.py:452 (_adv_lap_kernel)",
    },
    "rk3_mega": {
        "source": "cfd_tpu_torch/csrc/rk3_mega.cu",
        "replaces": "cfd_tpu/ops/pallas_megastep.py:95 (_mega_kernel)",
    },
    "compact_strided_solve": {
        "source": "cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_leading.py:157 (_leading_kernel, solve_only mode)",
    },
    "compact_strided_acc": {
        "source": "cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_leading.py:157 (_leading_kernel, acc mode)",
    },
    "compact_strided_mul": {
        "source": "cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_leading.py:157 (_leading_kernel, mul mode)",
    },
    "pair_subtract": {
        "source": "cfd_tpu_torch/csrc/compact_lane.cu; cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_pair.py:313 (_pair_sub_kernel)",
    },
    "adv_lap3": {
        "source": "cfd_tpu_torch/csrc/adv_lap3.cu",
        "replaces": "cfd_tpu/ops/pallas_lap.py:761 (_adv_lap3_kernel)",
    },
    "div_rhs": {
        "source": "cfd_tpu_torch/csrc/div_rhs.cu",
        "replaces": "cfd_tpu/ops/pallas_vec.py:197 (_div_kernel)",
    },
    "compact_lane_filter": {
        "source": "cfd_tpu_torch/csrc/compact_lane.cu",
        "replaces": "cfd_tpu/ops/pallas_lane.py:351 (_lane_fold_kernel, filters)",
    },
    "compact_strided_filter": {
        "source": "cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_sublane.py:231 (_sublane_fold_kernel, filters); "
        "cfd_tpu/ops/pallas_leading.py:157 (_leading_kernel, filters)",
    },
    "gradient_pair": {
        "source": "cfd_tpu_torch/csrc/pair.cu",
        "replaces": "cfd_tpu/ops/pallas_pair.py:162 (_pair_kernel)",
    },
    "d2_sum": {
        "source": "cfd_tpu_torch/csrc/d2_sum.cu",
        "replaces": "cfd_tpu/ops/pallas_pair.py:694 (_d2_sum_kernel)",
    },
    "lap_rhs": {
        "source": "cfd_tpu_torch/csrc/lap_rhs.cu",
        "replaces": "cfd_tpu/ops/pallas_lap.py:231 (_lap_rhs_kernel)",
    },
    "curl_rhs": {
        "source": "cfd_tpu_torch/csrc/curl_rhs.cu",
        "replaces": "cfd_tpu/ops/pallas_vec.py:429 (_curl_kernel)",
    },
    "lane_dist": {
        "source": "cfd_tpu_torch/csrc/lane_dist.cu",
        "replaces": "cfd_tpu/ops/pallas_dist.py:93 (_lane_dist_kernel, d1); "
        "cfd_tpu/ops/pallas_dist.py:216 (_lane_dist_fold_kernel, d2 and filters)",
    },
    "strided_dist": {
        "source": "cfd_tpu_torch/csrc/strided_dist.cu",
        "replaces": "cfd_tpu/ops/pallas_dist.py:152 (_sublane_dist_kernel, d1); "
        "cfd_tpu/ops/pallas_dist.py:285 (_sublane_dist_fold_kernel, d2 and filters); "
        "cfd_tpu/ops/pallas_leading.py:546 (_leading_kernel ext=True via _call_leading_dist)",
    },
    "strided_dist_lines": {
        "source": "cfd_tpu_torch/csrc/strided_dist.cu",
        "replaces": "cfd_tpu/ops/pallas_fused.py:78 (_fused_kernel via "
        "solve_lines_tables_pallas)",
    },
    "adv_pair": {
        "source": "cfd_tpu_torch/csrc/adv_pair.cu",
        "replaces": "cfd_tpu/ops/pallas_pair.py:519 (_adv_pair_kernel via _call_adv_pair)",
    },
    "compact_strided_rk": {
        "source": "cfd_tpu_torch/csrc/compact_strided.cu",
        "replaces": "cfd_tpu/ops/pallas_leading.py:157 (_leading_kernel rk=True via _call_rk3)",
    },
    "diag_copy2d": {
        "source": "cfd_tpu_torch/csrc/diag_copy.cu",
        "replaces": "benchmarks/diag_lane.py:49 (copy2d, pallas_call at :56)",
    },
    "diag_copy3d": {
        "source": "cfd_tpu_torch/csrc/diag_copy.cu",
        "replaces": "benchmarks/diag_lane.py:75 (copy3d, pallas_call at :82)",
    },
    **{f"diag_dfdz_{mode}": {
        "source": "cfd_tpu_torch/csrc/diag_dfdz.cu",
        "replaces": f"benchmarks/diag_dfdz.py:48 (_pallas2d, pallas_call at :53) with {body}",
    } for mode, body in (("copy", "k_copy :73"), ("rolls", "k_rolls :77"), ("dots", "k_dots :83"),
                         ("dots_default", "k_dots_default :94"))},
}


def launch_counts() -> dict:
    """Every wrapper's launch count, by kernel (K1 and K2 by mode)."""
    modes = strided.MODE_LAUNCHES
    return {
        "compact_lane": lane.MODE_LAUNCHES["derivative"], "compact_strided": modes["derivative"],
        "adv_lap": adv_lap.LAUNCHES, "rk3_mega": megastep.LAUNCHES,
        "compact_strided_solve": modes["solve"], "compact_strided_acc": modes["acc"],
        "compact_strided_mul": modes["mul"], "pair_subtract": pair.LAUNCHES,
        "adv_lap3": adv_lap.LAUNCHES3, "div_rhs": vec.LAUNCHES,
        "compact_lane_filter": lane.MODE_LAUNCHES["filter"],
        "compact_strided_filter": modes["filter"], "gradient_pair": pair.GRADIENT_LAUNCHES,
        "d2_sum": pair.D2_SUM_LAUNCHES, "lap_rhs": adv_lap.LAP_LAUNCHES,
        "curl_rhs": vec.CURL_LAUNCHES, **dist.LAUNCHES,
        "adv_pair": pair.ADV_PAIR_LAUNCHES, "compact_strided_rk": modes["rk"],
        "diag_copy2d": diag.COPY_LAUNCHES["2d"], "diag_copy3d": diag.COPY_LAUNCHES["3d"],
        **{f"diag_dfdz_{mode}": n for mode, n in diag.DFDZ_LAUNCHES.items()},
    }


def zero_launch_counts() -> None:
    lane.LAUNCHES = strided.LAUNCHES = adv_lap.LAUNCHES = adv_lap.LAUNCHES3 = 0
    megastep.LAUNCHES = vec.LAUNCHES = pair.LAUNCHES = 0
    pair.GRADIENT_LAUNCHES = pair.D2_SUM_LAUNCHES = adv_lap.LAP_LAUNCHES = vec.CURL_LAUNCHES = 0
    pair.ADV_PAIR_LAUNCHES = 0
    for modes in (lane.MODE_LAUNCHES, strided.MODE_LAUNCHES, dist.LAUNCHES, diag.COPY_LAUNCHES,
                  diag.DFDZ_LAUNCHES):
        for mode in modes:
            modes[mode] = 0


def path(**launches) -> dict:
    """The launch counts a path implies: those given, 0 for every other kernel."""
    return {name: launches.get(name, 0) for name in KERNELS}


# Least bytes each kernel timed here must move per point at the timed call
# (f32 inputs read once, outputs written once: pair_subtract 3 reads and 2
# writes, the K2 modes 1 + one per mul/acc and 1, K7 1 and 2, K8 1 and 1,
# K10 3 and 3, K2's rk mode 4 (r, adv, fin, q) and 2), and the operations
# it does per point, counted from its arithmetic (line RHS ~17, forward
# sweep 4, backward 5; K7 and K8 two line solves; K10 four, two T_z and two
# B_z; a filter's line RHS ~21 with its three offsets; K2 rk the solve's 9
# and 6 for the update).
BYTES_PER_POINT = {"compact_strided": 8, "compact_strided_solve": 8, "compact_strided_acc": 12,
                   "compact_strided_mul": 16, "pair_subtract": 20,
                   "compact_strided_filter": 8, "gradient_pair": 12, "d2_sum": 8,
                   "curl_rhs": 24, "compact_strided_rk": 24}
FLOPS_PER_POINT = {"compact_strided": 26, "compact_strided_solve": 9, "compact_strided_acc": 27,
                   "compact_strided_mul": 28, "pair_subtract": 54,
                   "compact_strided_filter": 30, "gradient_pair": 52, "d2_sum": 53,
                   "curl_rhs": 128, "compact_strided_rk": 15}


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


def _gate(scheme) -> float:
    return D2_WALL_GATE if scheme.derivative_order == 2 and not scheme.periodic else GATE


def _compare(stats, kernel, label, got, ref, failures, gate=GATE):
    torch.cuda.synchronize()
    abs_err = (got.double() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    rel = abs_err / ref_max
    ok = rel <= gate and got.shape == ref.shape
    emit({"phase": "kernels", "kernel": kernel, "case": label, "max_abs_err": abs_err,
          "max_abs_ref": ref_max, "rel_err": rel, "gate": gate, "ok": ok})
    s = stats[kernel]
    s["max_abs_err"] = max(s["max_abs_err"], abs_err)
    s["max_rel_err"] = max(s["max_rel_err"], rel)
    if not ok:
        failures.append(f"{kernel} {label}: rel {rel:.3e}")


def _derivative_cases(stats, failures, schemes, fields, g, dev):
    """K1 and K2 (in filter mode for a filter) at 256^3 and on ragged shapes."""
    dx = 2 * math.pi / N
    mode = lambda kernel, scheme: kernel + ("_filter" if scheme.derivative_order == 0 else "")
    for scheme in schemes:
        gate = _gate(scheme)
        for fname, f in fields.items():
            f64 = f.double()
            _compare(stats, mode("compact_lane", scheme), f"x {scheme.name} {fname} {N}^3",
                     lane.lane_derivative(f, dx, scheme),
                     lane.lane_derivative_ref(f64, dx, scheme), failures, gate)
            for axis, name in ((1, "y"), (0, "z")):
                _compare(stats, mode("compact_strided", scheme),
                         f"{name} {scheme.name} {fname} {N}^3",
                         strided.strided_derivative(f, dx, scheme, axis),
                         strided.strided_derivative_ref(f64, dx, scheme, axis), failures, gate)
            del f64
    extra = [
        ("compact_lane", N512, -1),  # n > 256: pallas_lane's roll-form regime
        ("compact_lane", (3, 37, 256), -1),  # 111 lines: a ragged last block
        ("compact_strided", (5, 256, 100), 1),
        ("compact_strided", (100, 7, 9), 0),
    ]
    for kernel, shape, axis in extra:
        f = torch.randn(shape, generator=g, device=dev)
        for scheme in schemes:
            label = f"axis {axis} {scheme.name} {tuple(shape)}"
            if kernel == "compact_lane":
                got = lane.lane_derivative(f, 0.01, scheme)
                ref = lane.lane_derivative_ref(f.double(), 0.01, scheme)
            else:
                got = strided.strided_derivative(f, 0.01, scheme, axis)
                ref = strided.strided_derivative_ref(f.double(), 0.01, scheme, axis)
            _compare(stats, mode(kernel, scheme), label, got, ref, failures, _gate(scheme))


def _fused_cases(stats, failures, g, dev):
    c = coordinates(N, device=dev)
    smooth = (benchmark_field(c, c, c)[0], *taylor_green(c, c, c))
    for shape in ((N, N, N), RAGGED):
        dz, dy, dx = (2 * math.pi / n for n in shape)
        f, ux, uy, r, axy, uz, q = (torch.randn(shape, generator=g, device=dev)
                                    for _ in range(7))
        cases = {"random": (f, ux, uy)}  # K3's inputs
        if shape == (N, N, N):
            cases["smooth"] = smooth[:3]
        for s1, s2 in FUSED_PAIRS:
            names = f"{s1.name}+{s2.name} {tuple(shape)}"
            for fname, (ff, ux, uy) in cases.items():
                got = adv_lap.adv_lap_rhs(ff, ux, uy, dz, dy, dx, s1, s2)
                ref = adv_lap.adv_lap_rhs_ref(ff.double(), ux.double(), uy.double(),
                                              dz, dy, dx, s1, s2)
                for out, g_, r_ in zip(("axy", "r"), got, ref):
                    _compare(stats, "adv_lap", f"{out} {names} {fname}", g_, r_, failures)
            d64 = [t.double() for t in (f, r, axy, uz)]
            for rk in (RK3_MID, RK3_DIFFUSIVE):
                for case, qq, write_q in (("first", None, True), ("middle", q, True),
                                          ("last", q, False)):
                    kw = dict(rk, write_q=write_q)
                    label = f"{names} {case} nu={rk['nu']:g}"
                    got_q, got_f = megastep.rk3_mega(f, r, axy, uz, qq, s1, s2, dz, **kw)
                    ref_q, ref_f = megastep.rk3_mega_ref(
                        *d64, None if qq is None else qq.double(), s1, s2, dz, **kw)
                    _compare(stats, "rk3_mega", f"f' {label}", got_f, ref_f, failures)
                    if write_q:
                        _compare(stats, "rk3_mega", f"q' {label}", got_q, ref_q, failures)
                    elif got_q is not None:
                        failures.append(f"rk3_mega {label}: q' returned with write_q=False")


def _slice3_cases(stats, failures, g, dev):
    """K2's epilogues, pair_subtract, K5 and K6 at the shapes NS runs them."""
    d1_periodic = [s for s, _ in FUSED_PAIRS]
    for shape in ((N, N, N), RAGGED):
        dz, dy, dx = (2 * math.pi / n for n in shape)
        f, a, m = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        f64, a64, m64 = f.double(), a.double(), m.double()
        for scheme in D1_SCHEMES:
            label = f"{scheme.name} {tuple(shape)}"
            _compare(stats, "compact_strided_solve", f"z {label}",
                     strided.leading_solve(f, scheme),
                     strided.leading_solve_ref(f64, scheme), failures)
            # the projection's uz - dphi/dz: acc with spacing -dz
            _compare(stats, "compact_strided_acc", f"z -dz {label}",
                     strided.strided_derivative(f, -dz, scheme, 0, acc=a),
                     strided.strided_derivative_ref(f64, -dz, scheme, 0, acc=a64), failures)
            _compare(stats, "compact_strided_mul", f"z {label}",
                     strided.strided_derivative(f, dz, scheme, 0, acc=a, mul=m),
                     strided.strided_derivative_ref(f64, dz, scheme, 0, acc=a64, mul=m64),
                     failures)
        for scheme in d1_periodic:
            label = f"{scheme.name} {tuple(shape)}"
            got = pair.pair_subtract(f, a, m, dy, dx, scheme)
            ref = pair.pair_subtract_ref(f64, a64, m64, dy, dx, scheme)
            for out, g_, r_ in zip(("x", "y"), got, ref):
                _compare(stats, "pair_subtract", f"{out} {label}", g_, r_, failures)
            _compare(stats, "div_rhs", label, vec.div_rhs(f, a, m, dz, dy, dx, scheme),
                     vec.div_rhs_ref(f64, a64, m64, dz, dy, dx, scheme), failures)
        del f64, a64, m64
        u = (f, a, m)
        for s1, s2 in FUSED_PAIRS:
            label = f"{s1.name}+{s2.name} {tuple(shape)}"
            got = adv_lap.adv_lap_rhs3(u, dz, dy, dx, s1, s2)
            ref = adv_lap.adv_lap_rhs3_ref(tuple(c.double() for c in u), dz, dy, dx, s1, s2)
            gap = rel_gap = 0.0  # K5 against three K3 launches on the same components
            for i in range(3):
                for out, g_, r_ in zip(("axy", "r"), (got[0][i], got[1][i]),
                                       (ref[0][i], ref[1][i])):
                    _compare(stats, "adv_lap3", f"{out}{i} {label}", g_, r_, failures)
                k3 = adv_lap.adv_lap_rhs(u[i], u[0], u[1], dz, dy, dx, s1, s2)
                for x, y in zip((got[0][i], got[1][i]), k3):
                    d = (x - y).abs().max().item()
                    gap, rel_gap = max(gap, d), max(rel_gap, d / y.abs().max().item())
            del ref
            emit({"phase": "kernels", "kernel": "adv_lap3", "case": f"vs 3 x adv_lap {label}",
                  "max_abs_gap": gap, "max_rel_gap": rel_gap})


def _slice4_cases(stats, failures, g, dev):
    """K7-K10 and K2's acc on d2 closure rows, at 256^3 and (40, 96, 200),
    for the schemes each route takes."""
    d1_periodic = [s for s, _ in FUSED_PAIRS]
    d2_periodic = [s for _, s in FUSED_PAIRS]
    for shape in ((N, N, N), RAGGED):
        dz, dy, dx = (2 * math.pi / n for n in shape)
        f, a, m = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        f64, a64, m64 = f.double(), a.double(), m.double()
        for scheme in D1_SCHEMES:
            label = f"{scheme.name} {tuple(shape)}"
            got = pair.gradient_pair(f, dy, dx, scheme)
            ref = pair.gradient_pair_ref(f64, dy, dx, scheme)
            for out, g_, r_ in zip(("x", "y"), got, ref):
                _compare(stats, "gradient_pair", f"{out} {label}", g_, r_, failures)
        for scheme in D2_SCHEMES:
            label = f"{scheme.name} {tuple(shape)}"
            _compare(stats, "d2_sum", label, pair.d2_pair_sum(f, dy, dx, scheme),
                     pair.d2_pair_sum_ref(f64, dy, dx, scheme), failures, _gate(scheme))
            if not scheme.periodic:  # the non-periodic Laplacian's z: K2 acc
                _compare(stats, "compact_strided_acc", f"z d2 {label}",
                         strided.strided_derivative(f, dz, scheme, 0, acc=a),
                         strided.strided_derivative_ref(f64, dz, scheme, 0, acc=a64),
                         failures, _gate(scheme))
        for scheme in d2_periodic:
            label = f"{scheme.name} {tuple(shape)}"
            _compare(stats, "lap_rhs", label, adv_lap.lap_rhs(f, dz, dy, dx, scheme),
                     adv_lap.lap_rhs_ref(f64, dz, dy, dx, scheme), failures)
        for scheme in d1_periodic:
            label = f"{scheme.name} {tuple(shape)}"
            got = vec.curl_rhs(f, a, m, dz, dy, dx, scheme)
            ref = vec.curl_rhs_ref(f64, a64, m64, dz, dy, dx, scheme)
            for out, g_, r_ in zip(("wz", "rA", "rB"), got, ref):
                _compare(stats, "curl_rhs", f"{out} {label}", g_, r_, failures)
        del f64, a64, m64


def phase_kernels(dev) -> dict:
    stats = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNELS}
    failures = []
    g = torch.Generator(device=dev).manual_seed(20261016)
    c = coordinates(N, device=dev)
    fields = {
        "random": torch.randn((N, N, N), generator=g, device=dev),
        "smooth": benchmark_field(c, c, c)[0],
    }
    _derivative_cases(stats, failures, D1_SCHEMES, fields, g, dev)
    _derivative_cases(stats, failures, D2_SCHEMES, fields, g, dev)
    _fused_cases(stats, failures, g, dev)
    _slice3_cases(stats, failures, g, dev)
    # the new cases draw their inputs last, so that every earlier case sees
    # the same inputs as at the parent commit, and a change to a shared
    # source shows as a change of its errors
    _derivative_cases(stats, failures, FILTERS, fields, g, dev)
    _slice4_cases(stats, failures, g, dev)
    _slice5_cases(stats, failures, g, dev)
    _slice6_cases(stats, failures, g, dev)
    _chain_cases(stats, failures, g, dev)
    _xy_chain_cases(stats, failures, g, dev)
    _z_chain_cases(stats, failures, g, dev)
    if failures:
        raise AssertionError("kernel vs plain over the gate: " + "; ".join(failures))
    return stats


# K1's chains (csrc/line_chains.cuh) at ragged line counts: n = 512, 1024
# and 8192, and lines that no divisor cuts into chains of 32 rows (257, 63:
# one chain, the whole line); every derivative scheme and filter, but at
# 8192 a d1, a d2 and a filter each periodic and not (whose float64 plain
# version is a Thomas solve over the 8192 rows, one step at a time)
CHAIN_SHAPES = ((3, 37, 512), (37, 1024), (3, 8192), (3, 37, 257), (5, 7, 63))
CHAIN_LONG_SCHEMES = [ct.SCHEME4, ct.SCHEME4_PERIODIC, ct.SCHEME6_D2, ct.SCHEME4_D2_PERIODIC,
                      FILTERS[2], FILTERS[3]]


def _chain_cases(stats, failures, g, dev):
    """K1's chains against the plain float64 version, with and without the
    acc epilogue (f' + acc, pair_subtract's x half)."""
    for shape in CHAIN_SHAPES:
        n = shape[-1]
        f = torch.randn(shape, generator=g, device=dev)
        acc = torch.randn(shape, generator=g, device=dev)
        schemes = D1_SCHEMES + D2_SCHEMES + FILTERS if n < 8192 else CHAIN_LONG_SCHEMES
        for scheme in schemes:
            kernel = "compact_lane_filter" if scheme.derivative_order == 0 else "compact_lane"
            label = f"chains nb={lane.line_nb(n)} {scheme.name} {tuple(shape)}"
            ref = lane.lane_derivative_ref(f.double(), 0.01, scheme)
            _compare(stats, kernel, label, lane.lane_derivative(f, 0.01, scheme), ref, failures,
                     _gate(scheme))
            _compare(stats, kernel, label + " + acc", lane.launch(f, 0.01, scheme, acc),
                     ref + acc.double(), failures, _gate(scheme))
            del ref


def phase_accuracy(dev) -> None:
    dx = 2 * math.pi / N
    c = coordinates(N, device=dev, dtype=torch.float64)
    f64, exact = sine_field(c, c, c)
    f = f64.float()  # built in float64, cast once: only input rounding enters
    cases = [  # (case, got, exact, gate, the plain float32 path or None)
        ("dfdx sin(x) SCHEME4", ct.dfdx(f, dx, ct.SCHEME4), exact, SIN_GATE, None),
        ("d2fdx2 sin(x) SCHEME4_D2_PERIODIC", ct.d2fdx2(f, dx, ct.SCHEME4_D2_PERIODIC),
         -f64, SIN2_GATE, None),
    ]
    # the Laplacian's two routes on a field of max 1
    Z, Y, X = c[:, None, None], c[None, :, None], c[None, None, :]
    s3 = ((torch.sin(X) + torch.sin(Y) + torch.sin(Z)) / 3).contiguous()
    for scheme, route in ((ct.SCHEME4_D2_PERIODIC, "K9 + solve"), (ct.SCHEME4_D2, "K8 + acc")):
        cases.append((f"laplacian (sin x + sin y + sin z) / 3 {scheme.name} ({route})",
                      ct.laplacian(s3.float(), dx, scheme), -s3, LAP_GATE,
                      ct.laplacian(s3.float(), dx, scheme, method="matmul")))
    # the fused curl of the Taylor–Green field against its analytic curl
    tg = tuple(v.float() for v in taylor_green(c, c, c))
    exact = (torch.sin(X) * torch.cos(Y) * torch.cos(Z), torch.cos(X) * torch.sin(Y) * torch.cos(Z),
             -2 * torch.cos(X) * torch.cos(Y) * torch.sin(Z))
    for name, got, want in zip(("wx", "wy", "wz"), ct.curl(tg, dx, ct.SCHEME4_PERIODIC), exact):
        cases.append((f"curl Taylor–Green {name} SCHEME4_PERIODIC (K10 + solves)", got, want,
                      SIN_GATE, None))
    for case, got, want, gate, plain in cases:
        err = (got.double() - want).abs().max().item()
        line = {"phase": "accuracy", "case": f"{case} {N}^3 f32", "max_abs_err": err}
        if plain is not None:
            line["plain_f32_max_abs_err"] = (plain.double() - want).abs().max().item()
        emit({**line, "gate": gate, "ok": err < gate})
        if not err < gate:
            raise AssertionError(f"{case}: error {err:.3e} >= {gate}")
    del s3, tg, exact

    # the filter's transfer function on one mode along each axis: all three
    # sweeps (K1, K2, K2) scale sin(m x) + sin(m y) + sin(m z) by G(m dx)
    filt = ct.get_filter(6, 0.45, periodic=True)
    m = 3 * N // 8  # k dx = 3 pi / 4, where the filter damps
    wave = sum(torch.sin(m * a) for a in (X, Y, Z))
    gain = ct.schemes.transfer_function(filt, m * dx).item()
    got = ct.filter_field(wave.float().contiguous(), filt)
    rel = (got.double() - gain * wave).abs().max().item() / wave.abs().max().item()
    emit({"phase": "accuracy", "case": f"filter_field sin({m} x) + sin({m} y) + sin({m} z) "
          f"{filt.name} {N}^3 f32 vs G(k) f", "gain": gain,
          "rel_err": rel, "gate": GATE, "ok": rel <= GATE})
    if not rel <= GATE:
        raise AssertionError(f"filter transfer function: rel error {rel:.3e} > {GATE}")
    del wave, got

    # cuFFT's float32 Poisson solve against a host float64 FFT on the same
    # float32 right-hand side (benchmarks/diag_ns.py found the TPU's f32 FFT
    # 28% off on Nyquist-plane modes, and gates at 1e-5)
    scheme = ct.SCHEME4_PERIODIC
    rng = np.random.default_rng(20261016)
    rhs = rng.standard_normal((N, N, N)).astype(np.float32)
    rhs -= rhs.mean(dtype=np.float64).astype(np.float32)
    lam = poisson.laplacian_eigenvalues(scheme, rhs.shape, (dx, dx, dx))
    inv = np.zeros_like(lam)
    inv[lam != 0.0] = 1.0 / lam[lam != 0.0]
    p_ref = np.fft.irfftn(np.fft.rfftn(rhs.astype(np.float64)) * inv, s=rhs.shape,
                          axes=(0, 1, 2))
    p = ct.solve_poisson(torch.from_numpy(rhs).to(dev), dx, scheme).cpu().numpy()
    rel = float(np.abs(p - p_ref).max() / np.abs(p_ref).max())
    emit({"phase": "accuracy", "case": f"solve_poisson {scheme.name} {N}^3 f32 (cuFFT) vs "
          "host f64 FFT", "rel_err": rel, "gate": POISSON_GATE, "ok": rel <= POISSON_GATE})
    if not rel <= POISSON_GATE:
        raise AssertionError(f"solve_poisson: rel error {rel:.3e} > {POISSON_GATE}")
    del rhs, p_ref, p, lam, inv

    # the compact projection removes what the fused divergence sees
    u = _ns_velocity(dev, torch.float32)
    up = ct.project(u, dx, scheme)
    speed = torch.sqrt(sum(c * c for c in u)).max().item()
    div = ct.divergence(up, dx, scheme).abs().max().item() / speed
    before = ct.divergence(u, dx, scheme).abs().max().item() / speed
    emit({"phase": "accuracy", "case": f"max|div(project(u))| / max|u| {N}^3 f32, compact "
          "projection", "rel_divergence": div, "before_projection": before,
          "gate": DIV_GATE, "ok": div <= DIV_GATE})
    if not div <= DIV_GATE:
        raise AssertionError(f"project: divergence {div:.3e} > {DIV_GATE}")

    # on the projected field the dissipation is 2 nu enstrophy
    z2 = 2 * NU_NS * spectra.enstrophy(up, dx, scheme).item()
    eps = spectra.dissipation(up, dx, scheme, NU_NS).item()
    rel = abs(z2 - eps) / eps
    emit({"phase": "accuracy", "case": f"2 nu enstrophy vs dissipation, projected field {N}^3 "
          "f32 (K10 + solves; K7 + K2)", "two_nu_enstrophy": z2, "dissipation": eps,
          "rel_diff": rel, "gate": IDENTITY_GATE, "ok": rel <= IDENTITY_GATE})
    if not rel <= IDENTITY_GATE:
        raise AssertionError(f"enstrophy-dissipation identity: rel {rel:.3e} > {IDENTITY_GATE}")


def _generic(derivs):
    """The bundle without its fused substeps: the models' generic form."""
    return dataclasses.replace(derivs, fused_substep=None, fused_substep_vec=None)


def _model(dev, scheme, method, dtype, second_derivative=False, nu=NU, generic=False):
    c = coordinates(N, device=dev)
    u = taylor_green(c, c, c)
    f0 = sine_field(c, c, c)[0]
    derivs = Derivs.single_device(2 * math.pi / N, scheme, method,
                                  second_derivative=second_derivative)
    if generic:
        derivs = _generic(derivs)
    return AdvectionDiffusion(derivs, nu=nu), f0.to(dtype), tuple(v.to(dtype) for v in u)


def _ns_velocity(dev, dtype, coords=None, spacing=2 * math.pi / N):
    """The Navier–Stokes probe, at 256^3 or on the (z, y, x) coordinates
    ``coords``: Taylor–Green (whose uz = 0 would hide K4's uz * dz term and
    K6's z parts) plus a seeded smooth perturbation in every component,
    projected in float64 and cast to ``dtype``."""
    if coords is None:
        c = coordinates(N, device=dev, dtype=torch.float64)
        coords = (c, c, c)
    z, y, x = coords
    Z, Y, X = z[:, None, None], y[None, :, None], x[None, None, :]
    amp = np.random.default_rng(FIELD_SEED).uniform(-0.2, 0.2, (3, 3))
    u = [v + a * torch.sin(Z + b) * torch.cos(X + d) + b * torch.cos(Y + a) * torch.sin(Z)
         for v, (a, b, d) in zip(taylor_green(z, y, x), amp)]
    u = poisson.project(tuple(v.contiguous() for v in u), spacing, ct.SCHEME4_PERIODIC,
                        method="spectral")
    return tuple(v.to(dtype) for v in u)


def _velocity_model(kind, dev, method, nu, dx=2 * math.pi / N):
    """"ns", "burgers", or "burgers_generic" (Burgers without its fused
    substeps)."""
    if kind == "ns":
        return NavierStokes.single_device(dx, ct.SCHEME4_PERIODIC, nu=nu, method=method)
    derivs = Derivs.single_device(dx, ct.SCHEME4_PERIODIC, method, second_derivative=True)
    return Burgers(_generic(derivs) if kind == "burgers_generic" else derivs, nu=nu)


# Per RK3 substep of the scalar model: the gradient (K7 for x and y, K2 for
# z) and the diffusion: d1 (K1 + 2 K2), periodic d2 (K9 + K2's solve) or
# non-periodic d2 (K8 + K2 acc). Burgers' generic stage runs that per
# component.
SLICE1_PATH = path(gradient_pair=3 * STEPS, compact_lane=3 * STEPS, compact_strided=9 * STEPS)
FUSED_PATH = path(adv_lap=3 * STEPS, rk3_mega=3 * STEPS)
GENERIC_D2_PATH = path(gradient_pair=3 * STEPS, compact_strided=3 * STEPS, lap_rhs=3 * STEPS,
                       compact_strided_solve=3 * STEPS)
WALLS_PATH = path(gradient_pair=3 * STEPS, compact_strided=3 * STEPS, d2_sum=3 * STEPS,
                  compact_strided_acc=3 * STEPS)
BURGERS_PATH = path(adv_lap3=3 * STEPS, rk3_mega=9 * STEPS)
BURGERS_GENERIC_PATH = path(gradient_pair=9 * STEPS, compact_strided=9 * STEPS,
                            lap_rhs=9 * STEPS, compact_strided_solve=9 * STEPS)
NS_PATH = path(adv_lap3=3 * STEPS, rk3_mega=9 * STEPS, div_rhs=3 * STEPS,
               compact_strided_solve=3 * STEPS, pair_subtract=3 * STEPS,
               compact_strided_acc=3 * STEPS)
# the NS steps, then enstrophy (K10 and two K2 solves) and dissipation (K7
# and K2 for each component); the energy spectrum launches no kernel
DIAGNOSTICS_PATH = {**NS_PATH, "curl_rhs": 1,
                    "compact_strided_solve": NS_PATH["compact_strided_solve"] + 2,
                    "gradient_pair": 3, "compact_strided": 3}
VELOCITY_SLICES = {
    # name: (model, nu, launches expected over STEPS steps)
    "slice3_burgers": ("burgers", NU_BURGERS, BURGERS_PATH),
    "slice4_burgers_generic": ("burgers_generic", NU_BURGERS, BURGERS_GENERIC_PATH),
    "slice3_ns": ("ns", NU_NS, NS_PATH),
    "slice3_ns_viscous": ("ns", NU_VISCOUS, NS_PATH),
}
SLICES = {
    # name: (scheme, second_derivative, nu, generic, launches expected over STEPS steps)
    "slice1": (ct.SCHEME4_PERIODIC, False, NU, False, SLICE1_PATH),
    "slice2_fused": (ct.SCHEME4_PERIODIC, True, NU, False, FUSED_PATH),
    "slice2_fused_viscous": (ct.SCHEME4_PERIODIC, True, NU_VISCOUS, False, FUSED_PATH),
    "slice4_generic_d2": (ct.SCHEME4_PERIODIC, True, NU, True, GENERIC_D2_PATH),
    "slice2_walls": (ct.SCHEME4, True, NU, False, WALLS_PATH),
}


def phase_slice(dev, name) -> dict:
    scheme, d2, nu, generic, want = SLICES[name]
    model, f0, u = _model(dev, scheme, "auto", torch.float32, d2, nu, generic)
    fused = model.derivs.fused_substep is not None
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    f = model.run(f0, u, DT, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    # float64 through the plain path: method="matmul" builds no fused
    # substep, so a fused run is held against the generic form
    ref_model, f0_64, u_64 = _model(dev, scheme, "matmul", torch.float64, d2, nu)
    f_ref = ref_model.run(f0_64, u_64, DT, STEPS)
    err = (f.double() - f_ref).abs().max().item()
    rel = err / f_ref.abs().max().item()
    rel_inc = err / (f_ref - f0_64).abs().max().item()
    # what the diffusion term adds to f: the float64 run without it
    inviscid = AdvectionDiffusion(ref_model.derivs, nu=0.0).run(f0_64, u_64, DT, STEPS)
    diffusion = (f_ref - inviscid).abs().max().item() / f_ref.abs().max().item()
    del inviscid
    finite = bool(torch.isfinite(f).all().item())
    ok = (finite and f.shape == (N, N, N) and f.dtype == torch.float32
          and rel <= SLICE_GATE and rel_inc <= INC_GATE and launches == want
          and fused == (want == FUSED_PATH))
    emit({"phase": "slice", "slice": name,
          "case": f"AdvectionDiffusion {scheme.name} second_derivative={d2} {N}^3 f32, "
          f"{STEPS} RK3 steps dt={DT} nu={nu}" + (", generic step" if generic else ""),
          "method": "auto", "fused_substep": fused,
          "max_abs_err_vs_f64_plain": err, "rel_err": rel, "gate": SLICE_GATE,
          "rel_err_of_increment": rel_inc, "increment_gate": INC_GATE,
          "diffusion_share_of_max_f": diffusion,
          "finite": finite, "launches": launches, "launches_expected": want,
          "wall_s_incl_first_calls": wall, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} failed: see its slice line")
    return launches


def phase_velocity_slice(dev, name) -> dict:
    """5 Burgers or Navier–Stokes steps through method="auto" at 256^3 f32
    against the same steps on the plain float64 path (the generic stage with
    dense operators; for Navier–Stokes the spectral projection)."""
    kind, nu, want = VELOCITY_SLICES[name]
    model = _velocity_model(kind, dev, "auto", nu)
    u64 = _ns_velocity(dev, torch.float64)
    u0 = tuple(c.float() for c in u64)
    u64 = tuple(c.double() for c in u0)  # both runs start from the same f32 field
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    u = model.run(u0, DT, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    ref = _velocity_model(kind, dev, "matmul", nu).run(u64, DT, STEPS)
    scale = max(c.abs().max().item() for c in ref)
    err = max((a.double() - b).abs().max().item() for a, b in zip(u, ref))
    inc = max((b - a).abs().max().item() for a, b in zip(u64, ref))
    inviscid = _velocity_model(kind, dev, "matmul", 0.0).run(u64, DT, STEPS)
    diffusion = max((a - b).abs().max().item() for a, b in zip(ref, inviscid)) / scale
    del inviscid
    finite = all(bool(torch.isfinite(c).all().item()) for c in u)
    ok = (finite and all(c.shape == (N, N, N) and c.dtype == torch.float32 for c in u)
          and err / scale <= SLICE_GATE and err / inc <= INC_GATE and launches == want)
    line = {"phase": "slice", "slice": name,
            "case": f"{type(model).__name__} ({kind}) {ct.SCHEME4_PERIODIC.name} {N}^3 f32, "
            f"{STEPS} RK3 steps dt={DT} nu={nu}", "method": "auto",
            "max_abs_err_vs_f64_plain": err, "rel_err": err / scale, "gate": SLICE_GATE,
            "rel_err_of_increment": err / inc, "increment_gate": INC_GATE,
            "diffusion_share_of_max_u": diffusion, "finite": finite, "launches": launches,
            "launches_expected": want, "wall_s_incl_first_calls": wall}
    if kind == "ns":
        speed = torch.sqrt(sum(c * c for c in u)).max().item()
        line["rel_divergence_after"] = model.divergence(u).abs().max().item() / speed
        ok = ok and line["rel_divergence_after"] <= DIV_GATE
    emit({**line, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} failed: see its slice line")
    return launches


def _diagnostics(u, scheme, method):
    dx = 2 * math.pi / N
    return (spectra.enstrophy(u, dx, scheme, method=method),
            spectra.dissipation(u, dx, scheme, NU_NS, method=method),
            spectra.energy_spectrum(u, dx))


def phase_diagnostics(dev) -> dict:
    """The diagnostics slice: 5 Navier–Stokes steps through method="auto",
    then the statistics a user reports of the flow (enstrophy, dissipation,
    the energy spectrum), against the same on the plain float64 path."""
    scheme = ct.SCHEME4_PERIODIC
    model = _velocity_model("ns", dev, "auto", NU_NS)
    u0 = tuple(c.float() for c in _ns_velocity(dev, torch.float64))
    u64 = tuple(c.double() for c in u0)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    u = model.run(u0, DT, STEPS)
    enst, diss, spec = _diagnostics(u, scheme, "auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # the shell sum runs in a fixed order: a second call gives the same bits
    spectrum_bitwise = torch.equal(spec, spectra.energy_spectrum(u, 2 * math.pi / N))

    ref_u = _velocity_model("ns", dev, "matmul", NU_NS).run(u64, DT, STEPS)
    ref = _diagnostics(ref_u, scheme, "matmul")
    scale = max(c.abs().max().item() for c in ref_u)
    err_u = max((a.double() - b).abs().max().item() for a, b in zip(u, ref_u)) / scale
    rel = {name: abs(got.item() - want.item()) / abs(want.item())
           for name, got, want in (("enstrophy", enst, ref[0]), ("dissipation", diss, ref[1]))}
    rel["energy_spectrum"] = ((spec.double() - ref[2]).abs().max() / ref[2].abs().max()).item()
    ke = 0.5 * sum((c.double() ** 2).mean().item() for c in u)
    parseval = abs(spec.double().sum().item() - ke) / ke
    finite = all(bool(torch.isfinite(t).all().item()) for t in (*u, enst, diss, spec))
    ok = (finite and err_u <= SLICE_GATE and max(rel.values()) <= SLICE_GATE
          and parseval <= SLICE_GATE and spec.shape == ref[2].shape
          and launches == DIAGNOSTICS_PATH and spectrum_bitwise)
    emit({"phase": "slice", "slice": "slice4_diagnostics",
          "case": f"NavierStokes {scheme.name} {N}^3 f32, {STEPS} RK3 steps dt={DT} nu={NU_NS}, "
          "then enstrophy, dissipation, energy_spectrum", "method": "auto",
          "rel_err_u": err_u, "rel_err": rel, "gate": SLICE_GATE,
          "enstrophy": enst.item(), "dissipation": diss.item(),
          "two_nu_enstrophy": 2 * NU_NS * enst.item(), "n_shells": spec.shape[0],
          "sum_E_vs_kinetic_energy": parseval, "energy_spectrum_bitwise_repeat": spectrum_bitwise,
          "finite": finite, "launches": launches,
          "launches_expected": DIAGNOSTICS_PATH, "wall_s_incl_first_calls": wall, "ok": ok})
    if not ok:
        raise AssertionError("slice4_diagnostics failed: see its slice line")
    return launches


def _vector_calculus(f, u, method):
    """The slice's entry points on one field f and one velocity u: gradient
    (periodic and not), curl, laplacian (periodic and not), filter_field
    (non-periodic and periodic, all three axes)."""
    dx = 2 * math.pi / N
    out = {}
    for scheme in (ct.SCHEME4_PERIODIC, ct.SCHEME4):
        for name, g in zip(("x", "y", "z"), ct.gradient(f, dx, scheme, method=method)):
            out[f"gradient {name} {scheme.name}"] = (g, GATE)
    for name, w in zip(("wx", "wy", "wz"), ct.curl(u, dx, ct.SCHEME4_PERIODIC, method=method)):
        out[f"curl {name} {ct.SCHEME4_PERIODIC.name}"] = (w, GATE)
    for scheme in (ct.SCHEME4_D2_PERIODIC, ct.SCHEME4_D2):
        out[f"laplacian {scheme.name}"] = (ct.laplacian(f, dx, scheme, method=method),
                                           _gate(scheme))
    for periodic in (False, True):
        filt = ct.get_filter(6, 0.45, periodic)
        out[f"filter_field {filt.name}"] = (ct.filter_field(f, filt, method=method), GATE)
    return out


# gradient: K7 + K2 (z) per scheme; curl: K10 + two K2 solves; laplacian:
# K9 + K2's solve (periodic), K8 + K2 acc (walls); filter_field: K1 + two
# K2, in filter mode, per filter
VECTOR_CALCULUS_PATH = path(gradient_pair=2, compact_strided=2, curl_rhs=1,
                            compact_strided_solve=3, lap_rhs=1, d2_sum=1, compact_strided_acc=1,
                            compact_lane_filter=2, compact_strided_filter=4)


def phase_vector_calculus(dev) -> dict:
    """The slice's entry points at 256^3 f32 through method="auto" on a
    seeded random field and velocity, each output against the plain float64
    path on the same inputs, with the launch counts of the run."""
    g = torch.Generator(device=dev).manual_seed(20261018)
    f, *u = (torch.randn((N, N, N), generator=g, device=dev) for _ in range(4))
    torch.cuda.synchronize()
    zero_launch_counts()
    got = _vector_calculus(f, tuple(u), "auto")
    torch.cuda.synchronize()
    launches = launch_counts()
    ref = _vector_calculus(f.double(), tuple(c.double() for c in u), "matmul")
    errors, ok = {}, launches == VECTOR_CALCULUS_PATH
    for case, (out, gate) in got.items():
        want = ref[case][0]
        rel = ((out.double() - want).abs().max() / want.abs().max()).item()
        fine = (rel <= gate and out.shape == want.shape and out.dtype == torch.float32
                and bool(torch.isfinite(out).all().item()))
        errors[case] = {"rel_err": rel, "gate": gate, "ok": fine}
        ok = ok and fine
    emit({"phase": "slice", "slice": "slice4_vector_calculus",
          "case": f"gradient, curl, laplacian, filter_field {N}^3 f32, random inputs",
          "method": "auto", "outputs": errors, "launches": launches,
          "launches_expected": VECTOR_CALCULUS_PATH, "ok": ok})
    if not ok:
        raise AssertionError("slice4_vector_calculus failed: see its slice line")
    return launches


# ---------------------------------------------------------------------------
# Slice 6: the stepwise fused substep on long x-lines
# ---------------------------------------------------------------------------

# A periodic box elongated along x at the spacing 2 pi / 128 on every axis:
# (nz, ny, nx) = (64, 128, 8192), 2^26 points, a box of 2 pi (0.5, 1, 64).
# Two staged x-lines (K3, K5) take 65.6 KB there, past an x block's 48 KB;
# one (K13, K9) takes 32.8 KB. The fields are the 256^3 slices' (Taylor–
# Green, sin x) on coordinates that run 64 periods along x and one over the
# box's length along z (sin 2z on its length pi, so that they are periodic
# there).
LONG = (64, 128, 8192)
LONG_DX = 2 * math.pi / 128
LONG_SPACING = (LONG_DX, LONG_DX, LONG_DX)
RK3_SUBSTEPS = (("first", 0.0, 1.0 / 3.0), ("middle", -5.0 / 9.0, 15.0 / 16.0),
                ("last", -153.0 / 128.0, 8.0 / 15.0))


def _long_coords(dev, dtype=torch.float32):
    nz, ny, nx = LONG
    return (coordinates(nz, device=dev, dtype=dtype), coordinates(ny, device=dev, dtype=dtype),
            coordinates(nx, device=dev, dtype=dtype, length=nx * LONG_DX))


def _spacing(shape):
    return LONG_SPACING if tuple(shape) == LONG else tuple(2 * math.pi / n for n in shape)


def _slice6_cases(stats, failures, g, dev):
    """K13 for the four d1 schemes and K2's rk mode for the four d2 schemes
    (first, middle and last substep, at nu = 1e-3 and dt * nu = 1)."""
    for shape in (LONG, (N, N, N), RAGGED):
        dz, dy, dx = _spacing(shape)
        f, ux, uy = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        f64, ux64, uy64 = f.double(), ux.double(), uy.double()
        for scheme in D1_SCHEMES:
            _compare(stats, "adv_pair", f"{scheme.name} {tuple(shape)}",
                     pair.advection_pair(f, ux, uy, dy, dx, scheme),
                     pair.advection_pair_ref(f64, ux64, uy64, dy, dx, scheme), failures)
        del f, ux, uy, f64, ux64, uy64
    for shape in (LONG, (N, N, N)):
        r, adv, fin, q = (torch.randn(shape, generator=g, device=dev) for _ in range(4))
        d64 = [t.double() for t in (r, adv, fin, q)]
        for scheme in D2_SCHEMES:
            for rk in (RK3_MID, RK3_DIFFUSIVE):
                for case, a, b in RK3_SUBSTEPS:
                    qq, qq64 = (None, None) if case == "first" else (q, d64[3])
                    kw = dict(a=a, b=b, dt=rk["dt"], nu=rk["nu"])
                    label = f"{scheme.name} {tuple(shape)} {case} nu={rk['nu']:g}"
                    got = strided.rk3_solve_update(r, adv, qq, fin, scheme, **kw)
                    ref = strided.rk3_solve_update_ref(d64[0], d64[1], qq64, d64[2], scheme, **kw)
                    for out, g_, r_ in zip(("q'", "f'"), got, ref):
                        _compare(stats, "compact_strided_rk", f"{out} {label}", g_, r_, failures,
                                 _gate(scheme))
        del r, adv, fin, q, d64


# The chained x phase (csrc/xy_phase.cuh xy_chain_launch) on the lines
# that phase 3 holds nowhere else: K9 and K6 at LONG (128 chains of 64 rows;
# 256^3 and RAGGED are in _slice3_cases and _slice4_cases, K13 at all three
# in _slice6_cases), K9, K13 and K6 on a prime line (8191: one chain, one
# line a block) and on 12278 points (14 chains of 877 rows: one line a
# block in opted-in shared memory); K5's paired launch on a one-chain line
# (257) and on 6134 points (two chains of 3067 rows: one line of two
# families a block, opted in). K9, K6 and K5 take nz >= 5 and ny >= 5 for
# their sixth-order schemes, K13 ny >= 6 for SCHEME6.
XY_CHAIN_SHAPES = {"lap_rhs": (LONG, (5, 8, 8191), (5, 8, 12278)),
                   "adv_pair": ((3, 8, 8191), (2, 8, 12278)),
                   "div_rhs": (LONG, (5, 8, 8191), (5, 8, 12278)),
                   "adv_lap3": ((5, 8, 257), (5, 8, 6134))}


def _xy_chain_cases(stats, failures, g, dev):
    """K9 (both periodic d2 schemes), K13 (the four d1 schemes), K6 (both
    periodic d1 schemes) and K5 (both FUSED_PAIRS) against their plain
    float64 versions on XY_CHAIN_SHAPES."""
    for kernel, shapes in XY_CHAIN_SHAPES.items():
        for shape in shapes:
            dz, dy, dx = _spacing(shape)
            f, ux, uy = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
            f64, ux64, uy64 = f.double(), ux.double(), uy.double()
            label = lambda scheme: (f"chains nb={lane.line_nb(shape[-1])} {scheme.name} "
                                    f"{tuple(shape)}")
            if kernel == "lap_rhs":
                for scheme in (s for s in D2_SCHEMES if s.periodic):
                    _compare(stats, kernel, label(scheme), adv_lap.lap_rhs(f, dz, dy, dx, scheme),
                             adv_lap.lap_rhs_ref(f64, dz, dy, dx, scheme), failures)
            elif kernel == "adv_pair":
                for scheme in D1_SCHEMES:
                    _compare(stats, kernel, label(scheme),
                             pair.advection_pair(f, ux, uy, dy, dx, scheme),
                             pair.advection_pair_ref(f64, ux64, uy64, dy, dx, scheme), failures)
            elif kernel == "div_rhs":
                for scheme, _ in FUSED_PAIRS:
                    _compare(stats, kernel, label(scheme),
                             vec.div_rhs(f, ux, uy, dz, dy, dx, scheme),
                             vec.div_rhs_ref(f64, ux64, uy64, dz, dy, dx, scheme), failures)
            else:
                for s1, s2 in FUSED_PAIRS:
                    got = adv_lap.adv_lap_rhs3((f, ux, uy), dz, dy, dx, s1, s2)
                    ref = adv_lap.adv_lap_rhs3_ref((f64, ux64, uy64), dz, dy, dx, s1, s2)
                    for i in range(3):
                        for out, g_, r_ in zip(("axy", "r"), (got[0][i], got[1][i]),
                                               (ref[0][i], ref[1][i])):
                            _compare(stats, kernel, f"{out}{i} {label(s1)}+{s2.name}", g_, r_,
                                     failures)
            del f, ux, uy, f64, ux64, uy64


# K4's staged z-tile chains (csrc/rk3_mega.cu) on the z-lines that phase 3
# holds nowhere else (256^3 and RAGGED are in _fused_cases): nz = 64 (two
# chains a column), 42 and the prime 257 (one chain), for both fused pairs
# and SCHEME4 + SCHEME4_D2 (closure rows in both families), on the first, a
# middle and the last substep at dt * nu = 1; and K3's paired chained x
# phase on 6134-point x-lines (two chains of 3067 rows: one line of two
# families a block, opted in).
Z_CHAIN_SHAPES = ((64, 64, 128), (42, 64, 128), (257, 32, 64))
K3_LONG_X = (16, 64, 6134)


def _z_chain_cases(stats, failures, g, dev):
    """K4 on Z_CHAIN_SHAPES and K3 at K3_LONG_X against their plain float64
    versions."""
    for shape in Z_CHAIN_SHAPES:
        dz = 2 * math.pi / shape[0]
        f, r, axy, uz, q = (torch.randn(shape, generator=g, device=dev) for _ in range(5))
        d64 = [t.double() for t in (f, r, axy, uz, q)]
        for s1, s2 in FUSED_PAIRS + [(ct.SCHEME4, ct.SCHEME4_D2)]:
            for case, qq, write_q in (("first", None, True), ("middle", q, True),
                                      ("last", q, False)):
                kw = dict(RK3_DIFFUSIVE, write_q=write_q)
                label = (f"chains nb={lane.line_nb(shape[0])} {s1.name}+{s2.name} "
                         f"{tuple(shape)} {case}")
                got_q, got_f = megastep.rk3_mega(f, r, axy, uz, qq, s1, s2, dz, **kw)
                ref_q, ref_f = megastep.rk3_mega_ref(
                    *d64[:4], None if qq is None else d64[4], s1, s2, dz, **kw)
                _compare(stats, "rk3_mega", f"f' {label}", got_f, ref_f, failures)
                if write_q:
                    _compare(stats, "rk3_mega", f"q' {label}", got_q, ref_q, failures)
                elif got_q is not None:
                    failures.append(f"rk3_mega {label}: q' returned with write_q=False")
        del f, r, axy, uz, q, d64
    dz, dy, dx = _spacing(K3_LONG_X)
    f, ux, uy = (torch.randn(K3_LONG_X, generator=g, device=dev) for _ in range(3))
    for s1, s2 in FUSED_PAIRS:
        got = adv_lap.adv_lap_rhs(f, ux, uy, dz, dy, dx, s1, s2)
        ref = adv_lap.adv_lap_rhs_ref(f.double(), ux.double(), uy.double(), dz, dy, dx, s1, s2)
        for out, g_, r_ in zip(("axy", "r"), got, ref):
            _compare(stats, "adv_lap", f"{out} chains nb={lane.line_nb(K3_LONG_X[-1])} "
                     f"{s1.name}+{s2.name} {K3_LONG_X}", g_, r_, failures)
        del got, ref


def _substep_state(dev, shape, dtype):
    """(f, u, spacing) of the advection–diffusion slices at ``shape``."""
    if tuple(shape) == LONG:
        z, y, x = _long_coords(dev, torch.float64)
    else:
        z = y = x = coordinates(shape[0], device=dev, dtype=torch.float64)
    u = tuple(c.to(dtype) for c in taylor_green(z, y, x))
    return sine_field(z, y, x)[0].to(dtype), u, _spacing(shape)


# the three substeps of one RK3 step through fused_step's stepwise routes
STEPWISE_PATH = path(adv_pair=3, lap_rhs=3, compact_strided_mul=3, compact_strided_rk=3)


def phase_stepwise(dev, shape) -> dict:
    """One RK3 step's three substeps through ``fused_step.stepwise_head`` and
    ``stepwise_tail`` (K13 + K9 + K2 mul+acc + K2 rk) at ``shape`` f32, each
    substep held against the plain float64 substep (merged head and K4's
    plain versions) and against the substep of ``head_route`` + K4 (K3 where
    it fits, else K13) on the same inputs: f' at 1e-5 of max|f'|, q' (the
    increment over b) at 1e-3 of max|q'|."""
    s1, s2 = FUSED_PAIRS[0]
    f, u, spacing = _substep_state(dev, shape, torch.float32)
    ux, uy, uz = u
    dz = spacing[0]
    ins, outs = [], []

    def run():
        fc, q = f, None
        for case, a, b in RK3_SUBSTEPS:
            ins.append((fc, q, a, b))
            axy, r = fused_step.stepwise_head(fc, ux, uy, spacing, s1, s2)
            q, fc = fused_step.stepwise_tail(fc, r, axy, uz, q, s1, s2, dz, a=a, b=b, dt=DT,
                                             nu=NU, last=False)
            outs.append((q, fc))

    _, launches = _run_path(run)
    head = fused_step.head_route(f, s1, s2)  # K3 where it fits, else K13 + K9
    u64 = tuple(c.double() for c in u)
    errors, ok = {}, launches == STEPWISE_PATH
    for (case, _, _), (fin, qin, a, b), (qo, fo) in zip(RK3_SUBSTEPS, ins, outs):
        axy, r = head(fin, ux, uy, spacing, s1, s2)
        k4 = fused_step.mega_tail(fin, r, axy, uz, qin, s1, s2, dz, a=a, b=b, dt=DT, nu=NU)
        del axy, r
        f64 = fin.double()
        axy, r = adv_lap.adv_lap_rhs_ref(f64, u64[0], u64[1], *spacing, s1, s2)
        plain = megastep.rk3_mega_ref(f64, r, axy, u64[2], None if qin is None else qin.double(),
                                      s1, s2, dz, a=a, b=b, dt=DT, nu=NU)
        del axy, r, f64
        for against, (q_ref, f_ref) in (("plain_f64", plain), (head.__name__ + " + K4", k4)):
            ef = ((fo.double() - f_ref.double()).abs().max() / f_ref.abs().max()).item()
            eq = ((qo.double() - q_ref.double()).abs().max() / q_ref.abs().max()).item()
            errors[f"{case} vs {against}"] = {"rel_err_f": ef, "rel_err_q": eq}
            ok = ok and ef <= SLICE_GATE and eq <= INC_GATE
        del plain, k4
    finite = all(bool(torch.isfinite(t).all().item()) for pair_ in outs for t in pair_)
    ok = ok and finite
    name = f"slice6_stepwise_{'x'.join(map(str, shape))}"
    emit({"phase": "slice", "slice": name,
          "case": f"stepwise substep (K13 + K9 + K2 mul+acc + K2 rk) {s1.name}+{s2.name} "
          f"{tuple(shape)} f32, the three substeps of one RK3 step dt={DT} nu={NU}",
          "errors": errors, "gate_f": SLICE_GATE, "gate_q": INC_GATE, "finite": finite,
          "launches": launches, "launches_expected": STEPWISE_PATH, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} failed: see its slice line")
    return {name: launches}


# per step at LONG: every substep on the stepwise head (K13 + K9) and K4;
# Burgers and Navier–Stokes take the scalar substep per component (K5 does
# not fit), and Navier–Stokes projects after each stage
LONG_AD_PATH = path(adv_pair=3 * STEPS, lap_rhs=3 * STEPS, rk3_mega=3 * STEPS)
LONG_BURGERS_PATH = path(adv_pair=9 * STEPS, lap_rhs=9 * STEPS, rk3_mega=9 * STEPS)
LONG_NS_PATH = {**LONG_BURGERS_PATH, "div_rhs": 3 * STEPS, "compact_strided_solve": 3 * STEPS,
                "pair_subtract": 3 * STEPS, "compact_strided_acc": 3 * STEPS}
LONG_SLICES = {
    # name: (model, nu, launches expected over STEPS steps)
    "slice6_advection_diffusion_long": ("advection_diffusion", NU, LONG_AD_PATH),
    "slice6_burgers_long": ("burgers", NU_BURGERS, LONG_BURGERS_PATH),
    "slice6_ns_long": ("ns", NU_NS, LONG_NS_PATH),
}


def _long_model(kind, dev, method, nu):
    """A model of the long-x configuration, through its normal entry point."""
    if kind == "advection_diffusion":
        derivs = Derivs.single_device(LONG_SPACING, ct.SCHEME4_PERIODIC, method,
                                      second_derivative=True)
        return AdvectionDiffusion(derivs, nu=nu)
    return _velocity_model(kind, dev, method, nu, dx=LONG_SPACING)


def _long_state(kind, dev):
    """The model's float32 state at LONG: (f, u) for advection–diffusion,
    u else."""
    if kind == "advection_diffusion":
        f, u, _ = _substep_state(dev, LONG, torch.float32)
        return f, u
    u = _ns_velocity(dev, torch.float64, _long_coords(dev, torch.float64), LONG_SPACING)
    return tuple(c.float() for c in u)


def _long_run(model, state, steps):
    """``steps`` RK3 steps of ``state``; the fields it returns, as a tuple."""
    if isinstance(model, AdvectionDiffusion):
        return (model.run(state[0], state[1], DT, steps),)
    return tuple(model.run(state, DT, steps))


def _generic_model(model, nu):
    """The same model with its fused substeps taken out: the generic step
    the JAX models run where no fused head fits."""
    derivs = _generic(model.derivs)
    if isinstance(model, NavierStokes):
        return NavierStokes(derivs, LONG_SPACING, ct.SCHEME4_PERIODIC, nu=nu)
    return type(model)(derivs, nu=nu)


def phase_long_slice(dev, name) -> dict:
    """5 steps of a model at LONG f32 through method="auto" (the stepwise
    head, K4 tail) against the same steps on the plain float64 path, at the
    slices' gates, with the launch counts of the run."""
    kind, nu, want = LONG_SLICES[name]
    model = _long_model(kind, dev, "auto", nu)
    state = _long_state(kind, dev)
    out, launches = _run_path(lambda: _long_run(model, state, STEPS))
    # both runs start from the same float32 state
    if kind == "advection_diffusion":
        ref_state = (state[0].double(), tuple(c.double() for c in state[1]))
        start = (ref_state[0],)
    else:
        ref_state = start = tuple(c.double() for c in state)
    ref = _long_run(_long_model(kind, dev, "matmul", nu), ref_state, STEPS)
    scale = max(c.abs().max().item() for c in ref)
    err = max((a.double() - b).abs().max().item() for a, b in zip(out, ref))
    inc = max((b - a).abs().max().item() for a, b in zip(start, ref))
    finite = all(bool(torch.isfinite(c).all().item()) for c in out)
    ok = (finite and all(c.shape == LONG and c.dtype == torch.float32 for c in out)
          and err / scale <= SLICE_GATE and err / inc <= INC_GATE and launches == want)
    line = {"phase": "slice", "slice": name,
            "case": f"{type(model).__name__} {ct.SCHEME4_PERIODIC.name} {LONG} f32 "
            f"(spacing 2 pi / 128), {STEPS} RK3 steps dt={DT} nu={nu}", "method": "auto",
            "max_abs_err_vs_f64_plain": err, "rel_err": err / scale, "gate": SLICE_GATE,
            "rel_err_of_increment": err / inc, "increment_gate": INC_GATE, "finite": finite,
            "launches": launches, "launches_expected": want}
    if kind == "ns":
        speed = torch.sqrt(sum(c * c for c in out)).max().item()
        line["rel_divergence_after"] = model.divergence(out).abs().max().item() / speed
        ok = ok and line["rel_divergence_after"] <= DIV_GATE
    emit({**line, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} failed: see its slice line")
    return launches


def _long_times(dev, smi) -> dict:
    """CUDA-event medians at LONG f32 and 256^3, in turns: K13 and K2 rk
    with their unfused compositions (row 16: K7, two multiplies and an add;
    row 7: K2 solve_only and the elementwise update), K2 rk with its plain
    version, the stepwise tail against K4 (LONG), and each model's step
    against its generic step at LONG. The device times of K13, K9, K6, K5,
    K3 and K4 themselves are lane_times.py's."""
    g = torch.Generator(device=dev).manual_seed(20261020)
    s1, s2 = FUSED_PAIRS[0]
    times = {}
    for shape in (LONG, (N, N, N)):
        dz, dy, dx = _spacing(shape)
        key = "x".join(map(str, shape))
        f, ux, uy, uz, r, q = (torch.randn(shape, generator=g, device=dev) for _ in range(6))

        def k7_unfused():
            fx, fy = pair.gradient_pair(f, dy, dx, s1)
            return ux * fx + uy * fy

        t = _turns(k7_unfused, lambda: pair.advection_pair(f, ux, uy, dy, dx, s1))
        times[f"adv_pair_vs_unfused_{key}"] = {
            "adv_pair_ms": t["kernel_ms"], "unfused_ms": t["plain_ms"],
            "readings_ms": [t["kernel_readings_ms"], t["plain_readings_ms"]]}
        rk = dict(a=RK3_MID["a"], b=RK3_MID["b"], dt=DT, nu=NU)
        adv = strided.strided_derivative(f, dz, s1, 0, mul=uz, acc=ux)
        times[f"compact_strided_rk_{key}"] = _turns(
            lambda: strided.rk3_solve_update_ref(r, adv, q, f, s2, **rk),
            lambda: strided.rk3_solve_update(r, adv, q, f, s2, **rk))

        def rk_unfused():
            qn = rk["a"] * q + DT * (NU * strided.leading_solve(r, s2) - adv)
            return qn, f + rk["b"] * qn

        t = _turns(rk_unfused, lambda: strided.rk3_solve_update(r, adv, q, f, s2, **rk))
        times[f"compact_strided_rk_{key}"]["unfused_ms"] = t["plain_ms"]
        times[f"compact_strided_rk_{key}"]["unfused_readings_ms"] = [t["kernel_readings_ms"],
                                                                     t["plain_readings_ms"]]
        if shape == LONG:
            axy = adv_lap.lap_rhs(f, dz, dy, dx, s2)  # any field: the tails' inputs
            t = _turns(lambda: fused_step.mega_tail(f, r, axy, uz, q, s1, s2, dz, **rk),
                       lambda: fused_step.stepwise_tail(f, r, axy, uz, q, s1, s2, dz, **rk))
            times["stepwise_tail_vs_k4_long"] = {
                "stepwise_tail_ms": t["kernel_ms"], "k4_ms": t["plain_ms"],
                "readings_ms": [t["kernel_readings_ms"], t["plain_readings_ms"]]}
            out = torch.empty_like(f)
            times["copy_long_ms"] = cuda_time_ms(lambda: out.copy_(f))
            del axy, out
        del f, ux, uy, uz, r, q, adv
    steps = {}
    for name, (kind, nu, _) in LONG_SLICES.items():
        model = _long_model(kind, dev, "auto", nu)
        generic = _generic_model(model, nu)
        state = _long_state(kind, dev)
        step = lambda m: (lambda: _long_run(m, state, 1))
        p1 = cuda_time_ms(step(generic), warmup=1, iters=3)
        k1 = cuda_time_ms(step(model), warmup=1, iters=3)
        k2 = cuda_time_ms(step(model), warmup=1, iters=3)
        p2 = cuda_time_ms(step(generic), warmup=1, iters=3)
        steps[name] = {"step_ms": (k1 + k2) / 2, "generic_step_ms": (p1 + p2) / 2,
                       "readings_ms": [[k1, k2], [p1, p2]]}
        del model, generic, state
    emit({"phase": "long_times", "device": smi, "shape": list(LONG), "dtype": "float32",
          "schemes": [s1.name, s2.name], **times, "steps": steps})
    return times


# ---------------------------------------------------------------------------
# Slice 5: the distributed layer, meshes of shards on this one card
# ---------------------------------------------------------------------------

# K11/K12 against plain float64: the gates the JAX dist kernels meet against
# float64 (tests/test_dist_kernels.py): first derivatives and periodic second
# derivatives 2e-6, second derivatives with closures 2e-5, periodic filters
# 5e-6, filters with closures 1e-4.
def _dist_gate(scheme) -> float:
    if scheme.derivative_order == 0:
        return 5e-6 if scheme.periodic else 1e-4
    return 2e-5 if scheme.derivative_order == 2 and not scheme.periodic else 2e-6


DIST_SCHEMES = [ct.SCHEME4, ct.SCHEME4_PERIODIC, ct.SCHEME4_D2, ct.SCHEME4_D2_PERIODIC,
                ct.get_filter(6, 0.45, False), ct.get_filter(6, 0.45, True)]
# phipsi against substructuring on the same float32 field sin x: the JAX
# dryrun holds them at 5e-7 on the O(1) derivative at n = 64
# (__graft_entry__.py:145-152); f32 rounding of the RHS grows as 1 / dx, so
# 4x that at n = 256
PHIPSI_GATE = 2e-6
DIST_VS_SINGLE_GATE = 1e-5  # distributed against single-device, relative


def _mesh(shape):
    """A mesh of ``shape`` shards, every one on card 0."""
    return make_mesh(shape, devices=[torch.device("cuda", 0)] * math.prod(shape))


def _dist_inputs(g, dev, scheme, r, p, shape, axis):
    """A shard block of ``shape`` (line along ``axis``), its halo rows
    (random toward a neighbour, closure ghosts on a physical end) and its
    interface weights, float32 on the card."""
    rows = lambda k: shape[:axis] + (k,) + shape[axis + 1:]
    w = scheme.stencil_width
    f, hl, hr = (torch.randn(s, generator=g, device=dev) for s in (shape, rows(w), rows(w)))
    ab = torch.randn(rows(2), generator=g, device=dev)
    if not scheme.periodic and r in (0, p - 1):
        gl, gr = closure_ghosts(f.double().movedim(axis, 0), scheme)
        if r == 0:
            hl = gl.movedim(0, axis).float().contiguous()
        if r == p - 1:
            hr = gr.movedim(0, axis).float().contiguous()
    return f, hl, hr, ab


# (label, p, r, shard shape, axis): the 128^3 shards of 256^3 on (2, 2, 2)
# (first and last along each axis: 4 sub-blocks), an interior shard of
# 256^3 over 4 (64-point lines, 2 sub-blocks), and a ragged shard,
# interior, of a line over 3 (1, 2 and 4 sub-blocks)
DIST_SHARDS = [
    ("(2,2,2) first", 2, 0, (N // 2,) * 3),
    ("(2,2,2) last", 2, 1, (N // 2,) * 3),
    ("4 shards, interior", 4, 1, None),
    ("ragged (40, 96, 200), 3 shards, interior", 3, 1, RAGGED),
]
# the last of 3 shards of 96 points along every axis (2 sub-blocks of 48),
# its inputs from a generator of its own, so that every other case draws
# what it drew before the shard was added
SUBBLOCK_SHARDS = [("nl = 96, 3 shards, last", 3, 2, (96, 96, 96))]
SUBBLOCK_SEED = 20261023


def _slice5_cases(stats, failures, g, dev):
    """K11 along x, K12 along y and z (with the interface update) and K12 on
    the generic route's flat lines (without it), at the shard shapes the
    distributed derivatives give them, against their plain float64 versions."""
    d = 2 * math.pi / N
    g_sub = torch.Generator(device=dev).manual_seed(SUBBLOCK_SEED)
    shards = [(*shard, g) for shard in DIST_SHARDS] + [(*shard, g_sub) for shard in SUBBLOCK_SHARDS]
    for scheme in DIST_SCHEMES:
        gate = _dist_gate(scheme)
        for label, p, r, shape, gen in shards:
            for axis, kernel in ((2, "lane_dist"), (1, "strided_dist"), (0, "strided_dist")):
                s = shape or tuple(N // 4 if a == axis else N for a in range(3))
                block = shard_blocks(scheme, p * s[axis], p)[r]
                f, hl, hr, ab = _dist_inputs(gen, dev, scheme, r, p, s, axis)
                d64 = lambda *ts: tuple(t.double() for t in ts)
                case = f"{'xyz'[2 - axis]} {scheme.name} {label} {s}"
                if axis == 2:
                    got = dist.lane_dist_derivative(f, hl, hr, ab, d, block)
                    ref = dist.lane_dist_derivative_ref(*d64(f, hl, hr, ab), d, block)
                else:
                    got = dist.sublane_dist_derivative(f, hl, hr, ab, d, block, axis=axis)
                    ref = dist.sublane_dist_derivative_ref(*d64(f, hl, hr, ab), d, block,
                                                           axis=axis)
                _compare(stats, kernel, case, got, ref, failures, gate)
                del f, hl, hr, ab, got, ref
        # the generic route's local solve (row 8): the x lines of a 256^3
        # field over 4 shards, moved to axis 0 and flattened
        for r in (0, 1, 3):
            block = shard_blocks(scheme, N, 4)[r]
            f, hl, hr, _ = _dist_inputs(g, dev, scheme, r, 4, (N // 4, N * N), 0)
            got = dist.solve_lines_tables(f, hl, hr, 1 / d, block)
            ref = dist.solve_lines_tables_ref(f.double(), hl.double(), hr.double(), 1 / d, block)
            _compare(stats, "strided_dist_lines", f"{scheme.name} shard {r} of 4 {tuple(f.shape)}",
                     got, ref, failures, gate)


def _sines(dev, dtype=torch.float32, x_only=False):
    """F = sin x + sin y + sin z at 256^3 (built in float64, cast once), and
    its exact first and second derivatives along (x, y, z), float64; with
    ``x_only``, sin x alone."""
    c = coordinates(N, device=dev, dtype=torch.float64)
    Z, Y, X = c[:, None, None], c[None, :, None], c[None, None, :]
    if x_only:
        return torch.sin(X).expand(N, N, N).contiguous().to(dtype)
    F = (torch.sin(X) + torch.sin(Y) + torch.sin(Z)).contiguous()
    d1 = tuple(torch.cos(v).expand(N, N, N) for v in (X, Y, Z))
    d2 = tuple(-torch.sin(v).expand(N, N, N) for v in (X, Y, Z))
    return F.to(dtype), d1, d2


def _solver(mesh_shape, scheme, method="auto"):
    grid = Grid(_mesh(mesh_shape), (N, N, N), (2 * math.pi / N,) * 3, scheme)
    return grid, DistributedCompactSolver(grid, method=method)


def _run_path(fn):
    """fn() with every launch count zeroed just before and read just after."""
    torch.cuda.synchronize()
    zero_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


# launches per path: one per shard and axis (K11 along x, K12 along y and z)
DIST_PATHS = {
    "slice5_d1_pade4": path(lane_dist=8, strided_dist=16),
    "slice5_d1_pade4_periodic": path(lane_dist=8, strided_dist=16),
    "slice5_lines_1x1x4": path(strided_dist_lines=4),
    "slice5_gradient_4x1x1": path(gradient_pair=4, strided_dist=4),
    "slice5_filter_field": path(lane_dist=8, strided_dist=16),
    "slice5_d2_pade4_periodic": path(lane_dist=8, strided_dist=16),
    "slice5_d2_pade4": path(lane_dist=8, strided_dist=16),
    "slice5_phipsi": path(),  # dense products and collectives, no kernel
}


def phase_dist_paths(dev) -> dict:
    """The distributed solver's entry points at 256^3 f32 on meshes of
    shards on this card, each path with its launch counts: dfdx, dfdy, dfdz
    on (2, 2, 2) (SCHEME4 and SCHEME4_PERIODIC: K11, K12) against cos and
    against the single-device K1/K2 result; dfdx with method="kernel" on
    (1, 1, 4), whose 64-point shard lines take the generic route (K12 on
    flat lines); the distributed gradient on (4, 1, 1) (K7 per shard, K12
    along z) against the single-device gradient; phipsi against
    substructuring (SCHEME4); filter_field and the d2 derivatives on (2, 2,
    2) against their single-device counterparts and -sin."""
    dx = 2 * math.pi / N
    F, d1, d2 = _sines(dev)
    launches, failures = {}, []

    def check(case, out, grid, want, gate, kind):
        got = torch.from_numpy(grid.gather(out)).to(dev).double()
        err = (got - want.double()).abs().max().item()
        val = err / want.abs().max().item() if kind == "rel" else err
        ok = val <= gate and bool(torch.isfinite(got).all().item())
        emit({"phase": "dist_accuracy", "case": case, f"{kind}_err": val, "gate": gate,
              "ok": ok})
        if not ok:
            failures.append(case)
        return got

    for name, scheme in (("slice5_d1_pade4", ct.SCHEME4),
                         ("slice5_d1_pade4_periodic", ct.SCHEME4_PERIODIC)):
        grid, solver = _solver((2, 2, 2), scheme)
        Fs = grid.distribute(F)
        outs, launches[name] = _run_path(lambda: [solver.apply(Fs, a) for a in (2, 1, 0)])
        for axis, out in zip((2, 1, 0), outs):
            case = f"d/d{'zyx'[axis]} (sin x + sin y + sin z) {scheme.name} (2,2,2) {N}^3 f32"
            got = check(case + " vs cos", out, grid, d1[2 - axis], SIN_GATE, "abs")
            check(case + " vs single-device K1/K2", out, grid,
                  ct.derivative(F, dx, scheme, axis=axis - 3, method="kernel"),
                  DIST_VS_SINGLE_GATE, "rel")
        del Fs, outs

    # phipsi against substructuring with the same ghost rows and RHS (the
    # generic route, dense local solves), on sin x as in the JAX dryrun
    grid, solver = _solver((2, 2, 2), ct.SCHEME4, "phipsi")
    S = grid.distribute(_sines(dev, x_only=True))
    phipsi, launches["slice5_phipsi"] = _run_path(lambda: solver.dfdx(S))
    check(f"phipsi vs substructuring (method=matmul) dfdx sin x {ct.SCHEME4.name} (2,2,2) "
          f"{N}^3 f32", phipsi, grid,
          torch.from_numpy(grid.gather(DistributedCompactSolver(grid, method="matmul").dfdx(S)))
          .to(dev), PHIPSI_GATE, "abs")
    del S, phipsi

    grid, solver = _solver((1, 1, 4), ct.SCHEME4, "kernel")
    Fs = grid.distribute(F)
    out, launches["slice5_lines_1x1x4"] = _run_path(lambda: solver.dfdx(Fs))
    case = f"dfdx {ct.SCHEME4.name} (1,1,4) method=kernel, generic route, {N}^3 f32"
    check(case + " vs cos", out, grid, d1[0], SIN_GATE, "abs")
    check(case + " vs single-device K1", out, grid, ct.dfdx(F, dx, ct.SCHEME4),
          DIST_VS_SINGLE_GATE, "rel")

    grid, solver = _solver((4, 1, 1), ct.SCHEME4_PERIODIC)
    Fs = grid.distribute(F)
    gradient = make_gradient_distributed(solver)
    outs, launches["slice5_gradient_4x1x1"] = _run_path(lambda: gradient(Fs))
    for name, out, want in zip("xyz", outs, ct.gradient(F, dx, ct.SCHEME4_PERIODIC)):
        check(f"gradient {name} {ct.SCHEME4_PERIODIC.name} (4,1,1) {N}^3 f32 vs single-device "
              "gradient (K7 + K2)", out, grid, want, DIST_VS_SINGLE_GATE, "rel")

    filt = ct.get_filter(6, 0.45, False)
    grid, solver = _solver((2, 2, 2), filt)
    Fs = grid.distribute(F)
    out, launches["slice5_filter_field"] = _run_path(lambda: solver.filter_field(Fs))
    check(f"filter_field {filt.name} (2,2,2) {N}^3 f32 vs single-device filter_field", out,
          grid, ct.filter_field(F, filt), GATE, "rel")

    # the d2 derivatives: periodic against -sin and the single-device K1/K2
    # result (SIN2_GATE); with closures, where float32 input rounding through
    # the wall rows alone moves f'' by ~1e-3 of max|f| (single-device K1/K2
    # too), against the float64 operator on the same float32 input at the
    # dist kernels' gate
    F64 = F.double()
    for name, scheme in (("slice5_d2_pade4_periodic", ct.SCHEME4_D2_PERIODIC),
                         ("slice5_d2_pade4", ct.SCHEME4_D2)):
        grid, solver = _solver((2, 2, 2), scheme)
        Fs = grid.distribute(F)
        outs, launches[name] = _run_path(lambda: [solver.apply(Fs, a) for a in (2, 1, 0)])
        for axis, out in zip((2, 1, 0), outs):
            case = f"d2/d{'zyx'[axis]}2 {scheme.name} (2,2,2) {N}^3 f32"
            if scheme.periodic:
                check(case + " vs -sin", out, grid, d2[2 - axis], SIN2_GATE, "abs")
                check(case + " vs single-device K1/K2", out, grid,
                      ct.derivative(F, dx, scheme, axis=axis - 3, method="kernel"), SIN2_GATE,
                      "abs")
            else:
                check(case + " vs float64 plain operator", out, grid,
                      ct.derivative(F64, dx, scheme, axis=axis - 3, method="matmul"),
                      _dist_gate(scheme), "rel")
                check(case + " vs single-device K1/K2", out, grid,
                      ct.derivative(F, dx, scheme, axis=axis - 3, method="kernel"),
                      _dist_gate(scheme), "rel")
        del Fs, outs
    for name, got in launches.items():
        ok = got == DIST_PATHS[name]
        emit({"phase": "dist_path", "path": name, "launches": got,
              "launches_expected": DIST_PATHS[name], "ok": ok})
        if not ok:
            failures.append(f"{name} launches")
    if failures:
        raise AssertionError("distributed paths failed: " + "; ".join(failures))
    return launches


# 5 RK3 steps of the distributed model: per substep (2, 2, 2) runs fx and
# d2x through K11 and fy, d2y, fz, d2z through K12, one launch per shard and
# derivative; (1, 2, 2) runs fx, d2x (K11) and fy, d2y (K12) on 4 shards and
# K4 per shard
DIST_SLICES = {
    # name: (mesh, nu, launches expected over STEPS steps)
    "slice5_2x2x2": ((2, 2, 2), NU, path(lane_dist=16 * 3 * STEPS, strided_dist=32 * 3 * STEPS)),
    "slice5_2x2x2_viscous": ((2, 2, 2), NU_VISCOUS,
                             path(lane_dist=16 * 3 * STEPS, strided_dist=32 * 3 * STEPS)),
    "slice5_1x2x2": ((1, 2, 2), NU, path(lane_dist=8 * 3 * STEPS, strided_dist=8 * 3 * STEPS,
                                         rk3_mega=4 * 3 * STEPS)),
    "slice5_1x2x2_viscous": ((1, 2, 2), NU_VISCOUS,
                             path(lane_dist=8 * 3 * STEPS, strided_dist=8 * 3 * STEPS,
                                  rk3_mega=4 * 3 * STEPS)),
}


def _dist_model(mesh_shape, nu):
    grids = [Grid(_mesh(mesh_shape), (N, N, N), (2 * math.pi / N,) * 3, s)
             for s in (ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC)]
    derivs = Derivs.distributed(*(DistributedCompactSolver(g) for g in grids))
    return grids[0], AdvectionDiffusion(derivs, nu=nu)


_REFS = {}


def phase_dist_slice(dev, name) -> dict:
    """5 RK3 steps of AdvectionDiffusion(Derivs.distributed(solver,
    d2_solver)) at 256^3 f32 on a mesh of shards on this card, against the
    same steps of the single-device model on the plain float64 path."""
    mesh_shape, nu, want = DIST_SLICES[name]
    grid, model = _dist_model(mesh_shape, nu)
    fused = model.derivs.fused_substep is not None
    if nu not in _REFS:  # the reference of both meshes at this viscosity
        ref_model, f0_64, u_64 = _model(dev, ct.SCHEME4_PERIODIC, "matmul", torch.float64,
                                        True, nu)
        _REFS[nu] = (f0_64, u_64, ref_model.run(f0_64, u_64, DT, STEPS))
    f0_64, u_64, f_ref = _REFS[nu]
    fs = grid.distribute(f0_64.float())
    us = tuple(grid.distribute(c.float()) for c in u_64)
    t0 = time.perf_counter()
    out, launches = _run_path(lambda: model.run(fs, us, DT, STEPS))
    wall = time.perf_counter() - t0
    f = torch.from_numpy(grid.gather(out)).to(dev)
    err = (f.double() - f_ref).abs().max().item()
    rel = err / f_ref.abs().max().item()
    rel_inc = err / (f_ref - f0_64).abs().max().item()
    finite = bool(torch.isfinite(f).all().item())
    ok = (finite and f.shape == (N, N, N) and f.dtype == torch.float32 and fused
          and rel <= SLICE_GATE and rel_inc <= INC_GATE and launches == want)
    emit({"phase": "slice", "slice": name,
          "case": f"AdvectionDiffusion(Derivs.distributed) {ct.SCHEME4_PERIODIC.name} + "
          f"{ct.SCHEME4_D2_PERIODIC.name} mesh {mesh_shape} on one card, {N}^3 f32, "
          f"{STEPS} RK3 steps dt={DT} nu={nu}", "fused_substep": fused,
          "max_abs_err_vs_f64_plain": err, "rel_err": rel, "gate": SLICE_GATE,
          "rel_err_of_increment": rel_inc, "increment_gate": INC_GATE, "finite": finite,
          "launches": launches, "launches_expected": want, "wall_s_incl_first_calls": wall,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{name} failed: see its slice line")
    return launches


def phase_dist_times(dev, smi) -> dict:
    """CUDA-event medians at 256^3 f32: the distributed dfdx, dfdy, dfdz on
    (2, 2, 2) (SCHEME4_PERIODIC) whole and split into halo, faces, gather +
    reduced solve and kernels (the kernels' 8 launches also queued: their
    device time alone), beside the single-device derivative; the
    distributed step on (2, 2, 2) and (1, 2, 2) in turns with the
    single-device fused step. Eight (four) shards on one card measure the
    distributed algorithm's overhead, not its scaling. K11 and K12 per
    launch are dist_kernel_times.py's."""
    g = torch.Generator(device=dev).manual_seed(20261019)
    dx = 2 * math.pi / N
    scheme = ct.SCHEME4_PERIODIC
    times = {}
    grid, solver = _solver((2, 2, 2), scheme)
    F = torch.randn((N, N, N), generator=g, device=dev)
    Fs = grid.distribute(F)
    kw = dict(scheme=scheme, n=N, p=2, inv_dx=1 / dx)
    kkw = dict(scheme=scheme, n=N, p=2, dx=dx)
    for axis, name in ((2, "dfdx"), (1, "dfdy"), (0, "dfdz")):
        left, right = pcompact._halo_ghosts(Fs, scheme=scheme, axis=axis, p=2, dim=axis - 3)
        faces = pcompact._dist_faces(Fs, left, right, axis, **kw)
        rinv = pcompact.shard_kernel_tables(scheme, N, 2)
        ab = pcompact._reduced_from_faces(*faces, rinv, scheme=scheme, axis=axis, p=2)
        wts = pcompact._kernel_weights(ab, axis, Fs.dtype)
        times[f"dist_{name}"] = {
            "total_ms": cuda_time_ms(lambda: solver.apply(Fs, axis)),
            "halo_ms": cuda_time_ms(lambda: pcompact._halo_ghosts(
                Fs, scheme=scheme, axis=axis, p=2, dim=axis - 3)),
            "faces_ms": cuda_time_ms(lambda: pcompact._dist_faces(Fs, left, right, axis, **kw)),
            "gather_reduced_ms": cuda_time_ms(lambda: pcompact._reduced_from_faces(
                *faces, rinv, scheme=scheme, axis=axis, p=2)),
            "kernels_ms": cuda_time_ms(lambda: pcompact._dist_kernels(
                Fs, left, right, wts, axis, **kkw)),
            "kernels_device_ms": cuda_time_ms(lambda: pcompact._dist_kernels(
                Fs, left, right, wts, axis, **kkw), queued=True),
            "single_device_ms": cuda_time_ms(
                lambda: ct.derivative(F, dx, scheme, axis=axis - 3, method="kernel")),
        }
    del Fs, left, right, faces, ab, wts

    model, f0, u = _model(dev, scheme, "auto", torch.float32, True)
    single = lambda: model.step(f0, u, DT)
    steps = {}
    for mesh_shape in ((2, 2, 2), (1, 2, 2)):
        grid, dmodel = _dist_model(mesh_shape, NU)
        fs, us = grid.distribute(f0), tuple(grid.distribute(c) for c in u)
        t = _turns(single, lambda: dmodel.step(fs, us, DT))
        steps["x".join(map(str, mesh_shape))] = {
            "dist_step_ms": t["kernel_ms"], "single_device_fused_step_ms": t["plain_ms"],
            "readings_ms": [t["kernel_readings_ms"], t["plain_readings_ms"]]}
    emit({"phase": "dist_times", "device": smi, "shape": [N, N, N], "dtype": "float32",
          "scheme": scheme.name, **times, "steps": steps,
          "note": "shards share one card: the distributed algorithm's overhead, not scaling"})
    return times


def _turns(plain, kernel, **kw) -> dict:
    """CUDA-event medians in turns (plain, kernel, kernel, plain), averaged;
    ``kw`` goes to cuda_time_ms."""
    p1 = cuda_time_ms(plain, **kw)
    k1 = cuda_time_ms(kernel, **kw)
    k2 = cuda_time_ms(kernel, **kw)
    p2 = cuda_time_ms(plain, **kw)
    return {"kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "kernel_readings_ms": [k1, k2], "plain_readings_ms": [p1, p2]}


def _library_ms(f, scheme, dx, axis) -> float:
    """One torch.matmul with the precomputed dense operator: the PyTorch
    call that computes the same function as K1/K2 (timed here only)."""
    n = f.shape[axis]
    M = torch.as_tensor(dense.dense_operator(scheme, n) / dx**scheme.derivative_order,
                        dtype=f.dtype, device=f.device)
    if axis in (-1, f.ndim - 1):
        a, b = f.view(-1, n), M.T.contiguous()
    else:
        a, b = M, f.view(math.prod(f.shape[:axis % f.ndim]), n, -1)
    return cuda_time_ms(lambda: torch.matmul(a, b))


def _z_library_ms(M, f, acc=None, mul=None) -> float:
    """The PyTorch library calls with the dense (n, n) float64 matrix M along
    z of f (timed here only): torch.matmul; torch.addmm adding acc; with mul
    too, torch.addcmul(acc, mul, torch.matmul(M, f)), two calls, since no
    one call forms mul * (M f) + acc."""
    n = f.shape[0]
    a = torch.as_tensor(M, dtype=f.dtype, device=f.device)
    b = f.view(n, -1)
    if acc is None:
        return cuda_time_ms(lambda: torch.matmul(a, b))
    c = acc.view(n, -1)
    if mul is None:
        return cuda_time_ms(lambda: torch.addmm(c, a, b))
    m = mul.view(n, -1)
    return cuda_time_ms(lambda: torch.addcmul(c, m, torch.matmul(a, b)))


def _slice3_times(times, f, g, dev) -> None:
    """K2's modes and pair_subtract at 256^3 as the Navier–Stokes step calls
    them, each in turns with its plain float32 version; K5 against the
    three K3 launches it replaces; the spectral subsystem."""
    dx = 2 * math.pi / N
    s1, s2 = FUSED_PAIRS[0]
    a, m = (torch.randn((N, N, N), generator=g, device=dev) for _ in range(2))
    times["compact_strided_solve"] = _turns(lambda: strided.leading_solve_ref(f, s1),
                                            lambda: strided.leading_solve(f, s1))
    times["compact_strided_solve"]["library_ms"] = _z_library_ms(
        np.linalg.inv(dense.lhs_matrix(s1, N)), f)
    times["compact_strided_acc"] = _turns(
        lambda: strided.strided_derivative_ref(f, -dx, s1, 0, acc=a),
        lambda: strided.strided_derivative(f, -dx, s1, 0, acc=a))
    times["compact_strided_acc"]["library_ms"] = _z_library_ms(
        dense.dense_operator(s1, N) / -dx, f, acc=a)
    times["compact_strided_mul"] = _turns(
        lambda: strided.strided_derivative_ref(f, dx, s1, 0, acc=a, mul=m),
        lambda: strided.strided_derivative(f, dx, s1, 0, acc=a, mul=m))
    times["compact_strided_mul"]["library_ms"] = _z_library_ms(
        dense.dense_operator(s1, N) / dx, f, acc=a, mul=m)
    times["pair_subtract"] = _turns(lambda: pair.pair_subtract_ref(f, a, m, dx, dx, s1),
                                    lambda: pair.pair_subtract(f, a, m, dx, dx, s1))
    u = (f, a, m)
    # K5 against the three K3 launches it replaces, in turns
    t = _turns(lambda: [adv_lap.adv_lap_rhs(c, f, a, dx, dx, dx, s1, s2) for c in u],
               lambda: adv_lap.adv_lap_rhs3(u, dx, dx, dx, s1, s2))
    times["adv_lap3_vs_3_adv_lap"] = {"adv_lap3_ms": t["kernel_ms"],
                                      "three_adv_lap_ms": t["plain_ms"],
                                      "readings_ms": [t["kernel_readings_ms"],
                                                      t["plain_readings_ms"]]}
    # the spectral subsystem: the Poisson round trip (cuFFT) and one
    # projection in each form
    times["solve_poisson_ms"] = cuda_time_ms(lambda: ct.solve_poisson(f, dx, s1))
    times["project_compact_ms"] = cuda_time_ms(lambda: ct.project(u, dx, s1, method="compact"))
    times["project_spectral_ms"] = cuda_time_ms(
        lambda: ct.project(u, dx, s1, method="spectral"))
    times["divergence_fused_ms"] = cuda_time_ms(lambda: ct.divergence(u, dx, s1))


def _slice4_times(times, f, g, dev) -> None:
    """K7, K8, K10 and K2's filter mode at 256^3, each in turns with its
    plain float32 version, and each fused route in turns with the unfused
    composition of kernels it replaces; the diagnostics of a velocity."""
    dx = 2 * math.pi / N
    s1, s2 = FUSED_PAIRS[0]
    walls = ct.SCHEME4_D2
    filt = ct.get_filter(6, 0.45, periodic=False)
    for name, axis in (("filter_y", -2), ("filter_z", -3)):
        def run(method, axis=axis):
            return lambda: ct.derivative(f, 1.0, filt, axis=axis, method=method)
        times[name] = _turns(run("matmul"), run("kernel"))
        times[name]["library_ms"] = _library_ms(f, filt, 1.0, axis)
    times["filter_field"] = _turns(lambda: ct.filter_field(f, filt, method="matmul"),
                                   lambda: ct.filter_field(f, filt))
    times["gradient_pair"] = _turns(lambda: pair.gradient_pair_ref(f, dx, dx, s1),
                                    lambda: pair.gradient_pair(f, dx, dx, s1))
    times["d2_sum"] = _turns(lambda: pair.d2_pair_sum_ref(f, dx, dx, walls),
                             lambda: pair.d2_pair_sum(f, dx, dx, walls))
    a, m = (torch.randn((N, N, N), generator=g, device=dev) for _ in range(2))
    u = (f, a, m)
    times["curl_rhs"] = _turns(lambda: vec.curl_rhs_ref(f, a, m, dx, dx, dx, s1),
                               lambda: vec.curl_rhs(f, a, m, dx, dx, dx, s1))

    # each fused route against the kernels it replaces, in turns: "plain"
    # below is the unfused composition (single K1/K2 launches and sums)
    def d1(c, axis):
        return ct.derivative(c, dx, s1, axis=axis, method="kernel")

    def d2(c, scheme, axis):
        return ct.derivative(c, dx, scheme, axis=axis, method="kernel")

    def curl_unfused():
        ux, uy, uz = u
        return (d1(uz, -2) - d1(uy, -3), d1(ux, -3) - d1(uz, -1), d1(uy, -1) - d1(ux, -2))

    routes = {
        "gradient_pair_vs_k1_k2": (lambda: (d1(f, -1), d1(f, -2)),
                                   lambda: pair.gradient_pair(f, dx, dx, s1)),
        "d2_sum_vs_unfused": (lambda: d2(f, walls, -1) + d2(f, walls, -2),
                              lambda: pair.d2_pair_sum(f, dx, dx, walls)),
        "laplacian_periodic_vs_unfused": (
            lambda: d2(f, s2, -1) + d2(f, s2, -2) + d2(f, s2, -3),
            lambda: ct.laplacian(f, dx, s2)),
        "laplacian_walls_vs_unfused": (
            lambda: d2(f, walls, -1) + d2(f, walls, -2) + d2(f, walls, -3),
            lambda: ct.laplacian(f, dx, walls)),
        "curl_vs_unfused": (curl_unfused, lambda: ct.curl(u, dx, s1)),
    }
    for key, (unfused, fused) in routes.items():
        t = _turns(unfused, fused)
        times[key] = {"fused_ms": t["kernel_ms"], "unfused_ms": t["plain_ms"],
                      "readings_ms": [t["kernel_readings_ms"], t["plain_readings_ms"]]}
    times["enstrophy_ms"] = cuda_time_ms(lambda: spectra.enstrophy(u, dx, s1))
    times["dissipation_ms"] = cuda_time_ms(lambda: spectra.dissipation(u, dx, s1, NU_NS))
    times["energy_spectrum_ms"] = cuda_time_ms(lambda: spectra.energy_spectrum(u, dx))


def _velocity_step_times(steps, dev) -> None:
    """The Navier–Stokes step, and the Burgers step on each of its routes."""
    u = _ns_velocity(dev, torch.float32)
    ns = _velocity_model("ns", dev, "auto", NU_NS)
    steps["ns_step_ms"] = cuda_time_ms(lambda: ns.step(u, DT), warmup=2, iters=10)
    burgers = _velocity_model("burgers", dev, "auto", NU_BURGERS)
    d = burgers.derivs
    for key, derivs in (
        ("burgers_step_vec_ms", d),
        ("burgers_step_scalar_fused_ms", dataclasses.replace(d, fused_substep_vec=None)),
        ("burgers_step_generic_ms",
         dataclasses.replace(d, fused_substep_vec=None, fused_substep=None)),
    ):
        model = Burgers(derivs, nu=NU_BURGERS)
        steps[key] = cuda_time_ms(lambda: model.step(u, DT), warmup=2, iters=10)


def phase_times(dev, smi) -> dict:
    """CUDA-event medians at 256^3 f32 of what lane_times.py and
    dist_kernel_times.py do not time: K2 along y and z, each in turns with
    its plain float32 version and beside its library call, K2's other
    modes, K7, K8, K10, pair_subtract, the fused routes against the
    compositions they replace, the spectral subsystem and the diagnostics
    (``_slice3_times``, ``_slice4_times``), a copy floor, and each
    configuration's step."""
    g = torch.Generator(device=dev).manual_seed(7)
    f = torch.randn((N, N, N), generator=g, device=dev)
    dx = 2 * math.pi / N
    s1, s2 = FUSED_PAIRS[0]
    times = {}
    for scheme, names in ((s1, ("dfdy", "dfdz")), (s2, ("d2fdy2", "d2fdz2"))):
        for axis, name in zip((-2, -3), names):
            def run(method, axis=axis, scheme=scheme):
                return lambda: ct.derivative(f, dx, scheme, axis=axis, method=method)
            times[name] = _turns(run("matmul"), run("kernel"))
            times[name]["library_ms"] = _library_ms(f, scheme, dx, axis)
    _slice3_times(times, f, g, dev)
    _slice4_times(times, f, g, dev)
    out = torch.empty_like(f)
    copy_ms = cuda_time_ms(lambda: out.copy_(f))
    steps = {}
    for key, scheme, method, d2 in (
        ("rk3_step_slice1_ms", s1, "auto", False),
        ("rk3_step_slice1_plain_f32_ms", s1, "matmul", False),
        ("rk3_step_fused_ms", s1, "auto", True),
        ("rk3_step_d2_walls_ms", ct.SCHEME4, "auto", True),
    ):
        model, f0, u = _model(dev, scheme, method, torch.float32, d2)
        steps[key] = cuda_time_ms(lambda: model.step(f0, u, DT), warmup=2, iters=10)
    # the same d2 configuration without its fused substep: the generic step
    # with the compact-d2 Laplacian through K1/K2
    model, f0, u = _model(dev, s1, "auto", torch.float32, True)
    generic = AdvectionDiffusion(dataclasses.replace(model.derivs, fused_substep=None), nu=NU)
    steps["rk3_step_d2_generic_ms"] = cuda_time_ms(lambda: generic.step(f0, u, DT),
                                                   warmup=2, iters=10)
    _velocity_step_times(steps, dev)
    pts = N**3
    emit({
        "phase": "times", "device": smi, "schemes": [s1.name, s2.name], "shape": [N, N, N],
        "dtype": "float32", **times, "copy_floor_ms": copy_ms,
        "copy_GB_per_s": 2 * 4 * pts / (copy_ms * 1e-3) / 1e9, **steps,
    })
    return {**times, "copy_floor_ms": copy_ms}


# ---------------------------------------------------------------------------
# Slice 8: the benchmark harness and its diagnosis kernels (K14, K15)
# ---------------------------------------------------------------------------

DFDZ = (N, N * N)  # the dfdz layout of a 256^3 field (diag_dfdz.py)
LANE2D = (N * N, N)  # K1's lines as diag_lane.py copies them
DFDZ_COLS = (1024, 2048)  # diag_dfdz.py's tiles
# The gates of the dots modes are the script's (benchmarks/diag_dfdz.py):
# dots against float64 at the dense-operator gate; dots_default against its
# bf16-operand plain version and against float64.
DIAG_TIMED = {"diag_copy2d": f"{LANE2D} tiles (1024, {N})",
              "diag_copy3d": f"{(N,) * 3} slabs ({N}, 8, {N})",
              "diag_dfdz_": f"{DFDZ} C={DFDZ_COLS[0]}"}


def _diag_cases(stats, failures, g, dev) -> None:
    """K14 and K15 against their plain versions: copies bitwise, rolls
    bitwise (the same two roundings), the dots modes at their gates."""
    def record(kernel, label, got, ref, ok, **extra):
        abs_err = (got.double() - ref.double()).abs().max().item()
        ref_max = ref.double().abs().max().item()
        emit({"phase": "kernels", "kernel": kernel, "case": label, "max_abs_err": abs_err,
              "max_abs_ref": ref_max, "rel_err": abs_err / ref_max, **extra, "ok": ok})
        s = stats[kernel]
        s["max_abs_err"] = max(s["max_abs_err"], abs_err)
        s["max_rel_err"] = max(s["max_rel_err"], abs_err / ref_max)
        if not ok:
            failures.append(f"{kernel} {label}")

    x2 = torch.randn(LANE2D, generator=g, device=dev)
    xz = torch.randn(DFDZ, generator=g, device=dev)
    for x, rows, cols in ((x2, 1024, N),) + tuple((xz, N, c) for c in (512, 2048, 8192)):
        got = diag.copy2d(x, rows, cols)
        record("diag_copy2d", f"{tuple(x.shape)} tiles ({rows}, {cols})", got, x,
               torch.equal(got, x), gate="bitwise")
    x3 = xz.view(N, N, N)
    for bz, by in ((N, 8), (N, 32), (8, N)):
        got = diag.copy3d(x3, bz, by)
        record("diag_copy3d", f"{tuple(x3.shape)} slabs ({bz}, {by}, {N})", got, x3,
               torch.equal(got, x3), gate="bitwise")
    table = diag.dfdz_table(N, dev)
    exact = diag.dfdz_stage_ref(xz.double(), "dots", DFDZ_COLS[0], table.double())
    for C in DFDZ_COLS:
        label = f"{DFDZ} C={C}"
        for mode in ("copy", "rolls"):
            got, ref = diag.dfdz_stage(xz, mode, C), diag.dfdz_stage_ref(xz, mode, C)
            record(f"diag_dfdz_{mode}", label, got, ref, torch.equal(got, ref), gate="bitwise")
        got = diag.dfdz_stage(xz, "dots", C)
        rel = _rel(got, exact)
        record("diag_dfdz_dots", label + " vs float64", got, exact, rel <= DOTS_GATE,
               gate=DOTS_GATE)
        got = diag.dfdz_stage(xz, "dots_default", C)
        rel16 = _rel(got, diag.dfdz_stage_ref(xz, "dots_default", C))
        rel64 = _rel(got, exact)
        record("diag_dfdz_dots_default", label + " vs bf16-operand plain", got,
               diag.dfdz_stage_ref(xz, "dots_default", C),
               rel16 <= BF16_GATE and rel64 <= BF16_F64_GATE, gate=BF16_GATE,
               rel_err_vs_float64=rel64, gate_vs_float64=BF16_F64_GATE)


def _rel(got, ref) -> float:
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def phase_diag(dev, smi) -> dict:
    """K14 and K15 against their plain versions on the card (at 256^3: the
    (256, 65536) dfdz layout and its 3-D view, and diag_lane's (65536,
    256)), then their device times (queued: every call issued behind a spin
    kernel), each in turns with its plain version, beside its bound and the
    one PyTorch call that computes the same function (Tensor.copy_ for the
    copies; torch.matmul(T, f.view(2, 128, L)) for dots; for dots_default
    the same as torch.bmm of the bf16 casts, made inside the call, with a
    float32 output; rolls has none: its unfused torch.roll form is
    timed)."""
    stats = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNELS if k.startswith("diag")}
    failures = []
    g = torch.Generator(device=dev).manual_seed(20261025)
    _diag_cases(stats, failures, g, dev)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("diag kernels vs plain over the gate: " + "; ".join(failures))
    q = dict(queued=True)
    times = {}
    xz = torch.randn(DFDZ, generator=g, device=dev)
    x2, x3 = xz.view(LANE2D), xz.view(N, N, N)
    out = torch.empty_like(xz)
    copy_ms = cuda_time_ms(lambda: out.copy_(xz), **q)
    times["diag_copy2d"] = _turns(lambda: diag.copy2d_ref(x2, 1024, N),
                                  lambda: diag.copy2d(x2, 1024, N), **q)
    times["diag_copy3d"] = _turns(lambda: diag.copy3d_ref(x3, N, 8),
                                  lambda: diag.copy3d(x3, N, 8), **q)
    for key in ("diag_copy2d", "diag_copy3d"):
        times[key]["library_ms"] = copy_ms
    times["diag_copy2d_patterns_ms"] = {
        f"{tuple(x.shape)} tiles ({r}, {c})": cuda_time_ms(lambda: diag.copy2d(x, r, c), **q)
        for x, r, c in ((x2, 1024, N), (xz, N, 512), (xz, N, 2048), (xz, N, 8192))}
    times["diag_copy3d_patterns_ms"] = {
        f"slabs ({bz}, {by}, {N})": cuda_time_ms(lambda: diag.copy3d(x3, bz, by), **q)
        for bz, by in ((N, 8), (N, 32), (8, N))}
    table = diag.dfdz_table(N, dev)
    blocks = xz.view(N // diag.BLOCK, diag.BLOCK, -1)
    # dots_default's library call: the same function, float32 in and out
    # (the bf16 casts inside the call, float32 accumulation and output)
    library = {"copy": lambda: out.copy_(xz), "rolls": None,
               "dots": lambda: torch.matmul(table, blocks),
               "dots_default": lambda: torch.bmm(table.bfloat16(), blocks.bfloat16(),
                                                 out_dtype=torch.float32)}
    for mode in diag.MODES:
        key = f"diag_dfdz_{mode}"
        for C in DFDZ_COLS:
            t = _turns(lambda: diag.dfdz_stage_ref(xz, mode, C, table),
                       lambda: diag.dfdz_stage(xz, mode, C, table), **q)
            times[key if C == DFDZ_COLS[0] else f"{key}_C{C}"] = t
        times[key]["library_ms"] = cuda_time_ms(library[mode], **q) if library[mode] else None
        if mode == "rolls":
            def unfused():
                g1 = torch.roll(xz, -1, 0) - xz
                return g1 + torch.roll(g1, 1, 0)
            times[key]["unfused_ms"] = cuda_time_ms(unfused, **q)
    emit({"phase": "diag_times", "device": smi, "dtype": "float32", "copy_floor_ms": copy_ms,
          **times, "note": "queued: every call issued behind a spin kernel, device time alone"})
    return {"stats": stats, "times": times}


# What each script must launch when it runs on the card: its own kernels
# (the path), checked after the script's run with every count zeroed first
BENCH_SCRIPTS = {
    # name: (argv, environment, kernels the run must launch)
    "diag_lane": (["--passes", "1"], {}, ("diag_copy2d", "diag_copy3d", "compact_lane")),
    "diag_dfdz": (["--passes", "1"], {}, tuple(f"diag_dfdz_{m}" for m in diag.MODES)
                  + ("compact_strided",)),
    "run_single": (["--sizes", "64,256"], {}, ("strided_dist_lines", "compact_lane",
                                               "compact_strided", "compact_lane_filter")),
    # 128-point shard lines: the fast path, K11 (64-point ones take the
    # dense generic route, which launches no kernel)
    "run_distributed": ([], {"CFD_MESH": "2,2,2", "CFD_GRID": "256,256,256",
                             "CFD_SPACING": "0.0245"}, ("lane_dist",)),
    "diag_axes": (["--n", "128"], {}, ("compact_lane", "compact_strided", "lap_rhs",
                                       "compact_strided_solve")),
    "diag_rk3": (["--n", "128"], {}, ("adv_lap", "rk3_mega", "adv_pair", "lap_rhs",
                                      "compact_strided_mul", "compact_strided_rk", "adv_lap3")),
    "diag_ns": (["--n", "128"], {}, ("adv_lap3", "rk3_mega", "div_rhs", "compact_strided_solve",
                                     "pair_subtract", "compact_strided_acc")),
}


def phase_bench_scripts(dev) -> dict:
    """Each ported benchmark script's main, in this process, at a reduced
    size (diag_lane and diag_dfdz at their own 256^3 with one pass), with
    every launch count zeroed just before and read just after: a failed
    gate or an error row ends the script nonzero, and this phase fails."""
    import importlib

    launches = {}
    for name, (argv, env, must) in BENCH_SCRIPTS.items():
        mod = importlib.import_module(f"cfd_tpu_torch.benchmarks.{name}")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            out, counts = _run_path(lambda: mod.main(argv + ["--device", str(dev)]))
        except SystemExit as exc:
            raise AssertionError(f"bench script {name} failed (exit {exc.code})") from None
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        missing = [k for k in must if counts[k] == 0]
        emit({"phase": "bench_scripts", "script": name, "argv": argv, "env": env,
              "rows": len(out), "seconds": time.perf_counter() - t0,
              "launches": {k: v for k, v in counts.items() if v}, "missing": missing,
              "ok": not missing})
        if missing:
            raise AssertionError(f"bench script {name} launched none of {missing}")
        launches[f"bench_{name}"] = counts
    return launches


# the kernels whose device time another script takes, by script
TIMED_BY = {**dict.fromkeys(("compact_lane", "compact_lane_filter", "adv_lap", "rk3_mega",
                             "adv_lap3", "div_rhs", "lap_rhs", "adv_pair"), "lane_times.py"),
            **dict.fromkeys(("lane_dist", "strided_dist", "strided_dist_lines"),
                            "dist_kernel_times.py")}


def _row(name, stats, launches) -> dict:
    """A kernel's summary row: its source, its launches on the paths above
    (and by path) and its largest errors against its plain version."""
    return {"name": name, "route": "cuda", **KERNELS[name],
            "launches": sum(by_path[name] for by_path in launches.values()),
            "launches_by_path": {p: by_path[name] for p, by_path in launches.items()
                                 if by_path[name]},
            "max_abs_err": stats[name]["max_abs_err"],
            "max_rel_err": stats[name]["max_rel_err"]}


def _summary(stats, launches, times, long_times, diag_out) -> list:
    pts = N**3
    copy_rate = 2 * 4 * pts / (times["copy_floor_ms"] * 1e-3)  # bytes/s, this run
    timed = {
        "compact_strided": ("dfdy", "dfdz"),  # K2 serves y and z equally often
        **{name: (name,) for name in (
            "compact_strided_solve", "compact_strided_acc", "compact_strided_mul",
            "pair_subtract", "gradient_pair", "d2_sum", "curl_rhs")},
        "compact_strided_filter": ("filter_y", "filter_z"),
    }
    rows = []
    for name, keys in timed.items():
        mean = lambda field: sum(times[k][field] for k in keys) / len(keys)
        nbytes = BYTES_PER_POINT[name] * pts
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = FLOPS_PER_POINT[name] * pts / F32_FLOPS_PER_S * 1e3
        lib = [times[k]["library_ms"] for k in keys if "library_ms" in times[k]]
        rows.append({
            **_row(name, stats, launches),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "copy_bound_ms": nbytes / copy_rate * 1e3,
            "library_ms": sum(lib) / len(lib) if lib else None,
            "timed": [f"{k} {N}^3 f32" for k in keys],
        })
    # K2's rk mode at LONG, the shape whose path (the stepwise tail) runs it
    t = long_times[f"compact_strided_rk_{'x'.join(map(str, LONG))}"]
    nbytes = BYTES_PER_POINT["compact_strided_rk"] * math.prod(LONG)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = FLOPS_PER_POINT["compact_strided_rk"] * math.prod(LONG) / F32_FLOPS_PER_S * 1e3
    rows.append({
        **_row("compact_strided_rk", stats, launches),
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "copy_bound_ms": nbytes / (2 * 4 * math.prod(LONG)) * long_times["copy_long_ms"],
        "library_ms": None, "unfused_ms": t["unfused_ms"],
        "timed": [f"compact_strided_rk {LONG} f32"],
    })
    # the diagnosis kernels at 256^3, queued (device time alone)
    for name, t in diag_out["times"].items():
        if name not in KERNELS:
            continue
        bound, bound_by = bench_dfdz.bound_ms(name.removeprefix("diag_dfdz_"), pts)
        rows.append({
            **_row(name, diag_out["stats"], launches),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "copy_bound_ms": 8 * pts / copy_rate * 1e3,
            "library_ms": t["library_ms"],
            **({"unfused_ms": t["unfused_ms"]} if "unfused_ms" in t else {}),
            **({"fma_bound_ms": bench_dfdz.fma_bound_ms(pts)} if name == "diag_dfdz_dots"
               else {}),
            "timed": [f"{name} {next(v for k, v in DIAG_TIMED.items() if name.startswith(k))} "
                      "f32, queued"],
        })
    rows += [{**_row(name, stats, launches), "timed_by": script}
             for name, script in TIMED_BY.items()]
    return rows


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    stats = phase_kernels(dev)
    phase_accuracy(dev)
    launches = {name: phase_slice(dev, name) for name in SLICES}
    launches.update({name: phase_velocity_slice(dev, name) for name in VELOCITY_SLICES})
    launches["slice4_vector_calculus"] = phase_vector_calculus(dev)
    launches["slice4_diagnostics"] = phase_diagnostics(dev)
    launches.update(phase_dist_paths(dev))
    launches.update({name: phase_dist_slice(dev, name) for name in DIST_SLICES})
    for shape in (LONG, (N, N, N)):
        launches.update(phase_stepwise(dev, shape))
    launches.update({name: phase_long_slice(dev, name) for name in LONG_SLICES})
    times = phase_times(dev, smi)
    phase_dist_times(dev, smi)
    long_times = _long_times(dev, smi)
    diag_out = phase_diag(dev, smi)
    launches.update(phase_bench_scripts(dev))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    # the launches of K3, K5, K6, K9 and K13 on the paths above, each of
    # which ran the staged y phase of csrc/xy_phase.cuh
    y_launches = sum(by_path[k] for by_path in launches.values()
                     for k in ("adv_lap", "adv_lap3", "div_rhs", "lap_rhs", "adv_pair"))
    emit({"phase": "y_phase", "launches_on_paths": y_launches})
    emit({"kernels": _summary(stats, launches, times, long_times, diag_out)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
