"""Build, load and feed the port's CUDA kernels.

The kernels (``cfd_tpu_torch/csrc/*.cu``) are compiled at first use with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``cfd_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so a changed source builds anew and an unchanged one is reused.
Importing this module builds nothing and needs no ``nvcc``; only
``library()`` does.

``kernel_tables`` turns a scheme into the kernels' inputs: the ``Coef``
struct (mirroring ``csrc/compact_common.cuh`` field by field) and the
per-point Thomas/Sherman–Morrison table, both built in float64 and cast
to float32.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..schemes import CompactScheme, lhs_bands
from . import tridiag

__all__ = ["Coef", "build", "library", "check", "kernel_tables", "launch_tables"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("compact_lane.cu", "compact_strided.cu")
HEADERS = ("compact_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

MAX_K, MAX_ROWS, MAX_TAPS = 3, 3, 8


class Coef(ctypes.Structure):
    """Scheme coefficients for one (scheme, n, dx): ``struct Coef`` in C."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("K", ctypes.c_int),
        ("periodic", ctypes.c_int),
        ("n_rows", ctypes.c_int),
        ("n_taps", ctypes.c_int),
        ("w", ctypes.c_float * MAX_K),
        ("sign", ctypes.c_float),
        ("center", ctypes.c_float),
        ("scale", ctypes.c_float),
        ("v0", ctypes.c_float),
        ("vn", ctypes.c_float),
        ("inv_denom", ctypes.c_float),
        ("left", (ctypes.c_float * MAX_TAPS) * MAX_ROWS),
        ("left_sum", ctypes.c_float * MAX_ROWS),
        ("right", (ctypes.c_float * MAX_TAPS) * MAX_ROWS),
        ("right_sum", ctypes.c_float * MAX_ROWS),
    ]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build only "
            "where the CUDA toolkit is installed"
        )
    return str(nvcc)


def build() -> Path:
    """Compile the kernels if this exact source set is not built yet."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"libcfd_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}):\n{done.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    coef = ctypes.POINTER(Coef)
    lib.cfd_compact_lane.argtypes = [p, p, p, coef, i64, p]
    lib.cfd_compact_lane.restype = i32
    lib.cfd_compact_strided.argtypes = [p, p, p, coef, i64, i64, p]
    lib.cfd_compact_strided.restype = i32
    return lib


def check(err: int, kernel: str) -> None:
    """Raise on the ``cudaError_t`` a kernel's C entry point returned."""
    if err:
        raise RuntimeError(f"{kernel} launch failed: {torch.cuda.CudaError(err)}")


@functools.lru_cache(maxsize=None)
def kernel_tables(scheme: CompactScheme, n: int):
    """(coefficients without the dx scale, per-point table (5, n)), float64.

    The per-point rows are the Thomas multipliers ``w``, ``invd`` and
    ``du`` of the (cyclic-core) LHS; for periodic schemes also the
    Sherman–Morrison ``q`` and row 0 of U^{-1} (``p``), which lets the
    kernels apply the rank-1 term during the backward sweep.
    """
    if scheme.stencil_width > MAX_K or scheme.n_closure > MAX_ROWS:
        raise ValueError(f"scheme {scheme.name} is wider than the kernels take")
    bands = lhs_bands(scheme, n)
    tab = np.zeros((5, n))
    coef = {"n": n, "K": scheme.stencil_width, "periodic": int(scheme.periodic)}
    if scheme.periodic:
        cyc = tridiag.cyclic_factor(*bands, scheme.alpha, scheme.alpha)
        core = cyc.core
        tab[3] = cyc.q
        coef.update(v0=cyc.v0, vn=cyc.vn, inv_denom=cyc.inv_denom)
    else:
        core = tridiag.thomas_factor(*bands)
        coef.update(v0=0.0, vn=0.0, inv_denom=0.0)
    tab[0], tab[1], tab[2] = core.w, core.invd, core.du
    p = tab[4]
    if scheme.periodic:
        p[0] = core.invd[0]
        for i in range(1, n):
            p[i] = -p[i - 1] * core.du[i - 1] * core.invd[i]
    w = np.zeros(MAX_K)
    for k, wk in zip(scheme.rhs_offsets, scheme.rhs_weights):
        w[k - 1] += wk
    coef.update(
        w=w,
        sign=scheme.rhs_sign,
        center=scheme.rhs_center + (1.0 + scheme.rhs_sign) * w.sum(),
    )
    taps = max([len(r.rhs_stencil) for r in scheme.left_rows] + [0])
    if taps > MAX_TAPS:
        raise ValueError(f"scheme {scheme.name}: closure rows wider than {MAX_TAPS}")
    for side, rows in (("left", scheme.left_rows), ("right", scheme.right_rows)):
        st = np.zeros((MAX_ROWS, MAX_TAPS))
        for j, row in enumerate(rows):
            st[j, : len(row.rhs_stencil)] = row.rhs_stencil
        sums = st.sum(axis=1)
        # a derivative row annihilates constants: keep its sum exactly 0
        sums[np.abs(sums) < 1e-12] = 0.0
        coef[side], coef[side + "_sum"] = st, sums
    coef.update(n_rows=scheme.n_closure, n_taps=taps)
    return coef, tab


def _fill(coef: dict, scale: float) -> Coef:
    c = Coef()
    for name, value in {**coef, "scale": scale}.items():
        if isinstance(value, np.ndarray):
            flat = getattr(c, name)
            if value.ndim == 1:
                flat[:] = value.tolist()
            else:
                for j, row in enumerate(value):
                    flat[j][:] = row.tolist()
        else:
            setattr(c, name, value)
    return c


@functools.lru_cache(maxsize=64)
def launch_tables(scheme: CompactScheme, n: int, dx: float, device: torch.device):
    """(Coef, float32 (5, n) table on ``device``) for one kernel launch."""
    coef, tab = kernel_tables(scheme, n)
    scale = (1.0 / float(dx)) ** scheme.derivative_order
    return _fill(coef, scale), torch.as_tensor(tab, dtype=torch.float32, device=device)
