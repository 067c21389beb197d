"""Build, load and feed the port's CUDA kernels.

The kernels (``cfd_tpu_torch/csrc/*.cu``) are compiled at first use with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``cfd_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags, so a changed source
builds anew and an unchanged one is reused. Importing this module builds
nothing and needs no ``nvcc``; only ``library()`` does.

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

__all__ = [
    "Coef",
    "build",
    "library",
    "check",
    "check_operands",
    "check_order",
    "fill_coef",
    "kernel_tables",
    "launch_tables",
    "x_lines_fit",
    "xy_planes_fit",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (
    "compact_lane.cu", "compact_strided.cu", "adv_lap.cu", "rk3_mega.cu",
    "adv_lap3.cu", "div_rhs.cu", "pair.cu", "d2_sum.cu", "lap_rhs.cu", "curl_rhs.cu",
    "lane_dist.cu", "strided_dist.cu", "adv_pair.cu", "diag_copy.cu", "diag_dfdz.cu",
)
HEADERS = ("compact_common.cuh", "xy_phase.cuh", "dist_common.cuh", "line_chains.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

MAX_K, MAX_ROWS, MAX_TAPS = 3, 3, 8
AHEAD = 8  # CFD_AHEAD: the rows a line's read-ahead holds (compact_common.cuh)
X_BLOCK_BYTES = 48 * 1024  # what a one-thread-a-line x block stages (pair.cu, xy_phase.cuh)


class Coef(ctypes.Structure):
    """Scheme coefficients for one (scheme, n, dx): ``struct Coef`` in C."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("K", ctypes.c_int),
        ("periodic", ctypes.c_int),
        ("n_rows", ctypes.c_int),
        ("n_taps", ctypes.c_int),
        ("diff2", ctypes.c_int),
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
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    compiles = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for s, o in zip(SOURCES, objs)
    ]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        for source, proc in zip(SOURCES, compiles):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{err}")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        done = subprocess.run(link, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({done.returncode}):\n{done.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    finally:
        for proc in compiles:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    coef = ctypes.POINTER(Coef)
    lib.cfd_compact_lane.argtypes = [p, p, p, coef, p, i64, i32, i32, i32, p]
    lib.cfd_compact_lane.restype = i32
    lib.cfd_compact_strided.argtypes = [p, p, p, coef, p, p, i32, i64, i64, p]
    lib.cfd_compact_strided.restype = i32
    f32 = ctypes.c_float
    lib.cfd_strided_rk.argtypes = [p] * 7 + [coef] + [f32] * 4 + [i64, i64, p]
    lib.cfd_strided_rk.restype = i32
    lib.cfd_adv_lap.argtypes = [p] * 11 + [coef] * 4 + [i32] * 7 + [p]
    lib.cfd_adv_lap.restype = i32
    lib.cfd_adv_lap3.argtypes = [p] * 15 + [coef] * 4 + [i32] * 7 + [p]
    lib.cfd_adv_lap3.restype = i32
    lib.cfd_div_rhs.argtypes = [p] * 8 + [coef] * 2 + [i32] * 5 + [p]
    lib.cfd_div_rhs.restype = i32
    lib.cfd_gradient_pair.argtypes = [p] * 5 + [coef] * 2 + [i64, p]
    lib.cfd_gradient_pair.restype = i32
    lib.cfd_d2_sum.argtypes = [p] * 4 + [coef] * 2 + [i64, p]
    lib.cfd_d2_sum.restype = i32
    lib.cfd_lap_rhs.argtypes = [p] * 6 + [coef] * 2 + [i32] * 5 + [p]
    lib.cfd_lap_rhs.restype = i32
    lib.cfd_curl_rhs.argtypes = [p] * 10 + [coef] * 2 + [i32, i32, p]
    lib.cfd_curl_rhs.restype = i32
    lib.cfd_rk3_mega.argtypes = [p] * 9 + [coef, coef] + [f32] * 4 + [i32, i64] + [i32] * 5 + [p]
    lib.cfd_rk3_mega.restype = i32
    lib.cfd_rk3_mega_smem_limit.argtypes = [ctypes.POINTER(i32)]
    lib.cfd_rk3_mega_smem_limit.restype = i32
    lib.cfd_lane_dist.argtypes = [p] * 6 + [coef, i64, i32, i32, i32, p]
    lib.cfd_lane_dist.restype = i32
    lib.cfd_strided_dist.argtypes = [p] * 6 + [coef, i64, i64, i32, i32, i32, p]
    lib.cfd_strided_dist.restype = i32
    lib.cfd_adv_pair.argtypes = [p] * 6 + [coef] * 2 + [i32] * 4 + [p]
    lib.cfd_adv_pair.restype = i32
    lib.cfd_diag_copy.argtypes = [p, p] + [i64] * 7 + [p]
    lib.cfd_diag_copy.restype = i32
    lib.cfd_diag_dfdz.argtypes = [p, p, p, i32, i32, i64, i32, p]
    lib.cfd_diag_dfdz.restype = i32
    return lib


def check(err: int, kernel: str) -> None:
    """Raise on the ``cudaError_t`` a kernel's C entry point returned."""
    if err:
        raise RuntimeError(f"{kernel} launch failed: {torch.cuda.CudaError(err)}")


def check_order(scheme: CompactScheme) -> None:
    """Raise unless ``scheme`` is a first or second derivative or a filter
    (``derivative_order`` 0), the three the kernels' tables serve."""
    if scheme.derivative_order not in (0, 1, 2):
        raise ValueError(
            f"scheme {scheme.name!r} has derivative_order="
            f"{scheme.derivative_order}; the port takes first and second "
            "derivatives and filters"
        )


def x_lines_fit(nx: int, tiles: int = 1) -> bool:
    """Whether ``tiles`` staged x-lines of ``nx`` floats, each with its wrap
    slots (``cfd_line_ld``), fit the shared memory an x block stages: the
    test ``xy_launch`` (``csrc/xy_phase.cuh``: K8, K10) and K7 make before
    they launch. With ``tiles=2``, the JAX package's limit for K3 and K5
    (two staged lines), which ``adv_lap`` keeps for their chained x phase."""
    return tiles * 4 * ((nx + AHEAD + 1) | 1) <= X_BLOCK_BYTES


def xy_planes_fit(scheme: CompactScheme, ny: int, nx: int) -> bool:
    """Whether ``"auto"`` routes (ny, nx) planes to K7-K10 and K13 for
    ``scheme``: both lines at least the scheme's ``min_points``, and one
    staged x-line within an x block's 48 KB (``x_lines_fit``), as the JAX
    package's routing has it. The chained x phase of K6, K9 and K13 also
    takes longer lines."""
    return min(ny, nx) >= scheme.min_points() and x_lines_fit(nx)


def check_operands(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on the
    first one's device: what every kernel takes."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: no kernel for device {t.device}")
        if t.device != dev:
            raise ValueError(f"{kernel}: operands on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} takes contiguous tensors")


@functools.lru_cache(maxsize=None)
def kernel_tables(scheme: CompactScheme, n: int):
    """(coefficients without the dx scale, per-point table (5, n)), float64.

    The per-point rows are the Thomas multipliers ``w``, ``invd`` and
    ``du`` of the (cyclic-core) LHS; for periodic schemes also the
    Sherman–Morrison ``q`` and row 0 of U^{-1} (``p``), which lets the
    kernels apply the rank-1 term during the backward sweep. A second
    derivative's closure rows are given over second differences
    (``diff2``, ``second_differences``; see ``csrc/compact_common.cuh``).
    A filter's rows do not annihilate constants: ``center`` carries the
    interior row's constant part, c0 + 2 sum(w) = 1 + 2 alpha, and
    ``left_sum``/``right_sum`` its identity closure rows' 1, so that a row
    formed from differences to f[i] returns f[i] exactly on those rows.
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
    diff2 = scheme.derivative_order == 2 and taps > 0
    for side, rows in (("left", scheme.left_rows), ("right", scheme.right_rows)):
        st = np.zeros((MAX_ROWS, MAX_TAPS))
        for j, row in enumerate(rows):
            st[j, : len(row.rhs_stencil)] = row.rhs_stencil
        sums = st.sum(axis=1)
        # a derivative row annihilates constants: keep its sum exactly 0 (a
        # filter's identity row sums to 1)
        sums[np.abs(sums) < 1e-12] = 0.0
        if diff2:
            st, sums = np.stack([second_differences(r) for r in st]), np.zeros(MAX_ROWS)
        coef[side], coef[side + "_sum"] = st, sums
    coef.update(n_rows=scheme.n_closure, n_taps=taps - 2 if diff2 else taps, diff2=int(diff2))
    return coef, tab


def second_differences(row: np.ndarray) -> np.ndarray:
    """Weights d of ``row`` c over second differences: c_m = d_m - 2 d_{m-1}
    + d_{m-2}, so sum_m c_m f_m = sum_m d_m (f_m - 2 f_{m+1} + f_{m+2}).

    Exists for a row that annihilates constants and linear functions, as a
    second derivative's closure row does; raises otherwise.
    """
    d = np.zeros_like(row)
    for m in range(len(row) - 2):
        d[m] = row[m] + (2.0 * d[m - 1] if m >= 1 else 0.0) - (d[m - 2] if m >= 2 else 0.0)
    back = d.copy()
    back[1:] -= 2.0 * d[:-1]
    back[2:] += d[:-2]
    if np.abs(back - row).max() > 1e-12 * max(1.0, np.abs(row).max()):
        raise ValueError("closure row does not annihilate linear functions")
    return d


def fill_coef(coef: dict, scale: float) -> Coef:
    """The ctypes ``Coef`` of a coefficient dict (``kernel_tables``) at one
    spacing scale."""
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
    return fill_coef(coef, scale), torch.as_tensor(tab, dtype=torch.float32, device=device)
