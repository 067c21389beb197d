"""The diagnosis kernels K14 (``diag_copy``) and K15 (``diag_dfdz``).

Here, on the CPU, the plain versions of ``cfd_tpu_torch.ops.diag`` are
held against the JAX benchmark scripts' own Pallas bodies
(``benchmarks/diag_lane.py`` ``copy2d``/``copy3d``,
``benchmarks/diag_dfdz.py`` ``_pallas2d`` with ``k_copy``, ``k_rolls``,
``k_dots``, ``k_dots_default``), loaded by path and run in interpret mode
(``pl.pallas_call`` patched to ``interpret=True``), on the same float32
inputs made with numpy:

* copy2d, copy3d, copy: bitwise;
* rolls: within 1 ulp of max|f| (the same two roundings, g = f[i+1] - f[i]
  then g[i] + g[i-1]);
* dots: within 1e-6 of max|ref| (the same float32 product, summed in
  another order), with gate 1 on the blocks: the port's
  ``direction_tables(SCHEME4_PERIODIC, 256, 2).tinv`` equals cfd_tpu's in
  float64, and rounded to float32 and transposed it is ``_lane_tables``'
  ``Tm`` bit for bit;
* dots_default: the plain version rounds T and f to bf16 and multiplies in
  float32; against float64 it stays within 1e-2 of max|ref| (8 mantissa
  bits). The JAX body on the CPU computes its default-precision dot in
  full float32 (it equals ``k_dots`` there), so it is held against
  float64 at the same 1e-2, not against the bf16 plain version. What the
  TPU's default-precision dot computes is spelled out in JAX instead
  (``jnp.dot`` of bf16 operands with ``preferred_element_type=float32``,
  block by block): the plain version agrees with it within 1e-6 of
  max|ref| and differs from the float32 dots by more than 1e-4.

Then the wrappers on CPU tensors: the plain route, launch counters that do
not move, and the shape errors. On the card (``gpu`` marker, skipped
here) K14 and K15 against their plain versions at the shapes of
``chip_smoke.py``'s diag phase.
"""

import functools
import importlib.util
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cfd_tpu_torch.ops import diag
from cfd_tpu_torch.parallel.compact import direction_tables
from cfd_tpu_torch.schemes import SCHEME4_PERIODIC

ROOT = Path(__file__).resolve().parent.parent
NZ, L, COLS = 256, 512, 128  # diag_dfdz.py's bodies fix nz = 256 (their N)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_bench_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jx():
    """The JAX scripts, loaded by path. Importing them points JAX's
    compilation cache into the repository (``JAX_COMPILATION_CACHE_DIR``
    and ``jax_compilation_cache_dir``); both are put back at once. Imported
    here, not at the top, so that the card's tests run where JAX is not
    installed (``--noconftest``)."""
    jax = pytest.importorskip("jax")
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache = jax.config.jax_compilation_cache_dir
    try:
        mods = {name: _load(name) for name in ("diag_lane", "diag_dfdz")}
    finally:
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
        jax.config.update("jax_compilation_cache_dir", cache)
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from cfd_tpu.ops.pallas_lane import _lane_tables
    from cfd_tpu.parallel.compact import direction_tables as jax_direction_tables
    from cfd_tpu.schemes import SCHEME4_PERIODIC as JAX_SCHEME

    return types.SimpleNamespace(jnp=jnp, pl=pl, lane=mods["diag_lane"], dfdz=mods["diag_dfdz"],
                                 lane_tables=_lane_tables, scheme=JAX_SCHEME,
                                 direction_tables=jax_direction_tables)


@pytest.fixture
def interpret(jx, monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode, for this test only."""
    monkeypatch.setattr(jx.pl, "pallas_call", functools.partial(jx.pl.pallas_call,
                                                                interpret=True))
    return jx


def _field(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape,rows,cols", [((256, 512), 64, 128), ((64, 256), 64, 256)])
def test_copy2d_ref_matches_pallas_interpret(interpret, shape, rows, cols):
    x = _field(shape)
    want = np.asarray(interpret.lane.copy2d(interpret.jnp.asarray(x), rows, cols))
    got = diag.copy2d_ref(torch.from_numpy(x), rows, cols).numpy()
    assert np.array_equal(want, x) and np.array_equal(got, want)


@pytest.mark.parametrize("bz,by", [(16, 8), (4, 16)])
def test_copy3d_ref_matches_pallas_interpret(interpret, bz, by):
    x = _field((16, 16, 128))
    want = np.asarray(interpret.lane.copy3d(interpret.jnp.asarray(x), bz, by))
    got = diag.copy3d_ref(torch.from_numpy(x), bz, by).numpy()
    assert np.array_equal(want, x) and np.array_equal(got, want)


def _body(jx, name, x, tables=()):
    return np.asarray(jx.dfdz._pallas2d(getattr(jx.dfdz, name), jx.jnp.asarray(x), COLS,
                                        tables=tables))


def _jax_table(jx):
    Tm = jx.lane_tables(jx.scheme, NZ)[0]
    return np.ascontiguousarray(np.transpose(Tm, (0, 2, 1)))


def test_dfdz_copy_ref_matches_pallas_interpret(interpret):
    x = _field((NZ, L))
    want = _body(interpret, "k_copy", x)
    got = diag.dfdz_stage_ref(torch.from_numpy(x), "copy", COLS).numpy()
    assert np.array_equal(want, x) and np.array_equal(got, want)


def test_dfdz_rolls_ref_matches_pallas_interpret(interpret):
    x = _field((NZ, L), seed=1) * 3.0 - 1.0
    want = _body(interpret, "k_rolls", x)
    got = diag.dfdz_stage_ref(torch.from_numpy(x), "rolls", COLS).numpy()
    ulp = np.spacing(np.float32(np.abs(x).max()))
    assert np.abs(got.astype(np.float64) - want).max() <= ulp


def test_dfdz_tables_equal_cfd_tpu(jx):
    """Gate 1: the blocks T the dots stages multiply by."""
    ours = direction_tables(SCHEME4_PERIODIC, NZ, NZ // diag.BLOCK).tinv
    theirs = np.asarray(jx.direction_tables(jx.scheme, NZ, NZ // diag.BLOCK).tinv)
    assert ours.dtype == np.float64 and np.array_equal(ours, theirs)
    assert np.array_equal(ours.astype(np.float32), _jax_table(jx))
    assert np.array_equal(diag.dfdz_table(NZ, "cpu").numpy(), _jax_table(jx))


def test_dfdz_dots_ref_matches_pallas_interpret(interpret):
    x = _field((NZ, L), seed=2) - 0.5
    T = _jax_table(interpret)
    want = _body(interpret, "k_dots", x, (interpret.jnp.asarray(T),))
    got = diag.dfdz_stage_ref(torch.from_numpy(x), "dots", COLS).numpy()
    assert _rel(got, want) <= 1e-6


def test_dfdz_dots_default_against_float64(interpret):
    x = _field((NZ, L), seed=3) - 0.5
    T = _jax_table(interpret)
    exact = diag.dfdz_stage_ref(torch.from_numpy(x).double(), "dots", COLS,
                                torch.from_numpy(T).double()).numpy()
    got = diag.dfdz_stage_ref(torch.from_numpy(x), "dots_default", COLS).numpy()
    assert _rel(got, exact) <= 1e-2
    # the JAX body's default-precision dot runs in full float32 on the CPU
    want = _body(interpret, "k_dots_default", x, (interpret.jnp.asarray(T),))
    assert _rel(want, exact) <= 1e-2


def test_dfdz_dots_default_ref_matches_bf16_dot(jx):
    """What the TPU's default-precision dot computes, spelled out in JAX:
    each block's product with bf16 operands and float32 accumulation. The
    plain version agrees within 1e-6 of max|ref| (the products of bf16
    operands are exact in float32; only the order of the sums differs),
    and it differs from the float32 dots by more than 1e-4, so the
    operand rounding is there."""
    jnp = jx.jnp
    x = _field((NZ, L), seed=6) - 0.5
    T = _jax_table(jx)
    want = np.concatenate([
        np.asarray(jnp.dot(jnp.asarray(T[b]).astype(jnp.bfloat16),
                           jnp.asarray(x[b * diag.BLOCK:(b + 1) * diag.BLOCK]).astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32))
        for b in range(NZ // diag.BLOCK)])
    got = diag.dfdz_stage_ref(torch.from_numpy(x), "dots_default", COLS).numpy()
    assert got.dtype == np.float32 and _rel(got, want) <= 1e-6
    dots = diag.dfdz_stage_ref(torch.from_numpy(x), "dots", COLS).numpy()
    assert _rel(got, dots) > 1e-4


# K15's dots on the tensor cores, emulated in numpy: tf32 by rounding the
# float32 mantissa to 10 bits (cvt.rna: to nearest, ties away from zero),
# bf16 to 7 bits (to nearest even); products of the rounded operands are
# exact in float32, and the float32 sums run a k-step of the mma at a time.


def _tf32(x):
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _bf16(x):
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _mma_blocks(x, terms, ksteps):
    """out[128 b:] = the float32 sum, a k-step of ``ksteps`` at a time, of
    the products ``terms(T[b], x_b)`` lists for each block b."""
    T = diag.dfdz_table(x.shape[0], "cpu").numpy()
    out = np.empty_like(x)
    for b in range(x.shape[0] // diag.BLOCK):
        xb = x[b * diag.BLOCK:(b + 1) * diag.BLOCK]
        acc = np.zeros_like(xb)
        for k0 in range(0, diag.BLOCK, ksteps):
            s = slice(k0, k0 + ksteps)
            for a, f in terms(T[b], xb):
                acc += a[:, s] @ f[s]
        out[b * diag.BLOCK:(b + 1) * diag.BLOCK] = acc
    return out


def test_dots_3xtf32_split_within_gate():
    """dots' 3xTF32 split (x = hi + lo, each a tf32, summed as hi lo + lo hi
    + hi hi) on the diag_dfdz table at nz = 256 stays within 3e-6 of
    max|ref| against float64; plain TF32 (hi hi alone) does not."""
    x = np.random.default_rng(7).standard_normal((NZ, 384)).astype(np.float32)
    exact = diag.dfdz_stage_ref(torch.from_numpy(x).double(), "dots", COLS,
                                diag.dfdz_table(NZ, "cpu").double()).numpy()

    def split(a):
        hi = _tf32(a)
        return hi, _tf32(a - hi)

    def three(T, f):
        (th, tl), (fh, fl) = split(T), split(f)
        return [(th, fl), (tl, fh), (th, fh)]

    assert _rel(_mma_blocks(x, three, 8), exact) <= 3e-6
    plain = _mma_blocks(x, lambda T, f: [(_tf32(T), _tf32(f))], 8)
    assert _rel(plain, exact) > 1e-4


def test_dots_default_bf16_mma_equals_plain():
    """dots_default's bf16 operands with float32 sums, a k16 step at a
    time, equal the plain version within 1e-6 of max|ref|."""
    x = np.random.default_rng(8).standard_normal((NZ, 384)).astype(np.float32)
    got = _mma_blocks(x, lambda T, f: [(_bf16(T), _bf16(f))], 16)
    want = diag.dfdz_stage_ref(torch.from_numpy(x), "dots_default", COLS).numpy()
    assert _rel(got, want) <= 1e-6


def test_wrappers_on_cpu_take_the_plain_version():
    x = torch.from_numpy(_field((NZ, L), seed=4))
    before = (dict(diag.COPY_LAUNCHES), dict(diag.DFDZ_LAUNCHES))
    assert torch.equal(diag.copy2d(x, 32, 128), x)
    assert torch.equal(diag.copy3d(x.view(16, 16, L), 4, 8), x.view(16, 16, L))
    for mode in diag.MODES:
        assert torch.equal(diag.dfdz_stage(x, mode, COLS), diag.dfdz_stage_ref(x, mode, COLS))
    assert (diag.COPY_LAUNCHES, diag.DFDZ_LAUNCHES) == before


@pytest.mark.parametrize("call,match", [
    (lambda x: diag.copy2d(x, 3, 128), "do not divide"),
    (lambda x: diag.copy2d(x, 32, 100), "do not divide"),
    (lambda x: diag.copy2d(x.view(16, 16, L), 4, 4), r"\(B, n\)"),
    (lambda x: diag.copy3d(x.view(16, 16, L), 3, 8), "do not divide"),
    (lambda x: diag.copy3d(x, 4, 8), r"\(nz, ny, nx\)"),
    (lambda x: diag.dfdz_stage(x, "fold", COLS), "unknown mode"),
    (lambda x: diag.dfdz_stage(x, "copy", 100), "do not divide"),
    (lambda x: diag.dfdz_stage(x[:200], "dots", COLS), "nz % 128"),
    (lambda x: diag.dfdz_stage(x, "dots", COLS, torch.zeros(1, 128, 128)), "table shape"),
    (lambda x: diag.dfdz_stage(x.view(16, 16, L), "copy", COLS), r"\(nz, L\)"),
])
def test_wrapper_shape_errors(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.from_numpy(_field((NZ, L), seed=5)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,rows,cols", [((65536, 256), 1024, 256), ((256, 65536), 256, 8192),
                                             ((32768, 512), 512, 512), ((100, 60), 10, 3)])
def test_copy2d_kernel_is_bitwise(cuda, shape, rows, cols):
    x = torch.randn(shape, device=cuda)
    before = diag.COPY_LAUNCHES["2d"]
    assert torch.equal(diag.copy2d(x, rows, cols), x)
    assert diag.COPY_LAUNCHES["2d"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("bz,by", [(256, 8), (256, 32), (8, 256)])
def test_copy3d_kernel_is_bitwise(cuda, bz, by):
    x = torch.randn((256, 256, 256), device=cuda)
    before = diag.COPY_LAUNCHES["3d"]
    assert torch.equal(diag.copy3d(x, bz, by), x)
    assert diag.COPY_LAUNCHES["3d"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1024, 2048])
@pytest.mark.parametrize("nz,L", [(256, 65536), (384, 4096)])
def test_dfdz_kernel_matches_plain(cuda, nz, L, C):
    x = torch.randn((nz, L), device=cuda)
    T = diag.dfdz_table(nz, cuda)
    for mode in ("copy", "rolls"):
        assert torch.equal(diag.dfdz_stage(x, mode, C), diag.dfdz_stage_ref(x, mode, C))
    exact = diag.dfdz_stage_ref(x.double(), "dots", C, T.double())
    rel = lambda got, ref: ((got.double() - ref.double()).abs().max() / ref.abs().max()).item()
    assert rel(diag.dfdz_stage(x, "dots", C), exact) <= 3e-6
    got = diag.dfdz_stage(x, "dots_default", C)
    assert rel(got, diag.dfdz_stage_ref(x, "dots_default", C)) <= 1e-5
    assert rel(got, exact) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 1024])
@pytest.mark.parametrize("nz,L", [(128, 1024), (256, 8192), (512, 3072)])
def test_dfdz_tensor_core_dots_match_plain(cuda, nz, L, C):
    """The dots stages on the tensor cores (bf16 mma for dots_default, a
    3xTF32 split for dots) on sub-tile counts that the grid does not
    divide: dots within 3e-6 of max|ref| of float64, dots_default within
    1e-5 of its bf16-operand plain version and apart from float32 dots."""
    x = torch.randn((nz, L), device=cuda)
    T = diag.dfdz_table(nz, cuda)
    exact = diag.dfdz_stage_ref(x.double(), "dots", C, T.double())
    rel = lambda got, ref: ((got.double() - ref.double()).abs().max() / ref.abs().max()).item()
    dots = diag.dfdz_stage(x, "dots", C)
    assert rel(dots, exact) <= 3e-6
    got = diag.dfdz_stage(x, "dots_default", C)
    assert rel(got, diag.dfdz_stage_ref(x, "dots_default", C)) <= 1e-5
    assert rel(got, dots) > 1e-4


@pytest.mark.gpu
def test_dfdz_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn((256, 4096), device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        diag.dfdz_stage(x, "copy", 32)
    with pytest.raises(TypeError, match="float32"):
        diag.dfdz_stage(x.double(), "copy", 1024)
    with pytest.raises(ValueError, match="aligned"):
        diag.dfdz_stage(torch.randn(256 * 4096 + 1, device=cuda)[1:].view(256, 4096), "copy",
                        1024)
