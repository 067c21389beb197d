"""The sub-block Thomas chains of K11 and K12 (``csrc/dist_common.cuh``),
held on the CPU.

A CUDA kernel cannot run here, so its algorithm is held in three ways, over
the six schemes ``chip_smoke.py`` runs the dist kernels with (SCHEME4,
SCHEME4_D2 and the sixth-order filter at alpha = 0.45, each with and
without period), a first, an interior and a last shard of a line over
three shards, and shard lines of nl in {40, 64, 96, 128, 200, 256}: one,
two, two, four, four and eight sub-blocks (``pick_nb``; 40 and 200 are no
multiple of 32):

* gate 1: the port's ``local_block_tables`` equals
  ``cfd_tpu.parallel.dist_tables.local_block_tables`` at 1e-12, and
  ``pick_nb`` the JAX rule;
* a float64 numpy transcription of the kernels' arithmetic (``_chains``:
  the RHS rows as ``ChainRhs`` forms them, closure rows from f on the end
  shards, the sub-block forward sweeps with their ``t0`` faces, the dot of
  two ``rinv`` rows with the line's faces, the backward sweeps with the
  rank-2 intra update and the shard update ``a suh + b slh``), reading the
  very table ``ops/dist._chain_table`` builds for the kernels, equals the
  plain version ``lane_dist_derivative_ref`` at 1e-12 of max|ref|;
* the same transcription in float32 stays within the gates the JAX dist
  kernels meet against float64 (``tests/test_dist_kernels.py``): 2e-6
  first derivatives and periodic second derivatives, 2e-5 second
  derivatives with closures, 5e-6 periodic filters, 1e-4 filters with
  closures. Run this file as a script for each scheme's budget.

Inputs are made by numpy from a seed: random lines, halos random toward a
neighbour and the closure ghost rows on a physical end (as the distributed
solve feeds them), random interface weights.
"""

import importlib

import numpy as np
import pytest
import torch

import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import _native, dist
from cfd_tpu_torch.ops.rhs import closure_ghosts
from cfd_tpu_torch.parallel import dist_tables as tdt

GATES = {
    "SCHEME4": 2e-6, "SCHEME4_PERIODIC": 2e-6, "SCHEME4_D2": 2e-5,
    "SCHEME4_D2_PERIODIC": 2e-6, "filter6": 1e-4, "filter6_periodic": 5e-6,
}
NAMES = list(GATES)
P = 3
SHARDS = {"first": 0, "interior": 1, "last": 2}
NLS = [40, 64, 96, 128, 200, 256]
DX = 0.05
LINES = 4
# the table's columns (csrc/dist_common.cuh DIST_TAB_*)
INVD, DU, UH, LH, SUH, SLH, W, T0 = range(8)


def _scheme(name):
    if name.startswith("filter6"):
        return tsch.get_filter(6, 0.45, periodic=name.endswith("periodic"))
    return getattr(tsch, name)


def _block(name, shard, nl):
    ts = _scheme(name)
    return tdt.shard_blocks(ts, P * nl, P)[SHARDS[shard]]


def _inputs(scheme, r, nl, seed):
    """float32 (f, hl, hr, ab) of LINES lines of shard r."""
    rng = np.random.default_rng(seed)
    w = scheme.stencil_width
    f = rng.standard_normal((LINES, nl)).astype(np.float32)
    hl = rng.standard_normal((LINES, w)).astype(np.float32)
    hr = rng.standard_normal((LINES, w)).astype(np.float32)
    ab = rng.standard_normal((LINES, 2)).astype(np.float32)
    if not scheme.periodic:
        gl, gr = closure_ghosts(torch.from_numpy(f).double().T, scheme)
        if r == 0:
            hl = gl.T.float().numpy()
        if r == P - 1:
            hr = gr.T.float().numpy()
    return f, hl, hr, ab


def _rhs(ext, block, c, dtype):
    """The scaled RHS rows as ``ChainRhs`` forms them, lines (L, nl) of
    ``ext`` = [hl | f | hr]."""
    scheme, nl, w = block.scheme, block.nl, block.scheme.stencil_width
    cast = np.dtype(dtype).type
    scale = cast((1.0 / DX) ** scheme.derivative_order)
    cw = [cast(v) for v in c["w"]]
    sign, center = cast(c["sign"]), cast(c["center"])
    left, lsum = c["left"].astype(dtype), c["left_sum"].astype(dtype)
    right, rsum = c["right"].astype(dtype), c["right_sum"].astype(dtype)
    at_f = lambda m: ext[:, m + w]
    rhs = np.empty((ext.shape[0], nl), dtype)
    for g in range(nl):
        fi = at_f(g)
        wall_l = block.first and g < c["n_rows"]
        wall_r = block.last and g >= nl - c["n_rows"]
        if wall_l or wall_r:
            if wall_l:
                wt, at, s0 = left[g], at_f, lsum[g]
            else:
                j = nl - 1 - g
                wt, at, s0 = right[j], (lambda m: at_f(nl - 1 - m)), rsum[j]
            if c["diff2"]:
                r = np.zeros_like(fi)
                for m in range(c["n_taps"]):
                    mid = at(m + 1)
                    r = r + wt[m] * ((at(m) - mid) + (at(m + 2) - mid))
            else:
                r = s0 * fi
                for m in range(c["n_taps"]):
                    r = r + wt[m] * (at(m) - fi)
            rhs[:, g] = scale * r
        else:
            r = center * fi
            for k in range(1, c["K"] + 1):
                r = r + cw[k - 1] * ((at_f(g + k) - fi) + sign * (at_f(g - k) - fi))
            rhs[:, g] = r * scale
    return rhs


def _chains(f, hl, hr, ab, block, dtype):
    """numpy transcription of K11/K12's arithmetic on lines (L, nl), in
    ``dtype``: ``solve_chain`` for every sub-block of every line."""
    nl = block.nl
    c, _ = _native.kernel_tables(block.scheme, nl)
    tab, nb = dist._chain_table(block)
    tab = tab.astype(dtype)
    padded = tab[: 8 * (nl + 2)].reshape(nl + 2, 8)
    assert not padded[0].any() and not padded[-1].any()
    rows = padded[1:-1]
    rinv = tab[8 * (nl + 2) :].reshape(2 * nb, 2 * nb)
    ext = np.concatenate([hl, f, hr], axis=1).astype(dtype)
    r = _rhs(ext, block, c, dtype)
    a, b = ab[:, 0].astype(dtype), ab[:, 1].astype(dtype)
    bz = nl // nb
    zs = np.empty_like(r)
    faces = np.empty((f.shape[0], 2 * nb), dtype)
    for k in range(nb):  # forward sweeps and faces
        z = np.zeros(f.shape[0], dtype)
        ff = np.zeros(f.shape[0], dtype)
        for g in range(k * bz, (k + 1) * bz):
            z = r[:, g] - rows[g, W] * z
            ff = ff + rows[g, T0] * r[:, g]
            zs[:, g] = z
        faces[:, 2 * k] = -ff
        faces[:, 2 * k + 1] = -(z * rows[(k + 1) * bz - 1, INVD])
    out = np.empty_like(r)
    for k in range(nb):  # the reduced dots and the backward sweeps
        alpha = np.zeros(f.shape[0], dtype)
        beta = np.zeros(f.shape[0], dtype)
        for j in range(2 * nb):
            alpha = alpha + rinv[2 * k, j] * faces[:, j]
            beta = beta + rinv[2 * k + 1, j] * faces[:, j]
        e = (k + 1) * bz - 1
        x = zs[:, e] * rows[e, INVD]
        for g in range(e, k * bz - 1, -1):
            if g < e:
                x = (zs[:, g] - rows[g, DU] * x) * rows[g, INVD]
            v = x + alpha * rows[g, UH] + beta * rows[g, LH]
            out[:, g] = v + (a * rows[g, SUH] + b * rows[g, SLH])
    return out


def _plain(f, hl, hr, ab, block):
    t = lambda x: torch.from_numpy(x).double()
    return dist.lane_dist_derivative_ref(t(f), t(hl), t(hr), t(ab), DX, block).numpy()


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _case(name, shard, nl):
    block = _block(name, shard, nl)
    f, hl, hr, ab = _inputs(block.scheme, SHARDS[shard], nl, seed=100 * nl + SHARDS[shard])
    return block, (f, hl, hr, ab), _plain(f, hl, hr, ab, block)


CASES = [(name, shard, nl) for name in NAMES for shard in SHARDS for nl in NLS]
IDS = [f"{name}-{shard}-{nl}" for name, shard, nl in CASES]


@pytest.fixture(scope="module")
def jdt():
    """The JAX package's dist tables (imported here, not at the top)."""
    pytest.importorskip("jax")
    return importlib.import_module("cfd_tpu.parallel.dist_tables")


def test_pick_nb_is_the_jax_rule(jdt):
    jlead = importlib.import_module("cfd_tpu.ops.pallas_leading")
    for nl in range(1, 1100):
        assert tdt.pick_nb(nl) == jdt.pick_nb(nl) == jlead._pick_nb(nl)
    assert [tdt.pick_nb(nl) for nl in NLS] == [1, 2, 2, 4, 4, 8]


@pytest.mark.parametrize("name,shard,nl", CASES, ids=IDS)
def test_local_block_tables_equal_cfd_tpu(jdt, name, shard, nl):
    block = _block(name, shard, nl)
    jsch = importlib.import_module("cfd_tpu.schemes")
    js = (jsch.get_filter(6, 0.45, periodic=name.endswith("periodic"))
          if name.startswith("filter6") else getattr(jsch, name))
    nb = tdt.pick_nb(nl)
    got = tdt.local_block_tables(block.scheme, nl, block.first, block.last, nb)
    want = jdt.local_block_tables(js, nl, block.first, block.last, nb)[:7]
    for field, g, w in zip(got._fields, got, want):
        assert g.shape == np.shape(w), field
        assert np.abs(g - w).max() <= 1e-12 * max(np.abs(w).max(), 1.0), field


@pytest.mark.parametrize("name,shard,nl", CASES, ids=IDS)
def test_chains_float64_equal_plain(name, shard, nl):
    block, inputs, ref = _case(name, shard, nl)
    assert _rel(_chains(*inputs, block, np.float64), ref) <= 1e-12


@pytest.mark.parametrize("name,shard,nl", CASES, ids=IDS)
def test_chains_float32_within_dist_gate(name, shard, nl):
    block, inputs, ref = _case(name, shard, nl)
    assert _rel(_chains(*inputs, block, np.float32), ref) <= GATES[name]


if __name__ == "__main__":
    # each scheme's float32 budget: the worst case over shards and nl
    for name in NAMES:
        worst = max(
            (_rel(_chains(*inp, blk, np.float32), ref), shard, nl)
            for shard in SHARDS for nl in NLS
            for blk, inp, ref in [_case(name, shard, nl)]
        )
        print(f"{name}: float32 chains {worst[0]:.3e} of max|ref| (worst: {worst[1]} shard, "
              f"nl = {worst[2]}), gate {GATES[name]:.0e}")
