"""27-device (3x3x3) mesh parity — the reference's largest test config.

The reference's Makefiles run its distributed tests under mpiexec with 8, 3
and 27 ranks (code/cuda/test/Makefile, lanl-implementation/python/
test_npts.py:13-54 — 27 ranks vs scipy solve_banded). The conftest mesh is
8 virtual devices, so this test spawns a subprocess with 27 virtual CPU
devices and checks the distributed solver — both the substructuring method
and the npts-parity phi/psi method — against the float64 oracle on a
3x3x3 mesh.
"""

import os
import subprocess
import sys
import textwrap

import pytest

_SCRIPT = textwrap.dedent(
    """
    import os, sys, math
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    sys.path.insert(0, os.environ["CFD_REPO"])
    import cfd_tpu
    from cfd_tpu.parallel import Grid, make_mesh
    from cfd_tpu.oracle import derivative_np

    assert jax.device_count() == 27, jax.device_count()
    n = 54
    dx = 2 * math.pi / n
    rng = np.random.default_rng(7)
    f = rng.standard_normal((n, n, n))
    mesh = make_mesh((3, 3, 3))

    for order, periodic, method in [
        (4, False, "auto"),
        (4, True, "auto"),
        (6, True, "auto"),
        (4, False, "phipsi"),   # the npts.c algorithm, 27-rank parity
    ]:
        scheme = cfd_tpu.get_scheme(order, periodic)
        grid = Grid(mesh, (n, n, n), (dx, dx, dx), scheme)
        solver = cfd_tpu.DistributedCompactSolver(grid, method=method)
        fd = grid.distribute(jnp.asarray(f))
        for fn, ax in [(solver.dfdx, 2), (solver.dfdy, 1), (solver.dfdz, 0)]:
            got = np.asarray(grid.gather(fn(fd)))
            ex = derivative_np(scheme, f, dx, axis=ax)
            err = np.abs(got - ex).max() / np.abs(ex).max()
            assert err < 1e-9, (scheme.name, method, ax, err)
        print(f"{scheme.name} method={method}: OK", flush=True)
    print("MESH27 PASS")
    """
)


def test_27_device_mesh():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=27"
    env["CFD_REPO"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        env=env,
        capture_output=True,
        text=True,
        timeout=540,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MESH27 PASS" in out.stdout
