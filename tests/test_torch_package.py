"""Package boundaries of the port: no jax, no build at import, no fallback.

* ``import cfd_tpu_torch`` (in a fresh process) loads no ``jax``;
* importing ``ops._native`` needs no ``nvcc``: the kernels build at first
  use, and a build where no toolkit exists raises;
* ``"auto"`` on a CPU tensor resolves to the plain path; on any other
  device to the kernels, whose wrappers raise for a device that has no
  kernel and for a CUDA float64 tensor (card only).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.ops import _native, lane, strided
from cfd_tpu_torch.ops.derivatives import resolve_method

ROOT = Path(__file__).resolve().parent.parent


def _python(code, **env):
    run_env = {**os.environ, "PYTHONPATH": str(ROOT), **env}
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=run_env,
        cwd=ROOT, timeout=120,
    )


def test_import_loads_no_jax():
    done = _python(
        "import sys, cfd_tpu_torch, cfd_tpu_torch.models, cfd_tpu_torch.oracle\n"
        "import cfd_tpu_torch.utils, cfd_tpu_torch.ops._native\n"
        "import cfd_tpu_torch.ops.adv_lap, cfd_tpu_torch.ops.megastep, cfd_tpu_torch.ops.fused_step\n"
        "import cfd_tpu_torch.ops.vec, cfd_tpu_torch.ops.pair, cfd_tpu_torch.ops.poisson\n"
        "import cfd_tpu_torch.ops.spectra, cfd_tpu_torch.ops.dist, cfd_tpu_torch.ops.rhs\n"
        "import cfd_tpu_torch.parallel, cfd_tpu_torch.parallel.fused, cfd_tpu_torch.parallel.phipsi\n"
        "import cfd_tpu_torch.oracle.lanl, cfd_tpu_torch.config, cfd_tpu_torch.ops.diag\n"
        "import cfd_tpu_torch.utils.profiling, cfd_tpu_torch.benchmarks\n"
        "import cfd_tpu_torch.benchmarks.diag_lane, cfd_tpu_torch.benchmarks.diag_dfdz\n"
        "import cfd_tpu_torch.benchmarks.run_single, cfd_tpu_torch.benchmarks.run_distributed\n"
        "import cfd_tpu_torch.benchmarks.diag_axes, cfd_tpu_torch.benchmarks.diag_rk3\n"
        "import cfd_tpu_torch.benchmarks.diag_ns\n"
        "import cfd_tpu_torch.models.burgers, cfd_tpu_torch.models.navier_stokes\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cfd_tpu.'))))"
    )
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_chip_smoke_imports_no_jax():
    """The card's smoke script imports the port and nothing of JAX: its
    module-level imports load, and no line of it names jax or cfd_tpu."""
    done = _python(
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cfd_tpu.'))))"
    )
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"
    for line in (ROOT / "chip_smoke.py").read_text().splitlines():
        words = line.replace(".", " ").split()
        if words[:1] in (["import"], ["from"]):
            assert "jax" not in words and "cfd_tpu" not in words, line


# the port's measurement scripts at the root of the repository
PORT_SCRIPTS = ("chip_smoke.py", "lane_times.py", "dist_kernel_times.py")


def test_no_module_of_the_port_imports_jax_or_cfd_tpu():
    """No line of any module of the port, or of its measurement scripts,
    imports jax or the JAX package, not even inside a function (the import
    test above sees only what an import loads)."""
    paths = [*(ROOT / "cfd_tpu_torch").rglob("*.py"), *(ROOT / p for p in PORT_SCRIPTS)]
    for path in sorted(paths):
        for line in path.read_text().splitlines():
            words = line.replace(".", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert "jax" not in words and "cfd_tpu" not in words, f"{path}: {line}"


def test_native_import_needs_no_nvcc():
    done = _python(
        "import cfd_tpu_torch.ops._native as n; print(n.SOURCES)",
        PATH="", CUDA_HOME=str(ROOT / "no-such-toolkit"),
    )
    assert done.returncode == 0, done.stderr
    assert "compact_lane.cu" in done.stdout


def test_build_without_toolkit_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _native.build()
    assert list(tmp_path.iterdir()) == []


def test_sources_are_present():
    kernels = {"compact_lane.cu", "compact_strided.cu", "adv_lap.cu", "rk3_mega.cu",
               "adv_lap3.cu", "div_rhs.cu", "pair.cu", "d2_sum.cu", "lap_rhs.cu",
               "curl_rhs.cu", "diag_copy.cu", "diag_dfdz.cu"}
    assert kernels <= set(_native.SOURCES)
    for name in _native.SOURCES + _native.HEADERS:
        assert (_native.CSRC / name).is_file()


def test_auto_on_cpu_is_plain():
    f = torch.zeros(8, 8, 16)
    assert resolve_method("auto", f) == "matmul"
    assert resolve_method("kernel", f) == "kernel"
    assert resolve_method("auto", f.to("meta")) == "kernel"


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        resolve_method("pcr", torch.zeros(4))
    with pytest.raises(ValueError, match="unknown method"):
        ct.dfdx(torch.zeros(4, 16), 0.1, method="pallas")


@pytest.mark.parametrize("method", ["auto", "kernel"])
@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_cpu_kernel_route_is_the_plain_version(method, axis):
    """On a CPU tensor every route returns the dense plain version, bit for bit."""
    g = torch.Generator().manual_seed(5)
    f = torch.randn((12, 10, 16), generator=g, dtype=torch.float64)
    got = ct.derivative(f, 0.3, ct.SCHEME6, axis=axis, method=method)
    ref = ct.derivative(f, 0.3, ct.SCHEME6, axis=axis, method="matmul")
    assert torch.equal(got, ref)


def test_no_kernel_device_raises():
    f = torch.zeros(8, 8, 16, device="meta")
    with pytest.raises(ValueError):
        ct.dfdx(f, 0.1)
    with pytest.raises(ValueError):
        ct.dfdz(f, 0.1)
    with pytest.raises(ValueError):
        lane.lane_derivative(f, 0.1, ct.SCHEME4)
    with pytest.raises(ValueError):
        strided.strided_derivative(f, 0.1, ct.SCHEME4, 0)
    with pytest.raises(ValueError):
        strided.strided_derivative(torch.zeros(8, 8), 0.1, ct.SCHEME4, -1)


def test_line_too_short_raises():
    with pytest.raises(ValueError, match="too small"):
        ct.dfdx(torch.zeros(4, 5), 0.1, ct.SCHEME6)


@pytest.mark.gpu
def test_auto_on_cuda_float64_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.zeros(8, 8, 16, dtype=torch.float64, device="cuda")
    assert resolve_method("auto", f) == "kernel"
    with pytest.raises(TypeError):
        ct.dfdz(f, 0.1)
    with pytest.raises(TypeError):
        ct.dfdx(f, 0.1)
    assert ct.dfdz(f, 0.1, method="matmul").dtype == torch.float64
