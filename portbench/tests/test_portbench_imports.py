"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Modules are compared by their
whole top-level name, so ``cfd_tpu_torch`` is not ``cfd_tpu``."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench import harness

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(folder: Path):
    return [p for p in folder.rglob("*.py") if "tests" not in p.relative_to(PB).parts]


def test_no_source_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(PB)): sorted(set(_imports(p)) & set(harness.BANNED))
             for p in _sources(PB)}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources(PB / "reference"):
        assert "cfd_tpu_torch" not in set(_imports(p)), p


def test_banned_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cfd_tpu_torch_like", sys)
    assert "cfd_tpu_torch_like" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "cfd_tpu.ops", sys)
    assert harness.banned_modules() == ["cfd_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    # a whole CPU run of a tiny cell in a fresh process, then its modules
    code = (
        "import sys, time; from pathlib import Path\n"
        "from portbench.tests.tiny import tiny_root\n"
        "from portbench import harness\n"
        f"root = tiny_root(Path({str(tmp_path)!r}))\n"
        "res, _ = harness.run_cell(root, harness.load_bench(root), 'tiny-dfdx.grad', 7, 0.2,"
        " False, 'cpu', time.perf_counter())\n"
        "assert res['correct'], res\n"
        "print(harness.banned_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "dfdx-512.x",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
