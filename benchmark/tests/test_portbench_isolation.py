"""Nothing the benchmark runs loads JAX or the JAX package, judged by whole
top-level module names (elbencho_tpu_torch begins with elbencho_tpu)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import isolation, spec


def test_whole_top_level_names():
    assert isolation.forbidden_modules(
        ["elbencho_tpu_torch", "elbencho_tpu_torch.cuda.native",
         "jaxtyping", "flaxen", "numpy"]) == []
    assert isolation.forbidden_modules(
        ["elbencho_tpu.tpu.native", "jax._src.core", "jaxlib", "flax",
         "numpy"]) == ["elbencho_tpu", "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    for base, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                bad = isolation.forbidden_modules(list(_imports(path)))
                assert bad == [], (path, bad)


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "peaks.py"):
        mods = list(_imports(os.path.join(spec.HERE, name)))
        assert not [m for m in mods if m.split(".")[0].startswith(
            "elbencho")], (name, mods)


def test_a_run_loads_nothing_forbidden(small_root, mock_env):
    """A whole run in a fresh process, then the module table."""
    code = (
        "import sys\n"
        "from benchmark import spec, run, isolation\n"
        f"cell = spec.load_cell('unet3d-1gpu.stream', {str(small_root)!r})\n"
        f"out = run.run_cell(cell, 5, 0.2, True, root={str(small_root)!r},"
        " log=open(__import__('os').devnull, 'w'))\n"
        "assert out['correct'], out['checks']\n"
        "print(isolation.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
