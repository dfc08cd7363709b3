"""The port stands alone: no module of elbencho_tpu_torch/ and not
chip_smoke.py imports jax or the original elbencho_tpu package, and no C++
or CUDA source of the port includes PJRT."""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "elbencho_tpu"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO,
                                                   "elbencho_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_files():
    files = _port_files()
    assert os.path.exists(files[0])
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_original_package_import(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


# modules later slices added (the native CUDA engine; distributed mode, the
# mesh tier and the graft entry; checkpoint restore), which must be among
# the scanned
NATIVE_MODULES = ("elbencho_tpu_torch/cuda/native.py",
                  "elbencho_tpu_torch/ops/fill_kernel.py",
                  "elbencho_tpu_torch/ops/kernel_build.py",
                  "elbencho_tpu_torch/ops/ingest_kernel.py",
                  "elbencho_tpu_torch/parallel/mesh.py",
                  "elbencho_tpu_torch/graft_entry.py",
                  "elbencho_tpu_torch/service.py",
                  "elbencho_tpu_torch/metrics.py",
                  "elbencho_tpu_torch/workers/remote.py",
                  "elbencho_tpu_torch/checkpoint.py")
# the kernel sources, which must be among the native sources scanned
KERNEL_SOURCES = ("verify.cu", "fill.cu", "ingest.cu", "mesh_reduce.cu")


def test_native_modules_are_scanned():
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    assert set(NATIVE_MODULES) <= scanned


def test_kernel_sources_are_scanned():
    assert {os.path.basename(p) for p in _native_sources()} >= \
        set(KERNEL_SOURCES)


def _native_sources():
    d = os.path.join(REPO, "elbencho_tpu_torch", "csrc")
    return sorted(os.path.join(d, f) for f in os.listdir(d))


@pytest.mark.parametrize("path", _native_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_pjrt_include(path):
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]',
                          open(path).read(), re.M)
    bad = [i for i in includes if "pjrt" in i.lower()]
    assert not bad, f"{os.path.relpath(path, REPO)} includes {bad}"
