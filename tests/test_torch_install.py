"""The installed port (C10): an installed copy of elbencho_tpu_torch runs
where an installed original runs, from the files `make torch` put in its
_prebuilt/ directory, and never compiles.

- A copy of the package alone (no core/, no build/ beside it), with
  _prebuilt/ filled as `make torch` fills it (prebuild.populate, reusing
  the fresh build/torch_core files), runs a write + read from a
  directory outside the repository on the staged, direct and pjrt (prebuilt
  mock driver) backends, with the checkout's result fields, and creates no
  build/.
- Without _prebuilt/libebtcore.so the run fails with the error naming the
  path and `make torch`, not a traceback; a source that does not compile
  (in a copy) fails with the compiler's message; an install without the
  kernel library refuses a kernel call on a non-CPU tensor with its cause,
  and CPU tensors still take the plain version; a checkout never reads
  _prebuilt/.
- `make torch` reports the kernel library not built where nvcc is missing
  and removes a stale one; `make torch-deb` (in a copy) packages the port
  with _prebuilt/, no sanitizer build and no bytecode, and its extracted
  launcher runs from another directory; `make torch-rpm` renders a spec
  whose %install builds the same tree; pip installs _prebuilt/ as package
  data (in a copy: pip writes build/ and *.egg-info into its source).
- bin/elbencho-tpu-torch runs from any directory, through a symlink too.
"""

from __future__ import annotations

import csv
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from elbencho_tpu_torch import __version__, engine, prebuild
from elbencho_tpu_torch.cuda import native
from elbencho_tpu_torch.ops import fill_kernel as fk
from elbencho_tpu_torch.ops import ingest_kernel as ik
from elbencho_tpu_torch.ops import kernel_build
from elbencho_tpu_torch.ops import verify_kernel as vk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "elbencho_tpu_torch")
# result fields that do not depend on timing
FIELDS = ("operation", "entries last", "bytes last", "threads", "dirs",
          "files", "file size", "block size", "direct IO", "random",
          "IO depth", "TPU IDs", "TPU backend", "verify salt",
          "tpu xfer lat clock")
_IGNORE = shutil.ignore_patterns("__pycache__", "_prebuilt")


def _copy_package(root) -> str:
    """elbencho_tpu_torch/ alone under `root`; returns the copy's path."""
    dest = os.path.join(str(root), "elbencho_tpu_torch")
    shutil.copytree(PKG, dest, ignore=_IGNORE)
    return dest


@pytest.fixture(scope="module")
def installed(tmp_path_factory) -> str:
    """A staged install: the package copied, then _prebuilt/ filled by
    prebuild.populate (`make torch`) from this checkout's fresh builds. Returns the
    directory that holds the copy."""
    root = tmp_path_factory.mktemp("inst")
    pkg = _copy_package(root)
    prebuild.populate(os.path.join(pkg, "_prebuilt"))
    return str(root)


def _env(pythonpath: str, **extra) -> dict[str, str]:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("EBT_", "PYTHONPATH"))}
    env.update(PYTHONPATH=pythonpath, EBT_TORCH_DEVICE="cpu", **extra)
    return env


def _cli(cwd, env, *args, timeout=120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "elbencho_tpu_torch.cli",
                           *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=timeout)


def _rows(path: str) -> dict[str, dict[str, str]]:
    return {r["operation"]: r for r in csv.DictReader(open(path))}


@pytest.mark.parametrize("backend", ["staged", "direct", "pjrt"])
def test_installed_copy_runs_like_the_checkout(installed, tmp_path,
                                               backend):
    """The install's write + read, from outside the repository, gives the
    checkout's result fields and builds nothing beside the copy."""
    prebuilt = os.path.join(installed, "elbencho_tpu_torch", "_prebuilt")
    runs = {}
    for name, path, mock in (
            ("install", installed, os.path.join(prebuilt,
                                                "libebtcudamock.so")),
            ("checkout", REPO, engine.build_plain_mock())):
        extra = {"EBT_CUDA_DRIVER": mock} if backend == "pjrt" else {}
        csvp = tmp_path / f"{name}.csv"
        r = _cli(tmp_path, _env(path, **extra), "-w", "-r", "-t", "2", "-s",
                 "8M", "-b", "1M", "--gpuids", "0", "--verify", "42",
                 "--tpubackend", backend, "--csvfile", str(csvp), "--nolive",
                 str(tmp_path / f"{name}.bin"))
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        runs[name] = _rows(str(csvp))
    assert runs["install"].keys() == runs["checkout"].keys() == \
        {"WRITE", "READ"}
    for op, row in runs["install"].items():
        assert row.keys() == runs["checkout"][op].keys()
        assert {f: row[f] for f in FIELDS} == \
            {f: runs["checkout"][op][f] for f in FIELDS}
    assert runs["install"]["READ"]["TPU backend"] == backend
    assert sorted(os.listdir(installed)) == ["elbencho_tpu_torch"]
    assert not os.path.exists(
        os.path.join(installed, "elbencho_tpu_torch", "build"))


def test_install_without_its_engine_names_the_path(tmp_path):
    """Without _prebuilt/libebtcore.so the CLI exits 1 with the path and
    `make torch`, and prints no traceback."""
    pkg = _copy_package(tmp_path / "inst")
    prebuild.populate(os.path.join(pkg, "_prebuilt"))
    os.remove(os.path.join(pkg, "_prebuilt", "libebtcore.so"))
    r = _cli(tmp_path, _env(str(tmp_path / "inst")), "-w", "-r", "-t", "1",
             "-s", "1M", "-b", "1M", "--nolive", str(tmp_path / "f"))
    want = os.path.join(pkg, "_prebuilt", "libebtcore.so")
    assert r.returncode == 1
    assert f"{want}: no such file" in r.stderr
    assert "built by `make torch`" in r.stderr
    assert "Traceback" not in r.stderr + r.stdout
    assert not os.path.exists(tmp_path / "inst" / "build")


def test_a_failed_build_carries_the_compilers_message(tmp_path):
    """In a copy of the sources with a broken mock driver, the build raises
    NativeFileError with the command and g++'s own error line."""
    shutil.copytree(os.path.join(REPO, "core"), tmp_path / "core")
    pkg = _copy_package(tmp_path)
    src = os.path.join(pkg, "csrc", "cuda_mock.cpp")
    with open(src, "a") as f:
        f.write("\nint ebt_broken_on_purpose( {\n")
    code = ("from elbencho_tpu_torch import engine\n"
            "try:\n"
            "    engine.build_mock()\n"
            "except engine.NativeFileError as e:\n"
            "    print(e)\n"
            "    raise SystemExit(3)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=_env(str(tmp_path)), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 3, r.stdout + r.stderr
    assert f"building {tmp_path / 'build' / 'torch_core'}" in r.stdout
    assert "elbencho_tpu_torch/csrc/cuda_mock.cpp" in r.stdout
    assert re.search(r"cuda_mock\.cpp:\d+:\d+: error:", r.stdout), r.stdout
    assert "CalledProcessError" not in r.stdout + r.stderr


@pytest.fixture
def no_kernels_installed(tmp_path, monkeypatch):
    """This process seen as an install whose _prebuilt/ has no kernel
    library (every wrapper's binding forgotten)."""
    monkeypatch.setattr(engine, "in_checkout", lambda: False)
    monkeypatch.setattr(engine, "PREBUILT_DIR", str(tmp_path))
    for mod in (vk, fk, ik):
        monkeypatch.setattr(mod, "_lib", None)
    return os.path.join(str(tmp_path), kernel_build.LIB_NAME)


def _meta(n: int, dtype) -> torch.Tensor:
    """A tensor that is not on the CPU, without a card."""
    return torch.empty(n, dtype=dtype, device="meta")


class _Path:
    so_path = "/nonexistent/driver.so"


@pytest.mark.parametrize("call", [
    lambda: vk.verify_block_lanes(_meta(1024, torch.int32), 0, 42),
    lambda: vk.verify_block_u32(_meta(4096, torch.uint8), 0, 42),
    lambda: ik.ingest_verify_batch(_meta(2048, torch.int32).view(2, 1024),
                                   [0, 4096], 42),
    fk.load_lib,
    lambda: native.NativeCudaPath._kernel_lib(_Path()),
], ids=["verify_block_lanes", "verify_block_u32", "ingest_verify_batch",
        "fill_load_lib", "native_engine"])
def test_install_without_kernels_refuses_off_the_cpu(no_kernels_installed,
                                                     monkeypatch, call):
    """A kernel call on a tensor that is not on the CPU (and the native
    engine on the card) raises with the missing library's path and the
    cause; the plain version does not run in the kernel's place."""
    monkeypatch.setattr(native, "requested_device_type", lambda: "cuda")
    before = (dict(vk.LAUNCHES), dict(fk.LAUNCHES), dict(ik.LAUNCHES))
    with pytest.raises(engine.NativeFileError) as e:
        call()
    assert f"{no_kernels_installed}: no such file" in str(e.value)
    assert "`make torch`" in str(e.value) and "nvcc" in str(e.value)
    assert (vk.LAUNCHES, fk.LAUNCHES, ik.LAUNCHES) == before


def test_install_without_kernels_keeps_the_plain_version_on_the_cpu(
        no_kernels_installed):
    from elbencho_tpu_torch.ops import integrity

    words = integrity.expected_words(512, 4096 + 42)
    lanes = words.view(torch.int32).clone()
    assert vk.verify_block_lanes(lanes, 4096, 42) == 0
    lanes[7] ^= 1
    assert vk.verify_block_lanes(lanes, 4096, 42) == 1
    out = fk.fill_u64_(torch.empty(512, dtype=torch.int64), 4096 + 42)
    assert torch.equal(out, words)


def test_a_checkout_never_reads_prebuilt(tmp_path, monkeypatch):
    """Inside the checkout the build directory wins over a _prebuilt/
    file, even one that exists."""
    (tmp_path / "libebtcore.so").write_bytes(b"stale")
    monkeypatch.setattr(engine, "PREBUILT_DIR", str(tmp_path))
    assert engine.in_checkout()
    assert engine.native_file("libebtcore.so", engine.build_core) == \
        engine._LIB_PATH
    assert engine.build_mock() in (engine.MOCK_DRIVER_PATH,
                                   os.environ.get(engine.MOCK_LIB_ENV))


def test_make_torch_fills_prebuilt_and_skips_kernels_without_nvcc(
        tmp_path, monkeypatch, capsys):
    """`make torch` copies the engine, the mock and the probe; without nvcc
    it says the kernels were not built and leaves no stale kernel library
    behind; an override names no file it copies."""
    monkeypatch.setattr(kernel_build, "nvcc_found", lambda: False)
    monkeypatch.setenv(engine.CORE_LIB_ENV, "/nonexistent/libebtcore_tsan.so")
    (tmp_path / kernel_build.LIB_NAME).write_bytes(b"stale")
    assert prebuild.main(["--dest", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "kernels: not built (nvcc not found)" in out
    assert re.search(r"^make torch: [\d.]+ s$", out, re.M)
    assert sorted(os.listdir(tmp_path)) == ["cuda_probe", "libebtcore.so",
                                            "libebtcudamock.so"]
    for name, src in (("libebtcore.so", engine._LIB_PATH),
                      ("libebtcudamock.so", engine.MOCK_DRIVER_PATH),
                      ("cuda_probe", engine.PROBE_PATH)):
        assert open(tmp_path / name, "rb").read() == open(src, "rb").read()
    assert os.access(tmp_path / "cuda_probe", os.X_OK)


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> str:
    """A copy of what `make torch-deb` and pip read, with this checkout's
    fresh builds (and an instrumented engine where one exists) in its
    build/torch_core, so nothing is compiled again."""
    root = str(tmp_path_factory.mktemp("tree"))
    for d in ("core", "bin", "dist", "packaging", "elbencho_tpu"):
        shutil.copytree(os.path.join(REPO, d), os.path.join(root, d),
                        ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    _copy_package(root)
    for f in ("Makefile", "LICENSE", "CHANGELOG.md", "README.md",
              "pyproject.toml"):
        shutil.copy2(os.path.join(REPO, f), os.path.join(root, f))
    build = os.path.join(root, "build", "torch_core")
    os.makedirs(build)
    engine.build_core()
    engine.build_plain_mock()
    engine.build_checkout_probe()
    for src in (engine._LIB_PATH, engine.MOCK_DRIVER_PATH, engine.PROBE_PATH,
                engine.TSAN_LIB_PATH):
        if os.path.exists(src):
            shutil.copy2(src, build)
    return root


def _make(tree, *targets, **env) -> subprocess.CompletedProcess:
    return subprocess.run(["make", "-s", *targets], cwd=tree,
                          env={**_env(""), **env}, capture_output=True,
                          text=True, timeout=240)


def test_torch_deb_packages_the_port(tree, tmp_path):
    if shutil.which("dpkg-deb") is None:
        pytest.skip("dpkg-deb is not installed")
    tsan = os.path.join(tree, "build", "torch_core", "libebtcore_tsan.so")
    r = _make(tree, "torch-deb", **({engine.CORE_LIB_ENV: tsan}
                                    if os.path.exists(tsan) else {}))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "kernels: not built (nvcc not found)" in r.stdout
    arch = subprocess.run(["dpkg", "--print-architecture"],
                          capture_output=True, text=True).stdout.strip()
    deb = os.path.join(tree, "build",
                       f"elbencho-tpu-torch_{__version__}_{arch}.deb")
    listing = subprocess.run(["dpkg-deb", "-c", deb], capture_output=True,
                             text=True, check=True).stdout
    names = {ln.split()[-1] for ln in listing.splitlines()}
    lib = "./usr/lib/elbencho-tpu-torch/elbencho_tpu_torch"
    for want in (f"{lib}/cli.py", f"{lib}/_prebuilt/libebtcore.so",
                 f"{lib}/_prebuilt/libebtcudamock.so",
                 f"{lib}/_prebuilt/cuda_probe",
                 "./usr/bin/elbencho-tpu-torch",
                 "./usr/bin/elbencho-tpu-torch-chart",
                 "./usr/share/bash-completion/completions/elbencho-tpu-torch",
                 "./usr/share/bash-completion/completions/"
                 "elbencho-tpu-torch-chart",
                 "./usr/share/doc/elbencho-tpu-torch/LICENSE",
                 "./usr/share/doc/elbencho-tpu-torch/CHANGELOG.md"):
        assert want in names, want
    assert not [n for n in names if "_tsan" in n or "__pycache__" in n
                or n.endswith(".pyc")]
    control = subprocess.run(["dpkg-deb", "-f", deb], capture_output=True,
                             text=True, check=True).stdout
    assert "Package: elbencho-tpu-torch" in control
    assert f"Version: {__version__}" in control
    assert "Depends: python3 (>= 3.10), python3-numpy" in control
    x = tmp_path / "x"
    subprocess.run(["dpkg-deb", "-x", deb, str(x)], check=True)
    for launcher in ("elbencho-tpu-torch", "elbencho-tpu-torch-chart"):
        r = subprocess.run([str(x / "usr" / "bin" / launcher), "--help"
                            if launcher.endswith("chart") else "--version"],
                           cwd=str(tmp_path), env=_env(""),
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
    assert f"elbencho-tpu-torch {__version__}" in subprocess.run(
        [str(x / "usr" / "bin" / "elbencho-tpu-torch"), "--version"],
        cwd="/", env=_env(""), capture_output=True, text=True,
        timeout=120).stdout


def test_torch_rpm_spec_installs_the_port(tree, tmp_path):
    """The rendered spec names the port's files, and its %install, run
    with the macros filled in, lays out the tree the deb holds."""
    r = _make(tree, "torch-rpm")
    assert r.returncode == 0, r.stdout + r.stderr
    spec = open(os.path.join(tree, "build", "elbencho-tpu-torch.spec")).read()
    assert "Name: elbencho-tpu-torch" in spec
    assert f"Version: {__version__}" in spec and "__VERSION__" not in spec
    for want in ("/usr/lib/elbencho-tpu-torch", "/usr/bin/elbencho-tpu-torch",
                 "/usr/bin/elbencho-tpu-torch-chart",
                 "completions/elbencho-tpu-torch-chart",
                 "elbencho_tpu_torch"):
        assert want in spec, want
    assert _make(tree, "torch").returncode == 0
    script = spec.split("%install\n")[1].split("\n%files")[0]
    buildroot = tmp_path / "root"
    script = script.replace("%{buildroot}", str(buildroot)).replace(
        "%{_sourcedir}", tree)
    subprocess.run(["bash", "-e", "-c", script], check=True, timeout=60)
    lib = buildroot / "usr" / "lib" / "elbencho-tpu-torch" / \
        "elbencho_tpu_torch"
    assert sorted(os.listdir(lib / "_prebuilt")) == [
        "cuda_probe", "libebtcore.so", "libebtcudamock.so"]
    assert not list(lib.rglob("__pycache__"))
    r = subprocess.run([str(buildroot / "usr" / "bin" / "elbencho-tpu-torch"),
                        "--version"], cwd=str(tmp_path), env=_env(""),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and __version__ in r.stdout, r.stderr


def test_pip_install_ships_prebuilt(tree, tmp_path):
    """pip (offline, into a target directory) installs _prebuilt/ with the
    package, and the result runs from another directory."""
    assert _make(tree, "torch").returncode == 0
    target = tmp_path / "site"
    r = subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                        "--no-build-isolation", "--no-index", "--quiet",
                        "--target", str(target), tree], cwd=str(tmp_path),
                       env=_env(""), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert sorted(os.listdir(target / "elbencho_tpu_torch" / "_prebuilt")) \
        == ["cuda_probe", "libebtcore.so", "libebtcudamock.so"]
    r = _cli(tmp_path, _env(str(target)), "-w", "-r", "-t", "1", "-s", "2M",
             "-b", "1M", "--nolive", str(tmp_path / "f"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert not os.path.exists(target / "build")


@pytest.mark.parametrize("via_symlink", [False, True],
                         ids=["direct", "symlink"])
def test_bin_launcher_runs_from_any_directory(tmp_path, via_symlink):
    """bin/elbencho-tpu-torch finds the package beside itself, whatever the
    working directory and PYTHONPATH."""
    launcher = os.path.join(REPO, "bin", "elbencho-tpu-torch")
    if via_symlink:
        os.symlink(launcher, tmp_path / "ebt")
        launcher = str(tmp_path / "ebt")
    r = subprocess.run([launcher, "--version"], cwd=str(tmp_path),
                       env=_env(""), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"elbencho-tpu-torch {__version__}")
