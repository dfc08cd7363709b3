"""Build of the port's CUDA kernels into one library.

Every csrc/*.cu is compiled with nvcc for sm_90a, one nvcc per source, all
started together, and the objects are linked into
build/torch_kernels/libebt_torch_kernels.so. The wrappers (verify_kernel.py,
fill_kernel.py, ingest_kernel.py) load it with ctypes, and the native CUDA
engine (csrc/cuda_path.cpp) resolves the kernels' C entries from it by
path. library() finds it by the engine's rule (engine.native_file): built
here in a source checkout, taken from _prebuilt/ in an installed copy,
which never compiles.
"""

from __future__ import annotations

import fcntl
import glob
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")
LIB_NAME = "libebt_torch_kernels.so"
LIB_PATH = os.path.join(BUILD_DIR, LIB_NAME)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_nvcc = "/usr/local/cuda/bin/nvcc"
    return cuda_nvcc if os.path.exists(cuda_nvcc) else "nvcc"


def nvcc_found() -> bool:
    return shutil.which(_nvcc()) is not None


def _fresh() -> bool:
    """The library exists and is newer than every kernel source."""
    return os.path.exists(LIB_PATH) and all(
        os.path.getmtime(src) <= os.path.getmtime(LIB_PATH)
        for src in SOURCES)


def build_lib() -> float:
    """Compile the kernel library if it is missing or older than a source;
    returns the seconds the build took (0.0 when it was up to date). A
    file lock serialises concurrent first uses; the library appears
    atomically. Refused outside a source checkout."""
    from ..engine import require_checkout

    if _fresh():
        return 0.0
    require_checkout(LIB_PATH)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():
            return 0.0
        t0 = time.perf_counter()
        pid = os.getpid()
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(
                BUILD_DIR, f"{os.path.basename(src)[:-3]}.{pid}.o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed on {src}:\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB_PATH}.{pid}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        for obj in objs:
            os.remove(obj)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
        return time.perf_counter() - t0


def library() -> str:
    """The kernel library's path by engine.native_file()'s rule (built
    first in a checkout if it is missing or stale)."""
    from ..engine import native_file

    def build() -> str:
        build_lib()
        return LIB_PATH

    return native_file(LIB_NAME, build, note="it builds the CUDA kernels "
                       "only where nvcc is found")
