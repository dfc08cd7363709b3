"""Fill the package's _prebuilt/ directory for an installed copy (`make
torch`, the counterpart of the original's `make core` plus its package
data).

    python3 -m elbencho_tpu_torch.prebuild [--dest DIR]

In a source checkout it builds, through the port's own build functions
(engine.build_core, build_plain_mock, build_checkout_probe and
kernel_build.build_lib, all started together), the engine library with its
CUDA transfer engine, the mock CUDA driver, the standalone copy probe and,
where nvcc is found, the CUDA kernel library, then copies them into
elbencho_tpu_torch/_prebuilt/ (or DEST). What was there before is removed
first, so a stale kernel library never outlives a build without nvcc. The
overrides EBT_TORCH_CORE_LIB and EBT_TORCH_MOCK_LIB play no part: no
sanitizer build is ever copied. One line per file, then one line with the
build's seconds.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from . import engine
from .ops import kernel_build

# the files an installed copy takes from _prebuilt/ (engine.native_file)
FILES = ("libebtcore.so", "libebtcudamock.so", "cuda_probe",
         kernel_build.LIB_NAME)


def _kernels() -> str:
    kernel_build.build_lib()
    return kernel_build.LIB_PATH


def populate(dest: str = engine.PREBUILT_DIR) -> dict[str, str | None]:
    """Build what is missing or stale and copy it into `dest`; returns
    {file name: source path, or None for the kernel library where nvcc is
    not found}."""
    engine.require_checkout("make torch")
    build = {"libebtcore.so": engine.build_core,
                "libebtcudamock.so": engine.build_plain_mock,
                "cuda_probe": engine.build_checkout_probe}
    if kernel_build.nvcc_found():
        build[kernel_build.LIB_NAME] = _kernels
    with ThreadPoolExecutor(len(build)) as pool:
        futures = {n: pool.submit(fn) for n, fn in build.items()}
        built = {n: f.result() for n, f in futures.items()}
    os.makedirs(dest, exist_ok=True)
    for name in FILES:
        path = os.path.join(dest, name)
        if os.path.exists(path):
            os.remove(path)
    for name, src in built.items():
        tmp = os.path.join(dest, f".{name}.{os.getpid()}.tmp")
        shutil.copy2(src, tmp)
        os.replace(tmp, os.path.join(dest, name))
    return {n: built.get(n) for n in FILES}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m elbencho_tpu_torch.prebuild",
        description="build the port's native files and copy them into "
                    "its _prebuilt/ directory")
    ap.add_argument("--dest", default=engine.PREBUILT_DIR,
                    help="target directory (default: %(default)s)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        got = populate(args.dest)
    except RuntimeError as e:  # NativeFileError, or nvcc's failure
        print(f"make torch: {e}", file=sys.stderr)
        return 1
    for name, src in got.items():
        label = "kernels" if name == kernel_build.LIB_NAME else name
        if src is None:
            print(f"{label}: not built (nvcc not found)")
        else:
            print(f"{label}: {src} -> {os.path.join(args.dest, name)}")
    print(f"make torch: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
