"""Runs of a cell that must come out not correct: the control and the
planted faults. The benchmark's own runs never run them.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        --seconds 5 --variant control,unchanged,half,altered,fail[,none]

- `control`: the port's own path that breaks the guarantee the cell's
  configuration states, switched on by the traffic file's `control.flags`
  (the stream cell: `--hostverify`, blocks checked on the host and not by
  the card's verify kernel);
- `unchanged`: every host-to-device copy returns without copying;
- `half`: every second host-to-device copy returns without copying;
- `altered`: every host-to-device copy carries one byte flipped;
- `fail`: one host-to-device copy in three reports a transfer error;
- `none`: a sound run, for the lower reading of each limit.

The faults sit under the engine: a shim in place of the native copy
function the engine calls, forwarding to the real one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import sys

VARIANTS = ("none", "control", "unchanged", "half", "altered", "fail")


def _shim(real_ptr: int, variant: str):
    from elbencho_tpu_torch.engine import DEV_COPY_FN

    real = DEV_COPY_FN(real_ptr)
    turn = itertools.count()

    def copy(ctx, rank, dev, direction, buf, length, offset):
        if direction != 0 or not length:
            return real(ctx, rank, dev, direction, buf, length, offset)
        if variant == "unchanged" or (variant == "half" and
                                      next(turn) % 2 == 0):
            return 0
        if variant == "fail" and next(turn) % 3 == 2:
            return 1
        if variant == "altered":
            # the engine's buffer may be a read-only page-cache mapping:
            # alter a private copy
            block = ctypes.create_string_buffer(
                ctypes.string_at(buf, length), length)
            block[0] = bytes([block.raw[0] ^ 0xFF])
            return real(ctx, rank, dev, direction, block, length, offset)
        return real(ctx, rank, dev, direction, buf, length, offset)

    return DEV_COPY_FN(copy)


@contextlib.contextmanager
def planted(variant: str):
    """Install the fault for every native path made inside the block."""
    if variant in ("none", "control"):
        yield
        return
    from elbencho_tpu_torch.cuda import native

    orig = native.NativeCudaPath.copy_fn_ptr
    keep = []

    def fault_ptr(path):
        fn = _shim(orig.fget(path), variant)
        keep.append(fn)
        return ctypes.cast(fn, ctypes.c_void_p).value

    native.NativeCudaPath.copy_fn_ptr = property(fault_ptr)
    try:
        yield
    finally:
        native.NativeCudaPath.copy_fn_ptr = orig


def variant_cell(cell, variant: str):
    """The cell with the control's flags added for `control`."""
    if variant != "control":
        return cell
    import dataclasses

    traffic = dict(cell.traffic)
    traffic["flags"] = list(traffic.get("flags", [])) + \
        list(traffic["control"]["flags"])
    return dataclasses.replace(cell, traffic=traffic)


def run_variant(cell, variant: str, seed: int, seconds: float,
                root: str, **kw) -> dict:
    """One run of `cell` as `variant`; the result line's fields (`kw`
    goes to run.run_cell)."""
    from . import run

    with planted(variant):
        return run.run_cell(variant_cell(cell, variant), seed, seconds,
                            False, root=root, **kw)


def main(argv=None) -> int:
    from . import run
    from .cell import numa_node_of_card
    from .spec import ROOT, load_cell

    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--variant", default="control")
    args = p.parse_args(argv)
    run._cache_env(ROOT)
    cell = load_cell(args.workload)
    if run.gpu_device(cell.chips) is None:
        return 2
    for variant in args.variant.split(","):
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant!r}")
        for seed in (int(s) for s in args.seeds.split(",")):
            out = run_variant(cell, variant, seed, args.seconds, ROOT,
                              numa_node=numa_node_of_card())
            print(json.dumps({
                "variant": variant, "seed": seed, "correct": out["correct"],
                "checks": {k: c["value"] for k, c in out["checks"].items()},
                "metrics": {k: m["value"] for k, m in out["metrics"].items()},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
