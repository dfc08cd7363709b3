"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in setup_s): the data set (made once per checkout, then
only warmed), the port's configuration and prepare, and one untimed phase
that runs every shape the window runs. The window then runs whole phases
until --seconds have passed; every byte that reached device memory in it,
over its whole time, is the rate. With --trace 1 the window runs under
torch.profiler and the line carries the per-layer metrics instead.

After the window: the corruption probe (where the traffic asks for it), the
comparison with the reference (judge.py), the teardown, and the check that
no JAX module was loaded. Each number compared is printed beside its limit
as the last lines on standard error and under "checks", last, in the line.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

import numpy as np  # noqa: E402

from . import dataset, judge  # noqa: E402
from .cell import PortSession, numa_node_of_card, port_argv  # noqa: E402
from .cell import reported_offset  # noqa: E402
from .isolation import forbidden_modules  # noqa: E402
from .spec import ROOT, Cell, load_cell, metric_reader  # noqa: E402


@dataclass
class RunRecord:
    """What the metric readers read: one run of one cell."""

    cell: Cell
    setup_s: float
    phases: list  # the window's PhaseRecords
    cpu_s: float  # user + system CPU seconds of the process in the window
    trace: object = None  # devtrace.TraceSummary of a --trace 1 window

    @property
    def window_s(self) -> float:
        return self.phases[-1].t1 - self.phases[0].t0

    @property
    def landed_bytes(self) -> int:
        return sum(p.landed for p in self.phases)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def gpu_device(chips: int) -> dict | None:
    """The cards this run uses, or None (with the cause on stderr) where
    there are fewer than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def gpu_memory_used(chips: int) -> int:
    """Device memory in use on the fullest card (the process's context and
    every allocation of the port's driver-API path)."""
    import torch

    used = 0
    for i in range(chips):
        free, total = torch.cuda.mem_get_info(i)
        used = max(used, total - free)
    return used


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _cache_env(root: str) -> None:
    # every build and kernel cache at a fixed path inside the checkout
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             root: str = ROOT, t0: float = _T0, memory=None,
             numa_node: int = -1, log=None) -> dict:
    """Set up, run the window, judge. Returns the result line's fields
    (without `device`). `memory` reads the device memory in use (None: not
    read, as on the CPU); `numa_node` >= 0 binds the port's workers there."""
    log = log or sys.stderr
    # set-up's parts, printed: imports and the device check come first
    marks = [("start", t0), ("imports", time.perf_counter())]
    port = cell.config["port"]
    traffic = cell.traffic
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 0])
    salt = port["verify_salt"]
    directory = dataset.data_dir(root, port["files"], port["file_bytes"],
                                 salt)
    paths = dataset.ensure(directory, port["files"], port["file_bytes"],
                           salt)
    marks.append(("data set", time.perf_counter()))
    dataset.warm(paths)
    order = list(rng.permutation(paths)) if traffic.get("order") == \
        "shuffled" else paths
    argv = port_argv(cell.config, traffic, directory, order, seed,
                     numa_node)
    print("portbench: elbencho-tpu-torch " + " ".join(argv), file=log)
    marks.append(("warm read", time.perf_counter()))
    session = PortSession(argv, log=log)
    marks.append(("prepare", time.perf_counter()))
    peak = 0
    try:
        judged = [session.run_phase()]  # warm-up: every shape, untimed
        marks.append(("warm-up", time.perf_counter()))
        if memory:
            peak = memory()
        marks.append(("memory", time.perf_counter()))
        setup_s = marks[-1][1] - t0
        print("portbench: set-up s: " + ", ".join(
            f"{name} {b - a:.3f}" for (_, a), (name, b)
            in zip(marks, marks[1:])), file=log)
        tracer = None
        if trace:
            from .devtrace import DeviceTrace

            tracer = DeviceTrace()
        window = []
        with tracer or contextlib.nullcontext():
            cpu0 = _cpu_s()
            while True:
                with tracer.phase() if tracer else contextlib.nullcontext():
                    rec = session.run_phase()
                window.append(rec)
                if rec.error or rec.t1 - window[0].t0 >= seconds:
                    break
            cpu_s = _cpu_s() - cpu0
        if memory:
            peak = max(peak, memory())
        probe = None
        if traffic.get("corrupt_probe"):
            probe = _probe(session, directory, order, port, rng)
    finally:
        session.close()
    judged += window
    verdict = judge.judge(port, traffic, judged, probe, root=root)
    run = RunRecord(cell=cell, setup_s=setup_s, phases=window,
                    cpu_s=cpu_s,
                    trace=tracer.summary(port["gpus"]) if tracer else None)
    print(f"portbench: window {run.window_s:.3f} s, {len(window)} phases; "
          f"phase wall s: " + " ".join(f"{p.wall_s:.3f}" for p in window),
          file=log)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = metric_reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"]
                  for c in verdict["checks"].values())
    out = {"correct": correct, "attempted": verdict["attempted"],
           "failed": verdict["failed"], "metrics": metrics,
           "memory_peak_bytes": peak, "checks": verdict["checks"]}
    if run.trace is not None:
        out["trace"] = run.trace
    return out


def _probe(session, directory: str, order: list, port: dict,
           rng: np.random.Generator) -> dict:
    """Flip one byte of the data set, run one more phase, put it back: the
    port's verify must name that byte's offset exactly."""
    path = order[int(rng.integers(len(order)))]
    readable = port["file_bytes"] // port["block_bytes"] * port["block_bytes"]
    offset = int(rng.integers(readable))
    dataset.flip_byte(directory, path, offset)
    try:
        rec = session.run_phase()
    finally:
        dataset.repair_probe(directory)
    return {"path": path, "offset": offset,
            "reported": reported_offset(rec.error)}


def result_line(out: dict, device: dict) -> dict:
    """The printed line: the driver's keys, `checks` last."""
    dev = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": dev}
    tr = out.get("trace")
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops,
                             "idle_gaps": tr.idle_gaps}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    _cache_env(ROOT)
    cell = load_cell(args.workload)
    t_harness = time.perf_counter()
    import torch  # noqa: F401

    t_torch = time.perf_counter()
    device = gpu_device(cell.chips)
    if device is None:
        return 2
    # the parts of set-up's first mark, printed apart
    print(f"portbench: start-up s: python and harness {t_harness - _T0:.3f}"
          f", import torch {t_torch - t_harness:.3f}, device check "
          f"{time.perf_counter() - t_torch:.3f}", file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   memory=lambda: gpu_memory_used(cell.chips),
                   numa_node=numa_node_of_card())
    bad = forbidden_modules()
    if bad:
        print("portbench: loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    line = result_line(out, device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
