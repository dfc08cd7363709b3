"""Drive one cell through the port's CLI path and count what each phase did.

The window drives what `elbencho-tpu-torch` runs: the argument list goes
through `config.config_from_args`, a `Coordinator` makes the
`LocalWorkerGroup` (native engine, `--tpubackend pjrt`: CudaPath and, with
--verify, the verify kernel) and runs each phase with its own `_run_phase`.
The session prepares once, as the CLI does, and then runs the cell's phase
again and again: one pass over the data set (READ) or one INGEST run of the
configured epochs per phase.

Around each phase the session reads the port's counters (lane submits and
bytes landed, kernel launches, registration cache, ingest ledger) and its
phase results, and keeps them as a PhaseRecord. It computes no metric and
judges nothing: that is reference.py's and the metric readers' work.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time
from dataclasses import dataclass, field

OFFSET_RE = re.compile(r"verification failed at file offset (\d+)")


@dataclass
class PhaseRecord:
    t0: float  # host clock (perf_counter) at the call into the coordinator
    t1: float
    engine_s: float = 0.0  # the slowest worker's phase time, engine clock
    submits: int = 0  # device copies submitted (lane counters)
    landed: int = 0  # bytes the lanes counted in device memory
    verify_launches: int = 0
    reg_misses: int = 0
    staged_fallbacks: int = 0
    epochs: list = field(default_factory=list)  # ingest: per-epoch records
    histo: object = None  # the merged IO latency histogram
    error: str = ""

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


def port_argv(config: dict, traffic: dict, data_dir: str, paths: list[str],
              seed: int, numa_node: int) -> list[str]:
    """The CLI arguments of one cell: the generator every traffic file
    goes through. Geometry comes from the configuration's `port` group,
    the access pattern from the traffic file; `{seed}` in a traffic flag
    takes the run's seed."""
    port = config["port"]
    argv = ["-t", str(port["threads"]), "-b", str(port["block_bytes"]),
            "-s", str(port["file_bytes"]), "--iodepth", str(port["iodepth"]),
            "--gpuids", ",".join(str(g) for g in range(port["gpus"])),
            "--tpubackend", "pjrt", "--nolive"]
    if traffic.get("verify"):
        argv += ["--verify", str(port["verify_salt"])]
    if numa_node >= 0:
        argv += ["--numazones", str(numa_node)]
    argv += [str(a).replace("{seed}", str(seed))
             for a in traffic.get("flags", [])]
    if traffic["phase"] == "INGEST":
        argv += ["--ingestshards", str(port["files"]),
                 "--recordsize", str(port["record_bytes"]),
                 "--epochs", str(traffic["epochs_per_phase"]), data_dir]
    else:
        argv += ["-r", *paths]
    return argv


class PortSession:
    """One prepared LocalWorkerGroup behind a Coordinator, as the CLI makes
    it; phases run on it until close()."""

    def __init__(self, argv: list[str], log=None) -> None:
        from elbencho_tpu_torch.common import BenchPhase
        from elbencho_tpu_torch.config import config_from_args
        from elbencho_tpu_torch.coordinator import Coordinator
        from elbencho_tpu_torch.logger import LOGGER
        from elbencho_tpu_torch.stats import Statistics

        # the port prints its phase tables on stdout; the harness keeps
        # stdout for its result line
        self._log = log or sys.stderr
        with contextlib.redirect_stdout(self._log):
            self.cfg = config_from_args(argv)
            LOGGER.level = self.cfg.log_level
            self.coord = Coordinator(self.cfg)
            self.coord.workers = self.coord._make_workers()
            self.coord.stats = Statistics(self.cfg, self.coord.workers)
            self.workers = self.coord.workers
            try:
                self.workers.prepare()
            except BaseException:
                self.workers.teardown()
                raise
            self.coord.stats.print_phase_header()
        self.phase = (BenchPhase.INGEST if self.cfg.ingest_active
                      else BenchPhase.READFILES)

    def _counters(self) -> dict:
        from elbencho_tpu_torch.cuda.native import kernel_launches

        lanes = self.workers.lane_stats() or []
        reg = self.workers.reg_cache_stats() or {}
        return {"submits": sum(ln["submits"] for ln in lanes),
                "landed": sum(ln["to_hbm"] for ln in lanes),
                "verify": kernel_launches()["verify_u32"],
                "misses": reg.get("misses", 0),
                "fallbacks": reg.get("staged_fallbacks", 0)}

    def run_phase(self) -> PhaseRecord:
        """One phase through the coordinator. A phase that fails keeps its
        cause in `error`; the counters are read either way."""
        from elbencho_tpu_torch.exceptions import ProgException
        from elbencho_tpu_torch.histogram import LatencyHistogram

        before = self._counters()
        rec = PhaseRecord(t0=time.perf_counter(), t1=0.0)
        with contextlib.redirect_stdout(self._log):
            try:
                self.coord._run_phase(self.phase)
            except ProgException as e:
                rec.error = str(e) or "phase failed"
        rec.t1 = time.perf_counter()
        after = self._counters()
        rec.submits = after["submits"] - before["submits"]
        rec.landed = after["landed"] - before["landed"]
        rec.verify_launches = after["verify"] - before["verify"]
        rec.reg_misses = after["misses"] - before["misses"]
        rec.staged_fallbacks = after["fallbacks"] - before["fallbacks"]
        results = self.workers.phase_results()
        rec.histo = LatencyHistogram()
        for r in results:
            rec.engine_s = max(rec.engine_s, r.elapsed_us / 1e6)
            rec.histo += r.iops_histo
            if r.error:  # every worker's cause: the first may be a stop
                rec.error = f"{rec.error} | {r.error}" if rec.error \
                    else r.error
        ingest = self.workers.ingest_stats()
        if ingest is not None:
            rec.epochs = ingest["epochs"]
        return rec

    def close(self) -> None:
        with contextlib.redirect_stdout(self._log):
            self.workers.teardown()


def reported_offset(error: str) -> int | None:
    """The exact corrupt offset a verify failure names, or None."""
    m = OFFSET_RE.search(error or "")
    return int(m.group(1)) if m else None


def numa_node_of_card(card: int = 0) -> int:
    """The NUMA node the first card's PCI function names, where the host
    has more than one node; -1 otherwise (or where nothing says)."""
    base = "/sys/devices/system/node"
    try:
        nodes = [d for d in os.listdir(base)
                 if d.startswith("node") and d[4:].isdigit()]
    except OSError:
        return -1
    if len(nodes) < 2:
        return -1
    try:
        import torch

        p = torch.cuda.get_device_properties(card)
        bus = f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
    except (AttributeError, RuntimeError, AssertionError):
        return -1
    try:
        with open(f"/sys/bus/pci/devices/{bus}/numa_node") as f:
            node = int(f.read().strip())
    except (OSError, ValueError):
        return -1
    return node
