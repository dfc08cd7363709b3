#!/usr/bin/env python3
"""The port's multi-device paths on every card of one machine.

    python3 tools/torch_multicard.py

Needs two or more CUDA devices. Runs chip_smoke.py's multi-device phases
over every card: MeshStatsReducer and run_sharded_ingest over [cuda:0],
[cuda:0, cuda:0] and all cards (exact totals, one ingest launch per
device and one reduction per step), then two port services and a port
master on a 1 GiB file with --gpuids over all cards, staged --verify
--lat: every service ships SliceOps reduced over all its devices (the
master checks them against its fan-in), with one latency row per host and
device. Then the native engine's stripe tier over all cards (--stripe rr
and contig on a 4 GiB file, each card's bytes as the planner places them)
and a checkpoint restore of meta-llama/Llama-3.1-8B's four shard sizes
(16.1 GB) with shard i on card i mod n, then the same manifest resharded
from n cards onto the first two (--reshard 2): the shards of the other
cards move card to card over cuMemcpyPeerAsync (peer access state
printed), with the reshard ledger checked as in chip_smoke.py. Prints the
card's name and power limit and the GiB/s it measured.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def slice_tier(cli, d: str, n: int) -> None:
    """Two services, --gpuids 0..n-1: SliceOps over n devices each."""
    path = os.path.join(d, "mc1g")
    gpuids = ",".join(str(i) for i in range(n))
    with chip_smoke.port_services(d) as ports:
        hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
        csvp = os.path.join(d, "mc.csv")
        rc, out, _ = chip_smoke.run_cli(cli, [
            "--hosts", hosts, "-w", "-r", "-t", str(n), "-s", "1G", "-b",
            "4M", "--verify", "42", "--gpuids", gpuids, "--tpubackend",
            "staged", "--lat", "--nolive", "--csvfile", csvp, path])
        if rc != 0:
            raise AssertionError(f"slice tier run: rc {rc}")
        for p in ports:
            res = chip_smoke._http_json(f"http://127.0.0.1:{p}/benchresult")
            sl = res["SliceOps"]
            if sl["NumDevices"] != n or sl["Reduction"] != "psum" or \
                    any(sl["Ops"][k] != res["Ops"][k]
                        for k in ("bytes", "iops", "entries")):
                raise AssertionError(f"SliceOps of {p}: {sl} vs {res['Ops']}")
            for dev in range(n):
                if f"READ      TPU 127.0.0.1:{p}:{dev} xfer lat us" not in out:
                    raise AssertionError(f"no READ latency row {p}:{dev}")
        rows = chip_smoke.read_csv(csvp)
        chip_smoke.phase("slice-tier", f"2 services x --gpuids {gpuids}: "
                         f"SliceOps over {n} devices equal to the fan-in on "
                         f"both; WRITE "
                         f"{int(rows['WRITE']['MiB/s last']) / 1024:.3f} "
                         f"GiB/s, READ "
                         f"{int(rows['READ']['MiB/s last']) / 1024:.3f} GiB/s")
        cli.main(["--hosts", hosts, "--quit"])


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"torch_multicard: needs two or more CUDA devices, found {n}",
              file=sys.stderr)
        return 2
    from elbencho_tpu_torch import cli, engine, graft_entry
    from elbencho_tpu_torch.ops import ingest_kernel as ik
    from elbencho_tpu_torch.ops import integrity as integ
    from elbencho_tpu_torch.ops import kernel_build
    from elbencho_tpu_torch.parallel import mesh

    print(chip_smoke.gpu_name_and_power(), f"x {n}", flush=True)
    chip_smoke.build_all(engine, kernel_build, (ik,))
    chip_smoke.check_reduce(mesh)
    chip_smoke.slice_main_path(ik, integ, mesh, graft_entry)
    shards = chip_smoke.LLAMA_8B_SHARDS
    with chip_smoke.scratch_dir(2 * (4 << 30) + sum(shards)) as d:
        slice_tier(cli, d, n)
        gpuids = ",".join(str(i) for i in range(n))
        path = os.path.join(d, "mc4g")
        rc, _, _ = chip_smoke.run_cli(cli, [
            "-w", "-s", "4G", *chip_smoke.STRIPE_READ, "--gpuids", gpuids,
            path])
        if rc != 0:
            raise AssertionError(f"4 GiB native write: rc {rc}")
        chip_smoke.native_stripe(path, 4 << 30, gpuids)
        os.remove(path)
        paths = chip_smoke.write_shards(d, shards)
        man = chip_smoke.write_manifest(d, "man.json", paths,
                                        [[i % n] for i in range(len(paths))])
        want = [sum(b for i, b in enumerate(shards) if i % n == dev)
                for dev in range(n)]
        chip_smoke.restore(["-t", str(len(paths)), "--tpubackend", "pjrt",
                            "--checkpoint", man, "--lat", "--nolive"],
                           f"one shard per card over {n} cards", want)
        chip_smoke.reshard(["-t", str(len(paths)), "--tpubackend", "pjrt",
                            "--checkpoint", man, "--reshard", "2", "--lat",
                            "--nolive"],
                           f"{n} cards -> 2, card to card", "d2d")
    print("torch_multicard: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
