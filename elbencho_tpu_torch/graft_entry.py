"""Entry points: the single-device step and the multi-device dry run.

Port of the original's __graft_entry__.py. The system's compute path is the
on-device integrity verify + stats step over blocks staged from storage into
device memory (ops/ingest_kernel.py, the B4 kernel), and its multi-device
form: blocks sharded over a device list with the stats reduced on the
devices (parallel/mesh.py, B4 per device and the B5 reduction).

    python -c "from elbencho_tpu_torch.graft_entry import dryrun_multichip; \\
               dryrun_multichip(2)"
"""

from __future__ import annotations

import numpy as np


def entry(device=None):
    """Return (fn, example_args): the single-device forward step and a
    64 KiB block at file offset 8192 (salt 1234) with its offset and salt
    halves. The block lies on the card unless the caller asks for the CPU
    (device="cpu" or EBT_TORCH_DEVICE=cpu); fn is the B4 kernel's wrapper."""
    import torch

    from .cuda.devices import resolve_devices
    from .ops.ingest_kernel import ingest_verify_step
    from .ops.integrity import make_example_block, split_u64

    dev = resolve_devices([0], device)[0]
    block = make_example_block(num_bytes=1 << 16, file_off=8192, salt=1234)
    off_lo, off_hi = split_u64(8192)
    salt_lo, salt_hi = split_u64(1234)
    args = (torch.from_numpy(block.view(np.int32)).to(dev), off_lo, off_hi,
            salt_lo, salt_hi)
    return ingest_verify_step, args


def dryrun_multichip(n_devices: int) -> None:
    """Exercise the whole multi-device stack on n CPU devices, a dry run by
    contract (it sets EBT_TORCH_DEVICE=cpu for itself and its services):

    1. the sharded ingest step over an n-device list (two ranks per device,
       one batched ingest step per device, the rows gathered and reduced),
       one step on tiny shapes;
    2. the MeshStatsReducer tier: exact u64 counters, including values
       past 2^32 that would corrupt a naive f32/u32 path;
    3. one distributed phase: two port service subprocesses (each with n
       CPU devices), a port master driving write+read through the engine's
       hot loops with the staged backend over all n devices, the HTTP
       fan-in, and the in-band SliceOps cross-check (device-reduced totals
       vs per-worker totals; a mismatch fails the phase, workers/remote.py);
    4. the same distributed phase over the native engine (--tpubackend
       pjrt: csrc/cuda_path.cpp against the mock CUDA driver that
       engine.build_mock() builds, n mock devices per service), write leg
       through the deferred D2H engine with per-chip latency for every
       device.

    It needs no card and runs in a bare process: python, torch and the
    repository."""
    import os

    os.environ["EBT_TORCH_DEVICE"] = "cpu"

    from .ops.integrity import make_example_block
    from .parallel.mesh import MeshStatsReducer, make_mesh, run_sharded_ingest

    mesh = make_mesh(n_devices)
    words_per_block = 256  # tiny: 2KiB blocks
    num_ranks = n_devices * 2  # two worker ranks per device
    salt = 77
    blocks = np.stack([
        make_example_block(num_bytes=words_per_block * 8,
                           file_off=r * words_per_block * 8, salt=salt)
        for r in range(num_ranks)
    ])
    offsets = np.arange(num_ranks, dtype=np.uint64) * \
        np.uint64(words_per_block * 8)
    out = run_sharded_ingest(mesh, blocks, offsets, salt)
    expect_ok = float(num_ranks * words_per_block * 8)
    assert out["bad_words"] == 0.0, out
    assert out["ok_bytes"] == expect_ok, out
    assert out["iops"] == float(num_ranks), out

    # ---- MeshStatsReducer: exact u64 totals over the devices
    reducer = MeshStatsReducer(mesh)
    per_dev = [[(1 << 40) + d, d * 3 + 1, 0xFFFF_FFFF + d]
               for d in range(n_devices)]
    got = reducer.reduce(per_dev)
    want = [sum(row[i] for row in per_dev) for i in range(3)]
    assert got == want, (got, want)

    # ---- end-to-end distributed phase (2 services + master, in-process)
    _dryrun_distributed_phase(n_devices)


def _dryrun_distributed_phase(n_devices: int) -> None:
    import json
    import os
    import socket
    import subprocess
    import sys
    import tempfile
    import time
    import urllib.request

    from . import engine
    from .cli import main

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    ports = [free_port() for _ in range(2)]
    # the pjrt leg runs the C++ engine against the mock CUDA driver with n
    # mock devices per service (the stand-in for n cards)
    env = dict(os.environ, EBT_TORCH_DEVICE="cpu",
               EBT_CUDA_DRIVER=engine.build_mock(),
               EBT_MOCK_CUDA_DEVICES=str(n_devices))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "elbencho_tpu_torch.cli", "--service",
             "--foreground", "--port", str(p)],
            cwd=repo, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        for p in ports
    ]
    try:
        deadline = time.monotonic() + 60
        for p in ports:
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{p}/info", timeout=2) as r:
                        json.loads(r.read())
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"service on port {p} not up")
                    time.sleep(0.2)

        hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
        gpuids = ",".join(str(i) for i in range(n_devices))
        # full device coverage: threads per service are sized so the two
        # services' global ranks 0..2t-1 cover every device under the
        # engine's rank % num_devices assignment, and the file holds two
        # blocks per rank
        tps = max(1, (n_devices + 1) // 2)
        t = str(tps)
        size = f"{2 * tps}M"  # 2 x 512k blocks per global rank
        with tempfile.TemporaryDirectory() as td:
            bench_file = os.path.join(td, "dryrun-dist-f1")
            rc = main(["--hosts", hosts, "-w", "-r", "-t", t,
                       "-s", size, "-b", "512k", "--gpuids", gpuids,
                       "--tpubackend", "staged", "--nolive", bench_file])
            assert rc == 0, f"distributed phase failed (rc={rc})"
            rc = main(["--hosts", hosts, "-F", "-t", t, "--nolive",
                       bench_file])
            assert rc == 0, f"distributed cleanup failed (rc={rc})"
            bench_file2 = os.path.join(td, "dryrun-dist-f2")
            rc = main(["--hosts", hosts, "-w", "-r", "-t", t,
                       "-s", size, "-b", "512k", "--gpuids", gpuids,
                       "--tpubackend", "pjrt", "--lat", "--nolive",
                       bench_file2])
            assert rc == 0, f"distributed pjrt phase failed (rc={rc})"
            # the write leg alone, through the deferred D2H engine: the
            # services' last phase is then the write, whose per-chip
            # latency must cover every device (each service owns half)
            rc = main(["--hosts", hosts, "-w", "-t", t,
                       "-s", size, "-b", "512k", "--gpuids", gpuids,
                       "--tpubackend", "pjrt", "--d2hdepth", "2",
                       "--lat", "--nolive", bench_file2])
            assert rc == 0, f"distributed pjrt write leg failed (rc={rc})"
            seen: dict[str, int] = {}
            for p in ports:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{p}/benchresult", timeout=10) as r:
                    res = json.loads(r.read())
                assert res.get("D2HTier") == "deferred", (
                    f"service {p}: write leg did not ride the deferred "
                    f"D2H engine (D2HTier={res.get('D2HTier')!r})")
                for label, wire in (res.get("DevLatHistos") or {}).items():
                    seen[label] = seen.get(label, 0) + int(
                        wire.get("count", 0))
            missing = [str(d) for d in range(n_devices)
                       if seen.get(str(d), 0) <= 0]
            assert not missing, (
                f"write-leg d2h latency fan-in missing chips {missing} "
                f"(saw {seen})")
            rc = main(["--hosts", hosts, "-F", "-t", t, "--nolive",
                       bench_file2])
            assert rc == 0, f"distributed pjrt cleanup failed (rc={rc})"
        main(["--hosts", hosts, "--quit"])
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
