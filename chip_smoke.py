#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elbencho_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the native engine with its CUDA transfer engine (g++) and the
     kernel library (nvcc, sm_90a, one nvcc per csrc/*.cu) from the
     checkout's sources, all started together;
  3. hold the verify kernel against its plain PyTorch version on the card:
     a 256 MiB block, a base that wraps past 2^64, a lane count that is not
     a multiple of 32768, a start 8 bytes past a 16-byte boundary, a word
     count that is not a multiple of the per-pass width, corruption at the
     first, last and random lanes, and clean and corrupt launches
     alternating back to back on one stream and on two streams;
  4. time it at 2 MiB, the verify run's 4 MiB block, the direct run's
     8 MiB block and 256 MiB, each with the data in L2 (as the path finds a
     block right after its copy) and out of it (buffers rotating over
     128 MiB): device time per launch from one CUDA graph of 200 launches
     replayed and timed with CUDA events, the wrapper's host time per call
     (perf_counter over a loop, then one synchronise), the plain version,
     and torch.count_nonzero over the same bytes as the floor one PyTorch
     call reaches;
  5. hold the fill kernel (B3) against its plain version on the card (a
     large offset and salt, a wrap past 2^64, odd word counts, a start 8
     mod 16, 256 MiB) and time it at 4, 8 and 256 MiB the same way, beside
     one torch.arange writing the same words;
  6. the direct path: a 4 GiB storage -> GPU write + read through the CLI
     with the direct backend;
  7. a 1 GiB staged write + read with on-device --verify in 4 MiB blocks of
     2 MiB chunks: clean, where the kernel must be launched exactly once per
     block read, then with one corrupt byte inside a block's second chunk
     and then one at the first byte of a block's second chunk, each of
     which must be reported at its exact file offset;
  8. the native main path (--tpubackend pjrt, the C++ CUDA engine) at the
     README's storage -> device setting, 4 GiB written and read through the
     worker-group API (the counters the CLI does not print: the confirmed
     tier must be the one the init probe found, the write must run through
     the deferred D2H engine);
  9. a 1 GiB native --verify write + read through the CLI: the engine must
     launch the fill kernel once per block written and the verify kernel
     once per block read, the file must hold the pattern, and a planted
     corrupt byte must be reported at its exact offset;
 10. direct and native reads of the 4 GiB file in turns, three pairs,
     printed as measurements (nothing asserted or claimed);
 11. hold the ingest kernel (B4, fused verify + checksum) against its plain
     version (a clean 64 KiB block, corrupt first, last and random words, a
     base that wraps past 2^64, a start 8 mod 16, a batch of 8 ranks x 4 MiB
     with one corrupt rank) and time it at 64 KiB, 4 MiB, 256 MiB and as
     batches of 2 and 8 ranks x 4 MiB, beside one torch.sum over the same
     bytes (a floor: no single PyTorch call computes the fused step);
 12. hold the reduction kernel (B5) against its plain version through
     MeshStatsReducer over [cuda:0], [cuda:0, cuda:0] and every card
     (exactness cases, values of 2^63 and above, a column wrapping past
     2^64) and time one launch beside one torch.sum(rows, 0);
 13. the slice's main path: entry()'s step on the card, run_sharded_ingest
     over each device list (2 ranks of 4 MiB per device at real file
     offsets, one rank corrupt) and a MeshStatsReducer reduction of its
     per-device counters; exactly one ingest launch per device and step,
     one reduction launch per step and reduce;
 14. distributed service mode on the card: two port services (subprocesses,
     --gpuids 0) and a port master on a 2 GiB file in /dev/shm, staged
     --verify write + read, then the native engine (--tpubackend pjrt
     --lat): totals equal to the file, host-prefixed per-chip rows, a
     corrupt byte failing the run framed by the host whose service reports
     its exact offset, /metrics answering; with two or more cards the slice
     tier (--gpuids 0,1, SliceOps reduced over two devices).

The second-to-last line is a JSON object describing each kernel of the path;
the last line is {"ok": true, "device": {...}}. Any failed check raises, so
the script exits non-zero and prints no result line. Without a CUDA device it
exits with code 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

U64 = (1 << 64) - 1
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit peak rate
VERIFY_OPS_PER_BYTE = 3     # add, xor and compares per 8-byte word, per byte
CHUNK = 2 << 20             # the staged path's transfer chunk
BLOCK = 4 << 20             # the staged verify run's block
TIME_SIZES = (CHUNK, BLOCK, 8 << 20, 256 << 20)  # 8 MiB: the direct block
FILL_SIZES = (BLOCK, 8 << 20, 256 << 20)
MAIN_ARGS = ["-t", "4", "-s", "4G", "-b", "8M", "--iodepth", "4", "--gpuids",
             "0", "--lat", "--nolive"]
INGEST_OPS_PER_BYTE = 4     # verify's 3, plus the checksum's adds
ENTRY_BLOCK = 64 << 10      # graft_entry.entry()'s block
DIST_SIZE = 2 << 30         # the distributed runs' file
COLD_BYTES = 128 << 20      # rotating buffers, 2.5x the 50 MB L2
GRAPH_LAUNCHES = 200


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_all(engine, kernel_build, wrappers) -> None:
    """The engine (g++) and the kernel library (one nvcc per source) in
    parallel, then the wrappers' bindings."""
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        core = pool.submit(timed, engine.load_lib)
        kern = pool.submit(timed, kernel_build.build_lib)
        phase("build", f"engine build/torch_core/libebtcore.so "
                       f"{core.result():.1f}s, kernels "
                       f"build/torch_kernels/libebt_torch_kernels.so "
                       f"{kern.result():.1f}s")
    for w in wrappers:
        w.load_lib()


def pattern_lanes(n_lanes: int, off: int, salt: int,
                  misalign: bool = False) -> torch.Tensor:
    """The on-disk pattern as int32 lanes on the card, made with numpy;
    with misalign, the lanes start 8 bytes past a 16-byte boundary."""
    words = (np.arange((n_lanes + 1) // 2, dtype=np.uint64) * np.uint64(8)
             + np.uint64(off & U64) + np.uint64(salt & U64))
    host = torch.from_numpy(words.view(np.int32)[:n_lanes])
    if not misalign:
        return host.cuda()
    room = torch.empty(n_lanes + 4, dtype=torch.int32, device="cuda")
    lanes = room[2:2 + n_lanes]
    lanes.copy_(host)
    assert lanes.data_ptr() % 16 == 8
    return lanes


def check_case(vk, integ, name, lanes, off, salt, corrupt) -> int:
    """Kernel outputs (bad lanes, bad words, first bad word) == plain;
    returns the largest absolute difference (0 when they agree)."""
    corrupt = sorted(set(corrupt))
    for pos in corrupt:
        lanes[pos] ^= 0x00A5A500
    n8 = (lanes.numel() // 2) * 2
    k_lanes = vk.verify_block_lanes(lanes, off, salt)
    torch.cuda.synchronize()
    k_words, k_first = (int(v) for v in vk.verify_block_u32(
        lanes[:n8].view(torch.uint8), off, salt))
    torch.cuda.synchronize()
    p_lanes = integ.verify_block_lanes_plain(lanes, off, salt)
    p_words, p_first = (int(v) for v in integ.verify_block_u32(
        lanes[:n8], off, salt))
    kernel = (k_lanes, k_words, k_first)
    plain = (p_lanes, p_words, p_first)
    err = max(abs(k - p) for k, p in zip(kernel, plain))
    if err or k_lanes != len(corrupt):
        raise AssertionError(f"verify kernel {name}: kernel {kernel} != "
                             f"plain {plain} (corrupt lanes {len(corrupt)})")
    phase("kernel", f"{name}: n_lanes={lanes.numel()} kernel == plain "
                    f"{kernel}")
    return err


def check_pair(vk, integ, name, lanes, off, salt, rng) -> int:
    """The case clean, then corrupt at the first, last and random lanes."""
    n = lanes.numel()
    spots = [0, n - 1] + [int(i) for i in rng.choice(n, 5, replace=False)]
    return max(check_case(vk, integ, f"{name} clean", lanes, off, salt, []),
               check_case(vk, integ, f"{name} corrupt", lanes, off, salt,
                          spots))


def check_alternating(vk, integ, streams, name) -> int:
    """Clean and corrupt 4 MiB blocks launched back to back with no
    synchronisation between them, round robin over `streams`: every result
    must equal the plain version's, which shows that the kernel's ticket
    resets and that streams do not share a workspace."""
    off, salt = 9 * BLOCK, 42
    clean = pattern_lanes(BLOCK // 4, off, salt)
    bad = clean.clone()
    bad[[3, 70001, BLOCK // 4 - 1]] ^= 0x11
    blocks = [clean.view(torch.uint8), bad.view(torch.uint8)]
    plain = [tuple(int(v) for v in integ.verify_block_u32(b.view(torch.int32),
                                                          off, salt))
             for b in blocks]
    torch.cuda.synchronize()
    got = []
    for i in range(32):
        with torch.cuda.stream(streams[i % len(streams)]):
            got.append(vk.verify_block_u32(blocks[i % 2], off, salt))
    torch.cuda.synchronize()
    got = [(int(n), int(f)) for n, f in got]
    err = max(abs(g - p) for i, r in enumerate(got)
              for g, p in zip(r, plain[i % 2]))
    if err:
        raise AssertionError(f"verify kernel {name}: {got} != plain "
                             f"{plain} alternating")
    phase("kernel", f"{name}: 32 launches alternating clean/corrupt == "
                    f"plain {plain}")
    return err


def check_kernel(vk, integ) -> int:
    """All cases; returns the largest kernel-vs-plain difference."""
    rng = np.random.default_rng(20261016)
    off, salt = (1 << 33) + 4096, (1 << 40) + 7
    errs = [check_pair(vk, integ, "256MiB", pattern_lanes(
        (256 << 20) // 4, off, salt), off, salt, rng)]
    woff, wsalt = U64 - (4 << 20) + 1, 12345  # base + 8i wraps mid-block
    errs.append(check_pair(vk, integ, "wrap past 2^64", pattern_lanes(
        (8 << 20) // 4, woff, wsalt), woff, wsalt, rng))
    odd_n = 3 * 32768 + 12345  # not a tile multiple, and odd
    errs.append(check_pair(vk, integ, "partial tile",
                           pattern_lanes(odd_n, 512, 9), 512, 9, rng))
    errs.append(check_pair(vk, integ, "start 8 mod 16", pattern_lanes(
        BLOCK // 4 + 3, off, salt, misalign=True), off, salt, rng))
    n_words = 256 * vk.PASS_WORDS + 777  # not a per-pass multiple, and odd
    errs.append(check_pair(vk, integ, "words not a per-pass multiple",
                           pattern_lanes(2 * n_words, off, salt), off, salt,
                           rng))
    errs.append(check_alternating(vk, integ, [torch.cuda.Stream()],
                                  "one stream"))
    errs.append(check_alternating(vk, integ, [torch.cuda.Stream(),
                                              torch.cuda.Stream()],
                                  "two streams"))
    return max(errs)


def graph_ms(call, bufs) -> float:
    """Device time per call: one CUDA graph of GRAPH_LAUNCHES calls, over
    `bufs` in turn, replayed and timed with CUDA events. The replay has no
    host work between launches, so this is the device's own rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, outside the graph
        for b in bufs[:2]:
            call(b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(GRAPH_LAUNCHES):
            call(bufs[i % len(bufs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = 5
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * GRAPH_LAUNCHES)


def events_ms(fn, iters: int) -> float:
    """Events around a host loop: for the plain version, whose many small
    launches are timed as the caller meets them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, loops: int = 5) -> float:
    """Host time per call: perf_counter over a loop, one final synchronise;
    the median of `loops` such loops (the host is shared and noisy)."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3 / iters)
    return sorted(per)[loops // 2]


def profiler_ms(call, bufs, name: str) -> float | None:
    """Kernel-only device time: the mean CUDA duration of the kernels named
    `name` that torch.profiler records over GRAPH_LAUNCHES host-launched
    calls; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(GRAPH_LAUNCHES):
            call(bufs[i % len(bufs)])
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and name in e.name]
    return sum(us) / len(us) / 1e3 if us else None


def bound_ms(nbytes: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = VERIFY_OPS_PER_BYTE * nbytes / ALU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernel(vk, integ, nbytes: int) -> dict:
    """Phase 4 at one size; returns the numbers of the kernel line."""
    off, salt = 1 << 20, 42
    n_lanes = nbytes // 4
    one = integ.fill_block_u32(n_lanes // 2, off, salt, "cuda")
    cold = [one] + [one.clone() for _ in range(max(2, COLD_BYTES // nbytes)
                                               - 1)]
    lib = vk.load_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ws = torch.zeros(lib.ebt_verify_workspace_bytes(sms) // 8,
                     dtype=torch.int64, device="cuda")  # zeroed once
    out = torch.empty(3, dtype=torch.int64, device="cuda")
    base = (off + salt) & U64

    def kernel(lanes):  # the bare launch; timing launches are not counted
        rc = lib.ebt_verify_u32(lanes.data_ptr(), n_lanes, base,
                                out.data_ptr(), ws.data_ptr(), sms,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"verify kernel launch failed ({rc})")

    def nonzero(lanes):
        torch.count_nonzero(lanes.view(torch.int64))

    def plain():  # both entry points' plain versions, as the kernel fuses
        integ.verify_block_lanes_plain(one, off, salt)
        integ.verify_block_u32(one, off, salt)

    raw = one.view(torch.uint8)
    # the host first: a profiler session leaves the launch path slower
    r = {"bytes": nbytes,
         "host": host_ms(lambda: vk.verify_block_u32(raw, off, salt), 2000),
         "warm": graph_ms(kernel, [one]), "cold": graph_ms(kernel, cold),
         "nz_warm": graph_ms(nonzero, [one]),
         "nz_cold": graph_ms(nonzero, cold),
         "plain": events_ms(plain, 5 if nbytes > (64 << 20) else 50),
         "prof_warm": profiler_ms(kernel, [one], "verify_u32_kernel"),
         "prof_cold": profiler_ms(kernel, cold, "verify_u32_kernel")}
    if int(out[1]) or int(out[2]) != n_lanes // 2:
        raise AssertionError(f"timed kernel saw bad words: {out.tolist()}")
    r["bound"], r["by"] = bound_ms(nbytes)

    def card(ms):
        if ms is None:
            return "not measured"
        return f"{ms:.6f} ms ({100 * r['bound'] / ms:.1f}% of bound)"

    phase("kernel-time", f"{nbytes >> 20} MiB: device L2-warm "
                         f"{card(r['warm'])}, L2-cold {card(r['cold'])}; "
                         f"kernel-only (torch.profiler) L2-warm "
                         f"{card(r['prof_warm'])}, L2-cold "
                         f"{card(r['prof_cold'])}; bound {r['bound']:.6f} ms ({r['by']}), wrapper "
                         f"host {r['host']:.6f} ms/call, plain "
                         f"{r['plain']:.6f} ms")
    phase("count-nonzero", f"{nbytes >> 20} MiB: torch.count_nonzero on the "
                           f"int64 view, device L2-warm {r['nz_warm']:.6f} "
                           f"ms, L2-cold {r['nz_cold']:.6f} ms")
    return r


def check_fill(fk, integ) -> int:
    """The fill kernel against the plain words on the card, each case in a
    buffer with a guard word on both sides; returns the largest absolute
    difference over the u32 lanes (0 when they agree)."""
    errs = []
    for name, n, skip, base in (
            ("offset 2^33+4096, salt 2^40+7", 1 << 16, 0,
             (1 << 33) + 4096 + (1 << 40) + 7),
            ("wrap past 2^64", 4097, 0, U64 - 8 * 2048 + 1),
            ("odd word count 1", 1, 0, 8),
            ("odd word count 3", 3, 0, 16),
            ("odd word count 12345", 12345, 0, 64 + 9),
            ("start 8 mod 16", 1 << 16, 1, 4096 + 42),
            ("start 8 mod 16, odd count", 4097, 1, 8192 + 5),
            ("256MiB", (256 << 20) // 8, 0, (1 << 20) + 42)):
        buf = torch.full((n + skip + 2,), -1, dtype=torch.int64,
                         device="cuda")
        out = buf[skip:skip + n]
        assert out.data_ptr() % 16 == 8 * skip
        fk.fill_u64_(out, base)
        want = integ.expected_words(n, base & U64, "cuda")
        torch.cuda.synchronize()
        diff = (out.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) - \
            (want.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
        err = int(diff.abs().max())
        guards = int((buf[:skip] != -1).sum() + (buf[skip + n:] != -1).sum())
        if err or guards:
            raise AssertionError(f"fill kernel {name}: max |kernel - plain| "
                                 f"{err}, {guards} guard words overwritten")
        phase("fill", f"{name}: {n} words kernel == plain")
        errs.append(err)
    return max(errs)


def time_fill(fk, integ, nbytes: int) -> dict:
    """The fill kernel's device time per launch (CUDA graph replay timed
    with events) at one size, the plain version's, and one torch.arange
    writing the same words (a library call computing the same function
    where the base does not wrap)."""
    n = nbytes // 8
    base = (1 << 20) + 42
    one = torch.empty(n, dtype=torch.int64, device="cuda")
    cold = [one] + [torch.empty_like(one) for _ in range(
        max(2, COLD_BYTES // nbytes) - 1)]
    lib = fk.load_lib()

    def kernel(buf):  # the bare launch; timing launches are not counted
        rc = lib.ebt_fill_u64(buf.data_ptr(), n, base,
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fill kernel launch failed ({rc})")

    def arange(buf):
        torch.arange(base, base + 8 * n, 8, dtype=torch.int64, out=buf)

    r = {"bytes": nbytes, "warm": graph_ms(kernel, [one]),
         "cold": graph_ms(kernel, cold), "lib": graph_ms(arange, [one]),
         "plain": events_ms(lambda: integ.fill_block_u32(n, base, 0, "cuda"),
                            5 if nbytes > (64 << 20) else 50)}
    if not torch.equal(one, integ.expected_words(n, base, "cuda")):
        raise AssertionError("timed fill kernel wrote wrong words")
    r["bound"] = nbytes / HBM_BYTES_PER_S * 1e3  # writes only: bytes-bound
    phase("fill-time", f"{nbytes >> 20} MiB: device {r['warm']:.6f} ms "
                       f"({100 * r['bound'] / r['warm']:.1f}% of bound), "
                       f"rotating over 128 MiB {r['cold']:.6f} ms; bound "
                       f"{r['bound']:.6f} ms (bytes), plain "
                       f"{r['plain']:.6f} ms, torch.arange {r['lib']:.6f} ms")
    return r


@contextlib.contextmanager
def scratch_dir(need_bytes: int):
    """A private directory on /dev/shm when it has room, else in the
    temporary directory; removed afterwards."""
    parent = tempfile.gettempdir()
    shm = "/dev/shm"
    if os.path.isdir(shm) and shutil.disk_usage(shm).free >= need_bytes:
        parent = shm
    d = tempfile.mkdtemp(prefix="ebt_torch_smoke_", dir=parent)
    phase("scratch", f"{d} ({shutil.disk_usage(d).free >> 30} GiB free)")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def read_csv(path: str) -> dict[str, dict[str, str]]:
    return {r["operation"]: r for r in csv.DictReader(open(path))}


def run_cli(cli, args: list[str]) -> tuple[int, str, str]:
    """Run the port's CLI in-process; returns (rc, what it wrote to stdout,
    what it wrote to stderr), both also passed through."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    sys.stdout.write(out.getvalue())
    sys.stderr.write(err.getvalue())
    return rc, out.getvalue(), err.getvalue()


def main_path(cli, d: str) -> None:
    """Phase 6: the README's storage -> GPU setting at 4 GiB, direct."""
    path, csvp = os.path.join(d, "f4g"), os.path.join(d, "p4.csv")
    t0 = time.perf_counter()
    rc, _, _ = run_cli(cli, ["-w", "-r", "-t", "4", "-s", "4G", "-b", "8M",
                          "--iodepth", "4", "--gpuids", "0", "--tpubackend",
                          "direct", "--lat", "--nolive", "--csvfile", csvp,
                          path])
    if rc != 0:
        raise AssertionError(f"4 GiB direct write+read: rc {rc}")
    rows = read_csv(csvp)
    for op in ("WRITE", "READ"):
        r = rows[op]
        if int(r["bytes last"]) != 4 << 30:
            raise AssertionError(f"{op}: moved {r['bytes last']} bytes")
        phase("main-path", f"{op} {int(r['MiB/s last']) / 1024:.3f} GiB/s, "
                           f"GPU 0 xfer p50 {r['tpu xfer lat p50 us']} us "
                           f"p99 {r['tpu xfer lat p99 us']} us "
                           f"(clock {r['tpu xfer lat clock']})")
    phase("main-path", f"4 GiB direct write+read took "
                       f"{time.perf_counter() - t0:.1f}s")


def flip_byte(path: str, off: int) -> None:
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x5A]))


def verify_run(cli, vk, d: str) -> int:
    """Phase 7: staged --verify with the chunk pinned to 2 MiB, clean, then
    with a corrupt byte inside a block's second chunk, then (that one
    repaired) one at the first byte of a block's second chunk. Returns the
    kernel launches of the clean run."""
    path, csvp = os.path.join(d, "f1g"), os.path.join(d, "v.csv")
    size = 1 << 30
    args = ["-t", "2", "-s", "1G", "-b", "4M", "--verify", "42", "--gpuids",
            "0", "--nolive", path]
    vk.reset_launches()
    rc, _, _ = run_cli(cli, ["-w", "-r", "--csvfile", csvp, *args])
    launched = sum(vk.LAUNCHES.values())
    if rc != 0 or launched != size // BLOCK:
        raise AssertionError(f"verify run: rc {rc}, {launched} kernel "
                             f"launches for {size // BLOCK} blocks read")
    rows = read_csv(csvp)
    phase("verify", f"clean 1 GiB staged --verify: rc 0, {launched} kernel "
                    f"launches for {size // BLOCK} blocks read; WRITE "
                    f"{rows['WRITE']['MiB/s last']} MiB/s, READ "
                    f"{rows['READ']['MiB/s last']} MiB/s")
    inside = 5 * BLOCK + CHUNK + 12345      # inside block 5's second chunk
    chunk_start = 7 * BLOCK + CHUNK         # block 7's second chunk, byte 0
    for corrupt, repair in ((inside, None), (chunk_start, inside)):
        if repair is not None:
            flip_byte(path, repair)
        flip_byte(path, corrupt)
        rc, _, err = run_cli(cli, ["-r", *args])
        want = f"on-device data verification failed at file offset {corrupt}"
        if rc != 1 or want not in err:
            raise AssertionError(f"corrupt run: rc {rc}, expected '{want}'")
        phase("verify", f"corrupt byte found: rc 1, '{want}'")
    return launched


def cli_read_gibs(cli, path: str, backend: str, d: str) -> float:
    """One read of `path` at the main setting through the CLI; GiB/s."""
    csvp = os.path.join(d, f"pair-{backend}.csv")
    if os.path.exists(csvp):
        os.remove(csvp)
    rc, _, _ = run_cli(cli, ["-r", *MAIN_ARGS, "--tpubackend", backend,
                          "--csvfile", csvp, path])
    if rc != 0:
        raise AssertionError(f"{backend} read: rc {rc}")
    return int(read_csv(csvp)["READ"]["MiB/s last"]) / 1024


def native_main_path(d: str) -> str:
    """Phase 8: the native engine's 4 GiB write + read at the main setting,
    through the worker group a program drives (the CLI's own layer), so
    the engine's tier, cache and d2h counters can be read. Returns the
    file's path."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    path = os.path.join(d, "f4g")
    cfg = config_from_args(["-w", "-r", *MAIN_ARGS, "--tpubackend", "pjrt",
                            path])
    group = LocalWorkerGroup(cfg)
    t0 = time.perf_counter()
    group.prepare()
    try:
        probe = "zero_copy" if group.plugin_caps()["dma_map"] else "staged"
        for op, ph in (("WRITE", BenchPhase.CREATEFILES),
                       ("READ", BenchPhase.READFILES)):
            group.start_phase(ph, "smoke")
            while not group.wait_done(1000):
                pass
            res = group.phase_results()
            errs = [r.error for r in res if r.error]
            moved = sum(r.ops.bytes for r in res)
            if errs or moved != 4 << 30:
                raise AssertionError(f"native {op}: {errs}, moved {moved}")
            secs = max(max(r.elapsed_us_list) for r in res) / 1e6
            h = group.device_latency()["0"]
            clock = group.device_latency_clock()["0"]
            phase("native", f"{op} {moved / secs / (1 << 30):.3f} GiB/s, "
                            f"GPU 0 xfer p50 {h.percentile_us(50.0)} us p99 "
                            f"{h.percentile_us(99.0)} us (clock {clock})")
        tier, d2h = group.data_path_tier(), group.d2h_tier()
        stats, cache = group.d2h_stats(), group.reg_cache_stats()
        if tier != probe:
            raise AssertionError(f"confirmed tier {tier} != probed {probe} "
                                 f"(registration cache {cache})")
        if d2h != "deferred" or stats["deferred_count"] <= 0:
            raise AssertionError(f"d2h ran {d2h}: {stats}")
        phase("native", f"tier {tier} (probe {probe}); registration cache "
                        f"{cache}; d2h {d2h}, {stats['deferred_count']} "
                        f"blocks deferred; 4 GiB native write+read took "
                        f"{time.perf_counter() - t0:.1f}s")
    finally:
        group.teardown()
    return path


def native_verify_run(cli, native, d: str) -> dict:
    """Phase 9: 1 GiB native --verify write + read; returns the engine's
    kernel launches of the clean run."""
    path, csvp = os.path.join(d, "n1g"), os.path.join(d, "nv.csv")
    size, salt = 1 << 30, 42
    args = ["-t", "2", "-s", "1G", "-b", "4M", "--verify", str(salt),
            "--gpuids", "0", "--tpubackend", "pjrt", "--nolive", path]
    native.reset_kernel_launches()
    rc, _, _ = run_cli(cli, ["-w", "-r", "--csvfile", csvp, *args])
    launches = native.kernel_launches()
    blocks = size // BLOCK
    if rc != 0 or launches != {"verify_u32": blocks, "fill_u64": blocks}:
        raise AssertionError(f"native verify run: rc {rc}, launches "
                             f"{launches} for {blocks} blocks each way")
    rng = np.random.default_rng(7)
    with open(path, "rb") as f:
        for off in [0, size - 8] + [8 * int(w) for w in
                                    rng.integers(0, size // 8, 64)]:
            f.seek(off)
            got = int.from_bytes(f.read(8), "little")
            if got != (off + salt) & U64:
                raise AssertionError(f"native write at {off}: word {got:#x}")
    rows = read_csv(csvp)
    phase("native-verify", f"clean 1 GiB: rc 0, engine launches {launches} "
                           f"for {blocks} blocks each way, 66 spot-checked "
                           f"words hold the pattern; WRITE "
                           f"{rows['WRITE']['MiB/s last']} MiB/s, READ "
                           f"{rows['READ']['MiB/s last']} MiB/s")
    corrupt = 9 * BLOCK + CHUNK + 4321
    flip_byte(path, corrupt)
    rc, _, err = run_cli(cli, ["-r", *args])
    want = f"on-device data verification failed at file offset {corrupt}"
    if rc != 1 or want not in err:
        raise AssertionError(f"native corrupt run: rc {rc}, expected "
                             f"'{want}'")
    phase("native-verify", f"corrupt byte found: rc 1, '{want}'")
    os.remove(path)
    return launches


def read_pairs(cli, path: str, d: str) -> None:
    """Phase 10: direct and native reads of the same file in turns."""
    for i in range(3):
        direct = cli_read_gibs(cli, path, "direct", d)
        nat = cli_read_gibs(cli, path, "pjrt", d)
        phase("pairs", f"pair {i}: READ direct {direct:.3f} GiB/s, native "
                       f"{nat:.3f} GiB/s")


def _step_row(out: dict) -> tuple[int, ...]:
    return tuple(int(out[k]) for k in ("ok_bytes", "bad_words",
                                       "first_bad_word", "checksum"))


def check_ingest(ik, integ) -> int:
    """Phase 11: the ingest kernel against its plain version on the same
    lanes on the card; returns the largest absolute difference over the
    four fields (0 when they agree)."""
    rng = np.random.default_rng(4)
    errs = []
    n64 = ENTRY_BLOCK // 4
    cases = [("64KiB clean", n64, 8192, 1234, [], False),
             ("64KiB corrupt first/last/random", n64, 8192, 1234,
              [0, n64 - 1, int(rng.integers(0, n64))], False),
             ("wrap past 2^64", (8 << 20) // 4, U64 - (4 << 20) + 1, 12345,
              [int(rng.integers(0, (8 << 20) // 4))], False),
             ("start 8 mod 16", BLOCK // 4 + 2, (1 << 33) + 4096,
              (1 << 40) + 7, [BLOCK // 4 + 1], True)]
    for name, n, off, salt, corrupt, misalign in cases:
        lanes = pattern_lanes(n, off, salt, misalign=misalign)
        for pos in corrupt:
            lanes[pos] ^= 0x00A5A500
        args = (*integ.split_u64(off), *integ.split_u64(salt))
        got = _step_row(ik.ingest_verify_step(lanes, *args))
        torch.cuda.synchronize()
        want = _step_row(integ.ingest_verify_step(lanes, *args))
        err = max(abs(g - w) for g, w in zip(got, want))
        if err or got[1] != len(set(p // 2 for p in corrupt)):
            raise AssertionError(f"ingest kernel {name}: kernel {got} != "
                                 f"plain {want}")
        phase("ingest", f"{name}: kernel == plain {got}")
        errs.append(err)
    salt = 42
    offs = [(1 << 30) + r * BLOCK for r in range(8)]
    blocks = torch.stack([pattern_lanes(BLOCK // 4, o, salt) for o in offs])
    blocks[6, 123457] ^= 0x10
    got = ik.ingest_verify_batch(blocks, offs, salt)
    torch.cuda.synchronize()
    want = integ.ingest_verify_batch_plain(blocks, offs, salt)
    err = int((got - want).abs().max())
    if err or int(got[:, 1].sum()) != 1 or int(got[6, 0]) != 0:
        raise AssertionError(f"ingest batch: kernel {got.tolist()} != "
                             f"plain {want.tolist()}")
    phase("ingest", f"8 ranks x 4 MiB, rank 6 corrupt: kernel == plain "
                    f"(bad words per rank {got[:, 1].tolist()})")
    errs.append(err)
    # smaller launches after a larger one on the same stream and workspace,
    # 100 bad words in rank 1's first CTA pass: each finds its tickets at 0
    blocks[1, 0:200:2] ^= 0x1000
    for sl in (slice(0, 8), slice(2, 3), slice(1, 3), slice(0, 4)):
        got = ik.ingest_verify_batch(blocks[sl], offs[sl], salt)
        torch.cuda.synchronize()
        want = integ.ingest_verify_batch_plain(blocks[sl], offs[sl], salt)
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"ingest batch ranks {sl}: kernel "
                                 f"{got.tolist()} != plain {want.tolist()}")
        errs.append(err)
    phase("ingest", "8, 1, 2 and 4 ranks in turn on one workspace, 100 bad "
                    "words in rank 1's first 16 KiB: kernel == plain")
    return max(errs)


def ingest_bound_ms(nbytes: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = INGEST_OPS_PER_BYTE * nbytes / ALU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ingest(ik, integ, ranks: int, rank_bytes: int) -> dict:
    """Phase 11 at one shape: device time per launch of the bare C entry
    (CUDA graph replay timed with events) with the data in L2 and out of it
    (buffers rotating over 128 MiB), the plain version, and one torch.sum
    over the same bytes."""
    salt = 42
    offs = [(1 << 20) + r * rank_bytes for r in range(ranks)]
    lanes = rank_bytes // 4
    one = torch.stack([integ.fill_block_u32(lanes // 2, o, salt, "cuda")
                       for o in offs])
    lib = ik.load_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ws = torch.zeros(lib.ebt_ingest_workspace_bytes(sms, ranks) // 8,
                     dtype=torch.int64, device="cuda")  # zeroed once
    bases = torch.tensor([o + salt for o in offs], dtype=torch.int64,
                         device="cuda")
    out = torch.empty((ranks, 4), dtype=torch.int64, device="cuda")

    def kernel(blocks):  # the bare launch; timing launches are not counted
        rc = lib.ebt_ingest_verify_u32(
            blocks.data_ptr(), lanes, ranks, lanes, bases.data_ptr(),
            out.data_ptr(), ws.data_ptr(), sms,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ingest kernel launch failed ({rc})")

    nbytes = ranks * rank_bytes
    cold = [one] + [one.clone() for _ in range(max(2, COLD_BYTES // nbytes)
                                               - 1)]
    r = {"bytes": nbytes, "warm": graph_ms(kernel, [one]),
         "cold": graph_ms(kernel, cold),
         "sum": graph_ms(lambda b: torch.sum(b.view(torch.int64)), [one]),
         "plain": events_ms(lambda: integ.ingest_verify_batch_plain(
             one, offs, salt), 5 if nbytes > (64 << 20) else 50)}
    want = integ.ingest_verify_batch_plain(one, offs, salt)
    if not torch.equal(out, want):
        raise AssertionError(f"timed ingest kernel: {out.tolist()} != "
                             f"{want.tolist()}")
    r["bound"], r["by"] = ingest_bound_ms(nbytes)
    phase("ingest-time", f"{ranks} x {rank_bytes >> 10} KiB: device L2-warm "
                         f"{r['warm']:.6f} ms "
                         f"({100 * r['bound'] / r['warm']:.1f}% of bound), "
                         f"L2-cold {r['cold']:.6f} ms "
                         f"({100 * r['bound'] / r['cold']:.1f}%); bound "
                         f"{r['bound']:.6f} ms ({r['by']}); plain "
                         f"{r['plain']:.6f} ms")
    phase("ingest-sum", f"{ranks} x {rank_bytes >> 10} KiB: torch.sum on the "
                        f"int64 view, device {r['sum']:.6f} ms")
    return r


def device_lists() -> list[list[torch.device]]:
    """[cuda:0], [cuda:0, cuda:0] (the gather and a multi-row sum on one
    card) and, with two or more cards, every card."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    lists = [cards[:1], [cards[0], cards[0]]]
    if len(cards) > 1:
        lists.append(cards)
    return lists


def check_reduce(mesh) -> int:
    """Phase 12: MeshStatsReducer's exact totals on each device list;
    returns the largest absolute difference (0 when exact)."""
    errs = []
    for devs in device_lists():
        n = len(devs)
        reducer = mesh.MeshStatsReducer(devs)
        for name, rows in (
                ("exactness", [[(1 << 40) + 977 * i, (1 << 33) * i + 3, i]
                               for i in range(n)]),
                ("repeat", [[1, 2, 3]] * n),
                ("2^63 and a wrap past 2^64",
                 [[(1 << 63) + d, U64 - d, (1 << 62) + d, 7]
                  for d in range(n)])):
            got = reducer.reduce(rows)
            want = [sum(r[c] for r in rows) & U64 for c in range(len(rows[0]))]
            err = max(abs(g - w) for g, w in zip(got, want))
            if err:
                raise AssertionError(f"reducer {name} on {devs}: {got} != "
                                     f"{want}")
            errs.append(err)
        phase("reduce", f"MeshStatsReducer over {[str(d) for d in devs]}: "
                        f"exact on 3 cases")
    return max(errs)


def time_reduce(ik, integ, n: int, k: int) -> dict:
    """Phase 12: one reduction launch on [n, k] rows (CUDA graph replay
    timed with events), the plain version, and torch.sum(rows, 0), which
    computes the same column sums mod 2^64."""
    rows = torch.from_numpy(np.random.default_rng(n * k).integers(
        0, U64, (n, k), dtype=np.uint64, endpoint=True).view(np.int64)).cuda()
    out = torch.empty(k, dtype=torch.int64, device="cuda")
    lib = ik.load_lib()

    def kernel(r):
        rc = lib.ebt_sum_rows_u64(r.data_ptr(), n, k, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sum_rows kernel launch failed ({rc})")

    r = {"warm": graph_ms(kernel, [rows]),
         "lib": graph_ms(lambda x: torch.sum(x, 0), [rows]),
         "plain": events_ms(lambda: integ.sum_rows_u64_plain(rows), 50)}
    if not torch.equal(out, integ.sum_rows_u64_plain(rows)):
        raise AssertionError("timed sum_rows kernel: wrong sums")
    nbytes = (n * k + k) * 8
    r["bound"] = max(nbytes / HBM_BYTES_PER_S, n * k / ALU_OPS_PER_S) * 1e3
    phase("reduce-time", f"[{n}, {k}] rows: device {r['warm']:.6f} ms "
                         f"(launch-bound; bytes bound {r['bound']:.9f} ms); "
                         f"plain {r['plain']:.6f} ms; torch.sum(rows, 0) "
                         f"{r['lib']:.6f} ms")
    return r


def slice_main_path(ik, integ, mesh, graft_entry) -> dict:
    """Phase 13: entry()'s step, run_sharded_ingest and a MeshStatsReducer
    reduction on the card, with the launch counts of exactly this run."""
    ik.reset_launches()  # count only this phase's launches
    fn, args = graft_entry.entry()
    if args[0].device.type != "cuda":
        raise AssertionError(f"entry() put its block on {args[0].device}")
    got = _step_row(fn(*args))
    want = _step_row(integ.ingest_verify_step(args[0].cpu(), *args[1:]))
    if got != want or got[1] or got[0] != ENTRY_BLOCK:
        raise AssertionError(f"entry(): kernel {got} != plain {want}")
    phase("graft", f"entry() on {args[0].device}: fn(*args) == plain {got}")
    steps, launches_b4 = 0, 1
    salt = 42
    for devs in device_lists():
        n = len(devs)
        ranks = 2 * n
        offs = np.array([(5 << 30) + r * BLOCK for r in range(ranks)],
                        dtype=np.uint64)  # real file offsets: past 2^32
        words = np.arange(BLOCK // 8, dtype=np.uint64) * np.uint64(8)
        blocks = np.stack([(words + o + np.uint64(salt)).view(np.uint32)
                           for o in offs])
        blocks[-1, 99999] ^= 0x1  # the last rank is corrupt
        out = mesh.run_sharded_ingest(devs, blocks, offs, salt)
        steps += 1
        launches_b4 += n
        want_ok = float((ranks - 1) * BLOCK)
        if (float(out["bad_words"]) != 1.0 or float(out["iops"]) != ranks
                or float(out["ok_bytes"]) != want_ok):
            raise AssertionError(f"sharded ingest on {devs}: {out}")
        per_dev = [[BLOCK * 2, 2, d] for d in range(n)]
        tot = mesh.MeshStatsReducer(devs).reduce(per_dev)
        steps += 1
        if tot != [BLOCK * 2 * n, 2 * n, n * (n - 1) // 2]:
            raise AssertionError(f"reducer on {devs}: {tot}")
        phase("graft", f"run_sharded_ingest over {[str(d) for d in devs]}: "
                       f"{ranks} ranks x 4 MiB, {out}")
    launches = dict(ik.LAUNCHES)
    if launches != {"ingest_verify_u32": launches_b4, "sum_rows_u64": steps}:
        raise AssertionError(f"slice main path launches {launches}, want "
                             f"{launches_b4} ingest and {steps} reductions")
    phase("graft", f"launches: {launches} (one ingest per device and step "
                   f"plus entry()'s, one reduction per step and reduce)")
    return launches


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http_json(url: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def port_services(d: str, n: int = 2):
    """n port service subprocesses on the card, stopped afterwards."""
    import urllib.request
    ports = [_free_port() for _ in range(n)]
    logs = [open(os.path.join(d, f"svc{p}.log"), "w") for p in ports]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "elbencho_tpu_torch.cli", "--service",
         "--foreground", "--port", str(p)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log, stderr=subprocess.STDOUT) for p, log in zip(ports, logs)]
    try:
        deadline = time.monotonic() + 120
        for p in ports:
            while True:
                try:
                    urllib.request.urlopen(f"http://127.0.0.1:{p}/info",
                                           timeout=2).read()
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"service on port {p} not up")
                    time.sleep(0.2)
        yield ports
    except BaseException:
        for p, log in zip(ports, logs):
            log.flush()
            tail = open(log.name).read()[-3000:]
            print(f"service {p} log tail:\n{tail}", file=sys.stderr)
        raise
    finally:
        for pr in procs:
            pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=20)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
        for log in logs:
            log.close()


def distributed_run(cli, d: str) -> None:
    """Phase 14: two port services and a port master on the card."""
    import urllib.request
    path, size = os.path.join(d, "dist"), DIST_SIZE
    t0 = time.perf_counter()
    with port_services(d) as ports:
        phase("dist", f"2 port services up on ports {ports} in "
                      f"{time.perf_counter() - t0:.1f}s")
        hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
        base = ["--hosts", hosts, "-t", "2", "-s", f"{size >> 20}M", "-b", "4M",
                "--verify", "42", "--gpuids", "0", "--nolive"]
        for backend, extra in (("staged", []), ("pjrt", ["--lat"])):
            csvp = os.path.join(d, f"dist-{backend}.csv")
            rc, out, _ = run_cli(cli, ["-w", "-r", *base, "--tpubackend",
                                           backend, *extra, "--csvfile",
                                           csvp, path])
            if rc != 0:
                raise AssertionError(f"distributed {backend}: rc {rc}")
            rows = read_csv(csvp)
            for op in ("WRITE", "READ"):
                if int(rows[op]["bytes last"]) != size:
                    raise AssertionError(f"distributed {backend} {op}: "
                                         f"{rows[op]['bytes last']} bytes")
            totals = [ln.split()[-1] for ln in out.splitlines()
                      if "Total MiB" in ln]
            if totals != [str(size >> 20)] * 2:
                raise AssertionError(f"Total MiB rows {totals}")
            if backend == "pjrt":
                for p in ports:
                    want = f"TPU 127.0.0.1:{p}:0 xfer lat us"
                    rows_p = [ln for ln in out.splitlines() if want in ln]
                    if len(rows_p) != 2 or not all("clock=onready" in ln
                                                   for ln in rows_p):
                        raise AssertionError(f"per-chip rows of {p}: "
                                             f"{rows_p}")
            phase("dist", f"{backend} --verify {size >> 20} MiB through 2 "
                          f"services: "
                          f"WRITE {int(rows['WRITE']['MiB/s last']) / 1024:.3f}"
                          f" GiB/s, READ "
                          f"{int(rows['READ']['MiB/s last']) / 1024:.3f} GiB/s")
        # rank 3 (the second service's second thread) reads the last quarter
        bad = 3 * (size // 4) + size // 8 + 12345
        flip_byte(path, bad)
        rc, _, err = run_cli(cli, ["-r", *base, "--tpubackend", "staged",
                                       path])
        framed = f"service 127.0.0.1:{ports[1]}: worker failed"
        history = _http_json(f"http://127.0.0.1:{ports[1]}/benchresult"
                             ).get("ErrorHistory") or []
        want = f"on-device data verification failed at file offset {bad}"
        if rc != 1 or framed not in err or not any(want in ln
                                                   for ln in history):
            raise AssertionError(f"corrupt distributed read: rc {rc}, "
                                 f"history {history}")
        phase("dist", f"corrupt byte: rc 1, '{framed}', service reports "
                      f"'{want}'")
        for p in ports:
            with urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics",
                                        timeout=30) as r:
                if r.status != 200 or b"ebt_scrape_ok 1" not in r.read():
                    raise AssertionError(f"/metrics of {p}")
        phase("dist", "/metrics answers 200 (ebt_scrape_ok 1) on both")
        if torch.cuda.device_count() >= 2:
            rc, _, _ = run_cli(cli, [
                "--hosts", hosts, "-w", "-r", "-t", "2", "-s",
                f"{size >> 20}M", "-b", "4M", "--gpuids", "0,1",
                "--tpubackend", "staged",
                "--nolive", path])
            for p in ports:
                sl = _http_json(f"http://127.0.0.1:{p}/benchresult")
                if rc != 0 or sl["SliceOps"]["NumDevices"] != 2 or \
                        sl["SliceOps"]["Reduction"] != "psum":
                    raise AssertionError(f"slice tier on {p}: rc {rc}, {sl}")
            phase("dist", "slice tier: SliceOps reduced over 2 devices on "
                          "both services")
        else:
            phase("dist", "slice tier not run: it needs two devices and "
                          "this machine has one card")
        cli.main(["--hosts", hosts, "--quit"])
    phase("dist", f"distributed phase took {time.perf_counter() - t0:.1f}s")



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from elbencho_tpu_torch import cli, engine, graft_entry
    from elbencho_tpu_torch.cuda import native
    from elbencho_tpu_torch.ops import fill_kernel as fk
    from elbencho_tpu_torch.ops import ingest_kernel as ik
    from elbencho_tpu_torch.ops import integrity as integ
    from elbencho_tpu_torch.ops import kernel_build
    from elbencho_tpu_torch.ops import verify_kernel as vk
    from elbencho_tpu_torch.parallel import mesh

    card = gpu_name_and_power()
    print(card, flush=True)
    build_all(engine, kernel_build, (vk, fk, ik))

    max_err = check_kernel(vk, integ)
    times = {n: time_kernel(vk, integ, n) for n in TIME_SIZES}
    at_block = times[BLOCK]
    fill_err = check_fill(fk, integ)
    fill_times = {n: time_fill(fk, integ, n) for n in FILL_SIZES}
    fill_at_block = fill_times[BLOCK]
    ingest_err = check_ingest(ik, integ)
    ingest_times = {shape: time_ingest(ik, integ, *shape) for shape in (
        (1, ENTRY_BLOCK), (1, BLOCK), (2, BLOCK), (8, BLOCK),
        (1, 256 << 20))}
    ingest_main = ingest_times[(2, BLOCK)]  # one device's launch, phase 13
    reduce_err = check_reduce(mesh)
    reduce_main = time_reduce(ik, integ, 4, 4)  # phase 13's gathered rows
    time_reduce(ik, integ, 2, 5)  # the slice tier's: 2 devices x 5 counters

    with scratch_dir(2 * (4 << 30)) as d:
        vk.reset_launches()  # count only the main path's launches
        main_path(cli, d)
        os.environ["EBT_TPU_CHUNK_BYTES"] = str(CHUNK)
        try:
            staged_launches = verify_run(cli, vk, d)
        finally:
            del os.environ["EBT_TPU_CHUNK_BYTES"]
        fk.reset_launches()
        path = native_main_path(d)
        launches = native_verify_run(cli, native, d)
        if fk.LAUNCHES["fill_block_u32"]:
            raise AssertionError("the fill wrapper launched on the native "
                                 "path; the engine launches from C++")
        read_pairs(cli, path, d)
        os.remove(path)
        slice_launches = slice_main_path(ik, integ, mesh, graft_entry)
        distributed_run(cli, d)
    phase("launches", f"staged --verify run: {staged_launches} verify "
                      f"launches (Python wrapper); native --verify run: "
                      f"{launches} (C++ engine); slice path: "
                      f"{slice_launches}")

    print(json.dumps({"kernels": [{
        "name": "verify_u32",
        "route": "cuda",
        "source": "elbencho_tpu_torch/csrc/verify.cu",
        "replaces": "elbencho_tpu/ops/pallas_verify.py:63",
        "launches": launches["verify_u32"],
        "max_abs_err": max_err,
        "ms": at_block["warm"],
        "plain_ms": at_block["plain"],
        "bound_ms": at_block["bound"],
        "bound_by": at_block["by"],
        "library_ms": None,
    }, {
        "name": "fill_u64",
        "route": "cuda",
        "source": "elbencho_tpu_torch/csrc/fill.cu",
        "replaces": "elbencho_tpu/ops/integrity.py:59",
        "launches": launches["fill_u64"],
        "max_abs_err": fill_err,
        "ms": fill_at_block["warm"],
        "plain_ms": fill_at_block["plain"],
        "bound_ms": fill_at_block["bound"],
        "bound_by": "bytes",
        "library_ms": fill_at_block["lib"],
    }, {
        "name": "ingest_verify_u32",
        "route": "cuda",
        "source": "elbencho_tpu_torch/csrc/ingest.cu",
        "replaces": "elbencho_tpu/ops/integrity.py:74",
        "launches": slice_launches["ingest_verify_u32"],
        "max_abs_err": ingest_err,
        "ms": ingest_main["warm"],
        "plain_ms": ingest_main["plain"],
        "bound_ms": ingest_main["bound"],
        "bound_by": ingest_main["by"],
        "library_ms": None,
    }, {
        "name": "sum_rows_u64",
        "route": "cuda",
        "source": "elbencho_tpu_torch/csrc/mesh_reduce.cu",
        "replaces": "elbencho_tpu/parallel/mesh.py:95",
        "launches": slice_launches["sum_rows_u64"],
        "max_abs_err": reduce_err,
        "ms": reduce_main["warm"],
        "plain_ms": reduce_main["plain"],
        "bound_ms": reduce_main["bound"],
        "bound_by": "bytes",
        "bound_note": "launch-bound: bound_ms is the bytes bound of a few "
                      "hundred bytes; a launch sets the time",
        "library_ms": reduce_main["lib"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
