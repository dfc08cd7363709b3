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
     printed as measurements (nothing asserted or claimed).

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


def run_cli(cli, args: list[str]) -> tuple[int, str]:
    """Run the port's CLI in-process; returns (rc, what it wrote to
    stderr), which is also passed through."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    sys.stderr.write(err.getvalue())
    return rc, err.getvalue()


def main_path(cli, d: str) -> None:
    """Phase 6: the README's storage -> GPU setting at 4 GiB, direct."""
    path, csvp = os.path.join(d, "f4g"), os.path.join(d, "p4.csv")
    t0 = time.perf_counter()
    rc, _ = run_cli(cli, ["-w", "-r", "-t", "4", "-s", "4G", "-b", "8M",
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
    rc, _ = run_cli(cli, ["-w", "-r", "--csvfile", csvp, *args])
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
        rc, err = run_cli(cli, ["-r", *args])
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
    rc, _ = run_cli(cli, ["-r", *MAIN_ARGS, "--tpubackend", backend,
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
    rc, _ = run_cli(cli, ["-w", "-r", "--csvfile", csvp, *args])
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
    rc, err = run_cli(cli, ["-r", *args])
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from elbencho_tpu_torch import cli, engine
    from elbencho_tpu_torch.cuda import native
    from elbencho_tpu_torch.ops import fill_kernel as fk
    from elbencho_tpu_torch.ops import integrity as integ
    from elbencho_tpu_torch.ops import kernel_build
    from elbencho_tpu_torch.ops import verify_kernel as vk

    card = gpu_name_and_power()
    print(card, flush=True)
    build_all(engine, kernel_build, (vk, fk))

    max_err = check_kernel(vk, integ)
    times = {n: time_kernel(vk, integ, n) for n in TIME_SIZES}
    at_block = times[BLOCK]
    fill_err = check_fill(fk, integ)
    fill_times = {n: time_fill(fk, integ, n) for n in FILL_SIZES}
    fill_at_block = fill_times[BLOCK]

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
    phase("launches", f"staged --verify run: {staged_launches} verify "
                      f"launches (Python wrapper); native --verify run: "
                      f"{launches} (C++ engine)")

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
