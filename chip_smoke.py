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
 10. direct and native reads of the 4 GiB file in turns, one pair,
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
     2^64) and time one launch beside one torch.sum(rows, 0) and one launch
     of an empty kernel of the same block shape (the launch floor);
 13. the slice's main path: entry()'s step on the card, run_sharded_ingest
     over each device list (2 ranks of 4 MiB per device at real file
     offsets, one rank corrupt) and a MeshStatsReducer reduction of its
     per-device counters; exactly one ingest launch per device and step,
     one reduction launch per step and reduce;
 14. distributed service mode on the card: two port services (subprocesses,
     --gpuids 0) and a port master on a 1 GiB file in /dev/shm, staged
     --verify write + read, then the native engine (--tpubackend pjrt
     --lat): totals equal to the file, host-prefixed per-chip rows, a
     corrupt byte failing the run framed by the host whose service reports
     its exact offset, /metrics answering; with two or more cards the slice
     tier (--gpuids 0,1, SliceOps reduced over two devices);
 15. the native stripe tier on two lanes of the card (--gpuids 0,0): the
     first 2 GiB of the 4 GiB file read with --stripe rr, then contig
     (tier "striped", one settled unit per block, the lanes' bytes as the
     planner places them, GiB/s and p50/p99 per lane);
 16. a 1 GiB native --verify write + read with --stripe rr over two lanes:
     one C++ fill launch per block written and one verify launch per block
     read on the lane the planner chose, a corrupt byte at its exact offset;
 17. the staged and direct placements over two lanes (the --stripe mesh
     fallback, direct --tpustripe on its default two submitters, direct
     with EBT_TPU_SUBMITTERS=2, direct inline): half the file on each lane,
     GiB/s beside a probe of whether a pageable copy releases the GIL; then
     1 GiB staged --tpustripe --verify, one verify launch per 2 MiB chunk on
     its own lane and a corrupt byte at its exact offset;
 18. checkpoint restore at the shard layout of meta-llama/Llama-3.1-8B
     (four files, 16.1 GB, written to /dev/shm from a seeded generator):
     every shard on device 0, then over --gpuids 0,0 with one shard
     replicated, then a generated 8 x 256 MiB checkpoint; every shard
     resident, bytes per device as the manifest places them;
 19. device faults on two lanes of the card (runs right after phase 15):
     the 4 GiB file read with --stripe rr over --gpuids 0,0 three times,
     clean, clean with --retry 1 --maxerrors 5%, and with lane 1
     force-ejected after the first quarter of the blocks: one ejection with
     its cause, replanned units, the stripe ledger reconciled, no block
     placed on lane 1 after the ejection, the lanes' bytes adding up to
     the file;
     GiB/s of the three passes; no kernel launched;
 20. the N->M reshard (runs inside phase 18, on its shard files): the
     Llama-3.1-8B layout with shard i on lane i mod 2 of --gpuids 0,0,
     resharded onto one lane (--reshard 1), device to device and then with
     EBT_D2D_DISABLE=1 through the host bounce: tier d2d then bounce,
     d2d_submitted == d2d_resident == the plan's move bytes, the pair
     matrix equal to the plan's moves; RESHARD GiB/s and the time until all
     is resharded;
 21. serving rotation (runs inside phase 18): open-loop serving reads of a
     1 GiB file (-t 4 -b 64K, a steady trace of 56 arrivals/s per worker)
     while the Llama-3.1-8B shards are rotated onto device 0 every second
     (--rotate 1, unthrottled, at least two swaps), then one pass without
     rotation, then rotation of the generated 8 x 256 MiB checkpoint with
     --bgbudget at half of the first run's restore rate: every swapped
     record reconciled (4 shards, 16060556376 bytes; released == the
     previous record's retained), free device memory falling by a
     generation while one is resident and coming back after the teardown,
     sampled ranges of every shard read back from device memory equal to
     the files, the tenant ledger exact, throttle evidence under the
     budget, no kernel launched; TTR per rotation, READ GiB/s and p99 with
     and without rotation;
 22. DL ingestion: a generated 16 x 256 MiB dataset in /dev/shm read as
     32768 records of 128 KiB in 4 MiB batches over two epochs with a
     1024-record shuffle window (-t 4, tier pipelined), then the serial
     control (-t 1 --prefetchbatches 1): per epoch every record read and
     resident and none dropped, the lanes' bytes equal to the dataset times
     the epochs, no kernel launched; GiB/s and records/s per epoch;
 23. the transfer-manager tier (EBT_PJRT_XFER_MGR=1, one cuMemAllocAsync
     device buffer per block; a tier requested and not active fails the
     phase with its cause): phase 8's 4 GiB file read at phase 8's
     settings (runs right after it), the tier active and confirmed, one
     block counted and one latency sample per block, the device bytes equal
     to the file, no kernel launched, free device memory back within
     256 MiB after the teardown, GiB/s and p50/p99 beside phase 8's chunked
     read; phase 9's 1 GiB --verify read with the tier requested (inside
     phase 9): one verify launch per block and no block on the tier, a
     corrupt byte at its exact offset; one rotation of phase 18's generated
     8 x 256 MiB checkpoint on the tier under phase 21's serving traffic
     (inside phase 18): every record reconciled, retained_buffers equal to
     the generation's blocks, sampled ranges read back equal to the files;
 24. --chaos on the card (runs after phase 23): the first 1 GiB of phase
     8's file read on the native engine into its I/O buffers
     (EBT_TPU_NO_MMAP=1) with --iodepth 4 and --arrival paced, the
     storage engine's seams armed at p = 1 (aio: the first
     io_setup refused and retried, visible in aio_setup_retries on a host
     without io_uring; reactor: the second worker's eventfd bridge fails,
     visible as the reactor's cause), the bytes landing exactly; then a
     mock-driver seam (submit=1.0) armed against the real driver: the
     INERT warning names it and the read is clean; no kernel launched;
 25. a campaign on the card (runs after phase 24, in its own directory
     under /dev/shm): tools/torch_campaign.py on the real driver (no
     --mock) over a spec of five stages on two lanes (--gpuids 0,0): a
     4 GiB --verify fill (-b 8M --iodepth 4), the same file read with
     --stripe rr --verify and --retry 1 --maxerrors 5%, a generated
     4 x 1 GiB restore, 10 s of open-loop reads (-b 64K, 500 arrivals/s
     per worker) with the reactor seam armed, a generated 8 x 512 MiB
     checkpoint resharded onto one lane. Exit 0, every invariant held, the
     two mock-only ones recorded as skipped; the engine's launches counted
     per stage (B3 once per block in the fill, B1 once per block in the
     verified read, none elsewhere); the confirmed tier of the read
     stages, the verified read's lane bytes in halves, no ejection, the
     reactor's cause; each stage's time and GiB/s, the open-loop p99 and
     the report's fingerprint.
 26. the in-session raw transport ceilings (runs inside phase 8, on its
     worker group between its phases, at its settings: 4 GiB, 2 MiB
     chunks): the host-to-device ceiling on the confirmed tier with one
     submitter (16 chunks in flight, phase 8's -t 4 --iodepth 4 x 8 MiB
     blocks per worker) and with four (the -t 4 denominator), probe_tier()
     equal to the confirmed tier, the device-to-host ceiling (one block's
     4 chunks in flight), phase 8's READ and WRITE as shares of them; the
     path's transferred bytes and the engine's kernel launches unmoved and
     raw_last_error() empty; a second group with EBT_PJRT_NO_DMAMAP=1 whose
     ceiling lands on the staged rung; then the standalone probe
     (build/torch_core/cuda_probe, built on first use) in both modes. Inside
     phase 20, on its reshard group (two lanes of the card), the
     device-to-device ceiling lane 1 -> lane 0 beside the RESHARD rate, and
     the refusals for src == dst and under EBT_D2D_DISABLE=1;
     tools/torch_multicard.py measures it between cards 0 and 1.
 27. the port's native selftest on the card (runs after phase 25; built in
     phase 2 beside the engine): csrc/cuda_selftest.cpp, plain build, every
     scope against libcuda.so.1 and the nvcc-built kernel library on four
     lanes of device 0, one process per scope: every check passed, the
     checks that need the mock driver's seams or counters counted and not
     run, the path scope's B1 and B3 launched from C++ (3 verify, 1 fill),
     the kernels scope's four entries held against plain host loops; one
     line per scope with its checks, its time and its launches. Then the
     kernels and path scopes under compute-sanitizer (memcheck, racecheck,
     synccheck) with 0 errors required; where the tool is missing, or
     refuses the card ("Device not supported"), the line says so and no
     pass is claimed. Phase 27 alone:
       python3 -c "import chip_smoke as c; c.selftest_on_card()"
 28. the port's headline bench (elbencho_tpu_torch/bench.py, runs after
     phase 27) in a child process against libcuda.so.1, its pair counts
     shrunk through module attributes (NUM_PAIRS 4, WRITE_PAIRS 5,
     RAND_PAIRS 3, MIN_READ_PAIRS 2), every other constant the bench's
     own, and its ledger in a temp dir. Its thirteen legs, in the bench's
     order: write, read, random, scale, stripe, checkpoint, metadata,
     io_uring A/B, offered load, serving under rotation, faults, ingest
     and reshard. Checks: rc 0, backend pjrt with no fallback, tier
     zero_copy with no mismatch, no wedge, read and write in (0, 1.05] of
     their in-session ceilings, random IOPS, the scale and checkpoint legs
     clean, the stripe and reshard legs run or skipped with their note,
     the metadata leg clean above 0 of its raw-syscall ceiling, the
     io_uring leg on aio with its cause (where the host has io_uring:
     uring with a ratio, or the original's engagement refusal, printed
     beside the host's kernel), the load leg clean with a monotone curve
     and a byte-identical A/B, the serving leg clean with its engagement
     confirmed, the faults leg's mock-only skip, the ingest leg clean
     (tier pipelined or serial, records/s above 0), and no kernel
     launched; one line per leg with its rates, ratios and device
     p50/p99, and the spread of each paired leg's graded pairs (from its
     --raw lines). Phase 28 alone:
       python3 -c "import chip_smoke as c; c.bench_on_card()"
 29. the direct backend's three error paths on the card (runs after phase
     28, in a child process under a time limit of its own, so a hang fails
     the phase instead of the run): a TorchStagingPath on cuda:0 whose copy
     fails through its _copy_to_device seam, as
     tests/test_torch_regressions.py fails it on the CPU. A copy failure in
     the submitter thread (EBT_TPU_SUBMITTERS=1) is accepted at submit
     (rc 0) and comes back at the pre-reuse barrier as rc 1; an inline
     partial failure (2 chunks per block, the second copy raising) fails
     the submit with rc 1 and registers the first chunk, a real copy onto
     the card, which the barrier then waits out (rc 0, its bytes equal the
     block's first chunk); an inline failure fails the submit (rc 1) and
     leaves a clean barrier (rc 0). One line with each case's codes and
     the phase's time. Phase 29 alone:
       python3 -c "import chip_smoke as c; c.direct_errors_on_card()"
 30. the port's examples harness on the card (runs after phase 29):
     tools/torch_test_examples.sh --card -b in a child process under a
     time limit of its own (300 s): the multi-file tier, the tooling tier
     (the port's chart launcher and storage sweep), the native tier
     (--tpubackend pjrt on libcuda.so.1 with --gpuids 0, the default tier
     and the transfer-manager tier), two localhost services, four services
     on the native path with the --start barrier and a time-limited phase,
     and the slice-stats tier on two CPU devices, without loop devices.
     Every tier must pass; one line with each tier's verdict and seconds.
     Phase 30 alone:
       python3 -c "import chip_smoke as c; c.examples_on_card()"
 31. the installed port on the card (runs after phase 30, 300 s limit):
     `make torch` (the engine, the mock driver and the copy probe with g++,
     the kernel library with nvcc, copied into elbencho_tpu_torch/_prebuilt/),
     then elbencho_tpu_torch/ alone copied into a temporary directory outside
     the repository, with no core/ and no build/ beside it. A child process
     whose sys.path holds only that copy of the repository's files runs a
     1 GiB --tpubackend pjrt --verify 42 --gpuids 0 write + read through the
     CLI: rc 0, one fill and one verify launch per 4 MiB block from C++ (the
     engine's counters, as in phase 9), then a flipped byte reported at its
     exact offset; no compiler is started (the child records every process
     it starts), no build/ appears beside the copy, and the engine and
     kernel libraries mapped in the child are the copy's _prebuilt/ files.
     Then tools/torch_record_distributed_evidence.sh (two port services and
     a master, --tpubackend pjrt --gpuids 0) must end with the master's rc 0;
     what it wrote is removed. One line with the phase's seconds, the
     `make torch` build time and the launches. Phase 31 alone:
       python3 -c "import chip_smoke as c; c.installed_on_card()"

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
import platform
import re
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
DIST_SIZE = 1 << 30         # the distributed runs' file
COLD_BYTES = 128 << 20      # rotating buffers, 2.5x the 50 MB L2
GRAPH_LAUNCHES = 200
STRIPE_READ = ["-t", "4", "-b", "8M", "--iodepth", "4", "--tpubackend",
               "pjrt", "--lat", "--nolive"]
# meta-llama/Llama-3.1-8B, model-0000{1..4}-of-00004.safetensors (bf16)
LLAMA_8B_SHARDS = (4976698672, 4999802720, 4915916176, 1168138808)
SERVE_BYTES = 1 << 30       # the serving file
SERVE_RATE = 56             # arrivals/s per worker: 14 MiB/s over 4 workers
SERVE_SECS = 70             # the rotation run (two swaps at up to 34 s of
                            # TTR each); the 1 GiB lasts 73 s
PLAIN_SECS = 10             # the pass without rotation
CEILING_BYTES = 4 << 30     # phase 26's windows: phase 8's file
SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck")
SANITIZED_SCOPES = ("kernels", "path")
INGEST_ARGS = ["--ingestshards", "16", "-s", "256M", "--recordsize", "128K",
               "-b", "4M", "--epochs", "2", "--shufflewindow", "1024",
               "--tpubackend", "pjrt", "--nolive"]


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_all(engine, kernel_build, wrappers) -> None:
    """The engine (g++), the kernel library (one nvcc per source) and the
    native selftest (g++) in parallel, then the wrappers' bindings."""
    from elbencho_tpu_torch import selftest

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(3) as pool:
        core = pool.submit(timed, engine.load_lib)
        kern = pool.submit(timed, kernel_build.build_lib)
        test = pool.submit(timed, selftest.build)
        phase("build", f"engine build/torch_core/libebtcore.so "
                       f"{core.result():.1f}s, kernels "
                       f"build/torch_kernels/libebt_torch_kernels.so "
                       f"{kern.result():.1f}s, selftest "
                       f"build/torch_core/cuda_selftest "
                       f"{test.result():.1f}s")
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
    errs.append(check_pair(vk, integ, "2 MiB chunk (staged --tpustripe)",
                           pattern_lanes(CHUNK // 4, 5 * BLOCK + CHUNK, 42),
                           5 * BLOCK + CHUNK, 42, rng))
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
    file's path and the read's GiB/s, p50 and p99."""
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
            if op == "WRITE":
                write_gibs = moved / secs / (1 << 30)
            read = {"gibs": moved / secs / (1 << 30),
                    "p50": h.percentile_us(50.0),
                    "p99": h.percentile_us(99.0)}
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
        raw_ceilings(group, read["gibs"], write_gibs, path)
    finally:
        group.teardown()
    return path, read


def raw_ceilings(group, read_gibs: float, write_gibs: float,
                 path: str) -> None:
    """Phase 26, on phase 8's group between its phases: the in-session raw
    transport ceilings at phase 8's settings, phase 8's rates as shares of
    them, the ladder under EBT_PJRT_NO_DMAMAP=1 on a second group, and the
    standalone probe. Nothing here may move the path's own counters."""
    from elbencho_tpu_torch import engine
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.cuda import native
    from elbencho_tpu_torch.exceptions import ProgException
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    card = gpu_name_and_power()
    np_ = group._native_path
    tier = group.data_path_tier()
    before = (np_.transferred_bytes, native.kernel_launches())
    # phase 8's transfers: 2 MiB chunks, per worker --iodepth 4 blocks of
    # 8 MiB in flight (16 chunks); its write fetches one block's 4 chunks
    # at a time; the windows move the phase's bytes
    total, depth_h2d, depth_d2h = CEILING_BYTES, 16, 4
    t0 = time.perf_counter()
    h2d1 = group.native_raw_ceiling(total, depth_h2d, chunk_bytes=CHUNK)
    tier1 = group.probe_tier()
    h2d4 = group.native_raw_ceiling(total, depth_h2d, chunk_bytes=CHUNK,
                                    streams=4)
    tier4 = group.probe_tier()
    d2h = group.native_raw_ceiling(total, depth_d2h, direction="d2h",
                                   chunk_bytes=CHUNK)
    secs = time.perf_counter() - t0
    after = (np_.transferred_bytes, native.kernel_launches())
    err = np_.raw_last_error()
    if (min(h2d1, h2d4, d2h) <= 0 or tier1 != tier or tier4 != tier
            or before != after or err):
        raise AssertionError(
            f"raw ceilings: h2d {h2d1}/{h2d4} MiB/s on {tier1}/{tier4} "
            f"(confirmed {tier}), d2h {d2h}, counters {before} -> {after}, "
            f"raw error '{err}'")
    try:
        group.native_raw_d2d_ceiling(1 << 30, src_device=0, dst_device=0)
        raise AssertionError("a d2d ceiling from a lane onto itself ran")
    except ProgException as e:
        if "src/dst must be distinct in-range device indices" not in str(e):
            raise
    phase("ceilings", f"{card}: H2D {h2d1:.1f} MiB/s (1 submitter), "
                      f"{h2d4:.1f} MiB/s (4 submitters) on tier {tier1} "
                      f"(probe_tier; confirmed {tier}); D2H {d2h:.1f} MiB/s;"
                      f" {total >> 30} GiB each, 2 MiB chunks, "
                      f"{secs:.1f}s for the three; transferred bytes and "
                      f"kernel launches unmoved")
    phase("ceilings", f"{card}: phase 8 READ {read_gibs:.3f} GiB/s = "
                      f"{100 * read_gibs * 1024 / h2d4:.1f}% of the 4-"
                      f"submitter H2D ceiling "
                      f"({100 * read_gibs * 1024 / h2d1:.1f}% of 1); WRITE "
                      f"{write_gibs:.3f} GiB/s = "
                      f"{100 * write_gibs * 1024 / d2h:.1f}% of the D2H "
                      f"ceiling")
    with env_set(EBT_PJRT_NO_DMAMAP=1):
        staged = LocalWorkerGroup(config_from_args(
            ["-r", *MAIN_ARGS, "--tpubackend", "pjrt", path]))
        staged.prepare()
    try:
        v = staged.native_raw_ceiling(total, depth_h2d, chunk_bytes=CHUNK)
        rung = staged.probe_tier()
        if v <= 0 or rung != "staged":
            raise AssertionError(f"EBT_PJRT_NO_DMAMAP=1 ceiling {v} on "
                                 f"{rung}")
    finally:
        staged.teardown()
    phase("ceilings", f"{card}: EBT_PJRT_NO_DMAMAP=1: H2D {v:.1f} MiB/s on "
                      f"the {rung} rung (pageable sources)")
    probe = engine.build_probe()
    for mode in ("h2d", "d2h"):
        r = subprocess.run([probe, str(total >> 20), str(CHUNK >> 20),
                            str(depth_h2d if mode == "h2d" else depth_d2h),
                            "64", "64", "1", mode],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"cuda_probe {mode}: rc {r.returncode} "
                                 f"{r.stderr.strip()}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        if line[f"native_{mode}_mib_s"] <= 0:
            raise AssertionError(f"cuda_probe {mode}: {line}")
        phase("ceilings", f"{card}: cuda_probe {mode} {json.dumps(line)}")


def ceilings_on_card() -> None:
    """Phases 8 and 26 alone: phase 8's 4 GiB write + read in a scratch
    directory, the raw ceilings measured on its group."""
    from elbencho_tpu_torch import engine

    print(gpu_name_and_power(), flush=True)
    engine.load_lib()
    with scratch_dir(5 << 30) as d:
        native_main_path(d)


def xfer_mgr_group(args: list[str]):
    """A prepared worker group whose native path was built with the
    transfer-manager tier requested; the tier must be active (nothing falls
    back: a failed probe fails the phase with its cause)."""
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    with env_set(EBT_PJRT_XFER_MGR=1):
        group = LocalWorkerGroup(config_from_args(args))
        group.prepare()
    if not group._native_path.xfer_mgr_active:
        cause = group._native_path.reg_error()
        group.teardown()
        raise AssertionError(f"transfer-manager tier requested but not "
                             f"active: {cause}")
    return group


def xfer_mgr_read(path: str, chunked: dict) -> None:
    """Phase 23, the plain read: phase 8's file read on the tier at phase
    8's settings, printed beside phase 8's chunked read."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.cuda import native

    size = os.path.getsize(path)
    blocks = size // (8 << 20)
    launches = native.kernel_launches()
    free0 = torch.cuda.mem_get_info(0)[0]
    group = xfer_mgr_group(["-r", *MAIN_ARGS, "--tpubackend", "pjrt", path])
    try:
        np_ = group._native_path
        res, secs = drive(group, BenchPhase.READFILES, "xfer-mgr read")
        moved = sum(r.ops.bytes for r in res)
        tier, count = group.confirm_engaged_tier(), np_.xfer_mgr_count
        to_hbm = np_.transferred_bytes[0]
        h = group.device_latency()["0"]
        if (moved != size or to_hbm != size or tier != "xfer_mgr"
                or count != blocks or h.count != blocks):
            raise AssertionError(
                f"xfer-mgr read: moved {moved}, device bytes {to_hbm}, tier "
                f"{tier}, {count} tier blocks and {h.count} latency samples "
                f"for {blocks} blocks")
        phase("xfer-mgr", f"READ {moved / secs / (1 << 30):.3f} GiB/s, GPU 0 "
                          f"xfer p50 {h.percentile_us(50.0)} us p99 "
                          f"{h.percentile_us(99.0)} us ({h.count} samples, "
                          f"one per block); chunked (phase 8) READ "
                          f"{chunked['gibs']:.3f} GiB/s, p50 "
                          f"{chunked['p50']} us p99 {chunked['p99']} us; "
                          f"tier {tier}, {count} tier blocks, device bytes "
                          f"{to_hbm}")
    finally:
        group.teardown()
    held = free0 - torch.cuda.mem_get_info(0)[0]
    if held > 256 << 20:
        raise AssertionError(f"xfer-mgr read: {held} bytes of device memory "
                             "still held after the teardown")
    if native.kernel_launches() != launches:
        raise AssertionError("xfer-mgr read: the tier's read launched a "
                             "kernel")
    phase("xfer-mgr", f"free device memory back after the teardown (held "
                      f"{held >> 20} MiB); no kernel launched")


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
    # phase 23: the same read with the transfer-manager tier requested
    # takes the verified path, one verify launch per block, none on the tier
    from elbencho_tpu_torch.common import BenchPhase

    native.reset_kernel_launches()
    group = xfer_mgr_group(["-r", *args])
    try:
        drive(group, BenchPhase.READFILES, "xfer-mgr --verify")
        tier_launches = native.kernel_launches()
        count = group._native_path.xfer_mgr_count
    finally:
        group.teardown()
    if tier_launches != {"verify_u32": blocks, "fill_u64": 0} or count:
        raise AssertionError(f"xfer-mgr --verify: launches {tier_launches}, "
                             f"{count} tier blocks, for {blocks} blocks")
    phase("xfer-mgr", f"--verify 1 GiB with the tier requested: engine "
                      f"launches {tier_launches} for {blocks} blocks, "
                      f"{count} tier blocks (the verified path first)")
    corrupt = 9 * BLOCK + CHUNK + 4321
    flip_byte(path, corrupt)
    rc, _, err = run_cli(cli, ["-r", *args])
    want = f"on-device data verification failed at file offset {corrupt}"
    if rc != 1 or want not in err:
        raise AssertionError(f"native corrupt run: rc {rc}, expected "
                             f"'{want}'")
    phase("native-verify", f"corrupt byte found: rc 1, '{want}'")
    with env_set(EBT_PJRT_XFER_MGR=1):
        rc, _, err = run_cli(cli, ["-r", *args])
    if rc != 1 or want not in err:
        raise AssertionError(f"xfer-mgr corrupt run: rc {rc}, expected "
                             f"'{want}'")
    phase("xfer-mgr", f"corrupt byte found with the tier requested: rc 1, "
                      f"'{want}'")
    os.remove(path)
    return launches


def read_pairs(cli, path: str, d: str, pairs: int = 1) -> None:
    """Phase 10: direct and native reads of the same file in turns (one
    pair: cut from three so that the script keeps its time with the faults
    and reshard phases, whose three native reads of the file stand beside
    it)."""
    for i in range(pairs):
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

    def empty(_):  # an empty kernel of the same block shape: the floor
        rc = lib.ebt_launch_floor(torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty kernel launch failed ({rc})")

    r = {"warm": graph_ms(kernel, [rows]), "floor": graph_ms(empty, [rows]),
         "lib": graph_ms(lambda x: torch.sum(x, 0), [rows]),
         "plain": events_ms(lambda: integ.sum_rows_u64_plain(rows), 50)}
    if not torch.equal(out, integ.sum_rows_u64_plain(rows)):
        raise AssertionError("timed sum_rows kernel: wrong sums")
    nbytes = (n * k + k) * 8
    r["bound"] = max(nbytes / HBM_BYTES_PER_S, n * k / ALU_OPS_PER_S) * 1e3
    phase("reduce-time", f"[{n}, {k}] rows: device {r['warm']:.6f} ms "
                         f"(launch-bound; bytes bound {r['bound']:.9f} ms; "
                         f"empty kernel, same block shape, "
                         f"{r['floor']:.6f} ms); plain {r['plain']:.6f} ms; "
                         f"torch.sum(rows, 0) {r['lib']:.6f} ms")
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


@contextlib.contextmanager
def env_set(**kv):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def drive(group, ph, label: str):
    """Run one phase of a worker group; returns (results, seconds)."""
    group.start_phase(ph, "smoke")
    while not group.wait_done(1000):
        pass
    res = group.phase_results()
    errs = [r.error for r in res if r.error]
    if errs:
        raise AssertionError(f"{label}: {errs}")
    return res, max(max(r.elapsed_us_list) for r in res) / 1e6


def lane_rows(group) -> str:
    """p50/p99 transfer latency per lane (--gpuids 0,0 labels both lanes
    "0" in the result rows, so the lanes' own histograms are read)."""
    source = group._native_path or group._staging_path()
    return "; ".join(f"lane {k} p50 {h.percentile_us(50.0)} us p99 "
                     f"{h.percentile_us(99.0)} us" for k, h in sorted(
                         source.device_latency_histograms().items()))


def stripe_split(size: int, unit: int, n: int, policy: str) -> list[int]:
    """The bytes each of n lanes must receive when the planner places
    `unit`-byte units of a `size`-byte file (rr: unit u on lane u mod n;
    contig: runs of ceil(units / n) units, the tail on the last lane)."""
    units = -(-size // unit)
    per = -(-units // n)
    out = [0] * n
    for u in range(units):
        lane = u % n if policy == "rr" else min(u // per, n - 1)
        out[lane] += min(unit, size - u * unit)
    return out


def native_stripe(path: str, size: int, gpuids: str = "0,0") -> None:
    """Phase 15: the stripe tier of the native engine, by default on two
    lanes of one card (--gpuids 0,0), rr then contig, over the native run's
    file: the tier must read "striped", every block be one settled unit and
    the lanes' bytes add up to the file, split as the planner places the
    units."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    block = 8 << 20
    n = len(gpuids.split(","))
    for policy in ("rr", "contig"):
        cfg = config_from_args(["-r", "-s", str(size), *STRIPE_READ,
                                "--gpuids", gpuids, "--stripe", policy,
                                path])
        group = LocalWorkerGroup(cfg)
        group.prepare()
        try:
            base = group.tier_counter_snapshot()
            lanes0 = [ln["to_hbm"] for ln in group.lane_stats()]
            res, secs = drive(group, BenchPhase.READFILES, f"stripe {policy}")
            moved = sum(r.ops.bytes for r in res)
            st = group.stripe_stats()
            lanes = [ln["to_hbm"] - b for ln, b in zip(group.lane_stats(),
                                                       lanes0)]
            tier = group.confirm_stripe_tier(base)
            unit = cfg.stripe_unit_blocks(
                spans_active=group._native_path.dma_supported) * block
            want = stripe_split(size, unit, n, policy)
            blocks = size // block
            if (tier != "striped" or moved != size or lanes != want
                    or st["units_submitted"] != blocks
                    or st["units_awaited"] != blocks
                    or group.stripe_error()):
                raise AssertionError(
                    f"stripe {policy}: tier {tier}, moved {moved}, lanes "
                    f"{lanes} (want {want}), {st}, error "
                    f"'{group.stripe_error()}'")
            phase("stripe", f"--stripe {policy} --gpuids {gpuids}, "
                            f"{size >> 20} MiB in {unit >> 20} MiB units: "
                            f"tier {tier}, {st['units_awaited']}/"
                            f"{st['units_submitted']} units settled, lane "
                            f"bytes {lanes}; READ "
                            f"{size / secs / (1 << 30):.3f} GiB/s; "
                            f"{lane_rows(group)}")
        finally:
            group.teardown()


def faults_pass(path: str, size: int, policy: bool,
                eject_at: float | None) -> dict:
    """One native read of the 4 GiB file over two lanes of the card with the
    stripe planner; `policy` arms --retry 1 --maxerrors 5%, `eject_at`
    force-ejects lane 1 from a second thread once that share of the file
    has been read. Returns what the phase checks and prints."""
    import threading

    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    cfg = config_from_args(["-r", "-s", str(size), *STRIPE_READ, "--gpuids",
                            "0,0", "--stripe", "rr",
                            *(["--retry", "1", "--maxerrors", "5%"]
                              if policy else []), path])
    group = LocalWorkerGroup(cfg)
    group.prepare()
    out: dict = {}
    try:
        np_ = group._native_path
        lanes0 = [ln["to_hbm"] for ln in np_.lane_stats()]
        stop = threading.Event()

        def ejector() -> None:
            # the first quarter of the blocks read, then the forced
            # ejection; lane 1's blocks and bytes are read again 100 ms
            # later, past a submit that read the mask before it changed
            while not stop.is_set():
                done = sum(ln["to_hbm"] for ln in np_.lane_stats()) - \
                    sum(lanes0)
                if done >= eject_at * size:
                    out["ejected_ok"] = np_.eject_device(
                        1, "chip_smoke forced")
                    out["at_bytes"] = done
                    time.sleep(0.1)
                    lane1 = np_.lane_stats()[1]
                    out["lane1_after"] = lane1["to_hbm"] - lanes0[1]
                    out["lane1_blocks_after"] = lane1["submits"]
                    return
                time.sleep(0.0005)

        th = threading.Thread(target=ejector) if eject_at else None
        if th:
            th.start()
        try:
            res, secs = drive(group, BenchPhase.READFILES,
                              f"faults policy={policy} eject={eject_at}")
        finally:
            stop.set()
            if th:
                th.join()
        out.update(
            secs=secs, moved=sum(r.ops.bytes for r in res),
            fault=group.fault_stats(), ejected=group.ejected_devices(),
            stripe=group.stripe_stats(),
            lanes=[ln["to_hbm"] - b for ln, b in zip(np_.lane_stats(),
                                                     lanes0)],
            lane1_blocks=np_.lane_stats()[1]["submits"],
            lat=lane_rows(group))
    finally:
        group.teardown()
    return out


def native_faults(path: str, size: int) -> dict:
    """The faults phase: the 4 GiB file read three times over --gpuids 0,0
    with --stripe rr (-t 4 -b 8M --iodepth 4 --lat): clean without a fault
    policy, clean with --retry 1 --maxerrors 5%, and with the policy and
    lane 1 force-ejected after the first quarter of the blocks. On a card
    a real asynchronous fault is sticky for the device's whole context, so
    it would take down both lanes of --gpuids 0,0: the phase ejects through
    the force seam. The third pass must end clean with one ejection, its
    cause, replanned units, the stripe ledger reconciled, no block placed
    on lane 1 after the ejection and the lanes' bytes adding up to the
    file. A block counts its bytes on its lanes once all its chunks are
    submitted, and a chunk submitted after the ejection goes to lane 0, so
    lane 1 may still count, after the ejection, blocks whose submission had
    begun: at most the workers' blocks in flight (-t 4, --iodepth 4)."""
    t0 = time.perf_counter()
    clean = faults_pass(path, size, False, None)
    armed = faults_pass(path, size, True, None)
    ejected = faults_pass(path, size, True, 0.25)
    for label, r in (("clean", clean), ("armed", armed)):
        if (r["moved"] != size or any(r["fault"].values())
                or r["ejected"] != ""
                or r["stripe"]["units_awaited"] !=
                r["stripe"]["units_submitted"]):
            raise AssertionError(f"faults {label}: {r}")
    fs, st, lanes = ejected["fault"], ejected["stripe"], ejected["lanes"]
    if (not ejected.get("ejected_ok") or ejected["moved"] != size
            or fs["ejected_devices"] != 1 or fs["replanned_units"] <= 0
            or ejected["ejected"] != "device 1: chip_smoke forced"
            or st["units_awaited"] != st["units_submitted"]
            or ejected["lane1_blocks"] != ejected["lane1_blocks_after"]
            or not 0 <= lanes[1] - ejected["lane1_after"] <= 16 * (8 << 20)
            or sum(lanes) != size):
        raise AssertionError(f"faults ejected pass: {ejected}")
    gibs = {k: size / r["secs"] / (1 << 30)
            for k, r in (("clean", clean), ("armed", armed),
                         ("ejected", ejected))}
    phase("faults", f"{size >> 20} MiB --stripe rr --gpuids 0,0 READ: clean "
                    f"{gibs['clean']:.3f} GiB/s; --retry 1 --maxerrors 5% "
                    f"{gibs['armed']:.3f} GiB/s (armed/clean "
                    f"{gibs['armed'] / gibs['clean']:.3f}); lane 1 "
                    f"force-ejected at {ejected['at_bytes'] >> 20} MiB: "
                    f"{gibs['ejected']:.3f} GiB/s")
    phase("faults", f"ejected pass: FaultStats {fs}; EjectedDevices "
                    f"'{ejected['ejected']}'; stripe {st['units_awaited']}/"
                    f"{st['units_submitted']} units settled; lane bytes "
                    f"{lanes} (lane 1 {ejected['lane1_after']} 100 ms after "
                    f"the ejection, {lanes[1]} at the end; its blocks "
                    f"{ejected['lane1_blocks']} then and at the end); "
                    f"{ejected['lat']}; faults phase took "
                    f"{time.perf_counter() - t0:.1f}s")
    return gibs


def native_stripe_verify(cli, native, d: str,
                         size: int = 1 << 30) -> tuple[str, dict]:
    """Phase 16: 1 GiB native --verify write + read with --stripe rr over
    two lanes: the engine launches the fill kernel once per block written
    and the verify kernel once per block read, each on the lane the
    planner chose (the lanes' bytes split in halves), and a planted corrupt
    byte is reported at its exact offset. Returns the file (corrupt byte
    repaired) and the launches."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    path = os.path.join(d, "sv1g")
    salt = 42
    args = ["-t", "2", "-s", str(size), "-b", "4M", "--verify", str(salt),
            "--gpuids", "0,0", "--tpubackend", "pjrt", "--stripe", "rr",
            "--nolive", path]
    group = LocalWorkerGroup(config_from_args(["-w", "-r", *args]))
    group.prepare()
    try:
        native.reset_kernel_launches()
        drive(group, BenchPhase.CREATEFILES, "stripe verify write")
        lanes0 = [ln["to_hbm"] for ln in group.lane_stats()]
        _, secs = drive(group, BenchPhase.READFILES, "stripe verify read")
        launches = native.kernel_launches()
        lanes = [ln["to_hbm"] - b for ln, b in zip(group.lane_stats(),
                                                   lanes0)]
        st = group.stripe_stats()
    finally:
        group.teardown()
    blocks = size // BLOCK
    if (launches != {"verify_u32": blocks, "fill_u64": blocks}
            or lanes != [size // 2] * 2):
        raise AssertionError(f"stripe verify: launches {launches} for "
                             f"{blocks} blocks each way, lanes {lanes}")
    phase("stripe-verify", f"clean {size >> 20} MiB --stripe rr --verify: "
                           f"engine "
                           f"launches {launches} for {blocks} blocks each "
                           f"way, lane bytes {lanes}, stripe {st}; READ "
                           f"{size / secs / (1 << 30):.3f} GiB/s")
    corrupt = 11 * BLOCK + CHUNK + 999  # block 11: lane 0's third unit
    flip_byte(path, corrupt)
    rc, _, err = run_cli(cli, ["-r", *args])
    want = f"on-device data verification failed at file offset {corrupt}"
    if rc != 1 or want not in err:
        raise AssertionError(f"stripe verify corrupt run: rc {rc}, expected "
                             f"'{want}'")
    phase("stripe-verify", f"corrupt byte found: rc 1, '{want}'")
    flip_byte(path, corrupt)
    return path, launches


def gil_probe() -> tuple[float, float]:
    """Whether a pageable host -> device copy releases the GIL: a Python
    counting loop's rate while another thread copies 8 MiB blocks from
    pageable memory, over its rate alone, and the copier's rate beside the
    loop over its rate alone (both near 1.0 when the copy releases it)."""
    import threading
    src = torch.from_numpy(np.ones(8 << 20, dtype=np.uint8))
    dst = torch.empty(8 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.Stream()
    window = 0.5

    def count(stop) -> int:
        n = 0
        while not stop.is_set():
            n += 1
        return n

    def copies(stop, out) -> None:
        n = 0
        with torch.cuda.stream(stream):
            while not stop.is_set():
                dst.copy_(src, non_blocking=True)
                stream.synchronize()
                n += 1
        out.append(n)

    def run(with_count: bool, with_copy: bool) -> tuple[int, int]:
        stop, got = threading.Event(), []
        t = threading.Thread(target=copies, args=(stop, got)) \
            if with_copy else None
        if t:
            t.start()
        timer = threading.Timer(window, stop.set)
        timer.start()
        n = count(stop) if with_count else (stop.wait() or 0)
        if t:
            t.join()
        return n, got[0] if got else 0

    run(False, True)  # warm-up
    solo_count, _ = run(True, False)
    _, solo_copy = run(False, True)
    both_count, both_copy = run(True, True)
    return both_count / solo_count, both_copy / max(1, solo_copy)


STAGED_TIERS = (
    ("staged --stripe rr (mesh fallback)", "staged", ["--stripe", "rr"],
     None),
    ("direct --tpustripe (default submitters)", "direct", ["--tpustripe"],
     None),
    ("direct EBT_TPU_SUBMITTERS=2", "direct", [], "2"),
    ("direct inline (EBT_TPU_SUBMITTERS=0)", "direct", [], "0"),
)


def staged_tiers(path: str, size: int) -> None:
    """Phase 17: the staged and direct placements over two lanes of one
    card with 2 MiB chunks, 4 MiB blocks: each must put half the file on
    each lane; GiB/s printed, inline beside the submitters."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    ratio_count, ratio_copy = gil_probe()
    phase("gil", f"pageable 8 MiB host -> device copies in a second thread: "
                 f"a Python loop keeps {ratio_count:.3f} of its solo rate, "
                 f"the copier {ratio_copy:.3f} of its solo rate")
    saved = {k: os.environ.get(k) for k in ("EBT_TPU_CHUNK_BYTES",
                                            "EBT_TPU_SUBMITTERS")}
    os.environ["EBT_TPU_CHUNK_BYTES"] = str(CHUNK)
    try:
        for label, backend, extra, submitters in STAGED_TIERS:
            os.environ.pop("EBT_TPU_SUBMITTERS", None)
            if submitters is not None:
                os.environ["EBT_TPU_SUBMITTERS"] = submitters
            group = LocalWorkerGroup(config_from_args(
                ["-r", "-t", "2", "-s", str(size), "-b", "4M", "--gpuids",
                 "0,0", "--tpubackend", backend, *extra, "--lat",
                 "--nolive", path]))
            group.prepare()
            try:
                sp = group._dev_callback.staging_path
                _, secs = drive(group, BenchPhase.READFILES, label)
                per_dev = sp.device_bytes()
                mode = ("inline" if sp.inline_submit else
                        f"{sp.num_submitters} submitters"
                        if sp.direct else "blocking")
                if per_dev != [size // 2] * 2 or \
                        sp.transferred_bytes[0] != size or \
                        (extra == ["--tpustripe"] and sp.num_submitters != 2):
                    raise AssertionError(f"{label}: bytes per lane {per_dev}"
                                         f", {sp.transferred_bytes}, {mode}")
                phase("placement", f"{label}: bytes per lane {per_dev}, "
                                   f"{mode}; READ "
                                   f"{size / secs / (1 << 30):.3f} GiB/s; "
                                   f"{lane_rows(group)}")
            finally:
                group.teardown()
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def staged_stripe_verify(cli, vk, d: str, size: int = 1 << 30) -> int:
    """Phase 17b: staged --tpustripe --verify over two lanes, 2 MiB chunks
    of 4 MiB blocks: each chunk is checked on the lane it landed on, one
    launch per chunk, and a corrupt byte in a block's second chunk (lane 1)
    is reported at its exact offset. Returns the clean run's launches."""
    path = os.path.join(d, "ts1g")
    args = ["-t", "2", "-s", str(size), "-b", "4M", "--verify", "42",
            "--gpuids",
            "0,0", "--tpubackend", "staged", "--tpustripe", "--nolive", path]
    os.environ["EBT_TPU_CHUNK_BYTES"] = str(CHUNK)
    try:
        rc, _, _ = run_cli(cli, ["-w", *args])
        vk.reset_launches()
        rc_r, _, _ = run_cli(cli, ["-r", *args])
        launched = sum(vk.LAUNCHES.values())
        if rc or rc_r or launched != size // CHUNK:
            raise AssertionError(f"staged --tpustripe --verify: rc {rc}/"
                                 f"{rc_r}, {launched} launches for "
                                 f"{size // CHUNK} chunks read")
        phase("tpustripe-verify", f"clean {size >> 20} MiB: {launched} "
                                  f"verify launches "
                                  f"for {size // CHUNK} chunks read")
        corrupt = 5 * BLOCK + CHUNK + 4242
        flip_byte(path, corrupt)
        rc, _, err = run_cli(cli, ["-r", *args])
    finally:
        del os.environ["EBT_TPU_CHUNK_BYTES"]
    want = f"on-device data verification failed at file offset {corrupt}"
    if rc != 1 or want not in err:
        raise AssertionError(f"tpustripe corrupt run: rc {rc}, expected "
                             f"'{want}'")
    phase("tpustripe-verify", f"corrupt byte found: rc 1, '{want}'")
    os.remove(path)
    return launched


def write_shards(d: str, sizes, seed: int = 20261016) -> list[str]:
    """The checkpoint's shard files, each made from its own PCG64 stream of
    one seeded numpy SeedSequence, all written together (the generator
    and the writes release the GIL)."""
    streams = np.random.SeedSequence(seed).spawn(len(sizes))

    def write(i: int) -> str:
        p = os.path.join(d, f"model-{i + 1:05d}-of-{len(sizes):05d}"
                            ".safetensors")
        write_file(p, sizes[i], streams[i])
        return p

    with ThreadPoolExecutor(len(sizes)) as pool:
        return list(pool.map(write, range(len(sizes))))


def restore(args: list[str], label: str, want_dev: list[int]) -> float:
    """One checkpoint restore through the worker group: every shard
    resident, resident bytes per device as the manifest places them, no
    error. Returns the phase's seconds."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    cfg = config_from_args(args)
    group = LocalWorkerGroup(cfg)
    group.prepare()
    try:
        res, secs = drive(group, BenchPhase.CHECKPOINT, label)
        st, dev = group.ckpt_stats(), group.ckpt_dev_bytes()
        err = group.ckpt_error()
        n, total = len(cfg.ckpt_shards), cfg.ckpt_total_bytes()
        if (st["shards_resident"] != n or st["shards_total"] != n
                or dev != want_dev or err
                or sum(r.ops.bytes for r in res) != total):
            raise AssertionError(f"{label}: {st}, bytes per device {dev} "
                                 f"(want {want_dev}), error '{err}'")
        lat = lane_rows(group) if cfg.show_latency else ""
        phase("restore", f"{label}: {st['shards_resident']}/{n} shards "
                         f"resident, bytes per device {dev}; RESTORE "
                         f"{total / secs / (1 << 30):.3f} GiB/s, every shard "
                         f"resident after {secs:.3f} s (all-resident "
                         f"barriers {st['resident_wait_ns'] / 1e9:.3f} s)"
                         + (f"; {lat}" if lat else ""))
    finally:
        group.teardown()
    return secs


def reshard(args: list[str], label: str, want_tier: str,
            d2d_pair: tuple[int, int] | None = None) -> dict:
    """One --reshard run through the worker group: the plan's move units
    staged at prepare, then the RESHARD phase. The confirmed tier must be
    want_tier, d2d_submitted == d2d_resident == the plan's move bytes,
    every move unit resident and the pair matrix the plan's moves (one
    chunk move per 2 MiB of each moved shard). With d2d_pair (src, dst),
    phase 26's device-to-device ceiling between those lanes follows on the
    same group (on the bounce control: its refusal). Returns the numbers
    printed."""
    from elbencho_tpu_torch.checkpoint import reshard_plan_summary
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    cfg = config_from_args(args)
    group = LocalWorkerGroup(cfg)
    t0 = time.perf_counter()
    group.prepare()
    prep = time.perf_counter() - t0
    try:
        res, secs = drive(group, BenchPhase.RESHARD, label)
        st, tier = group.reshard_stats(), group.reshard_tier()
        pairs = sorted((p["src"], p["dst"], p["moves"], p["bytes"])
                       for p in group.reshard_pairs())
        plan = reshard_plan_summary(cfg.reshard_units)
        chunk = int(os.environ.get("EBT_TPU_CHUNK_BYTES", 0) or CHUNK)
        want_pairs: dict = {}
        for u in cfg.reshard_units:
            if u.action == "move":
                m, b = want_pairs.get((u.src_dev, u.dst_dev), (0, 0))
                want_pairs[(u.src_dev, u.dst_dev)] = (
                    m + -(-u.bytes // chunk), b + u.bytes)
        want = sorted((s_, d_, m, b) for (s_, d_), (m, b) in
                      want_pairs.items())
        move_bytes = plan["move_bytes"]
        err = group.reshard_error()
        if (tier != want_tier or err or pairs != want
                or st["d2d_submitted_bytes"] != move_bytes
                or st["d2d_resident_bytes"] != move_bytes
                or st["units_moved"] != plan["move"]
                or st["unit_bytes_submitted"] != st["unit_bytes_resident"]):
            raise AssertionError(f"{label}: tier {tier}, {st}, pairs {pairs}"
                                 f" (want {want}), error '{err}'")
        enabled, npairs = group._native_path.peer_access()
        phase("reshard", f"{label}: tier {tier}, {plan['move']} of "
                         f"{plan['units']} units moved, d2d_submitted == "
                         f"d2d_resident == {move_bytes} bytes, pairs {pairs}, "
                         f"{st['d2d_moves']} device-to-device and "
                         f"{st['bounce_moves']} bounce chunk moves; RESHARD "
                         f"{move_bytes / secs / (1 << 30):.3f} GiB/s, all "
                         f"resharded after {secs:.3f} s (barriers "
                         f"{st['resident_wait_ns'] / 1e9:.3f} s); preload "
                         f"{prep:.1f} s; peer access on for {enabled} of "
                         f"{npairs} device pairs; {lane_rows(group)}")
        if d2d_pair is not None:
            d2d_ceiling(group, *d2d_pair, move_bytes / secs / (1 << 30),
                        want_tier == "d2d")
    finally:
        group.teardown()
    return {"tier": tier, "gibs": move_bytes / secs / (1 << 30),
            "secs": secs, "move_bytes": move_bytes}


def d2d_ceiling(group, src: int, dst: int, reshard_gibs: float,
                native_d2d: bool) -> None:
    """Phase 26 on a reshard group after its phase: the in-session
    device-to-device ceiling from lane src onto lane dst (4 GiB in 2 MiB
    chunks, 8 in flight) beside the RESHARD rate; under the bounce control
    (EBT_D2D_DISABLE=1) its refusal with the cause."""
    from elbencho_tpu_torch.exceptions import ProgException

    card = gpu_name_and_power()
    np_ = group._native_path
    if not native_d2d:
        try:
            group.native_raw_d2d_ceiling(1 << 30, 8, src, dst, CHUNK)
            raise AssertionError("a d2d ceiling ran under EBT_D2D_DISABLE=1")
        except ProgException as e:
            cause = str(e)
        if "EBT_D2D_DISABLE=1 forces the bounce control" not in cause:
            raise AssertionError(f"bounce-control refusal: {cause}")
        phase("ceilings", f"{card}: D2D ceiling refused under "
                          f"EBT_D2D_DISABLE=1: {cause}")
        return
    before = np_.transferred_bytes
    c = group.native_raw_d2d_ceiling(CEILING_BYTES, 8, src, dst, CHUNK)
    err = np_.raw_last_error()
    if c <= 0 or err or np_.transferred_bytes != before:
        raise AssertionError(f"d2d ceiling {c} MiB/s, raw error '{err}', "
                             f"bytes {before} -> {np_.transferred_bytes}")
    phase("ceilings", f"{card}: D2D lane {src} -> lane {dst} {c:.1f} MiB/s "
                      f"({CEILING_BYTES >> 30} GiB, 2 MiB chunks, 8 in "
                      f"flight); RESHARD "
                      f"{reshard_gibs:.3f} GiB/s = "
                      f"{100 * reshard_gibs * 1024 / c:.1f}% of it")


def native_reshard(d: str, paths) -> None:
    """The reshard phase: the Llama-3.1-8B shard layout placed two shards
    per lane on --gpuids 0,0 (shard i on lane i mod 2) and resharded onto
    one lane (--reshard 1): the shards of lane 1 move device to device
    (cuMemcpyDtoDAsync between two lanes of one card), then the same plan
    with EBT_D2D_DISABLE=1 through the host bounce (the control)."""
    man = write_manifest(d, "man_rs.json", paths,
                         [[i % 2] for i in range(len(paths))])
    args = ["-t", "4", "--gpuids", "0,0", "--tpubackend", "pjrt",
            "--checkpoint", man, "--reshard", "1", "--lat", "--nolive"]
    # phase 26: the moves run lane 1 -> lane 0, the ceiling too
    native = reshard(args, "--gpuids 0,0 -> 1 lane, device to device",
                     "d2d", (1, 0))
    os.environ["EBT_D2D_DISABLE"] = "1"
    try:
        bounce = reshard(args, "--gpuids 0,0 -> 1 lane, EBT_D2D_DISABLE=1",
                         "bounce", (1, 0))
    finally:
        del os.environ["EBT_D2D_DISABLE"]
    phase("reshard", f"device to device {native['gibs']:.3f} GiB/s "
                     f"({native['secs']:.3f} s), bounce {bounce['gibs']:.3f} "
                     f"GiB/s ({bounce['secs']:.3f} s) for "
                     f"{native['move_bytes']} bytes moved")


def write_file(path: str, size: int, seed) -> None:
    """A file of `size` bytes from a PCG64 stream of `seed` (an int or a
    numpy SeedSequence)."""
    gen = np.random.PCG64(seed)
    with open(path, "wb") as f:
        left = size
        while left:
            k = min(left, 64 << 20)
            f.write(gen.random_raw(-(-k // 8)).view(np.uint8)[:k])
            left -= k


def merged_p99(histos) -> int:
    h = None
    for x in histos:
        h = x if h is None else h.merge(x)
    return h.percentile_us(99.0) if h is not None else 0


def serve(serve_file: str, trace: str, label: str, extra: list[str],
          paths=(), gen_bytes: int = 0, min_swaps: int = 2,
          retained: int | None = None) -> dict:
    """One serving read phase over the 1 GiB file on device 0, with
    rotation when `extra` names a manifest. At least `min_swaps` swapped
    records, every one reconciled to the manifest (and retaining `retained`
    buffers, where given), the tenant ledger is exact, device memory shows
    a resident generation while the phase runs and comes back after the
    teardown, and sampled ranges of every shard read back from the active
    generation equal the files. Returns what the phase prints."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.cuda import native
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    cfg = config_from_args([serve_file, "-r", "-t", "4", "-b", "64K", "-s",
                            str(SERVE_BYTES), "--tpubackend", "pjrt",
                            "--arrival", "trace", "--ratetrace", trace,
                            "--nolive", *extra])
    launches = native.kernel_launches()
    free0 = torch.cuda.mem_get_info(0)[0]
    min_free = free0
    group = LocalWorkerGroup(cfg)
    group.prepare()
    try:
        group.start_phase(BenchPhase.READFILES, "smoke")
        while not group.wait_done(100):
            min_free = min(min_free, torch.cuda.mem_get_info(0)[0])
        res = group.phase_results()
        errs = [r.error for r in res if r.error]
        if errs:
            raise AssertionError(f"{label}: {errs}")
        secs = max(max(r.elapsed_us_list) for r in res) / 1e6
        moved = sum(r.ops.bytes for r in res)
        (tenant,) = group.tenant_stats()
        if tenant["arrivals"] != tenant["completions"] + tenant["dropped"]:
            raise AssertionError(f"{label}: tenant ledger {tenant}")
        out = {"gibs": moved / secs / (1 << 30), "secs": secs,
               "op_p99": merged_p99(r.iops_histo for r in res),
               "tenant_p99": merged_p99(group.tenant_latency().values()),
               "tenant": tenant}
        if paths:
            svs, recs = group.serving_stats(), group.rotation_records()
            ttrs = group.rotation_ttr_ns()
            out.update(svs=svs, recs=recs, ttrs=ttrs,
                       mem_drop=free0 - min_free)
            total = sum(os.path.getsize(p) for p in paths)
            if len(recs) < min_swaps or len(ttrs) != len(recs):
                raise AssertionError(f"{label}: {len(recs)} swaps, {svs}")
            for i, r in enumerate(recs):
                want_rel = 0 if i == 0 else recs[i - 1]["retained_buffers"]
                if (r["shards_resident"] != len(paths)
                        or r["shards_total"] != len(paths)
                        or r["bytes_submitted"] != total
                        or r["bytes_resident"] != total
                        or r["released_buffers"] != want_rel
                        or retained not in (None, r["retained_buffers"])):
                    raise AssertionError(f"{label}: record {i} {r}")
            if free0 - min_free < gen_bytes:
                raise AssertionError(
                    f"{label}: free device memory fell by only "
                    f"{free0 - min_free} bytes, one generation is "
                    f"{gen_bytes}")
            # the active generation, read back from device memory
            np_ = group._native_path
            for s, p in enumerate(paths):
                size = os.path.getsize(p)
                span = min(1 << 20, size)
                with open(p, "rb") as f:
                    for off in (0, (size - span) // 2, size - span):
                        f.seek(off)
                        if np_.rotation_read(s, off, span) != f.read(span):
                            raise AssertionError(
                                f"{label}: shard {s} at {off} differs "
                                "from its file")
    finally:
        group.teardown()
    free1 = torch.cuda.mem_get_info(0)[0]
    if free0 - free1 > 256 << 20:
        raise AssertionError(f"{label}: {free0 - free1} bytes of device "
                             "memory still held after the teardown")
    if native.kernel_launches() != launches:
        raise AssertionError(f"{label}: the serving path launched a kernel")
    return out


def serving_rotation(d: str, paths) -> dict:
    """Phase 21 (inside phase 18, on its Llama-3.1-8B shard files): serving
    traffic on a 1 GiB file while the 16.1 GB model is rotated onto
    device 0 every second, then one pass without rotation. Returns the
    serving file, the trace and run 1's restore rate, for run 2."""
    serve_file = os.path.join(d, "serve.bin")
    write_file(serve_file, SERVE_BYTES, 20261017)
    trace = os.path.join(d, "steady.json")
    with open(trace, "w") as f:
        json.dump({"segments": [{"at": 0, "kind": "step",
                                 "rate": SERVE_RATE}]}, f)
    man = write_manifest(d, "man_rot.json", paths, [[0]] * len(paths))
    total = sum(os.path.getsize(p) for p in paths)
    rot = serve(serve_file, trace, "rotation",
                ["--checkpoint", man, "--rotate", "1", "--timelimit",
                 str(SERVE_SECS)], paths, total)
    plain = serve(serve_file, trace, "no rotation",
                  ["--timelimit", str(PLAIN_SECS)])
    ttrs = [t / 1e9 for t in rot["ttrs"]]
    rate = total / (sum(ttrs) / len(ttrs))
    phase("serving", f"--rotate 1 unthrottled, {len(rot['recs'])} swaps of "
                     f"{len(paths)} shards / {total} bytes, every record "
                     f"reconciled; TTR per rotation "
                     f"{', '.join(f'{t:.3f}' for t in ttrs)} s (restore "
                     f"{rate / (1 << 30):.3f} GiB/s); free device memory "
                     f"fell by {rot['mem_drop'] >> 20} MiB while resident, "
                     f"back after the teardown; read-back == files; "
                     f"READ {rot['gibs']:.3f} GiB/s, op p99 "
                     f"{rot['op_p99']} us, arrival-clock p99 "
                     f"{rot['tenant_p99']} us, tenant {rot['tenant']}")
    phase("serving", f"no rotation: READ {plain['gibs']:.3f} GiB/s, op p99 "
                     f"{plain['op_p99']} us, arrival-clock p99 "
                     f"{plain['tenant_p99']} us, tenant {plain['tenant']}")
    return {"serve_file": serve_file, "trace": trace, "rate": rate}


def serving_budgeted(d: str, run1: dict, paths) -> None:
    """Phase 21, run 2 (on phase 18's generated 8 x 256 MiB checkpoint):
    the same serving traffic with --bgbudget at half of run 1's restore
    rate; the buckets must show throttle evidence."""
    total = sum(os.path.getsize(p) for p in paths)
    budget = int(run1["rate"] / 2)
    secs = max(8, -(-3 * total // budget) + 2)  # two swaps, with room
    man = write_manifest(d, "man_rot2.json", paths, [[0]] * len(paths))
    run = serve(run1["serve_file"], run1["trace"], "rotation, budgeted",
                ["--checkpoint", man, "--rotate", "1", "--bgbudget",
                 str(budget), "--timelimit", str(secs)], paths, total)
    svs = run["svs"]
    throttled = svs["bg_throttle_ns"] + svs["bg_lane_throttle_ns"]
    if throttled <= 0:
        raise AssertionError(f"rotation, budgeted: no throttle evidence "
                             f"{svs}")
    ttrs = [t / 1e9 for t in run["ttrs"]]
    phase("serving", f"--bgbudget {budget} B/s over {len(paths)} x "
                     f"{os.path.getsize(paths[0]) >> 20} MiB: "
                     f"{len(run['recs'])} swaps, every record reconciled; "
                     f"TTR {', '.join(f'{t:.3f}' for t in ttrs)} s "
                     f"(restore {total / (sum(ttrs) / len(ttrs)) / (1 << 30):.3f}"
                     f" GiB/s); throttled {throttled / 1e9:.3f} s (storage "
                     f"{svs['bg_throttle_ns'] / 1e9:.3f}, lanes "
                     f"{svs['bg_lane_throttle_ns'] / 1e9:.3f}); READ "
                     f"{run['gibs']:.3f} GiB/s, op p99 {run['op_p99']} us, "
                     f"arrival-clock p99 {run['tenant_p99']} us")


def xfer_mgr_rotation(d: str, run1: dict, paths) -> None:
    """Phase 23, the rotation: phase 18's generated checkpoint rotated onto
    device 0 on the transfer-manager tier under phase 21's serving traffic
    (whose blocks ride the tier too). Each tier block of the restoring
    generation lands in the generation's memory and retains one buffer."""
    total = sum(os.path.getsize(p) for p in paths)
    blocks = sum(-(-os.path.getsize(p) // (64 << 10)) for p in paths)
    # The tier's restore (one device buffer per 64 KiB block) has run at
    # 0.45-0.77 of run 1's chunked rate on the card, so the limit lets it
    # run at a quarter of that rate after the first rotation's second.
    secs = max(6, -(-4 * total // int(run1["rate"])) + 3)
    man = write_manifest(d, "man_rot3.json", paths, [[0]] * len(paths))
    with env_set(EBT_PJRT_XFER_MGR=1):
        run = serve(run1["serve_file"], run1["trace"],
                    "rotation on the transfer-manager tier",
                    ["--checkpoint", man, "--rotate", "1", "--timelimit",
                     str(secs)], paths, total, min_swaps=1, retained=blocks)
    ttrs = [t / 1e9 for t in run["ttrs"]]
    phase("xfer-mgr", f"--rotate 1 on the tier over {len(paths)} x "
                      f"{os.path.getsize(paths[0]) >> 20} MiB: "
                      f"{len(run['recs'])} swaps, every record reconciled, "
                      f"retained_buffers == {blocks} blocks; read-back == "
                      f"files; TTR {', '.join(f'{t:.3f}' for t in ttrs)} s; "
                      f"READ {run['gibs']:.3f} GiB/s, op p99 "
                      f"{run['op_p99']} us")


def chaos_on_card(path: str, size: int = 1 << 30) -> None:
    """Phase 24: --chaos on the card. The storage engine's seams, armed at
    p = 1 on a native read, must each show (aio on a host without io_uring,
    reactor), the bytes landing exactly; a mock-driver seam armed against
    the real driver must be named INERT and change nothing."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.cuda import native
    from elbencho_tpu_torch.engine_stats import uring_stats
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    launches = native.kernel_launches()
    seams = ("EBT_MOCK_AIO_SETUP_FAIL", "EBT_MOCK_REACTOR_FAIL_AT",
             "EBT_MOCK_CUDA_FAIL_AT")

    def read(spec: str, extra: list[str], label: str, **env):
        cfg = config_from_args(["-r", "-t", "4", "-s", str(size), "-b", "8M",
                                "--iodepth", "4", "--gpuids", "0",
                                "--tpubackend", "pjrt", "--lat", "--nolive",
                                "--chaos", spec, *extra, path])
        group = LocalWorkerGroup(cfg)
        err = io.StringIO()
        with contextlib.redirect_stderr(err), env_set(**env):
            group.prepare()
        sys.stderr.write(err.getvalue())
        try:
            res, secs = drive(group, BenchPhase.READFILES, label)
            moved = sum(r.ops.bytes for r in res)
            to_hbm = group._native_path.transferred_bytes[0]
            if moved != size or to_hbm != size:
                raise AssertionError(f"{label}: moved {moved}, device bytes "
                                     f"{to_hbm}, file {size}")
            return (err.getvalue(), moved / secs / (1 << 30),
                    group.io_engine(), group.reactor_cause() or "",
                    group.tenant_stats())
        finally:
            group.teardown()

    u0 = uring_stats()["aio_setup_retries"]
    try:
        # EBT_TPU_NO_MMAP: the blocks come through the engine's I/O buffers
        # and its async queue (the native read maps the file otherwise)
        log, gibs, engine, cause, tenants = read(
            "aio=1.0,reactor=1.0,seed=1",
            ["--arrival", "paced", "--rate", "16"], "chaos, engine seams",
            EBT_TPU_NO_MMAP=1)
        retries = uring_stats()["aio_setup_retries"] - u0
        if "EBT_MOCK_REACTOR_FAIL_AT" not in cause:
            raise AssertionError(f"chaos: the reactor seam did not show: "
                                 f"cause '{cause}'")
        if engine == "aio" and retries < 1:
            raise AssertionError("chaos: the aio seam did not show: "
                                 f"aio_setup_retries +{retries}")
        for t in tenants:
            if t["arrivals"] != t["completions"] + t["dropped"]:
                raise AssertionError(f"chaos: tenant ledger {t}")
        phase("chaos", f"aio=1.0,reactor=1.0 on a native {size >> 20} MiB "
                       f"read (--iodepth 4 into the engine's buffers, "
                       f"--arrival paced): io engine {engine}, "
                       f"aio_setup_retries +{retries}"
                       + ("" if engine == "aio" else
                          " (io_uring here: the aio seam is not reached)")
                       + f", reactor cause '{cause}'; bytes exact; READ "
                         f"{gibs:.3f} GiB/s")
        for k in seams:
            os.environ.pop(k, None)
        log, gibs, _, _, _ = read("submit=1.0,seed=1", [],
                                  "chaos, mock seam on the card")
        inert = [ln for ln in log.splitlines() if "INERT" in ln]
        if not inert or "submit" not in inert[0]:
            raise AssertionError(f"chaos: no INERT warning for submit in "
                                 f"{log!r}")
        phase("chaos", f"submit=1.0 against the real driver: '{inert[0]}'; "
                       f"the read is clean, bytes exact, READ {gibs:.3f} "
                       f"GiB/s")
    finally:
        for k in seams:
            os.environ.pop(k, None)
    if native.kernel_launches() != launches:
        raise AssertionError("chaos: a kernel was launched")


def ingest_run(args: list[str], label: str, want_tier: str) -> None:
    """One INGEST phase: per epoch records_read == records_resident ==
    every record of the dataset and none dropped, the bytes the lanes took
    equal to the dataset times the epochs, the confirmed tier, no kernel
    launched. Prints GiB/s and records/s per epoch."""
    from elbencho_tpu_torch.common import BenchPhase
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.cuda import native
    from elbencho_tpu_torch.workers.local import LocalWorkerGroup

    cfg = config_from_args(args)
    launches = native.kernel_launches()
    group = LocalWorkerGroup(cfg)
    group.prepare()
    try:
        to0 = group._native_path.transferred_bytes[0]
        drive(group, BenchPhase.INGEST, label)
        moved = group._native_path.transferred_bytes[0] - to0
        st, tier = group.ingest_stats(), group.ingest_tier()
        n = cfg.ingest_total_records()
        size = n * cfg.record_size
        bad = [e for e in st["epochs"] if e["read"] != n
               or e["resident"] != n or e["dropped"]]
        if (bad or len(st["epochs"]) != cfg.ingest_epochs
                or moved != size * cfg.ingest_epochs or tier != want_tier
                or group.ingest_error()):
            raise AssertionError(f"{label}: tier {tier}, {st}, device bytes "
                                 f"{moved}, error '{group.ingest_error()}'")
        per_epoch = "; ".join(
            f"epoch {i}: {size / (t / 1e9) / (1 << 30):.3f} GiB/s, "
            f"{n / (t / 1e9):.0f} records/s"
            for i, t in enumerate(st["epoch_time_ns"]))
        phase("ingest-ledger", f"{label}: tier {tier}, {n} records of "
                               f"{cfg.record_size} B per epoch read == "
                               f"resident, 0 dropped, device bytes {moved};"
                               f" {per_epoch}; prefetch peak "
                               f"{st['prefetch_depth_peak']} batches")
    finally:
        group.teardown()
    if native.kernel_launches() != launches:
        raise AssertionError(f"{label}: the ingest path launched a kernel")


def ingest_ledger(d: str) -> None:
    """Phase 22: DL ingestion of a generated 16 x 256 MiB dataset (32768
    records of 128 KiB, about the mean size of an ImageNet-1k training
    JPEG) over two shuffled epochs, then the serial control."""
    t0 = time.perf_counter()
    ds = os.path.join(d, "dataset")
    os.mkdir(ds)
    ingest_run(["-w", "-t", "4", *INGEST_ARGS, ds], "-t 4, pipelined",
               "pipelined")
    # the serial control: one worker with one batch in flight (with more
    # workers the path-wide in-flight gauge sees their batches overlap)
    ingest_run(["-t", "1", "--prefetchbatches", "1", *INGEST_ARGS, ds],
               "-t 1 --prefetchbatches 1, serial", "serial")
    shutil.rmtree(ds)
    phase("ingest-ledger", f"ingest phase took "
                           f"{time.perf_counter() - t0:.1f}s")


def write_manifest(d: str, name: str, paths, devices) -> str:
    man = os.path.join(d, name)
    with open(man, "w") as f:
        json.dump({"version": 1, "shards": [
            {"path": p, "devices": dv} for p, dv in zip(paths, devices)]}, f)
    return man


def checkpoint_restore(d: str, shard_sizes=LLAMA_8B_SHARDS,
                       gen_size: str = "256M") -> None:
    """Phase 18: checkpoint restore at the shard layout of
    meta-llama/Llama-3.1-8B (four bf16 safetensors files; only their byte
    counts are used): every shard on device 0, then over two lanes with
    one shard replicated, then the generated form."""
    t0 = time.perf_counter()
    paths = write_shards(d, shard_sizes)
    s = list(shard_sizes)
    total = sum(s)
    phase("restore", f"{len(s)} shards, {total} bytes written from a seeded "
                     f"generator in {time.perf_counter() - t0:.1f}s")
    man = write_manifest(d, "man0.json", paths, [[0]] * len(s))
    restore(["-t", "4", "--tpubackend", "pjrt", "--checkpoint", man, "--lat",
             "--nolive"], "all shards on device 0", [total])
    man2 = write_manifest(d, "man2.json", paths, [[0], [1], [0], [0, 1]])
    restore(["-t", "4", "--gpuids", "0,0", "--tpubackend", "pjrt",
             "--checkpoint", man2, "--lat", "--nolive"],
            "--gpuids 0,0, shards 0 and 2 on lane 0, 1 on lane 1, 3 on both",
            [s[0] + s[2] + s[3], s[1] + s[3]])
    native_reshard(d, paths)
    run1 = serving_rotation(d, paths)
    for p in paths:
        os.remove(p)
    gen = os.path.join(d, "gen")
    os.mkdir(gen)
    n_gen = 8
    gen_bytes = n_gen * _size_bytes(gen_size)
    restore(["-w", "--checkpoint-shards", str(n_gen), "-s", gen_size, "-t",
             "4", "--tpubackend", "pjrt", "--nolive", gen],
            f"generated, {n_gen} x {gen_size}", [gen_bytes])
    gen_paths = [os.path.join(gen, f"ckpt.shard.{i}") for i in range(n_gen)]
    serving_budgeted(d, run1, gen_paths)
    xfer_mgr_rotation(d, run1, gen_paths)
    os.remove(run1["serve_file"])
    shutil.rmtree(gen)
    phase("restore", f"checkpoint phase took {time.perf_counter() - t0:.1f}s")


def _size_bytes(spec: str) -> int:
    return int(spec[:-1]) << {"K": 10, "M": 20, "G": 30}[spec[-1]]


# Phase 25 runs tools/torch_campaign.py under this probe, which counts the
# engine's kernel launches around each stage and reads, from the stage's
# live group, what the campaign report does not carry (the confirmed tier,
# the reactor's cause, the tenant latency p99); it writes them to
# $EBT_SMOKE_PROBE and leaves the tool, its report and its exit code as
# they are.
CAMPAIGN_PROBE = r"""
import json, os, runpy, sys
from elbencho_tpu_torch import campaign
from elbencho_tpu_torch.cuda import native

sys.argv = sys.argv[1:]
out = {}
snapshot, run_stage = campaign._snapshot, campaign.CampaignRunner._run_stage


def probed_snapshot(group):
    caps = group.plugin_caps() or {}
    out["_live"] = {
        "tier": group.confirm_engaged_tier(),
        "probe": "zero_copy" if caps.get("dma_map") else "staged",
        "stripe_tier": group.confirm_stripe_tier(),
        "lanes": [ln["to_hbm"] for ln in group.lane_stats() or []],
        "reactor_cause": group.reactor_cause() or "",
        "p99_us": {k: h.percentile_us(99.0)
                   for k, h in group.tenant_latency().items()}}
    return snapshot(group)


def probed_run_stage(self, index, st):
    native.reset_kernel_launches()
    try:
        return run_stage(self, index, st)
    finally:
        out[st.name] = dict(out.pop("_live", {}),
                            launches=native.kernel_launches())


campaign._snapshot = probed_snapshot
campaign.CampaignRunner._run_stage = probed_run_stage
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    with open(os.environ["EBT_SMOKE_PROBE"], "w") as f:
        json.dump(out, f)
"""
CAMPAIGN_LANES = ["--tpubackend", "pjrt", "--gpuids", "0,0"]
CAMPAIGN_RATE = 500         # arrivals/s per worker: 125 MiB/s over 4


def campaign_spec() -> dict:
    """Phase 25's campaign: a verified fill of phase 8's 4 GiB, a verified
    striped read of it with the fault policy armed, a 4 x 1 GiB restore,
    10 s of open-loop reads with the reactor seam armed, and an
    8 x 512 MiB reshard onto one lane, all on two lanes of the card (the
    shard counts of campaigns/soak-smoke.json)."""
    size, shard, rshard, secs = "4G", "1G", "512M", 10
    read = ["-r", "-t", "4", "-s", size]
    clean = ["phase_clean"]
    return {"campaign": {
        "name": "card-campaign", "seed": 25, "spec_version": 1,
        "description": "chip_smoke.py phase 25: the port's campaign engine "
                       "on the card at full size"},
        "stages": [
            {"name": "fill", "phase": "write", "path": "campaign.bin",
             "flags": ["-w", "-t", "4", "-s", size, "-b", "8M", "--iodepth",
                       "4", "--verify", "42", *CAMPAIGN_LANES],
             "invariants": clean + ["no_leaks"]},
            {"name": "verified-stripe-read", "phase": "stripe",
             "path": "campaign.bin",
             "flags": read + ["-b", "8M", "--iodepth", "4", "--stripe", "rr",
                              "--verify", "42", "--retry", "1",
                              "--maxerrors", "5%", *CAMPAIGN_LANES],
             "invariants": clean + [
                 "stripe_reconciliation",
                 {"name": "expected_ejections", "equals": 0},
                 "byte_exact_landing", "metrics_consistent", "no_leaks"]},
            {"name": "restore", "phase": "restore", "path": "ckpt",
             "create": "dir",
             "flags": ["--checkpoint-shards", "4", "-w", "-s", shard, "-b",
                       "8M", "-t", "4", *CAMPAIGN_LANES],
             "invariants": clean + ["ckpt_reconciliation",
                                    "metrics_consistent", "no_leaks"]},
            {"name": "open-loop", "phase": "load", "path": "campaign.bin",
             "flags": read + ["-b", "64K", "--arrival", "paced", "--rate",
                              str(CAMPAIGN_RATE), "--timelimit", str(secs),
                              *CAMPAIGN_LANES],
             "chaos": {"reactor": 1.0},
             "invariants": clean + ["open_loop_ledger", "backlog_reported",
                                    "reactor_reconciles",
                                    "metrics_consistent"]},
            {"name": "reshard-drain", "phase": "reshard", "path": "reshard",
             "create": "dir",
             "flags": ["--checkpoint-shards", "8", "-w", "-s", rshard, "-b",
                       "8M", "--reshard", "1", "-t", "4", *CAMPAIGN_LANES],
             "invariants": clean + ["reshard_reconciliation",
                                    "metrics_consistent", "no_leaks"]},
        ]}


def campaign_on_card() -> None:
    """Phase 25: tools/torch_campaign.py on the real driver (no --mock) over
    phase 25's spec, in its own directory under /dev/shm. The campaign must
    hold every invariant, the mock-only ones recorded as skipped; the
    engine must launch B3 once per block in the fill and B1 once per block
    in the verified read, and nothing in the other stages."""
    spec = campaign_spec()
    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="ebt_torch_campaign_", dir="/dev/shm")
    try:
        specp, rep, probe = (os.path.join(d, n) for n in (
            "spec.json", "report.json", "probe.json"))
        with open(specp, "w") as f:
            json.dump(spec, f)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items()
               if k not in ("EBT_TORCH_DEVICE", "EBT_CUDA_DRIVER")}
        env["EBT_SMOKE_PROBE"] = probe
        r = subprocess.run(
            [sys.executable, "-c", CAMPAIGN_PROBE,
             os.path.join(repo, "tools", "torch_campaign.py"), specp,
             "--dir", os.path.join(d, "work"), "--report", rep,
             "--print-fingerprint"],
            cwd=repo, env=env, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-8000:])
            raise AssertionError(f"campaign: tool exit {r.returncode}: "
                                 f"{r.stdout[-2000:]}")
        report = json.load(open(rep))
        live = json.load(open(probe))
        _check_campaign(spec, report, live, r.stdout.strip())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    phase("campaign", f"phase 25 took {time.perf_counter() - t0:.1f}s")


def _compute_sanitizer() -> str | None:
    """compute-sanitizer beside the nvcc the kernels are built with."""
    from elbencho_tpu_torch.ops import kernel_build
    nvcc = shutil.which(kernel_build._nvcc()) or kernel_build._nvcc()
    cs = os.path.join(os.path.dirname(nvcc), "compute-sanitizer")
    return cs if os.path.exists(cs) else shutil.which("compute-sanitizer")


def _selftest_scope(argv: list[str], env: dict, scope: str) -> dict:
    """One scope of the selftest in its own process: exit 0 and "all checks
    passed" required; returns its scope line's numbers."""
    t0 = time.perf_counter()
    r = subprocess.run(argv[:3] + [scope], capture_output=True, text=True,
                       timeout=600, env={**os.environ, **env})
    wall = time.perf_counter() - t0
    if r.returncode != 0 or "cuda selftest: all checks passed" not in \
            r.stdout:
        sys.stderr.write(r.stderr[-8000:])
        raise AssertionError(f"selftest scope {scope}: exit {r.returncode}: "
                             f"{r.stdout[-3000:]}")
    m = re.search(r"^scope \w+: (\d+) checks passed, 0 failed, (\d+) need "
                  r"the mock, ([0-9.]+) s, CudaPath kernel launches verify "
                  r"(\d+) fill (\d+)$", r.stdout, re.M)
    if not m:
        raise AssertionError(f"selftest scope {scope}: no scope line in "
                             f"{r.stdout[-2000:]}")
    return {"passed": int(m[1]), "need_mock": int(m[2]), "secs": float(m[3]),
            "wall": wall, "verify": int(m[4]), "fill": int(m[5]),
            "stdout": r.stdout}


def _sanitized(cs: str, tool: str, argv: list[str], env: dict,
               scope: str) -> str:
    """One scope under compute-sanitizer's `tool`: "0 errors" when the
    selftest passed under it with an error summary of 0; the tool's own
    refusal line when it cannot instrument the card (no pass claimed);
    anything else raises."""
    r = subprocess.run([cs, "--tool", tool, "--error-exitcode", "99",
                        *argv[:3], scope], capture_output=True, text=True,
                       timeout=900, env={**os.environ, **env})
    out = r.stdout + r.stderr
    refused = re.search(r"Error: (Device not supported[^\n]*)", out)
    if refused:
        return f"not run: compute-sanitizer refuses the card: {refused[1]}"
    summary = re.search(r"(ERROR|RACECHECK) SUMMARY: (\d+) (error|hazard)",
                        out)
    if r.returncode == 0 and "cuda selftest: all checks passed" in out and \
            summary and summary[2] == "0":
        return "0 errors"
    sys.stderr.write(out[-8000:])
    raise AssertionError(f"compute-sanitizer --tool {tool} on scope {scope}: "
                         f"exit {r.returncode}, "
                         f"{summary[0] if summary else 'no summary'}")


def selftest_on_card() -> dict:
    """Phase 27: the native selftest (csrc/cuda_selftest.cpp) against the
    real driver and the nvcc-built kernel library, every scope in its own
    process, then the kernels and path scopes under compute-sanitizer.
    Returns the per-scope numbers."""
    from elbencho_tpu_torch import selftest

    card = gpu_name_and_power()
    t0 = time.perf_counter()
    argv, env = selftest.command(mock=False, scope="all")
    rows = {}
    for scope in selftest.SCOPES:
        row = rows[scope] = _selftest_scope(argv, env, scope)
        need = re.findall(r"^needs the mock: (.*)$", row["stdout"], re.M)
        extra = ""
        if scope == "path":
            m = re.search(r"^path: kernel launches from C\+\+: verify_u32 "
                          r"(\d+) fill_u64 (\d+)$", row["stdout"], re.M)
            if not m or int(m[1]) != 3 or int(m[2]) != 1:
                raise AssertionError("selftest path: B1/B3 not launched from "
                                     f"C++ as expected: {row['stdout']}")
            extra = f", B1 {m[1]} and B3 {m[2]} launched from C++"
        if scope == "kernels":
            m = re.search(r"^kernels: held against host loops: verify_u32 "
                          r"(\d+) fill_u64 (\d+) ingest_verify_u32 (\d+) "
                          r"sum_rows_u64 (\d+) launches$", row["stdout"],
                          re.M)
            if not m or min(int(m[i]) for i in range(1, 5)) < 1:
                raise AssertionError("selftest kernels: an entry was not "
                                     f"held: {row['stdout']}")
            extra = (f", held against host loops: verify_u32 {m[1]}, "
                     f"fill_u64 {m[2]}, ingest_verify_u32 {m[3]}, "
                     f"sum_rows_u64 {m[4]} launches")
        phase("selftest", f"scope {scope}: {row['passed']} checks passed, "
                          f"{row['need_mock']} need the mock"
                          f"{' (' + '; '.join(need) + ')' if need else ''}, "
                          f"{row['secs']:.3f} s in the scope, "
                          f"{row['wall']:.3f} s wall, CudaPath launches "
                          f"verify {row['verify']} fill {row['fill']}"
                          f"{extra} [{card}]")
    cs = _compute_sanitizer()
    if not cs:
        phase("selftest", "compute-sanitizer is not installed beside nvcc: "
                          "the sanitized runs were not made")
    else:
        version = subprocess.run([cs, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout.split("\n")
        phase("selftest", f"{cs}: {version[-1] or version[-2]}")
        for tool in SANITIZER_TOOLS:
            for scope in SANITIZED_SCOPES:
                t1 = time.perf_counter()
                verdict = _sanitized(cs, tool, argv, env, scope)
                phase("selftest", f"compute-sanitizer --tool {tool} scope "
                                  f"{scope}: {verdict} "
                                  f"({time.perf_counter() - t1:.1f}s)")
    phase("selftest", f"phase 27 took {time.perf_counter() - t0:.1f}s "
                      f"[{card}]")
    return rows


# phase 28: the port's headline bench in a child process (its watchdog ends
# the process with os._exit(3)), its pair counts shrunk through module
# attributes, its ledger under a temp dir; after main() the child writes the
# engine's and the wrappers' kernel launches, which the bench must not move
BENCH_CHILD = """
import json, sys
import elbencho_tpu_torch.bench as b
from elbencho_tpu_torch.cuda import native
from elbencho_tpu_torch.ops import fill_kernel, ingest_kernel, verify_kernel
b.NUM_PAIRS, b.WRITE_PAIRS, b.RAND_PAIRS, b.MIN_READ_PAIRS = 4, 5, 3, 2
b.REPO = sys.argv[1]
sys.argv = [sys.argv[0], "--raw"]
native.reset_kernel_launches()
rc = b.main()
launches = dict(native.kernel_launches())
for m in (fill_kernel, ingest_kernel, verify_kernel):
    launches.update(m.LAUNCHES)
with open(b.REPO + "/launches.json", "w") as f:
    json.dump(launches, f)
sys.exit(rc)
"""
BENCH_TIMEOUT_S = 300
# a graded pair's framework reading in the bench's --raw lines: read
# "pair[i] framework(<backend>)", write "wpair[i] framework write", random
# "rpair[i] framework rand"
BENCH_PAIR_LINE = re.compile(
    r"\] (w|r)?pair\[(\d+)\] framework(?:\(\w+\)| write| rand) = "
    r"([0-9.]+) MiB/s")


def bench_pair_spread(stdout: str) -> dict:
    """MiB/s of each leg's graded pairs (the warm-up pair and discarded
    ones left out) from the bench's --raw lines: {"read": [...], "write":
    [...], "rand": [...]}."""
    legs = {"read": [], "write": [], "rand": []}
    for line in stdout.splitlines():
        m = BENCH_PAIR_LINE.search(line)
        if m and int(m.group(2)) > 0 and "discarded" not in line:
            leg = {"w": "write", "r": "rand"}.get(m.group(1), "read")
            legs[leg].append(float(m.group(3)))
    return legs


def _uring_leg_ok(rep: dict) -> tuple[bool, str]:
    """The io_uring A/B leg, the one leg whose outcome depends on the host:
    aio with its cause where the kernel refuses io_uring (the card's
    machine), else uring with a ratio, or the original's engagement
    refusal. Returns (ok, which branch ran)."""
    ur = rep["legs"].get("uring", {})
    engine = ur.get("ioengine")
    if engine == "aio":
        return (bool(ur.get("ioengine_cause")) and rep["uring_error"] is None
                and (ur.get("aio_mib_s") or 0) > 0,
                f"aio ({ur.get('ioengine_cause')})")
    if engine == "uring":
        if rep["uring_error"] is None:
            return ((ur.get("uring_vs_aio") or 0) > 0,
                    f"uring, uring_vs_aio {ur.get('uring_vs_aio')}")
        return (rep["uring_error"] == URING_REFUSAL,
                f"uring refused on kernel {platform.release()}: "
                f"{rep['uring_error']}")
    return False, f"no resolved engine ({ur})"


# the original bench's io_uring engagement refusal, word for word
URING_REFUSAL = ("uring engagement not confirmed: resolved backend is uring "
                 "but uring_fixed_hits did not move")
FAULTS_SKIP = ("fault seams are mock-only (EBT_CUDA_DRIVER must point at "
               "libebtcudamock.so)")


def bench_on_card() -> dict:
    """Phase 28: python -m elbencho_tpu_torch.bench's main() on the card
    (libcuda.so.1) with NUM_PAIRS 4, WRITE_PAIRS 5, RAND_PAIRS 3 and
    MIN_READ_PAIRS 2, all thirteen legs. Its last line must grade the
    native path: rc 0, backend pjrt with no fallback, tier zero_copy with
    no mismatch, no wedge, both ceiling ratios in (0, 1.05], random IOPS,
    the scale and checkpoint legs clean, the stripe and reshard legs run or
    skipped with their note, the metadata, load, serving and ingest legs
    clean, the io_uring leg on its host's branch, the faults leg's
    mock-only skip, and no kernel launched. Returns the report."""
    card = gpu_name_and_power()
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("EBT_TORCH_DEVICE", "EBT_CUDA_DRIVER")}
    d = tempfile.mkdtemp(prefix="ebt_torch_bench_")
    try:
        r = subprocess.run([sys.executable, "-c", BENCH_CHILD, d], cwd=repo,
                           env=env, capture_output=True, text=True,
                           timeout=BENCH_TIMEOUT_S)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            sys.stderr.write(r.stderr[-8000:])
            raise AssertionError(f"bench: rc {r.returncode}, last line "
                                 f"{lines[-1] if lines else None}")
        rep = json.loads(lines[-1])
        spread = bench_pair_spread(r.stdout)
        with open(os.path.join(d, "launches.json")) as f:
            launches = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    legs = rep["legs"]
    uring_ok, uring_branch = _uring_leg_ok(rep)
    checks = {
        "backend pjrt": rep["backend"] == "pjrt",
        "no fallback": rep["fallback_events"] == 0,
        "tier zero_copy": rep["tier"] == "zero_copy",
        "no tier mismatch": rep["tier_mismatch"] is None,
        "not wedged": rep["wedged"] is None,
        "0 < vs_baseline <= 1.05": 0 < rep["vs_baseline"] <= 1.05,
        "0 < write_vs_d2h_ceiling <= 1.05":
            0 < (rep["write_vs_d2h_ceiling"] or 0) <= 1.05,
        "rand_iops > 0": (rep["rand_iops"] or 0) > 0,
        "scale leg clean": rep["scale_error"] is None
            and "error" not in legs.get("scale", {"error": "missing"}),
        "ckpt leg clean": rep["ckpt_error"] is None
            and "error" not in legs.get("ckpt", {"error": "missing"}),
        "stripe leg ran or skipped": rep["stripe_error"] is None and (
            "skipped" in legs.get("stripe", {})
            or legs.get("stripe", {}).get("tier") == "striped"),
        "reshard leg ran or skipped": rep["reshard_error"] is None and (
            "skipped" in legs.get("reshard", {})
            or legs.get("reshard", {}).get("engagement") == "confirmed"),
        "meta leg clean": rep["meta_error"] is None
            and (rep["meta_vs_ceiling"] or 0) > 0,
        "uring leg on its host's branch": uring_ok,
        "load leg clean": rep["load_error"] is None
            and legs.get("load", {}).get("curve_monotone") is True
            and legs.get("load", {}).get("ab_bytes_identical") is True,
        "serving leg confirmed": rep["serving_error"] is None
            and rep["serving_engagement"] == "confirmed",
        "faults leg skipped (mock-only)": rep["faults_error"] is None
            and legs.get("faults") == {"skipped": FAULTS_SKIP},
        "ingest leg clean": rep["ingest_error"] is None
            and rep["ingest_tier"] in ("pipelined", "serial")
            and (rep["ingest_records_s"] or 0) > 0,
        "no kernel launched": not any(launches.values()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench: {failed}; report {json.dumps(rep)}")
    gib = 1024.0
    sl = legs["scale"]
    ck = legs["ckpt"]
    phase("bench", f"READ {rep['value'] / gib:.3f} GiB/s, "
                   f"{rep['vs_baseline']} of the in-session H2D ceiling "
                   f"({rep['native_ceiling_mib_s'] / gib:.3f} GiB/s), "
                   f"pairs {rep['pairs']}, python pageable-copy ceiling "
                   f"{rep['python_ceiling_mib_s'] / gib:.3f} GiB/s [{card}]")
    phase("bench", f"WRITE {rep['write_value'] / gib:.3f} GiB/s, "
                   f"{rep['write_vs_d2h_ceiling']} of the D2H ceiling "
                   f"({rep['d2h_ceiling_mib_s'] / gib:.3f} GiB/s), "
                   f"{rep['write_pairs']} pairs, tier {rep['write_tier']} "
                   f"[{card}]")
    phase("bench", f"RANDOM {rep['rand_block_kib']} KiB at iodepth "
                   f"{rep['rand_iodepth']}: {rep['rand_value'] / gib:.3f} "
                   f"GiB/s, {rep['rand_iops']} IOPS, "
                   f"{rep['rand_vs_ceiling']} of its ceiling "
                   f"({rep['rand_ceiling_mib_s'] / gib:.3f} GiB/s); device "
                   f"p50 {rep['dev_p50_us']} us p99 {rep['dev_p99_us']} us "
                   f"(n {rep['dev_lat_n']}, clock {rep['dev_lat_clock']}) "
                   f"[{card}]")
    phase("bench", f"SCALE -t 1 {sl['t1_value'] / gib:.3f} GiB/s, "
                   f"-t {sl['threads']} {sl['value'] / gib:.3f} GiB/s "
                   f"(efficiency {sl['efficiency']}), single lane "
                   f"{sl['single_lane_value'] / gib:.3f} GiB/s, lock wait "
                   f"{sl['lock_wait_ns']} ns, ceilings {sl['ceiling_mib_s']} "
                   f"MiB/s [{card}]")
    phase("bench", f"CKPT {ck['shards']} shards x {ck['shard_bytes']} B "
                   f"on {ck['devices']} device(s): cold ttr p50 "
                   f"{ck['cold']['ttr_p50_s']} s p99 "
                   f"{ck['cold']['ttr_p99_s']} s "
                   f"({ck['cold'].get('vs_device_ceiling_sum')} of the "
                   f"ceiling floor), warm p50 {ck['warm']['ttr_p50_s']} s, "
                   f"under load p50 {ck['under_load']['ttr_p50_s']} s; "
                   f"stripe {legs['stripe']}; reshard {legs['reshard']} "
                   f"[{card}]")
    me, ld, sv, ig = (legs["meta"], legs["load"], legs["serving"],
                      legs["ingest"])
    phase("bench", f"META {me['total_files']} files at -t {me['threads']}: "
                   f"mkdirs {me['mkdirs_per_s']}/s, stat "
                   f"{me['stat_per_s']}/s, delfiles {me['delfiles_per_s']}"
                   f"/s, median {me['vs_ceiling']} of the raw-syscall "
                   f"ceilings {me['ceiling_per_s']} [{card}]")
    phase("bench", f"URING branch {uring_branch}: aio "
                   f"{legs['uring'].get('aio_mib_s')} MiB/s "
                   f"({legs['uring'].get('aio_vs_raw')} of raw pread "
                   f"{legs['uring'].get('raw_pread_mib_s')} MiB/s) [{card}]")
    phase("bench", f"LOAD closed loop {ld['closed_loop_iops']} IOPS, knee "
                   f"{ld['knee_frac']}, offered/achieved IOPS "
                   + ", ".join(f"{p['offered_frac']}x "
                               f"{p['offered_iops']}/{p['achieved_iops']}"
                               for p in ld["points"])
                   + "; worst class p99 us "
                   + "/".join(str(max(c["p99_us"]
                                      for c in p["classes"].values()))
                              for p in ld["points"])
                   + f"; reactor {ld['reactor_enabled']}, mid-grid "
                   f"sched_lag {rep['reactor_sched_lag_ns']} ns vs poll "
                   f"{rep['poll_sched_lag_ns']} ns [{card}]")
    phase("bench", f"SERVING closed loop {sv['closed_loop_iops']} IOPS, "
                   f"baseline p99 {sv['baseline_p99_us']} us, slo "
                   f"{sv['slo_target_ms']} ms; " + "; ".join(
                       f"budget {p['bgbudget']} B/s: goodput "
                       f"{p['goodput']}, p99 {p['p99_us']} us, "
                       f"{p['rotations']} rotation(s), ttr "
                       f"{p['ttr_mean_s']} s, throttle "
                       f"{p['bg_throttle_ms']} ms"
                       for p in sv["frontier"]) + f" [{card}]")
    phase("bench", f"FAULTS {legs['faults']}; INGEST "
                   f"{ig['ingest_records_s']} records/s ({ig['tier']}, "
                   f"epoch p50 {ig['epoch_p50_s']} s, "
                   f"{ig['vs_ceiling']} of the raw record ceiling "
                   f"{ig['ceiling_records_s']}/s), records "
                   f"{ig['ingest']['records_read']} read / "
                   f"{ig['ingest']['records_resident']} resident [{card}]")
    # the medians above stand on a few pairs of 128 MiB windows each: the
    # spread of the pairs beside them says how far one reading can move
    phase("bench", "graded pairs, MiB/s min-max (n): " + "; ".join(
        f"{leg} {min(v)}-{max(v)} ({len(v)})" if v else f"{leg} none"
        for leg, v in spread.items()) + f" [{card}]")
    phase("bench", f"phase 28 took {time.perf_counter() - t0:.1f}s, file "
                   f"window {rep['reg_window']} B registered, engine and "
                   f"wrapper launches {launches} [{card}]")
    return rep


def _check_campaign(spec: dict, report: dict, live: dict,
                    printed: str) -> None:
    if not report["ok"] or report["violations"]:
        raise AssertionError(f"campaign: {report['violations']}")
    if printed != report["fingerprint"]:
        raise AssertionError(f"campaign: printed '{printed}', report "
                             f"{report['fingerprint']}")
    gib = 1 << 30
    for st, want in zip(report["stages"], spec["stages"]):
        name, stats = st["stage"], st["stats"]
        flags, got = want["flags"], live[st["stage"]]
        if st["error"] or not st["ok"] or name != want["name"]:
            raise AssertionError(f"campaign stage {name}: {st['error']}")
        for inv in st["invariants"]:
            mock_only = inv["name"] in ("byte_exact_landing", "no_leaks")
            if mock_only != bool(inv["skipped"]):
                raise AssertionError(f"campaign stage {name}: {inv}")
        # one launch per block under --verify (phases 9 and 16), else none
        blocks = _size_bytes(flags[flags.index("-s") + 1]) // (8 << 20)
        kernel = ({"-w": "fill_u64", "-r": "verify_u32"}[flags[0]]
                  if "--verify" in flags else None)
        want_l = {k: blocks if k == kernel else 0
                  for k in ("verify_u32", "fill_u64")}
        if got["launches"] != want_l:
            raise AssertionError(f"campaign stage {name}: launches "
                                 f"{got['launches']}, want {want_l}")
        secs = stats["elapsed_us"] / 1e6
        rate = stats["ops"]["bytes"] / secs / gib
        line = (f"stage {name} ({st['phase']}): {st['timing']['wall_s']} s "
                f"wall, phase {secs:.3f} s, engine launches "
                f"{got['launches']}")
        if name == "fill":
            line += f"; WRITE {rate:.3f} GiB/s"
        elif st["phase"] in ("stripe", "load"):
            # the confirmed tier, as phase 8 prints it; a verified read
            # takes the engine's verified (staged) path whatever the probe
            want_t = "staged" if kernel else got["probe"]
            if got["tier"] != want_t:
                raise AssertionError(f"campaign stage {name}: tier "
                                     f"{got['tier']} (probe {got['probe']})")
            line += (f"; READ {rate:.3f} GiB/s; tier {got['tier']} (probe "
                     f"{got['probe']})")
        if st["phase"] == "stripe":
            # the verified path keeps no stripe-unit ledger (as in the
            # original): the planner's placement shows in the lanes' bytes
            half = stats["ops"]["bytes"] // 2
            if got["lanes"] != [half, half] or \
                    stats["faults"]["ejected_devices"] != 0:
                raise AssertionError(f"campaign stage {name}: lane bytes "
                                     f"{got['lanes']}, faults "
                                     f"{stats['faults']}")
            line += f", lane bytes {got['lanes']}"
        elif st["phase"] == "restore":
            line += f"; RESTORE {rate:.3f} GiB/s, {stats['ckpt']}"
        elif st["phase"] == "reshard":
            rs = stats["reshard"]
            line += (f"; RESHARD {rs['d2d_resident_bytes'] / secs / gib:.3f} "
                     f"GiB/s ({rs['d2d_resident_bytes']} bytes moved, "
                     f"{rs['d2d_moves']} d2d / {rs['bounce_moves']} bounce "
                     f"chunk moves)")
        elif st["phase"] == "load":
            if list(st["chaos_env"]) != ["EBT_MOCK_REACTOR_FAIL_AT"]:
                raise AssertionError(f"campaign stage {name}: chaos_env "
                                     f"{st['chaos_env']}")
            if "EBT_MOCK_REACTOR_FAIL_AT" not in got["reactor_cause"]:
                raise AssertionError(f"campaign stage {name}: reactor cause "
                                     f"'{got['reactor_cause']}'")
            ledger = [(t["arrivals"], t["completions"], t["dropped"])
                      for t in stats["tenants"]]
            line += (f"; chaos_env {st['chaos_env']}, tenant (arrivals, "
                     f"completions, dropped) {ledger}, open-loop p99 "
                     f"{got['p99_us']} us; reactor cause (from the live "
                     f"group: the report has no field for it) "
                     f"'{got['reactor_cause']}'")
        phase("campaign", line)
    phase("campaign", f"ok, no violations; fingerprint {printed}")



DIRECT_ERRORS_CHILD = """
import json
import chip_smoke as c
print(json.dumps(c.direct_errors_child()))
"""
DIRECT_ERRORS_TIMEOUT_S = 120
EXAMPLES_TIMEOUT_S = 300    # phase 30's limit, the harness's own


class _CountedEvent:
    """A chunk's CUDA event that records each wait on it."""

    def __init__(self, event, waited: list) -> None:
        self.event, self.waited = event, waited

    def synchronize(self) -> None:
        self.waited.append(self)
        if self.event is not None:  # None: a copy on the CPU
            self.event.synchronize()

    def query(self) -> bool:
        return self.event is None or self.event.query()


def direct_errors_child() -> dict:
    """Phase 29's three cases, in this process, on cuda:0: each case's
    return codes at submit and at the barrier, and the inline partial
    failure's waits and landed bytes."""
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.cuda.backend import TorchStagingPath

    d = tempfile.mkdtemp(prefix="ebt_torch_direct_errors_")
    path = os.path.join(d, "x")
    with open(path, "wb") as f:
        f.write(b"\0" * (64 << 10))
    buf = np.random.default_rng(29).integers(0, 256, 64 << 10,
                                             dtype=np.uint8)

    def staging(env: dict):
        with env_set(**env):
            return TorchStagingPath(config_from_args(
                ["-r", "-t", "1", "-b", "64k", "--gpuids", "0",
                 "--tpubackend", "direct", "--nolive", path]))

    def boom(view, dev_idx, dst=None):
        raise RuntimeError("boom")

    def pair(sp) -> list[int]:
        try:
            return [sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, 0),
                    sp.copy(0, 0, 2, buf.ctypes.data, buf.nbytes, 0)]
        finally:
            sp.close()

    out = {}
    try:
        sp = staging({"EBT_TPU_SUBMITTERS": "1"})
        threaded = sp.num_submitters == 1 and not sp.inline_submit
        sp._copy_to_device = boom
        out["submitter"] = pair(sp) + [threaded]

        sp = staging({"EBT_TPU_CHUNK_BYTES": str(32 << 10)})
        real, calls, waited, landed = sp._copy_to_device, [], [], []

        def second_fails(view, dev_idx, dst=None):
            calls.append(view.nbytes)
            if len(calls) > 1:
                raise RuntimeError("boom on chunk 2")
            arr, event = real(view, dev_idx, dst)
            landed.append(arr)
            return arr, _CountedEvent(event, waited)

        sp._copy_to_device = second_fails
        inline = sp.inline_submit and sp.devices[0].type == "cuda"
        rcs = pair(sp)
        first = landed[0].cpu().numpy().tobytes() if landed else b""
        out["partial"] = rcs + [inline, calls, len(waited),
                                first == buf[:32 << 10].tobytes(),
                                sp.transferred_bytes[0]]

        sp = staging({})
        sp._copy_to_device = boom
        out["inline"] = pair(sp) + [sp.inline_submit]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def direct_errors_on_card() -> dict:
    """Phase 29: direct_errors_child() in a child process with its own
    time limit; each case's codes must be the original's. Returns its
    results."""
    card = gpu_name_and_power()
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("EBT_TORCH_DEVICE", "EBT_TPU_SUBMITTERS",
                        "EBT_TPU_CHUNK_BYTES")}
    try:
        r = subprocess.run([sys.executable, "-c", DIRECT_ERRORS_CHILD],
                           cwd=repo, env=env, capture_output=True,
                           text=True, timeout=DIRECT_ERRORS_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"direct backend errors: hung past "
                             f"{DIRECT_ERRORS_TIMEOUT_S} s") from e
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        sys.stderr.write(r.stderr[-8000:])
        raise AssertionError(f"direct backend errors: rc {r.returncode}")
    got = json.loads(lines[-1])
    want = {"submitter": [0, 1, True],
            "partial": [1, 0, True, [32 << 10, 32 << 10], 1, True, 0],
            "inline": [1, 0, True]}
    if got != want:
        raise AssertionError(f"direct backend errors: {got} != {want}")
    causes = [ln for ln in r.stderr.splitlines() if "copy error" in ln]
    if len(causes) != 3:
        raise AssertionError(f"direct backend errors: causes {causes}")
    phase("29 direct errors",
          f"submitter error: submit rc {got['submitter'][0]}, barrier rc "
          f"{got['submitter'][1]}; inline partial failure: submit rc "
          f"{got['partial'][0]}, barrier rc {got['partial'][1]}, "
          f"{got['partial'][4]} registered chunk waited, its bytes landed; "
          f"inline error: submit rc {got['inline'][0]}, barrier rc "
          f"{got['inline'][1]}; {time.perf_counter() - t0:.1f} s "
          f"(limit {DIRECT_ERRORS_TIMEOUT_S} s) on {card}")
    return got


def examples_on_card() -> dict[str, tuple[str, float]]:
    """Phase 30: tools/torch_test_examples.sh --card -b under its own time
    limit; every tier must pass. Returns {tier: (verdict, seconds)}."""
    card = gpu_name_and_power()
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("EBT_TORCH_DEVICE", "EBT_CUDA_DRIVER")}
    try:
        r = subprocess.run(
            ["bash", os.path.join(repo, "tools", "torch_test_examples.sh"),
             "--card", "-b"], cwd=repo, env=env, capture_output=True,
            text=True, timeout=EXAMPLES_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"examples harness: past its "
                             f"{EXAMPLES_TIMEOUT_S} s limit") from e
    tiers = {name: (verdict, float(secs)) for name, verdict, secs in
             re.findall(r"^TIER (\w+) (\w+) ([\d.]+)$", r.stdout, re.M)}
    secs = time.perf_counter() - t0
    skipped = re.findall(r"^SKIPPED (?:TIER|RUN) (.*)$", r.stdout, re.M)
    phase("30 examples",
          ", ".join(f"{n} {v} {t:.1f} s" for n, (v, t) in tiers.items())
          + f"; skipped: {skipped or 'none'}; {secs:.1f} s (limit "
          f"{EXAMPLES_TIMEOUT_S} s) on {card}")
    want = ("multifile", "tooling", "native", "dist2", "dist4", "mesh")
    if r.returncode != 0 or tuple(tiers) != want or any(
            v != "pass" for v, _ in tiers.values()):
        sys.stderr.write(r.stdout[-12000:] + r.stderr[-4000:])
        raise AssertionError(f"examples harness: rc {r.returncode}, "
                             f"tiers {tiers}")
    return tiers


INSTALLED_TIMEOUT_S = 300  # phase 31's limit
# phase 31's child: run with its working directory at the copy's root and
# no PYTHONPATH, so the copy is the only one of the repository's files on
# sys.path; argv: the repository root, the scratch directory
INSTALLED_CHILD = r"""
import contextlib, io, json, os, subprocess, sys

started = []
_Popen = subprocess.Popen


class _Recorded(_Popen):
    def __init__(self, args, *a, **k):
        started.append([str(x) for x in ([args] if isinstance(args, str)
                                         else args)])
        super().__init__(args, *a, **k)


subprocess.Popen = _Recorded
repo, scratch = sys.argv[1:3]
on_path = [os.path.realpath(p or os.getcwd()) for p in sys.path]
import elbencho_tpu_torch
from elbencho_tpu_torch import cli, engine
from elbencho_tpu_torch.cuda import native

block, chunk, size, salt = 4 << 20, 2 << 20, 1 << 30, 42
path = os.path.join(scratch, "installed1g")
args = ["-t", "2", "-s", "1G", "-b", "4M", "--verify", str(salt),
        "--gpuids", "0", "--tpubackend", "pjrt", "--nolive", path]


def run(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    sys.stderr.write(err.getvalue())
    return rc, err.getvalue()


native.reset_kernel_launches()
rc, _ = run(["-w", "-r", *args])
launches = native.kernel_launches()
corrupt = 11 * block + chunk + 777
with open(path, "r+b") as f:
    f.seek(corrupt)
    b = f.read(1)
    f.seek(corrupt)
    f.write(bytes([b[0] ^ 0x5A]))
corrupt_rc, err = run(["-r", *args])
want = f"on-device data verification failed at file offset {corrupt}"
os.remove(path)
maps = {ln.split()[-1] for ln in open("/proc/self/maps") if "/" in ln}
print(json.dumps({
    "package": os.path.realpath(os.path.dirname(elbencho_tpu_torch.__file__)),
    "repo_on_path": [p for p in on_path
                     if p == repo or p.startswith(repo + os.sep)],
    "prebuilt": os.path.realpath(engine.PREBUILT_DIR),
    "in_checkout": engine.in_checkout(),
    "rc": rc, "launches": launches, "blocks": size // block,
    "corrupt_rc": corrupt_rc, "corrupt_found": want in err,
    "corrupt_offset": corrupt, "started": started,
    "engine": sorted(m for m in maps if m.endswith("/libebtcore.so")),
    "kernels": sorted(m for m in maps
                      if m.endswith("/libebt_torch_kernels.so"))}))
"""
COMPILERS = ("g++", "gcc", "c++", "cc", "nvcc", "clang++", "clang")


def installed_on_card() -> dict:
    """Phase 31: `make torch`, then the package alone in a temporary
    directory, run from there on the card in a child process, then the
    distributed evidence tool; all inside INSTALLED_TIMEOUT_S. Returns the
    child's report."""
    card = gpu_name_and_power()
    t0 = time.perf_counter()
    deadline = t0 + INSTALLED_TIMEOUT_S
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("EBT_TORCH_DEVICE", "EBT_CUDA_DRIVER", "PYTHONPATH",
                        "EBT_TORCH_CORE_LIB", "EBT_TORCH_MOCK_LIB")}

    def child(argv, cwd, what):
        try:
            r = subprocess.run(argv, cwd=cwd, env=env, capture_output=True,
                               text=True, errors="replace",
                               timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"installed port: {what} ran past the "
                                 f"phase's {INSTALLED_TIMEOUT_S} s") from e
        if r.returncode:
            sys.stderr.write(r.stdout[-8000:] + r.stderr[-8000:])
            raise AssertionError(f"installed port: {what}: rc "
                                 f"{r.returncode}")
        return r

    make = child(["make", "torch"], repo, "make torch")
    build_s = time.perf_counter() - t0
    for line in make.stdout.splitlines():
        phase("31 make torch", line)
    if "kernels: not built" in make.stdout:
        raise AssertionError("installed port: make torch built no kernel "
                             "library on the card")
    root = os.path.realpath(tempfile.mkdtemp(prefix="ebt_torch_installed_"))
    pkg = os.path.join(root, "elbencho_tpu_torch")
    prebuilt = os.path.join(pkg, "_prebuilt")
    try:
        if os.path.realpath(root).startswith(repo + os.sep):
            raise AssertionError(f"installed port: {root} lies inside the "
                                 "repository")
        shutil.copytree(os.path.join(repo, "elbencho_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        with scratch_dir(2 << 30) as d:
            r = child([sys.executable, "-c", INSTALLED_CHILD, repo, d], root,
                      "the copy's 1 GiB --verify run")
        sys.stderr.write(r.stderr[-4000:])
        got = json.loads(r.stdout.strip().splitlines()[-1])
        beside = sorted(os.listdir(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    compilers = [a for a in got["started"]
                 if any(os.path.basename(x) in COMPILERS for x in a)]
    problems = []
    if got["package"] != pkg or \
            got["repo_on_path"] or got["in_checkout"] or \
            got["prebuilt"] != prebuilt:
        problems.append(f"not the copy alone: package {got['package']}, "
                        f"repo on sys.path {got['repo_on_path']}, "
                        f"in_checkout {got['in_checkout']}")
    if got["rc"] != 0 or got["launches"] != {"verify_u32": got["blocks"],
                                             "fill_u64": got["blocks"]}:
        problems.append(f"rc {got['rc']}, engine launches {got['launches']} "
                        f"for {got['blocks']} blocks each way")
    if got["corrupt_rc"] != 1 or not got["corrupt_found"]:
        problems.append(f"corrupt run rc {got['corrupt_rc']}, offset "
                        f"{got['corrupt_offset']} not reported")
    if compilers:
        problems.append(f"compilers started: {compilers}")
    if beside != ["elbencho_tpu_torch"]:
        problems.append(f"beside the copy: {beside}")
    if got["engine"] != [os.path.join(prebuilt, "libebtcore.so")] or \
            got["kernels"] != [os.path.join(prebuilt,
                                            "libebt_torch_kernels.so")]:
        problems.append(f"loaded engine {got['engine']}, kernels "
                        f"{got['kernels']}")
    if problems:
        raise AssertionError("installed port: " + "; ".join(problems))
    run_s = time.perf_counter() - t0 - build_s

    evidence = os.path.join(repo, "results", "torch_distributed")
    existed = os.path.isdir(evidence)
    before = set(os.listdir(evidence)) if existed else set()
    t_ev = time.perf_counter()
    try:
        ev = child(["bash", os.path.join(repo, "tools",
                                         "torch_record_distributed_evidence.sh")],
                   repo, "the distributed evidence tool")
    finally:
        if existed:
            for name in set(os.listdir(evidence)) - before:
                shutil.rmtree(os.path.join(evidence, name),
                              ignore_errors=True)
        else:
            shutil.rmtree(evidence, ignore_errors=True)
    if "(master rc=0)" not in ev.stdout:
        raise AssertionError(f"installed port: evidence tool: "
                             f"{ev.stdout[-2000:]}")
    ev_s = time.perf_counter() - t_ev
    secs = time.perf_counter() - t0
    phase("31 installed",
          f"make torch {build_s:.1f} s; the copy (no core/, no build/, "
          f"loaded {got['engine'][0]} and {got['kernels'][0]}, no compiler "
          f"started) ran 1 GiB --verify 42 write+read in {run_s:.1f} s: rc 0, "
          f"engine launches {got['launches']} for {got['blocks']} blocks "
          f"each way, corrupt byte at {got['corrupt_offset']} reported (rc "
          f"1); evidence tool master rc 0 in {ev_s:.1f} s; {secs:.1f} s "
          f"(limit {INSTALLED_TIMEOUT_S} s) on {card}")
    return got


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

    # the 4 GiB file, the 1 GiB stripe file and the 16.1 GB checkpoint
    with scratch_dir(4 * (4 << 30) + sum(LLAMA_8B_SHARDS)) as d:
        vk.reset_launches()  # count only the main path's launches
        main_path(cli, d)
        os.environ["EBT_TPU_CHUNK_BYTES"] = str(CHUNK)
        try:
            staged_launches = verify_run(cli, vk, d)
        finally:
            del os.environ["EBT_TPU_CHUNK_BYTES"]
        fk.reset_launches()
        path, chunked = native_main_path(d)
        xfer_mgr_read(path, chunked)
        chaos_on_card(path)
        launches = native_verify_run(cli, native, d)
        if fk.LAUNCHES["fill_block_u32"]:
            raise AssertionError("the fill wrapper launched on the native "
                                 "path; the engine launches from C++")
        read_pairs(cli, path, d)
        native_stripe(path, 2 << 30)
        native.reset_kernel_launches()
        native_faults(path, 4 << 30)
        if any(native.kernel_launches().values()):
            raise AssertionError("the faults phase launched a kernel")
        os.remove(path)
        path, stripe_launches = native_stripe_verify(cli, native, d)
        staged_tiers(path, 1 << 30)
        os.remove(path)
        tpustripe_launches = staged_stripe_verify(cli, vk, d)
        checkpoint_restore(d)
        ingest_ledger(d)
        slice_launches = slice_main_path(ik, integ, mesh, graft_entry)
        distributed_run(cli, d)
    campaign_on_card()
    selftest_on_card()
    bench_on_card()
    direct_errors_on_card()
    examples_on_card()
    installed = installed_on_card()
    phase("launches", f"staged --verify run: {staged_launches} verify "
                      f"launches (Python wrapper); native --verify run: "
                      f"{launches} (C++ engine); native --stripe --verify "
                      f"run: {stripe_launches} (C++ engine); staged "
                      f"--tpustripe --verify run: {tpustripe_launches} "
                      f"(Python wrapper); slice path: {slice_launches}; installed "
                      f"copy's native --verify run (phase 31): "
                      f"{installed['launches']} (C++ engine, _prebuilt/)")

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
                      "hundred bytes; an empty kernel of the same block "
                      f"shape takes {reduce_main['floor']:.6f} ms on this "
                      "card (CUDA-graph replay), the floor of any launch",
        "library_ms": reduce_main["lib"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
