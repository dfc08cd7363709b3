"""Checkpoint restore on the port (--checkpoint, --checkpoint-shards) against
the original package's, on the same inputs.

The port runs its CUDA engine (csrc/cuda_path.cpp) on the mock CUDA driver
(EBT_MOCK_CUDA_DEVICES=4), the original its PjrtPath on the mock PJRT plugin
(EBT_MOCK_PJRT_DEVICES=4); both restore the same manifests and shard files.
Refusal texts, shard and byte counters, per-device resident bytes and
result-tree fields compare exactly; only the per-device fault seam's name
differs in an error text (EBT_MOCK_STRIPE_FAIL_AT there,
EBT_MOCK_CUDA_DEV_FAIL_AT here).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.checkpoint as jax_checkpoint
import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.checkpoint as torch_checkpoint
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
import elbencho_tpu_torch.workers.remote as torch_remote
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
BLK = 256 << 10


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.ebt_mock_total_bytes.restype = ctypes.c_uint64
    lib.ebt_mock_checksum.restype = ctypes.c_uint64
    return lib


def _pkg(name, cfg_mod, local, common, exc, stats, remote, ckpt, lib):
    return SimpleNamespace(
        name=name, config_from_args=cfg_mod.config_from_args,
        Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
        ProgException=exc.ProgException, Statistics=stats.Statistics,
        Remote=remote.RemoteWorkerGroup, checkpoint=ckpt, mock=lib)


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port) on their mocks, 4 devices each, counters zeroed."""
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "4")
    made = (
        _pkg("jax", jax_config, jax_local, jax_common, jax_exceptions,
             jax_stats, jax_remote, jax_checkpoint, _mock_lib(JAX_MOCK)),
        _pkg("torch", torch_config, torch_local, torch_common,
             torch_exceptions, torch_stats, torch_remote, torch_checkpoint,
             _mock_lib(torch_mock)))
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def write_manifest(d, shards: list[dict], name="manifest.json") -> str:
    path = d / name
    path.write_text(json.dumps({"version": 1, "shards": shards}))
    return str(path)


def write_shard(d, name: str, nbytes: int = BLK, seed: int = 0) -> str:
    p = d / name
    p.write_bytes(np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes())
    return name


def ckpt_args(manifest: str, extra=()) -> list[str]:
    return ["--checkpoint", manifest, "-b", str(BLK), "--tpubackend", "pjrt",
            "--nolive", *extra]


def gen_args(d, n: int, extra=()) -> list[str]:
    return ["--checkpoint-shards", str(n), "-w", "-s", str(BLK),
            "-b", str(BLK), "--tpubackend", "pjrt", "--nolive", *extra,
            str(d)]


def refusal(pkg, args) -> str:
    with pytest.raises(pkg.ProgException) as ei:
        pkg.config_from_args(args)
    return str(ei.value)


def file_checksum(paths) -> int:
    total = 0
    for p in paths:
        total += int(np.fromfile(p, dtype=np.uint8).sum(dtype=np.uint64))
    return total & ((1 << 64) - 1)


def restore(pkg, args, sessions: int = 1) -> dict:
    """Build one package's group, run `sessions` RESTORE phases and collect
    what the two packages must agree on (cumulative over the sessions)."""
    pkg.mock.ebt_mock_reset()
    cfg = pkg.config_from_args(args)
    group = pkg.Group(cfg)
    group.prepare()
    try:
        resident = []
        for i in range(sessions):
            group.start_phase(pkg.Phase.CHECKPOINT, f"ckpt{i}")
            while not group.wait_done(1000):
                pass
            resident.append(group.ckpt_stats()["shards_resident"])
        results = group.phase_results()
        st = group.ckpt_stats()
        return {
            "error": group.first_error(),
            "ckpt_error": group.ckpt_error(),
            "shards": (st["shards_total"], st["shards_resident"]),
            "resident_per_session": resident,
            "barriers": st["barriers"],
            "dev_bytes": group.ckpt_dev_bytes(),
            "byte_totals": tuple(group._native_path.ckpt_byte_totals()),
            "entries": sum(r.ops.entries for r in results),
            "bytes": sum(r.ops.bytes for r in results),
            "checksum": pkg.mock.ebt_mock_checksum(),
            "paths": [s.path for s in cfg.ckpt_shards],
        }
    finally:
        group.teardown()


# ------------------------------------------------- manifest refusals


def _refusal_cases(d):
    """The eight manifest refusals of the original, as (name, manifest
    shards or raw text, extra args, expected fragment)."""
    s0 = write_shard(d, "s0.bin")
    empty = write_shard(d, "empty.bin", 0)
    return {
        "missing-file": ([{"path": "nope.bin", "device": 0}], [],
                         "shard file not found"),
        "outside-selection": ([{"path": s0, "device": 3}],
                              ["--gpuids", "0,1"],
                              "device index(es) [3], outside"),
        "duplicate-device": ([{"path": s0, "devices": [0, 1, 0]}], [],
                             "duplicate device assignment [0]"),
        "zero-byte": ([{"path": empty, "device": 0}], [], "zero-byte shard"),
        "duplicate-path": ([{"path": s0, "device": 0},
                            {"path": s0, "device": 1}], [],
                           "duplicate shard path"),
        "bad-json": ("{not json", [], "not valid JSON"),
        "empty": ([], [], '"shards" is empty'),
        "no-placement": ([{"path": s0}], [], 'missing "device"'),
        "declared-bytes": ([{"path": s0, "device": 0, "bytes": BLK + 1}], [],
                           "declared bytes"),
    }


@pytest.mark.parametrize("case", [
    "missing-file", "outside-selection", "duplicate-device", "zero-byte",
    "duplicate-path", "bad-json", "empty", "no-placement", "declared-bytes"])
def test_manifest_refusals_match(pkgs, tmp_path, case):
    """Each malformed manifest is refused at config time with the
    original's text."""
    shards, extra, frag = _refusal_cases(tmp_path)[case]
    if isinstance(shards, str):
        man = tmp_path / "m.json"
        man.write_text(shards)
        man = str(man)
    else:
        man = write_manifest(tmp_path, shards)
    msgs = [refusal(p, ckpt_args(man, extra)) for p in pkgs]
    assert frag in msgs[1]
    assert msgs[1] == msgs[0]


def test_device_outside_resolved_count_refused_at_prepare(pkgs, tmp_path,
                                                          monkeypatch):
    """Without --gpuids the placement is checked again at prepare, against
    the devices the engine resolved (here 2)."""
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "2")
    man = write_manifest(tmp_path, [{"path": write_shard(tmp_path, "s.bin"),
                                     "device": 2}])
    msgs = []
    for pkg in pkgs:
        group = pkg.Group(pkg.config_from_args(ckpt_args(man)))
        with pytest.raises(pkg.ProgException) as ei:
            group.prepare()
        group.teardown()
        msgs.append(str(ei.value))
    assert "outside the selected device" in msgs[1]
    assert msgs[1] == msgs[0]


# ------------------------------------------------------ scenario rules


@pytest.mark.parametrize("case", [
    "staged", "read-phase", "w-explicit", "stripe", "tpustripe",
    "both-manifests", "verify", "rand", "arrival", "path-with-manifest",
    "rotate-first"])
def test_checkpoint_scenario_rules_match(pkgs, tmp_path, case):
    """The scenario's own checks, refused with the original's texts
    (--rotate is ported: a restore with it is refused by the serving
    scenario's own rule, as in the original)."""
    man = write_manifest(tmp_path, [{"path": write_shard(tmp_path, "s.bin"),
                                     "device": 0}])
    args = {
        "staged": ["--checkpoint", man, "--tpubackend", "staged",
                   "--gpuids", "0", "--nolive"],
        "read-phase": ckpt_args(man, ["-r"]),
        "w-explicit": ckpt_args(man, ["-w"]),
        "stripe": ckpt_args(man, ["--stripe", "rr"]),
        "tpustripe": ckpt_args(man, ["--tpustripe"]),
        "both-manifests": ckpt_args(man, ["--checkpoint-shards", "4"]),
        "verify": ckpt_args(man, ["--verify", "3"]),
        "rand": ckpt_args(man, ["--rand"]),
        "arrival": ckpt_args(man, ["--arrival", "poisson", "--rate", "5"]),
        "path-with-manifest": ckpt_args(man, [str(tmp_path)]),
        "rotate-first": ckpt_args(man, ["--rotate", "1"]),
    }[case]
    msgs = [refusal(p, args) for p in pkgs]
    assert msgs[1] == msgs[0]


def test_selected_phases_is_the_restore(pkgs, tmp_path):
    man = write_manifest(tmp_path, [{"path": write_shard(tmp_path, "s.bin"),
                                     "device": 0}])
    for pkg in pkgs:
        cfg = pkg.config_from_args(ckpt_args(man))
        assert cfg.selected_phases() == [pkg.Phase.CHECKPOINT]
        assert cfg.ckpt_total_bytes() == BLK


def test_generated_shards_require_existing_or_w(pkgs, tmp_path):
    """Generated shards must exist, unless -w creates them at prepare."""
    no_w = ["--checkpoint-shards", "4", "-s", str(BLK), "-b", str(BLK),
            "--tpubackend", "pjrt", "--nolive", str(tmp_path)]
    msgs = [refusal(p, no_w) for p in pkgs]
    assert "shard file not found" in msgs[1] and msgs[1] == msgs[0]
    got = []
    for pkg in pkgs:
        cfg = pkg.config_from_args(gen_args(tmp_path, 4))
        got.append([(os.path.basename(s.path), s.bytes, s.devices)
                    for s in cfg.ckpt_shards])
    assert len(got[1]) == 4 and got[1] == got[0]


# ------------------------------------------------------- restore E2E


def test_restore_all_devices_resident_byte_exact(pkgs, tmp_path):
    """8 generated shards over 4 devices, -t 2: every shard resident, the
    bytes landed byte-exact, 2 shards' bytes per device, submitted ==
    resident, one entry per shard; the same counters as the original."""
    out = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        out[pkg.name] = restore(pkg, gen_args(d, 8, ["-t", "2"]))
    t = out["torch"]
    assert t["error"] == "" and t["ckpt_error"] == ""
    assert t["shards"] == (8, 8)
    assert t["barriers"] >= 2  # one all-resident barrier per worker
    assert t["checksum"] == file_checksum(t["paths"])
    assert t["dev_bytes"] == [2 * BLK] * 4
    assert t["byte_totals"] == (8 * BLK, 8 * BLK)
    assert (t["entries"], t["bytes"]) == (8, 8 * BLK)
    for k in ("error", "ckpt_error", "shards", "dev_bytes", "byte_totals",
              "entries", "bytes"):
        assert t[k] == out["jax"][k], k


def test_restore_replicated_placement(pkgs, tmp_path):
    """A shard listing two devices is resident on both; storage reads it
    once."""
    s0 = write_shard(tmp_path, "s0.bin", seed=1)
    s1 = write_shard(tmp_path, "s1.bin", seed=2)
    man = write_manifest(tmp_path, [{"path": s0, "devices": [0, 2]},
                                    {"path": s1, "device": 3}])
    out = {p.name: restore(p, ckpt_args(man)) for p in pkgs}
    t = out["torch"]
    assert t["error"] == ""
    assert t["shards"] == (2, 2)
    assert t["dev_bytes"] == [BLK, 0, BLK, BLK]
    assert t["byte_totals"] == (3 * BLK, 3 * BLK)
    assert t["bytes"] == 2 * BLK
    for k in ("shards", "dev_bytes", "byte_totals", "entries", "bytes",
              "checksum"):
        assert t[k] == out["jax"][k], k


def test_ranks_beyond_dataset_threads_own_no_partition(pkgs, tmp_path):
    """-t 4 --datasetthreads 2: ranks 2 and 3 restore nothing, so every
    shard is restored exactly once."""
    out = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        out[pkg.name] = restore(pkg, gen_args(
            d, 6, ["-t", "4", "--datasetthreads", "2"]))
    t = out["torch"]
    assert t["error"] == "" and t["shards"] == (6, 6)
    assert (t["entries"], t["bytes"]) == (6, 6 * BLK)
    assert t["byte_totals"] == (6 * BLK, 6 * BLK)
    for k in ("shards", "entries", "bytes", "byte_totals", "dev_bytes"):
        assert t[k] == out["jax"][k], k


def test_repeated_restore_sessions_reconcile(pkgs, tmp_path):
    """Three RESTORE phases on one session: each reconciles every shard,
    and the per-device bytes accumulate."""
    out = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        out[pkg.name] = restore(pkg, gen_args(d, 4), sessions=3)
    t = out["torch"]
    assert t["error"] == ""
    assert t["resident_per_session"] == [4, 4, 4]
    assert t["dev_bytes"] == [3 * BLK] * 4
    for k in ("resident_per_session", "dev_bytes", "byte_totals"):
        assert t[k] == out["jax"][k], k


def test_midrestore_failure_attributed_device_and_shard(pkgs, tmp_path,
                                                        monkeypatch):
    """The second copy to device 2 fails in flight (the warm-up copy is the
    first): the phase fails with "device 2 shard 2: cause" and the shard
    is not counted resident."""
    monkeypatch.setenv("EBT_MOCK_STRIPE_FAIL_AT", "2:2")
    monkeypatch.setenv("EBT_MOCK_CUDA_DEV_FAIL_AT", "2:2")
    out = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        out[pkg.name] = restore(pkg, gen_args(d, 8))
    t = out["torch"]
    assert "device 2 shard 2" in t["error"]
    assert "EBT_MOCK_CUDA_DEV_FAIL_AT" in t["error"]
    assert t["ckpt_error"].startswith("device 2 shard 2: ")
    assert t["shards"][1] < t["shards"][0]
    j = out["jax"]
    assert j["ckpt_error"].split(": ")[0] == t["ckpt_error"].split(": ")[0]
    assert j["shards"] == t["shards"]


def test_restore_rides_regwindow_cache(pkgs, tmp_path):
    """The restore's reads fan through the --regwindow pin cache and stay
    on the zero-copy tier, in both packages."""
    got = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        group = pkg.Group(pkg.config_from_args(
            ["--checkpoint-shards", "4", "-w", "-s", str(4 * BLK),
             "-b", str(BLK), "--regwindow", str(2 * BLK),
             "--tpubackend", "pjrt", "--nolive", str(d)]))
        group.prepare()
        try:
            base = group.reg_cache_stats()
            group.start_phase(pkg.Phase.CHECKPOINT, "rw")
            while not group.wait_done(1000):
                pass
            rc = group.reg_cache_stats()
            got[pkg.name] = (
                group.first_error(),
                rc["hits"] + rc["misses"] > base["hits"] + base["misses"],
                group.ckpt_stats()["shards_resident"],
                group.confirm_engaged_tier())
        finally:
            group.teardown()
    assert got["torch"] == ("", True, 4, "zero_copy")
    assert got["torch"] == got["jax"]


# ----------------------------------------------------- result tree / pod


def test_result_tree_carries_ckpt_fields(pkgs, tmp_path):
    wires = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        cfg = pkg.config_from_args(gen_args(d, 4))
        group = pkg.Group(cfg)
        group.prepare()
        try:
            group.start_phase(pkg.Phase.CHECKPOINT, "wire")
            while not group.wait_done(1000):
                pass
            wire = pkg.Statistics(cfg, group).bench_result_wire(
                pkg.Phase.CHECKPOINT, "ckpt-wire", [])
            wires[pkg.name] = {
                "CkptStats": {k: v for k, v in wire["CkptStats"].items()
                              if k != "resident_wait_ns"},
                "CkptBytesPerDevice": wire["CkptBytesPerDevice"],
                "CkptError": wire["CkptError"],
                "StripeTier": wire["StripeTier"]}
        finally:
            group.teardown()
    assert wires["torch"]["CkptStats"]["shards_resident"] == 4
    assert wires["torch"]["CkptBytesPerDevice"] == [BLK] * 4
    assert not wires["torch"]["CkptError"]
    assert wires["torch"] == wires["jax"]


def test_pod_fanin_rules_match(pkgs):
    """The fan-in rules on synthetic host replies: shards_resident, wait and
    barriers sum, shards_total takes the max, per-device bytes sum
    index-wise, and the first host-framed failure wins."""

    class P:
        def __init__(self, host, stats, dev, err):
            self.host = host
            self.host_index = int(host[1:])
            self.ckpt_stats = stats
            self.ckpt_dev_bytes = dev
            self.ckpt_error = err

    got = []
    for pkg in pkgs:
        g = pkg.Remote.__new__(pkg.Remote)
        g.proxies = [
            P("h1", {"shards_total": 8, "shards_resident": 4,
                     "resident_wait_ns": 10, "barriers": 2},
              [100, 0, 50, 0], None),
            P("h2", {"shards_total": 8, "shards_resident": 4,
                     "resident_wait_ns": 5, "barriers": 2},
              [0, 200, 0, 25], "device 1 shard 5: boom"),
        ]
        got.append((g.ckpt_stats(), g.ckpt_dev_bytes(), g.ckpt_error()))
    assert got[1] == ({"shards_total": 8, "shards_resident": 8,
                       "resident_wait_ns": 15, "barriers": 4},
                      [100, 200, 50, 25],
                      "service h2: device 1 shard 5: boom")
    assert got[1] == got[0]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _services(package: str, n: int = 2):
    """n foreground services of `package` on the CPU, each with its mock
    at 2 devices."""
    env = dict(os.environ, EBT_TORCH_DEVICE="cpu",
               EBT_CUDA_DRIVER=torch_engine.build_mock(),
               EBT_MOCK_CUDA_DEVICES="2", EBT_PJRT_PLUGIN=JAX_MOCK,
               EBT_MOCK_PJRT_DEVICES="2", JAX_PLATFORMS="cpu",
               EBT_JAX_PLATFORM="cpu")
    procs, ports = [], []
    for _ in range(n):
        port = _free_port()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{package}.cli", "--service",
             "--foreground", "--port", str(port)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
        ports.append(port)
    try:
        for port in ports:
            deadline = time.monotonic() + 60
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/info", timeout=2):
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
        yield ports
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_pod_fanin_through_services(pkgs, tmp_path):
    """A 4-shard manifest restored by a master over two services of each
    package (2 mock devices each): the pod's shard counts, per-device bytes
    and entries equal the original pod's."""

    def hang(signum, frame):
        raise TimeoutError("pod restore exceeded its 150 s limit")

    old = signal.signal(signal.SIGALRM, hang)
    signal.alarm(150)
    try:
        shards = [{"path": write_shard(tmp_path, f"s{i}.bin", seed=i),
                   "device": i % 2} for i in range(4)]
        man = write_manifest(tmp_path, shards)
        got = {}
        for pkg, package in zip(pkgs, ("elbencho_tpu", "elbencho_tpu_torch")):
            with _services(package) as ports:
                hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
                cfg = pkg.config_from_args(
                    ["--hosts", hosts, "-t", "1"] + ckpt_args(man))
                group = pkg.Remote(cfg)
                group.prepare()
                try:
                    group.start_phase(pkg.Phase.CHECKPOINT, "pod")
                    while not group.wait_done(1000):
                        pass
                    results = group.phase_results()
                    st = group.ckpt_stats()
                    got[pkg.name] = (
                        group.first_error(),
                        (st["shards_total"], st["shards_resident"],
                         st["barriers"]),
                        group.ckpt_dev_bytes(), group.ckpt_error(),
                        sum(r.ops.entries for r in results),
                        sum(r.ops.bytes for r in results))
                finally:
                    group.teardown()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    err, counts, dev, cerr, entries, nbytes = got["torch"]
    assert err == "" and not cerr
    assert counts[:2] == (4, 4)
    assert dev == [2 * BLK, 2 * BLK]
    assert (entries, nbytes) == (4, 4 * BLK)
    assert got["torch"] == got["jax"]


# ------------------------------------------------------- page cache


@pytest.mark.parametrize("mode", [None, "fadvise", "dropcaches"])
def test_drop_page_cache_modes(pkgs, tmp_path, mode):
    """drop_page_cache returns the mode it used: "dropcaches" only when the
    privileged write succeeded, else per-file fadvise, as the original."""
    f = tmp_path / "shard"
    f.write_bytes(b"x" * 4096)
    used = []
    for pkg in pkgs:
        shards = [pkg.checkpoint.CheckpointShard(path=str(f), bytes=4096,
                                                 devices=[0])]
        used.append(pkg.checkpoint.drop_page_cache(shards)
                    if mode is None else
                    pkg.checkpoint.drop_page_cache(shards, mode))
    try:
        with open("/proc/sys/vm/drop_caches", "w"):
            privileged = True
    except OSError:
        privileged = False
    expect = ("dropcaches" if mode == "dropcaches" and privileged
              else "fadvise")
    assert used == [expect, expect]


def test_restore_under_eviction_churn_waits_out_unpins(pkgs, tmp_path,
                                                       monkeypatch):
    """Four workers restore four shards through a two-span --regwindow, so
    each window registration evicts another worker's window. The mock's
    unpin takes 1 ms, during which the range still counts as pinned, and a
    copy from a range unpinned before it runs faults the stream: a block
    submitted while its window is being unpinned must wait the unpin out
    (else the driver takes it for pinned, and the copy reads unpinned
    memory). Every shard ends resident, as in the original."""
    monkeypatch.setenv("EBT_MOCK_CUDA_UNREGISTER_US", "1000")
    monkeypatch.setenv("EBT_MOCK_CUDA_DELAY_US", "3000")
    shards = [{"path": write_shard(tmp_path, f"s{i}.bin", 16 * BLK, seed=i),
               "device": i} for i in range(4)]
    man = write_manifest(tmp_path, shards)
    args = ckpt_args(man, ["-t", "4", "-b", str(BLK // 4), "--regwindow",
                           str(BLK)])
    out = {p.name: restore(p, args) for p in pkgs}
    t = out["torch"]
    assert t["error"] == "" and t["ckpt_error"] == ""
    assert t["shards"] == (4, 4)
    assert t["checksum"] == file_checksum(t["paths"])
    assert t["dev_bytes"] == [16 * BLK] * 4
    for k in ("error", "shards", "dev_bytes", "byte_totals", "checksum"):
        assert t[k] == out["jax"][k], k
