"""Distributed mode of the port: port services on localhost driven by a port
master, the cases of tests/test_distributed.py, plus the two cross-package
pairings (a port master over the original's services, the original's master
over port services) with equal totals.

Services run on the CPU (EBT_TORCH_DEVICE=cpu in their environment) and the
pjrt leg runs the port's C++ engine against the mock CUDA driver
(EBT_CUDA_DRIVER, EBT_MOCK_CUDA_DEVICES). The port services are a
module-scoped pair, since each imports torch. Every test has its own time
limit, so a hang fails one test and not the run.
"""

import contextlib
import csv
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu_torch import engine
from elbencho_tpu_torch.cli import main
from elbencho_tpu_torch.common import PROTOCOL_VERSION
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_LIMIT_S = 150


class _Hang(BaseException):
    """Raised by the per-test alarm; a BaseException, so no broad except
    inside the master swallows it."""


@pytest.fixture(autouse=True)
def _time_limit(monkeypatch):
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")

    def hang(signum, frame):
        raise _Hang(f"test exceeded its {TEST_LIMIT_S}s limit")

    old = signal.signal(signal.SIGALRM, hang)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_service(port: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/info", timeout=2) as r:
                json.loads(r.read())
                return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"service on port {port} did not come up")


@contextlib.contextmanager
def _spawn_services(n: int, package: str = "elbencho_tpu_torch"):
    """n foreground service subprocesses of `package` on random ports: the
    port's on the CPU with the mock CUDA driver (2 mock devices), the
    original's on CPU jax."""
    env = dict(os.environ, EBT_TORCH_DEVICE="cpu",
               EBT_CUDA_DRIVER=engine.build_mock(), EBT_MOCK_CUDA_DEVICES="2",
               JAX_PLATFORMS="cpu", EBT_JAX_PLATFORM="cpu")
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
            _wait_service(port)
        yield ports
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


@pytest.fixture(scope="module")
def two_services():
    with _spawn_services(2) as ports:
        yield ports


def _hosts_arg(ports):
    return ",".join(f"127.0.0.1:{p}" for p in ports)


def _benchresult(port: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/benchresult", timeout=10) as r:
        return json.loads(r.read())


def test_info_keeps_the_original_service_name(two_services):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{two_services[0]}/info", timeout=5) as r:
        info = json.loads(r.read())
    assert info["Service"] == "elbencho-tpu"
    assert info["ProtocolVersion"] == PROTOCOL_VERSION == "1.18.0"


def test_distributed_write_read_delete(two_services, bench_dir, capsys):
    p = str(bench_dir / "f1")
    hosts = _hosts_arg(two_services)
    rc = main(["--hosts", hosts, "-w", "-r", "-F", "-t", "2", "-s", "8M",
               "-b", "1M", "--nolive", "--lat", p])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "WRITE" in out and "READ" in out and "RMFILES" in out
    assert not os.path.exists(p)
    # 2 hosts x 2 threads shared the dataset: totals equal one file pass
    totals = [ln.split()[-1] for ln in out.splitlines() if "Total MiB" in ln]
    assert totals and all(t == "8" for t in totals)


def test_distributed_dir_mode(two_services, bench_dir, capsys):
    hosts = _hosts_arg(two_services)
    rc = main(["--hosts", hosts, "-d", "-w", "-r", "-F", "-D", "-t", "2",
               "-n", "1", "-N", "5", "-s", "4k", "-b", "4k", "--nolive",
               str(bench_dir)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Files total" in out
    for line in out.splitlines():
        if "Files total" in line and "WRITE" in line:
            assert line.split()[-1] == "20"  # 4 ranks x 1 dir x 5 files


def test_distributed_verify(two_services, bench_dir, capsys):
    p = str(bench_dir / "vf")
    hosts = _hosts_arg(two_services)
    rc = main(["--hosts", hosts, "-w", "-r", "-t", "1", "-s", "2M", "-b",
               "256k", "--verify", "9", "--gpuids", "0", "--nolive", p])
    assert rc == 0, capsys.readouterr().out


def test_distributed_verify_reports_the_corrupt_offset(two_services,
                                                       bench_dir, capfd):
    """A corrupt byte in the shared file fails the run through the master,
    framed by the service whose rank read it (rank 1 reads the second
    MiB), and that service's /benchresult error history carries the exact
    offset. As in the original, the master's live poll reports the failure
    before the history reaches it."""
    p = str(bench_dir / "cf")
    hosts = _hosts_arg(two_services)
    assert main(["--hosts", hosts, "-w", "-t", "1", "-s", "2M", "-b",
                 "256k", "--verify", "9", "--gpuids", "0", "--nolive",
                 p]) == 0
    bad = (1 << 20) + 4321
    with open(p, "r+b") as f:
        f.seek(bad)
        b = f.read(1)
        f.seek(bad)
        f.write(bytes([b[0] ^ 0x5A]))
    capfd.readouterr()
    rc = main(["--hosts", hosts, "-r", "-t", "1", "-s", "2M", "-b", "256k",
               "--verify", "9", "--gpuids", "0", "--nolive", p])
    out = capfd.readouterr()
    assert rc == 1
    assert f"service 127.0.0.1:{two_services[1]}: worker failed" in out.err
    history = _benchresult(two_services[1])["ErrorHistory"]
    assert any(f"verification failed at file offset {bad}" in ln
               for ln in history), history


def test_mesh_slice_stats_reduction(two_services, bench_dir, capsys):
    """The device stats tier in a real distributed run: with --gpuids 0,1
    each service reduces its slice's LiveOps over two devices
    (MeshStatsReducer), ships them as SliceOps on /benchresult, and the
    master cross-checks them against the per-worker fan-in."""
    p = str(bench_dir / "mf")
    rc = main(["--hosts", _hosts_arg(two_services), "-w", "-r", "-t", "2",
               "-s", "8M", "-b", "1M", "--gpuids", "0,1", "--tpubackend",
               "staged", "--lat", "--nolive", p])
    out = capsys.readouterr().out
    assert rc == 0, out
    # one latency row per host and device
    for port in two_services:
        for dev in (0, 1):
            assert re.search(rf"READ +TPU 127\.0\.0\.1:{port}:{dev} xfer lat",
                             out), out
    expect_bytes = (8 << 20) // 2  # half the file per service slice
    for port in two_services:
        reply = _benchresult(port)
        sl = reply["SliceOps"]
        assert sl["Reduction"] == "psum" and sl["NumDevices"] == 2
        assert sl["Ops"]["bytes"] == reply["Ops"]["bytes"] == expect_bytes
        assert sl["Ops"]["iops"] == reply["Ops"]["iops"]


def test_one_device_slice_ships_no_slice_stats(two_services, bench_dir):
    """Below two devices the slice tier stays off, as in the original."""
    p = str(bench_dir / "sf")
    assert main(["--hosts", _hosts_arg(two_services), "-w", "-r", "-t", "2",
                 "-s", "4M", "-b", "1M", "--gpuids", "0", "--nolive",
                 p]) == 0
    assert _benchresult(two_services[0]).get("SliceOps") is None


def test_distributed_error_surfaces_host(two_services, bench_dir, capfd):
    hosts = _hosts_arg(two_services)
    rc = main(["--hosts", hosts, "-r", "-t", "1", "-s", "1M", "--nolive",
               str(bench_dir / "missing-file")])
    assert rc == 1
    err = capfd.readouterr().err
    assert re.search(r"service 127\.0\.0\.1:\d+", err), err


def test_unported_flag_refused_by_the_service_framed_by_host(
        bench_dir, capfd, monkeypatch):
    """The transfer-manager tier, selected by EBT_PJRT_XFER_MGR in a port
    service's environment, is ported: a configuration the original's
    master sends over the wire runs on the tier in the service (its
    result tree confirms it), and the master's totals equal the file."""
    p = bench_dir / "tf"
    p.mkdir()
    monkeypatch.setenv("EBT_PJRT_XFER_MGR", "1")
    with _spawn_services(1) as ports:
        monkeypatch.delenv("EBT_PJRT_XFER_MGR")
        capfd.readouterr()
        rc = jax_main(["--hosts", _hosts_arg(ports), "-w", "-r", "-t", "1",
                       "-s", "1M", "-b", "256k", "--gpuids", "0",
                       "--tpubackend", "pjrt", "--nolive", str(p / "f")])
        out = capfd.readouterr()
        tree = _benchresult(ports[0])
    assert rc == 0, out
    assert "not yet ported" not in out.err
    totals = [ln.split()[-1] for ln in out.out.splitlines()
              if "Total MiB" in ln]
    assert totals == ["1", "1"], out.out
    assert tree["DataPathTier"] == "xfer_mgr"
    assert tree["Ops"]["bytes"] == 1 << 20


def test_master_unreachable_service(bench_dir, capsys):
    port = _free_port()  # nothing listening
    rc = main(["--hosts", f"127.0.0.1:{port}", "-w", "-t", "1", "-s", "1M",
               "--nolive", str(bench_dir / "f")])
    assert rc == 1


def test_interrupt_and_quit(capsys):
    with _spawn_services(2) as ports:
        hosts = _hosts_arg(ports)
        assert main(["--hosts", hosts, "--interrupt"]) == 0
        assert main(["--hosts", hosts, "--quit"]) == 0
        time.sleep(1.0)
        for port in ports:
            with pytest.raises(OSError):
                urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                       timeout=2)


def test_failed_prepare_leaves_clean_state(two_services, bench_dir):
    port = two_services[0]
    bad_cfg = {"paths": [str(bench_dir / "nope" / "deeper" / "f")],
               "num_threads": 1, "file_size": 4096, "block_size": 4096,
               "run_read": True}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/preparephase?ProtocolVersion="
        f"{PROTOCOL_VERSION}",
        data=json.dumps(bad_cfg).encode(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e1:
        urllib.request.urlopen(req, timeout=10)
    assert e1.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e2:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=5)
    assert e2.value.code == 400
    assert "no prepared benchmark" in json.loads(e2.value.read())["Error"]


def test_protocol_version_gate(two_services):
    req = urllib.request.Request(
        f"http://127.0.0.1:{two_services[0]}/preparephase"
        "?ProtocolVersion=0.0.0", data=b"{}", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=5)
    assert "protocol version mismatch" in json.loads(
        exc_info.value.read())["Error"]


def test_distributed_native_pjrt_backend(two_services, bench_dir, capsys):
    """Service mode drives the native engine: each service runs csrc/
    cuda_path.cpp against the mock driver with two devices; per-chip rows
    come back host-prefixed with their clock."""
    p = str(bench_dir / "pjrt-f1")
    hosts = _hosts_arg(two_services)
    rc = main(["--hosts", hosts, "-w", "-r", "-t", "2", "-s", "8M", "-b",
               "1M", "--lat", "--gpuids", "0,1", "--tpubackend", "pjrt",
               "--nolive", p])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "WRITE" in out and "READ" in out
    assert re.search(r"TPU [\w.]+:\d+:0 xfer lat us.*p99=", out), out
    assert re.search(r"TPU [\w.]+:\d+:1 xfer lat us.*clock=onready", out), out
    for port in two_services:
        assert _benchresult(port)["D2HTier"] is not None
    assert main(["--hosts", hosts, "-F", "-t", "2", "--nolive", p]) == 0


def test_multi_host_prepare_errors_sorted_by_host():
    from elbencho_tpu_torch.config import config_from_args
    from elbencho_tpu_torch.exceptions import ProgException
    from elbencho_tpu_torch.workers.remote import RemoteWorkerGroup

    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    cfg = config_from_args(["-r", "-s", "1M", "--hosts", ",".join(hosts),
                            "/tmp/ebt-nonexistent"])
    grp = RemoteWorkerGroup(cfg)
    with pytest.raises(ProgException) as e:
        grp.prepare()
    lines = str(e.value).splitlines()
    assert len(lines) == len(hosts)
    assert lines == sorted(lines)


_STABLE = ("operation", "entries last", "bytes last", "paths", "threads",
           "file size", "block size", "TPU IDs", "TPU backend")


def _rows(path) -> list[dict]:
    return [{k: r[k] for k in _STABLE} for r in csv.DictReader(open(path))]


@pytest.mark.parametrize("master,services", [
    ("torch", "elbencho_tpu"), ("jax", "elbencho_tpu_torch")],
    ids=["port_master_over_original_services",
         "original_master_over_port_services"])
def test_cross_package_master_and_services(two_services, bench_dir,
                                           tmp_path, master, services):
    """The two packages interoperate on protocol 1.18.0: each master drives
    the other package's services, and the totals equal those of the
    port's own master over port services."""
    run = {"torch": main, "jax": jax_main}[master]
    args = ["-w", "-r", "-t", "2", "-s", "8M", "-b", "1M", "--gpuids", "0",
            "--nolive"]
    p = str(bench_dir / "xf")
    assert main(["--hosts", _hosts_arg(two_services), *args, "--csvfile",
                 str(tmp_path / "ref.csv"), p]) == 0
    with _spawn_services(2, services) as ports:
        assert run(["--hosts", _hosts_arg(ports), *args, "--csvfile",
                    str(tmp_path / "x.csv"), p]) == 0
    ref, got = _rows(tmp_path / "ref.csv"), _rows(tmp_path / "x.csv")
    assert got == ref
    assert [r["operation"] for r in got] == ["WRITE", "READ"]
    assert all(r["bytes last"] == str(8 << 20) for r in got)
