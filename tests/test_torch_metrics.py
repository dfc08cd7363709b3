"""The port's /metrics surface (metrics.py) against the original's, on the
CPU: the same strict text format, family names from the pinned registry,
reconciliation with the result tree, the service endpoint and the
--metricsport listener. The port's native engine runs against the mock
CUDA driver (2 devices)."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from elbencho_tpu import metrics as jax_metrics
from elbencho_tpu_torch import engine
from elbencho_tpu_torch.cli import main
from elbencho_tpu_torch.common import PROTOCOL_VERSION, BenchPhase
from elbencho_tpu_torch.config import config_from_args
from elbencho_tpu_torch.exceptions import ProgException
from elbencho_tpu_torch.metrics import (METRIC_FAMILIES, MetricsServer,
                                        metric_value, parse_prometheus_text,
                                        render_metrics)
from elbencho_tpu_torch.workers.local import LocalWorkerGroup
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLK = 256 << 10


@pytest.fixture
def mock2(monkeypatch):
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", engine.build_mock())
    monkeypatch.setenv("EBT_MOCK_CUDA_DEVICES", "2")


def _make_file(tmp_path, nblocks=8):
    p = tmp_path / "data.bin"
    p.write_bytes(os.urandom(nblocks * BLK))
    return str(p), nblocks


def _run_phase(group, phase):
    group.start_phase(phase, "metrics-test")
    while not group.wait_done(1000):
        pass


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.headers.get("Content-Type", ""), r.read().decode()


def test_registry_names_are_the_originals():
    """Every family the port can emit carries the original's name, type
    and help, and every family of the original is carried, the stripe,
    checkpoint, reshard, ingest and serving-rotation ones included."""
    original = {f[0]: f for f in jax_metrics.METRIC_FAMILIES}
    for fam in METRIC_FAMILIES:
        assert original[fam[0]] == fam
    names = {f[0] for f in METRIC_FAMILIES}
    assert {"ebt_stripe_units_total", "ebt_ckpt_shards_total",
            "ebt_ckpt_shards_resident", "ebt_ingest_records_total",
            "ebt_rotation_generation", "ebt_rotations_total"} <= names
    assert set(original) == names


@pytest.mark.parametrize("scenario", ["stripe", "checkpoint"])
def test_stripe_and_ckpt_families_match_the_original(mock2, tmp_path,
                                                     monkeypatch, scenario):
    """A striped read and a checkpoint restore emit the stripe and
    checkpoint families with the samples the original emits on the same
    inputs (its mock plugin at the same 2 devices)."""
    from elbencho_tpu.common import BenchPhase as JaxPhase
    from elbencho_tpu.config import config_from_args as jax_cfa
    from elbencho_tpu.workers.local import LocalWorkerGroup as JaxGroup

    jax_mock = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
    monkeypatch.setenv("EBT_PJRT_PLUGIN", jax_mock)
    monkeypatch.setenv("EBT_MOCK_PJRT_DEVICES", "2")
    path, nblocks = _make_file(tmp_path)
    if scenario == "stripe":
        args = ["-r", "-t", "2", "-s", str(nblocks * BLK), "-b", str(BLK),
                "--tpubackend", "pjrt", "--stripe", "rr", "--regwindow",
                str(2 * BLK), "--nolive", path]
        fams = ("ebt_stripe_units_total",)
    else:
        (tmp_path / "ck").mkdir()
        args = ["--checkpoint-shards", "4", "-w", "-s", str(BLK), "-b",
                str(BLK), "--tpubackend", "pjrt", "--nolive",
                str(tmp_path / "ck")]
        fams = ("ebt_ckpt_shards_total", "ebt_ckpt_shards_resident")
    got = []
    for cfa, Group, Phase, render in (
            (jax_cfa, JaxGroup, JaxPhase, jax_metrics.render_metrics),
            (config_from_args, LocalWorkerGroup, BenchPhase,
             render_metrics)):
        cfg = cfa(args)
        group = Group(cfg)
        group.prepare()
        try:
            phase = Phase.READFILES if scenario == "stripe" else \
                Phase.CHECKPOINT
            _run_phase(group, phase)
            assert group.first_error() == ""
            samples = parse_prometheus_text(render(group, cfg, phase))
            got.append(sorted((key, v) for key, v in samples.items()
                              if key[0] in fams))
        finally:
            group.teardown()
    assert got[1] and got[1] == got[0]


@pytest.mark.parametrize("text", [
    "ebt_x 1\n", '# TYPE ebt_x gauge\nebt_x{a="b} 1\n',
    '# HELP ebt_x helpful\n# TYPE ebt_x summary\n'
    'ebt_x{q="0.5",t="a}b"} 1.5\nebt_x_count{t="a}b"} 3\n'])
def test_parser_agrees_with_the_original(text):
    def parse(fn):
        try:
            return fn(text)
        except ValueError as e:
            return f"ValueError: {e}"
    assert parse(parse_prometheus_text) == \
        parse(jax_metrics.parse_prometheus_text)


def test_scrape_families_only_from_registry(mock2, tmp_path):
    """Every emitted family is in METRIC_FAMILIES (the pinned name set)
    and carries HELP + TYPE; an open-loop pjrt run emits the tenant,
    reactor and per-chip families."""
    path, nblocks = _make_file(tmp_path)
    cfg = config_from_args(["-r", "-t", "2", "-s", str(nblocks * BLK),
                            "-b", str(BLK), "--tpubackend", "pjrt",
                            "--gpuids", "0,1", "--arrival", "paced",
                            "--rate", "500", "--lat", "--nolive", path])
    group = LocalWorkerGroup(cfg)
    group.prepare()
    try:
        _run_phase(group, BenchPhase.READFILES)
        text = render_metrics(group, cfg, BenchPhase.READFILES)
        samples = parse_prometheus_text(text)
        registry = {f[0] for f in METRIC_FAMILIES}
        typed = {ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE ")}
        helped = {ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# HELP ")}
        assert typed <= registry and typed == helped
        for fam in ("ebt_tenant_arrivals_total", "ebt_tenant_latency_seconds",
                    "ebt_reactor_wakeups_total",
                    "ebt_device_xfer_latency_seconds"):
            assert fam in typed, fam
        total = group.live_total()
        assert metric_value(samples, "ebt_bytes_done_total") == total.bytes
        assert metric_value(samples, "ebt_ops_done_total") == total.iops
        assert metric_value(samples, "ebt_workers_total") == 2
        assert metric_value(samples, "ebt_phase_code", phase="READ") == 5
        for dev in ("0", "1"):
            assert metric_value(samples,
                                "ebt_device_xfer_latency_seconds_count",
                                device=dev) > 0
    finally:
        group.teardown()


def test_service_metrics_endpoint(mock2, tmp_path):
    """A port service answers /metrics on its benchmark port: 200 with
    scrape_ok 0 before any prepare, then the families of a master-driven
    phase, reconciling with /benchresult."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elbencho_tpu_torch.cli", "--service",
         "--foreground", "--port", str(port)],
        cwd=REPO, env=dict(os.environ), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/info",
                                       timeout=2)
                break
            except OSError:
                time.sleep(0.1)
        ctype, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert ctype.startswith("text/plain; version=0.0.4")
        assert metric_value(parse_prometheus_text(body),
                            "ebt_scrape_ok") == 0
        path = tmp_path / "f.bin"
        path.write_bytes(os.urandom(4 * BLK))
        cfg = config_from_args(["-r", "-t", "1", "-s", str(4 * BLK),
                                "-b", str(BLK), "--nolive", str(path)])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/preparephase?ProtocolVersion="
            f"{PROTOCOL_VERSION}",
            data=json.dumps(cfg.to_wire()).encode(), method="POST")
        urllib.request.urlopen(req, timeout=60).read()
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/startphase?PhaseCode=5&BenchID=m1",
            timeout=10).read()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/status", timeout=5) as r:
                st = json.loads(r.read())
            if st["NumWorkersDone"] + st["NumWorkersDoneWithError"] >= 1:
                break
            time.sleep(0.1)
        samples = parse_prometheus_text(
            _get(f"http://127.0.0.1:{port}/metrics")[1])
        assert metric_value(samples, "ebt_scrape_ok") == 1
        assert metric_value(samples, "ebt_build_info", role="service",
                            protocol=PROTOCOL_VERSION) == 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/benchresult", timeout=10) as r:
            result = json.loads(r.read())
        assert metric_value(samples, "ebt_bytes_done_total") == \
            result["Ops"]["bytes"] == 4 * BLK
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


def test_master_metrics_server():
    srv = MetricsServer(lambda: render_metrics(None), 0)
    srv.start()
    try:
        ctype, body = _get(f"http://127.0.0.1:{srv.port}/metrics")
        assert ctype.startswith("text/plain; version=0.0.4")
        assert metric_value(parse_prometheus_text(body), "ebt_scrape_ok") == 0
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/other",
                                   timeout=5)
        assert e.value.code == 404
    finally:
        srv.stop()


@pytest.mark.parametrize("args,needle", [
    (["-r", "--metricsport", "99999", "/tmp/x"], "not a valid TCP port"),
    (["--service", "--metricsport", "9090"], "master/local-mode flag"),
])
def test_metricsport_flag_validation(args, needle):
    with pytest.raises(ProgException) as e:
        config_from_args(args)
    assert needle in str(e.value)


def test_metricsport_local_run_scrapeable(mock2, tmp_path, capsys):
    """A port run with --metricsport serves /metrics while it runs (scraped
    from a helper thread) and releases the port after."""
    port = _free_port()
    path, nblocks = _make_file(tmp_path)
    seen: list[dict] = []
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                seen.append(parse_prometheus_text(
                    _get(f"http://127.0.0.1:{port}/metrics", timeout=2)[1]))
            except OSError:
                pass
            time.sleep(0.02)

    t = threading.Thread(target=scraper)
    t.start()
    try:
        rc = main(["-r", "-t", "1", "-s", str(nblocks * BLK), "-b", str(BLK),
                   "--tpubackend", "pjrt", "--metricsport", str(port),
                   "--arrival", "paced", "--rate", "25", "--nolive", path])
        assert rc == 0, capsys.readouterr().out
    finally:
        stop.set()
        t.join()
    assert any(metric_value(s, "ebt_build_info", role="master") == 1
               for s in seen)
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    s.close()
