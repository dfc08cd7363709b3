"""The port's CLI against the original's, run with the same arguments on
the CPU (CPU jax for the original, EBT_TORCH_DEVICE=cpu for the port).

Counts (entries, bytes), phase rows and corrupt offsets must be equal;
timings are not compared.
"""

import csv

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu_torch.cli import main as torch_main
from elbencho_tpu_torch.config import config_from_args
from elbencho_tpu_torch.exceptions import ProgException

# CSV columns that do not depend on timing
_STABLE = ("operation", "entries last", "bytes last", "paths", "threads",
           "file size", "block size", "IO depth", "TPU IDs", "TPU backend",
           "verify salt", "tpu xfer lat clock")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")


def _run(main, args, csv_path, capfd):
    rc = main([*args, "--csvfile", str(csv_path), "--nolive"])
    out = capfd.readouterr()
    rows = [{k: r[k] for k in _STABLE}
            for r in csv.DictReader(open(csv_path))]
    labels = [ln.split(":")[0].strip() for ln in out.out.splitlines()
              if " : " in ln]
    return rc, rows, labels, out.out + out.err


@pytest.mark.parametrize("backend", ["staged", "direct"])
def test_verify_clean_matches_jax(bench_dir, tmp_path, capfd, backend):
    p = str(bench_dir / "f")
    args = ["-w", "-r", "-t", "2", "-s", "1M", "-b", "128k", "--verify",
            "42", "--iodepth", "2", "--gpuids", "0", "--tpubackend", backend,
            "--lat", p]
    jrc, jrows, jlabels, _ = _run(jax_main, args, tmp_path / "j.csv", capfd)
    trc, trows, tlabels, _ = _run(torch_main, args, tmp_path / "t.csv",
                                  capfd)
    assert jrc == trc == 0
    assert trows == jrows
    assert [r["operation"] for r in trows] == ["WRITE", "READ"]
    assert trows[1]["bytes last"] == str(1 << 20)
    assert tlabels == jlabels


@pytest.mark.parametrize("backend", ["staged", "direct"])
@pytest.mark.parametrize("verify", [False, True])
def test_two_devices_match_jax(bench_dir, tmp_path, capfd, backend, verify):
    """--gpuids 0,1 on the staged/direct backends: ranks alternate between
    the devices, with one latency row per device, as in the original."""
    p = str(bench_dir / "f2")
    args = ["-w", "-r", "-t", "4", "-s", "2M", "-b", "128k", "--iodepth",
            "2", "--gpuids", "0,1", "--tpubackend", backend, "--lat",
            *(["--verify", "42"] if verify else []), p]
    jrc, jrows, jlabels, _ = _run(jax_main, args, tmp_path / "j.csv", capfd)
    trc, trows, tlabels, _ = _run(torch_main, args, tmp_path / "t.csv",
                                  capfd)
    assert jrc == trc == 0
    assert trows == jrows
    assert tlabels == jlabels
    for dev in ("0", "1"):
        assert f"READ      TPU {dev} xfer lat us" in tlabels


@pytest.mark.parametrize("backend", ["staged", "direct"])
@pytest.mark.parametrize("size,block,corrupt_off", [
    ("1M", "128k", 300001),          # unaligned: byte refinement step
    ("8M", "4M", (3 << 20) + 13),    # second 2MiB chunk of a 4MiB block
    ("8M", "4M", (4 << 20) + (2 << 20)),  # first byte of a block's 2nd chunk
    ("8M", "4M", (4 << 20) - 1),     # last byte of a block
    ("8M", "4M", 4 << 20),           # byte 0 of a block
])
def test_corruption_same_offset_as_jax(bench_dir, capfd, backend, size,
                                       block, corrupt_off):
    p = str(bench_dir / "c")
    assert torch_main(["-w", "-t", "1", "-s", size, "-b", block, "--verify",
                       "9", "--nolive", p]) == 0
    with open(p, "r+b") as f:
        f.seek(corrupt_off)
        b = f.read(1)
        f.seek(corrupt_off)
        f.write(bytes([b[0] ^ 0xA5]))
    want = f"on-device data verification failed at file offset {corrupt_off}"
    for main in (jax_main, torch_main):
        capfd.readouterr()
        rc = main(["-r", "-t", "1", "-s", size, "-b", block, "--verify", "9",
                   "--gpuids", "0", "--tpubackend", backend, "--nolive", p])
        out = capfd.readouterr()
        assert rc == 1, main
        assert want in out.out + out.err, main


@pytest.mark.parametrize("backend", ["staged", "direct"])
def test_two_corrupt_chunks_of_one_block_report_first_as_jax(
        bench_dir, capfd, backend):
    """Two corrupt bytes in different chunks of one 4 MiB block, the one in
    the later chunk at the lower position within its chunk: both packages
    report the first in file order."""
    p = str(bench_dir / "c2")
    assert torch_main(["-w", "-t", "1", "-s", "8M", "-b", "4M", "--verify",
                       "9", "--nolive", p]) == 0
    first, second = (4 << 20) + (1 << 20) + 7, (4 << 20) + (2 << 20) + 3
    with open(p, "r+b") as f:
        for off in (second, first):
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x3C]))
    want = f"on-device data verification failed at file offset {first}"
    for main in (jax_main, torch_main):
        capfd.readouterr()
        rc = main(["-r", "-t", "1", "-s", "8M", "-b", "4M", "--verify", "9",
                   "--gpuids", "0", "--tpubackend", backend, "--nolive", p])
        out = capfd.readouterr()
        assert rc == 1, main
        assert want in out.out + out.err, main


@pytest.mark.parametrize("writer,reader", [(jax_main, torch_main),
                                           (torch_main, jax_main)])
def test_file_written_by_one_package_verifies_under_the_other(
        bench_dir, writer, reader):
    p = str(bench_dir / "x")
    assert writer(["-w", "-t", "2", "-s", "2M", "-b", "256k", "--verify",
                   "1234", "--gpuids", "0", "--nolive", p]) == 0
    assert reader(["-r", "-t", "2", "-s", "2M", "-b", "256k", "--verify",
                   "1234", "--gpuids", "0", "--nolive", p]) == 0


@pytest.mark.parametrize("args,flag", [
    # --chaos on the native engine, with the spec "seed=1" that arms no seam
    pytest.param(["--tpubackend", "pjrt", "--chaos", "seed=1", "-r", "-s",
                  "1M", "PATH"], "--chaos", id="args0---tpubackend pjrt"),
    (["--chaos", "seed=1", "-r", "-s", "1M", "PATH"], "--chaos"),
    # the native engine's transfer-manager tier
    (["--tpubackend", "pjrt", "-r", "-s", "1M", "XFER_MGR", "PATH"],
     "EBT_PJRT_XFER_MGR"),
    # --chaos composed with the checkpoint and reshard scenarios
    (["--checkpoint-shards", "2", "-w", "-s", "1M", "--tpubackend", "pjrt",
      "--reshard", "1", "--chaos", "seed=1", "PATH"], "--chaos"),
    # --chaos over the stripe tier
    (["--stripe", "rr", "--tpubackend", "pjrt", "--chaos", "seed=1", "-r",
      "-s", "1M", "PATH"], "--chaos"),
    # --chaos over the device fault policy
    (["--maxerrors", "2", "--tpubackend", "pjrt", "--chaos", "seed=1", "-r",
      "-s", "1M", "PATH"], "--chaos"),
    # --chaos over serving rotation and ingestion
    (["--tpubackend", "pjrt", "--rotate", "1", "--chaos", "seed=1", "-r",
      "-s", "1M", "PATH"], "--chaos"),
    (["--ingestshards", "2", "--tpubackend", "pjrt", "--chaos", "seed=1",
      "PATH"], "--chaos"),
])
def test_unported_flags_refused(bench_dir, capfd, monkeypatch, args, flag):
    """--chaos and the transfer-manager tier are ported: the command lines
    the port refused as "not yet ported" now get the original's outcome.
    The --chaos cases carry the spec "seed=1", which arms no seam, so both
    packages refuse them with the same cause (the empty spec's, or the
    scenario's own refusal where that comes first), through the config and
    through the CLI; the tier's case is accepted by both."""
    from elbencho_tpu.config import config_from_args as jax_config_from_args
    from elbencho_tpu.exceptions import ProgException as JaxProgException

    argv = [str(bench_dir / "r") if a == "PATH" else a for a in args]
    if "XFER_MGR" in argv:
        argv.remove("XFER_MGR")
        monkeypatch.setenv("EBT_PJRT_XFER_MGR", "1")
    want = _outcome(jax_config_from_args, JaxProgException, argv)
    assert _outcome(config_from_args, ProgException, argv) == want
    if flag == "EBT_PJRT_XFER_MGR":
        assert want == "accepted"
    else:
        assert want in ("--chaos: no seams armed (empty spec)",
                        "--rotate re-restores a checkpoint and needs "
                        "--checkpoint MANIFEST (the generated "
                        "--checkpoint-shards mode owns the PATH argument, "
                        "which serving needs for its bench files — write an "
                        "explicit manifest instead)")
        capfd.readouterr()
        assert torch_main(argv) == 1
        assert want in capfd.readouterr().err
        assert jax_main(argv) == 1
        assert want in capfd.readouterr().err


def _outcome(config_fn, exc_type, argv) -> str:
    try:
        config_fn(argv)
    except exc_type as e:
        return str(e)
    return "accepted"


@pytest.mark.parametrize("args", [
    ["--tpubackend", "pjrt", "--rotate", "1", "-r", "-s", "1M", "PATH"],
    ["--rotate", "1", "-r", "-s", "1M", "PATH"],
    ["--ingestshards", "2", "--tpubackend", "pjrt", "-r", "PATH"],
    ["--checkpoint-shards", "2", "-w", "-s", "1M", "--tpubackend", "pjrt",
     "--rotate", "1", "PATH"],
    ["--ingest", "PATH", "-r"],
    ["--ingestshards", "2", "-r", "PATH"],
    ["--ingestshards", "2", "-w", "-s", "256K", "-b", "64K",
     "--recordsize", "4K", "--tpubackend", "pjrt", "DIR"],
], ids=["rotate-pjrt", "rotate", "ingestshards-pjrt", "rotate-generated",
        "ingest", "ingestshards", "ingestshards-accepted"])
def test_rotation_and_ingest_flags_no_longer_refused(bench_dir, args):
    """--rotate, --ingest and --ingestshards are ported: the command lines
    the port refused with "not yet ported" before now get the original's
    own outcome, its scenario refusal text or acceptance."""
    from elbencho_tpu.config import config_from_args as jax_config_from_args
    from elbencho_tpu.exceptions import ProgException as JaxProgException

    argv = [str(bench_dir / "r") if a == "PATH" else
            str(bench_dir) if a == "DIR" else a for a in args]
    port = _outcome(config_from_args, ProgException, argv)
    assert "not yet ported" not in port
    assert port == _outcome(jax_config_from_args, JaxProgException, argv)


@pytest.mark.parametrize("args", [
    ["--tpubackend", "pjrt", "--retry", "2", "-r", "-s", "1M", "PATH"],
    ["--maxerrors", "2", "--tpubackend", "pjrt", "-r", "-s", "1M", "PATH"],
    ["--checkpoint-shards", "2", "-w", "-s", "1M", "--tpubackend", "pjrt",
     "--reshard", "1", "DIR"],
], ids=["retry-pjrt", "maxerrors-pjrt", "reshard"])
def test_ported_fault_and_reshard_flags_accepted(bench_dir, args):
    """The device fault policy and --reshard are ported: the command lines
    the port refused before are accepted, as by the original."""
    argv = [str(bench_dir / "r") if a == "PATH" else
            str(bench_dir) if a == "DIR" else a for a in args]
    cfg = config_from_args(argv)
    assert cfg.tpu_backend_name == "pjrt"


def test_no_cuda_and_no_cpu_request_refuses(bench_dir, capfd, monkeypatch):
    """Without a CUDA device and without EBT_TORCH_DEVICE=cpu the run stops
    with the device error; no phase runs on the CPU instead."""
    monkeypatch.delenv("EBT_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = str(bench_dir / "n")
    rc = torch_main(["-w", "-r", "-t", "1", "-s", "1M", "-b", "128k",
                     "--gpuids", "0", "--nolive", p])
    out = capfd.readouterr()
    assert rc == 1
    assert "no CUDA device found (set EBT_TORCH_DEVICE=cpu" in out.err
    assert "WRITE" not in out.out and "READ" not in out.out
