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
    # --tpubackend pjrt itself is ported; its device fault policy is not
    pytest.param(["--tpubackend", "pjrt", "--retry", "2", "-r", "-s", "1M",
                  "PATH"], "--retry with --tpubackend pjrt",
                 id="args0---tpubackend pjrt"),
    (["--chaos", "seed=1", "-r", "-s", "1M", "PATH"], "--chaos"),
    (["--rotate", "1", "-r", "-s", "1M", "PATH"], "--rotate"),
    (["--reshard", "2", "-r", "PATH"], "--reshard"),
    (["--stripe", "rr", "--gpuids", "0", "-r", "-s", "1M", "PATH"],
     "--stripe"),
    (["--tpustripe", "--gpuids", "0", "-r", "-s", "1M", "PATH"],
     "--tpustripe"),
    (["--checkpoint-shards", "2", "-r", "PATH"], "--checkpoint-shards"),
    (["--ingestshards", "2", "-r", "PATH"], "--ingestshards"),
])
def test_unported_flags_refused(bench_dir, capfd, args, flag):
    argv = [str(bench_dir / "r") if a == "PATH" else a for a in args]
    with pytest.raises(ProgException) as e:
        config_from_args(argv)
    assert str(e.value) == f"{flag}: not yet ported (see ROADMAP.md)"
    assert torch_main(argv) == 1
    assert "not yet ported" in capfd.readouterr().err


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
