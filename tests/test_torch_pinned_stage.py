"""The verified read's pinned chunk slots (CudaPath::submitH2DVerified,
stageSlots) on the CPU, behind the mock CUDA driver.

A --verify block whose mmap window the driver refused to register is copied
chunk by chunk into the worker's own pinned slots (at most four), and each
chunk's DMA reads its slot; the span log names the tier `staged`. The mock
reads a pinned source when the copy runs, not at the call, so a slot
overwritten before its chunk landed would land the wrong bytes and fail the
verify kernel.

- Every window refused (EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER=1, the init
  probe's pin passes): every h2d.copy is `staged`, and the read verifies.
- A block of five chunks, more than the ring holds, lands and verifies
  while each copy runs late (EBT_MOCK_CUDA_DELAY_US): the slots are reused
  only after their chunk landed.
- A corrupt byte is named at its exact file offset through the slots.
- Registered windows keep the `registered` tier and allocate no slot.
- A refused pinned allocation (EBT_MOCK_CUDA_HOSTALLOC_REFUSE_AFTER) leaves
  the read on the `pageable` tier, without an error.
"""

from __future__ import annotations

import ctypes
import os

import pytest

from elbencho_tpu_torch import cli, engine, spans

SALT = 7
MIB = 1 << 20


@pytest.fixture
def mock(monkeypatch, tmp_path):
    """The port on the CPU behind its mock driver, no mock seam set, the
    span log off afterwards; yields (the mock library, a scratch dir)."""
    for k in list(os.environ):
        if k.startswith("EBT_MOCK_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", engine.build_mock())
    lib = ctypes.CDLL(engine.build_mock())
    lib.ebt_mock_hostalloc_count.restype = ctypes.c_uint64
    yield lib, tmp_path
    spans.disable()
    spans.drain()


def _args(path: str, size: str, block: str, threads: int = 1) -> list[str]:
    return ["-t", str(threads), "-s", size, "-b", block, "--verify",
            str(SALT), "--tpubackend", "pjrt", "--nolive", path]


def _written(lib, tmp_path, size: str, block: str) -> str:
    path = str(tmp_path / "f")
    assert cli.main(["-w", *_args(path, size, block)]) == 0
    lib.ebt_mock_reset()  # the seams' counts start at the read
    return path


def _copies(got: list[spans.Span]) -> list[spans.Span]:
    """The readers' h2d.copy spans (not the path's warm-up copy at init)."""
    readers = {s.tid for s in got if s.name == "h2d.block"}
    return [s for s in got if s.name == "h2d.copy" and s.tid in readers]


def _tiers(got: list[spans.Span]) -> set[str]:
    return {spans.COPY_TIERS[c.code] for c in _copies(got)}


def test_refused_windows_go_through_the_pinned_slots(mock, monkeypatch):
    lib, tmp = mock
    path = _written(lib, tmp, "8M", "2M")
    monkeypatch.setenv("EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER", "1")
    spans.enable()
    assert cli.main(["-r", *_args(path, "8M", "2M")]) == 0
    got = spans.drain()
    assert spans.state()["dropped"] == 0
    windows = [s for s in got if s.name == "reg.window"]
    assert {spans.REG_OUTCOMES[w.code] for w in windows} == \
        {"fallback_refused"}
    assert len(_copies(got)) == 4
    assert _tiers(got) == {"staged"}
    assert sum(c.arg for c in _copies(got)) == 8 * MIB
    # the worker's verify result word and its one slot ring
    assert lib.ebt_mock_hostalloc_count() == 2


@pytest.mark.parametrize("threads", [1, 2])
def test_block_longer_than_the_ring_reuses_its_slots(mock, monkeypatch,
                                                     threads):
    lib, tmp = mock
    path = _written(lib, tmp, "20M", "10M")
    monkeypatch.setenv("EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER", "1")
    # every copy runs 3 ms after its call: a slot refilled before its
    # chunk's copy ran would land the next chunk's bytes in its place
    monkeypatch.setenv("EBT_MOCK_CUDA_DELAY_US", "3000")
    spans.enable()
    assert cli.main(["-r", *_args(path, "20M", "10M", threads)]) == 0
    got = spans.drain()
    assert _tiers(got) == {"staged"}
    assert [c.arg for c in _copies(got)] == [10 * MIB] * 2
    # five 2 MiB chunks per block through four slots; one ring per worker
    assert lib.ebt_mock_hostalloc_count() == 2 * threads


@pytest.mark.parametrize("corrupt_off", [
    (10 << 20) + (8 << 20) + 12345,  # the fifth chunk: its slot reused
    (10 << 20) + 1,                  # the first chunk of the second block
    (10 << 20) - 1,                  # the last byte of the first block
])
def test_corrupt_byte_named_through_the_slots(mock, monkeypatch, capfd,
                                              corrupt_off):
    lib, tmp = mock
    path = _written(lib, tmp, "20M", "10M")
    with open(path, "r+b") as f:
        f.seek(corrupt_off)
        b = f.read(1)
        f.seek(corrupt_off)
        f.write(bytes([b[0] ^ 0x5A]))
    monkeypatch.setenv("EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER", "1")
    spans.enable()
    capfd.readouterr()
    assert cli.main(["-r", *_args(path, "20M", "10M")]) == 1
    out = capfd.readouterr()
    assert ("on-device data verification failed at file offset "
            f"{corrupt_off}") in out.out + out.err
    assert _tiers(spans.drain()) == {"staged"}


def test_registered_windows_take_no_slot(mock):
    lib, tmp = mock
    path = _written(lib, tmp, "20M", "10M")
    spans.enable()
    assert cli.main(["-r", *_args(path, "20M", "10M")]) == 0
    got = spans.drain()
    assert _tiers(got) == {"registered"}
    assert lib.ebt_mock_hostalloc_count() == 1  # the verify result word


def test_refused_pinned_slots_fall_back_to_pageable(mock, monkeypatch):
    lib, tmp = mock
    path = _written(lib, tmp, "20M", "10M")
    monkeypatch.setenv("EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER", "1")
    # the worker's verify result word passes, its slot ring is refused
    monkeypatch.setenv("EBT_MOCK_CUDA_HOSTALLOC_REFUSE_AFTER", "1")
    spans.enable()
    assert cli.main(["-r", *_args(path, "20M", "10M")]) == 0
    got = spans.drain()
    assert _tiers(got) == {"pageable"}
    assert sum(c.arg for c in _copies(got)) == 20 * MIB
    # refused once, not asked again for the second block
    assert lib.ebt_mock_hostalloc_count() == 2
