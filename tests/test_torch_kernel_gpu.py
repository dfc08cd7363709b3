"""The verify, fill, ingest and reduction kernels against their plain
versions on the card.

The CUDA kernel has no CPU mode, so these tests skip without a CUDA device.
They import neither jax nor the original package, so they also run on a
machine with only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from elbencho_tpu_torch.config import config_from_args
from elbencho_tpu_torch.cuda.backend import TorchStagingPath
from elbencho_tpu_torch.ops import (fill_kernel, ingest_kernel, integrity,
                                    verify_kernel)
from elbencho_tpu_torch.parallel import mesh

U64 = (1 << 64) - 1
CASES = [(0, 1), ((1 << 33) + 4096, (1 << 40) + 7), (U64 - 4095, 1 << 62)]
PASS = verify_kernel.PASS_WORDS


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the verify kernel has no CPU mode")


def _lanes(n_lanes: int, off: int, salt: int) -> torch.Tensor:
    words = (np.arange((n_lanes + 1) // 2, dtype=np.uint64) * np.uint64(8)
             + np.uint64(off & U64) + np.uint64(salt & U64))
    return torch.from_numpy(words.view(np.int32)[:n_lanes].copy())


def _corrupt(cpu: torch.Tensor, seed: int, k: int = 5) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    n = cpu.numel()
    bad = rng.choice(n, min(k, n), replace=False)
    cpu[torch.from_numpy(bad)] ^= 0x5A
    if n > 2:
        cpu[n - 1] ^= 0x100  # the last lane: a tail word or an odd lane
    return cpu


def _check(gpu: torch.Tensor, cpu: torch.Tensor, off: int, salt: int):
    """Both entry points on `gpu` (lanes at any 8-byte-aligned address)
    against the plain versions on the same lanes on the CPU."""
    assert verify_kernel.verify_block_lanes(gpu, off, salt) == \
        integrity.verify_block_lanes_plain(cpu, off, salt)
    n8 = (gpu.numel() // 2) * 2
    if n8:
        n, f = verify_kernel.verify_block_u32(gpu[:n8].view(torch.uint8),
                                              off, salt)
        pn, pf = integrity.verify_block_u32(cpu[:n8], off, salt)
        torch.cuda.synchronize()
        assert (int(n), int(f)) == (int(pn), int(pf))


@pytest.mark.gpu
@pytest.mark.parametrize("off,salt", CASES)
@pytest.mark.parametrize("n_lanes", [1, 12345, 1 << 20])
def test_kernel_matches_plain(cuda, off, salt, n_lanes):
    cpu = _corrupt(_lanes(n_lanes, off, salt), n_lanes)
    _check(cpu.cuda(), cpu, off, salt)


@pytest.mark.gpu
@pytest.mark.parametrize("n_words", [
    1, 2, 3, PASS - 1, PASS, PASS + 1, 3 * PASS + 1, 256 * PASS - 1,
    256 * PASS + 1, 1000 * PASS + 3])
@pytest.mark.parametrize("misalign", [False, True])
@pytest.mark.parametrize("odd_lane", [False, True])
@pytest.mark.parametrize("corrupt", [False, True])
def test_kernel_edges_match_plain(cuda, n_words, misalign, odd_lane,
                                  corrupt):
    """Word counts just above and below multiples of the per-pass width
    and of a whole wave, a start 8 bytes past a 16-byte boundary (the
    scalar head word), and an odd lane count."""
    off, salt = (1 << 33) + 4096, 77
    n_lanes = 2 * n_words + odd_lane
    cpu = _lanes(n_lanes, off, salt)
    if corrupt:
        cpu = _corrupt(cpu, n_words)
    room = torch.empty(n_lanes + 4, dtype=torch.int32, device="cuda")
    gpu = room[2:2 + n_lanes] if misalign else room[:n_lanes]
    gpu.copy_(cpu)
    assert gpu.data_ptr() % 16 == (8 if misalign else 0)
    _check(gpu, cpu, off, salt)


@pytest.mark.gpu
def test_kernel_edges_at_a_whole_wave(cuda):
    """Word counts around the grid's cap (SMs x CTAs per SM x per-pass
    width), where the CTAs stride a second time."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = sms * 4 * PASS
    for n_words in (wave - 1, wave, wave + 1, 2 * wave + 3):
        cpu = _corrupt(_lanes(2 * n_words, 8, 9), n_words)
        _check(cpu.cuda(), cpu, 8, 9)


def _alternating(streams):
    """Clean and corrupt 4 MiB blocks launched back to back, round robin
    over `streams`, with no synchronisation between launches."""
    off, salt = 4 << 20, 42
    clean = _lanes(1 << 20, off, salt)
    bad = clean.clone()
    bad[[3, 70000, (1 << 20) - 1]] ^= 0x11
    blocks = [clean.cuda().view(torch.uint8), bad.cuda().view(torch.uint8)]
    torch.cuda.synchronize()
    results = []
    for i in range(16):
        with torch.cuda.stream(streams[i % len(streams)]):
            results.append(verify_kernel.verify_block_u32(blocks[i % 2], off,
                                                          salt))
    torch.cuda.synchronize()
    want = [(0, 1 << 19), (3, 1)]
    assert [(int(n), int(f)) for n, f in results] == \
        [want[i % 2] for i in range(16)]


@pytest.mark.gpu
def test_alternating_launches_on_one_stream_reset_the_ticket(cuda):
    _alternating([torch.cuda.Stream()])


@pytest.mark.gpu
def test_alternating_launches_on_two_streams_use_two_workspaces(cuda):
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    _alternating([s1, s2])
    w1 = verify_kernel.workspace(0, s1.cuda_stream)
    w2 = verify_kernel.workspace(0, s2.cuda_stream)
    assert w1[0].data_ptr() != w2[0].data_ptr()


@pytest.mark.gpu
def test_kernel_counts_launches_and_refuses_misalignment(cuda):
    gpu = _lanes(1 << 10, 0, 1).cuda()
    before = verify_kernel.LAUNCHES["verify_block_lanes"]
    assert verify_kernel.verify_block_lanes(gpu, 0, 1) == 0
    assert verify_kernel.LAUNCHES["verify_block_lanes"] == before + 1
    with pytest.raises(ValueError, match="aligned"):
        verify_kernel.verify_block_lanes(gpu[1:], 4, 1)


@pytest.mark.gpu
def test_staged_verify_on_the_card(cuda, tmp_path, monkeypatch):
    """A staged --verify block of 4 chunks on cuda:0: one launch, and a
    planted byte in the block's second chunk reported at its offset."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(1 << 20))
    p = tmp_path / "f"
    p.write_bytes(b"\0" * (4 << 20))
    sp = TorchStagingPath(config_from_args(
        ["-r", "-t", "1", "-b", "4M", "--gpuids", "0", "--tpubackend",
         "staged", "--verify", "42", "--nolive", str(p)]))
    assert sp.devices == [torch.device("cuda", 0)]
    file_off = 12 << 20
    words = (np.arange(1 << 19, dtype=np.uint64) * np.uint64(8)
             + np.uint64(file_off + 42))
    buf = words.view(np.uint8).copy()
    before = verify_kernel.LAUNCHES["verify_block_u32"]
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, file_off) == 0
    assert verify_kernel.LAUNCHES["verify_block_u32"] == before + 1
    assert len(sp.last_staged_arrays(0)) == 4
    planted = (1 << 20) + 4
    buf[planted] ^= 0x81
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, file_off) == 2
    assert sp.verify_errors[0].endswith(f"file offset {file_off + planted}")


# B3 on the card: (words, word offset into the buffer, file offset, salt)
FILL_CASES = [(1 << 16, 0, (1 << 33) + 4096, (1 << 40) + 7),
              (4097, 0, U64 - 4095, 7),            # wraps past 2^64
              (1, 0, 0, 1), (3, 0, 8, 2), (12345, 0, 64, 9),  # odd counts
              (1 << 16, 1, 4096, 42), (4097, 1, 8192, 5)]     # start 8 mod 16


@pytest.mark.gpu
@pytest.mark.parametrize("n,skip,off,salt", FILL_CASES)
def test_fill_kernel_matches_plain(cuda, n, skip, off, salt):
    """The fill kernel writes exactly the plain pattern, only its words,
    and counts one launch."""
    buf = torch.full((n + skip + 2,), -1, dtype=torch.int64, device="cuda")
    before = fill_kernel.LAUNCHES["fill_block_u32"]
    fill_kernel.fill_u64_(buf[skip:skip + n], off + salt)
    torch.cuda.synchronize()
    assert fill_kernel.LAUNCHES["fill_block_u32"] == before + 1
    want = integrity.expected_words(n, off + salt)
    got = buf.cpu()
    assert torch.equal(got[skip:skip + n], want)
    assert bool((got[:skip] == -1).all()) and bool((got[skip + n:] == -1).all())


@pytest.mark.gpu
def test_fill_block_u32_on_the_card_matches_cpu(cuda):
    off, salt = (1 << 33) + 4096, (1 << 40) + 7
    gpu = fill_kernel.fill_block_u32(3001, off, salt, "cuda")
    assert gpu.device.type == "cuda"
    assert torch.equal(gpu.cpu(), fill_kernel.fill_block_u32(3001, off, salt))


# ---------------------------------------------------------------- B4, B5

def _step_rows(out: dict) -> list[int]:
    return [int(out[k]) for k in ("ok_bytes", "bad_words", "first_bad_word",
                                  "checksum")]


@pytest.mark.gpu
@pytest.mark.parametrize("off,salt", CASES)
@pytest.mark.parametrize("n_words", [1, 2, 3, PASS - 1, PASS + 1,
                                     256 * PASS + 1, 1 << 19])
@pytest.mark.parametrize("misalign", [False, True])
@pytest.mark.parametrize("corrupt", [False, True])
def test_ingest_kernel_matches_plain(cuda, off, salt, n_words, misalign,
                                     corrupt):
    """The fused verify + checksum step: word counts around the per-pass
    width, a start 8 mod 16, offsets that carry and wrap, corrupt lanes
    including the last."""
    cpu = _lanes(2 * n_words, off, salt)
    if corrupt:
        cpu = _corrupt(cpu, n_words)
    room = torch.empty(2 * n_words + 4, dtype=torch.int32, device="cuda")
    gpu = room[2:2 + 2 * n_words] if misalign else room[:2 * n_words]
    gpu.copy_(cpu)
    args = (*integrity.split_u64(off), *integrity.split_u64(salt))
    before = ingest_kernel.LAUNCHES["ingest_verify_u32"]
    got = ingest_kernel.ingest_verify_step(gpu, *args)
    assert got["checksum"].device.type == "cuda"
    assert _step_rows(got) == _step_rows(
        integrity.ingest_verify_step(cpu, *args))
    assert ingest_kernel.LAUNCHES["ingest_verify_u32"] == before + 1


@pytest.mark.gpu
def test_ingest_batch_matches_plain(cuda):
    """One launch over 8 ranks at their own offsets (one wrapping past
    2^64), rows strided inside a wider tensor, one rank corrupt; then a
    larger batch on the same stream grows the workspace."""
    salt = (1 << 40) + 7
    offs = [r * (1 << 20) for r in range(7)] + [U64 - 4095]
    cpu = torch.stack([_lanes(1 << 18, o, salt) for o in offs])
    cpu[5, 777] ^= 0x40
    wide = torch.zeros((8, (1 << 18) + 6), dtype=torch.int32, device="cuda")
    gpu = wide[:, 2:2 + (1 << 18)]
    gpu.copy_(cpu)
    got = ingest_kernel.ingest_verify_batch(gpu, offs, salt)
    want = integrity.ingest_verify_batch_plain(cpu, offs, salt)
    assert torch.equal(got.cpu(), want)
    assert int(want[:, 1].sum()) == 1
    big = torch.stack([_lanes(1 << 12, o, 3) for o in range(0, 64 << 12,
                                                             1 << 12)])
    offs_big = list(range(0, 64 << 12, 1 << 12))
    assert torch.equal(
        ingest_kernel.ingest_verify_batch(big.cuda(), offs_big, 3).cpu(),
        integrity.ingest_verify_batch_plain(big, offs_big, 3))


@pytest.mark.gpu
def test_ingest_smaller_batch_after_larger_on_one_workspace(cuda):
    """A batch of 4 ranks with 100 bad words in rank 1's first 16 KiB (the
    first CTA's pass), then a 1-rank step on another rank's block, a 2-rank
    batch and 4 ranks again on the same stream and workspace: every launch
    finds its tickets at 0, whatever the earlier, larger batch left in its
    slots. (With the tickets placed after the launch's own n_ranks regions,
    the step's ticket would be rank 1's first bad-word slot, 100, more than
    the step's 64 CTAs, and no CTA would fold: `out` would stay unwritten.)"""
    salt, lanes = 9, 1 << 18
    # offsets 1 MiB + 8*977 apart: a CTA's partial checksum differs from
    # rank to rank (1 MiB alone is 2^32 over a CTA's 2048 words)
    offs = [r * (lanes * 4 + 8 * 977) for r in range(4)]
    cpu = torch.stack([_lanes(lanes, o, salt) for o in offs])
    cpu[1, 0:200:2] ^= 0x1000  # 100 bad words, all in the first CTA's pass
    gpu = cpu.cuda()
    for _ in range(2):
        got = ingest_kernel.ingest_verify_batch(gpu, offs, salt)
        assert torch.equal(got.cpu(), integrity.ingest_verify_batch_plain(
            cpu, offs, salt))
        assert got[:, 1].tolist() == [0, 100, 0, 0]
        args = (*integrity.split_u64(offs[2]), *integrity.split_u64(salt))
        assert _step_rows(ingest_kernel.ingest_verify_step(gpu[2], *args)) \
            == _step_rows(integrity.ingest_verify_step(cpu[2], *args))
        got = ingest_kernel.ingest_verify_batch(gpu[1:3], offs[1:3], salt)
        assert torch.equal(got.cpu(), integrity.ingest_verify_batch_plain(
            cpu[1:3], offs[1:3], salt))


@pytest.mark.gpu
def test_ingest_kernel_refuses_what_it_does_not_take(cuda):
    gpu = _lanes(1 << 10, 0, 1).cuda()
    with pytest.raises(ValueError, match="even lane count"):
        ingest_kernel.ingest_verify_step(gpu[:-1], 0, 0, 1, 0)
    with pytest.raises(ValueError, match="aligned"):
        ingest_kernel.ingest_verify_batch(gpu[1:-1].view(1, -1), [4], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1, 1), (2, 5), (37, 6), (1000, 3),
                                 (3, 100), (5, 0)])
def test_sum_rows_kernel_matches_plain(cuda, n, k):
    rows = np.random.default_rng(n * 1000 + k).integers(
        0, U64, (n, k), dtype=np.uint64, endpoint=True)
    cpu = torch.from_numpy(rows.view(np.int64))
    before = ingest_kernel.LAUNCHES["sum_rows_u64"]
    got = ingest_kernel.sum_rows_u64(cpu.cuda())
    assert torch.equal(got.cpu(), integrity.sum_rows_u64_plain(cpu))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64),
                                  rows.sum(axis=0, dtype=np.uint64))
    assert ingest_kernel.LAUNCHES["sum_rows_u64"] == before + (k > 0)


def _device_lists():
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[:1], [cards[0], cards[0]], cards]


@pytest.mark.gpu
def test_mesh_reducer_and_sharded_ingest_on_the_card(cuda):
    """MeshStatsReducer and run_sharded_ingest over [cuda:0], [cuda:0,
    cuda:0] and every card: exact totals, one ingest launch per device and
    one reduction per step."""
    for devs in _device_lists():
        n = len(devs)
        rows = [[(1 << 63) + d, U64 - d, (1 << 40) + d, d]
                for d in range(n)]
        ingest_kernel.reset_launches()
        assert mesh.MeshStatsReducer(devs).reduce(rows) == [
            sum(r[c] for r in rows) & U64 for c in range(4)]
        assert ingest_kernel.LAUNCHES == {"ingest_verify_u32": 0,
                                          "sum_rows_u64": 1}
        words, salt = 1 << 12, 5
        offs = np.arange(2 * n, dtype=np.uint64) * np.uint64(words * 8)
        blocks = np.stack([_lanes(2 * words, int(o), salt).numpy().view(
            np.uint32) for o in offs])
        blocks[1, 10] ^= 0xFF
        ingest_kernel.reset_launches()
        got = mesh.run_sharded_ingest(devs, blocks, offs, salt)
        assert ingest_kernel.LAUNCHES == {"ingest_verify_u32": n,
                                          "sum_rows_u64": 1}
        assert got["bad_words"] == 1.0 and got["iops"] == float(2 * n)
        assert got["ok_bytes"] == float((2 * n - 1) * words * 8)
        plain = integrity.ingest_verify_batch_plain(
            torch.from_numpy(blocks.view(np.int32)), offs, salt)
        assert got["checksum"] == float(np.float32(int(plain[:, 3].sum())))
