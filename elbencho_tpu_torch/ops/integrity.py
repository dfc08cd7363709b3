"""On-device data-integrity ops, plain PyTorch versions.

Port of the original package's ops/integrity.py. The pattern matches
core/src/engine.cpp fillVerifyPattern: little-endian u64 word i of a block
at file offset `off` equals (off + 8*i + salt) mod 2^64.

Blocks are carried as raw bytes viewed as torch.int64 words or torch.int32
lanes: torch's unsigned dtypes have few ops, and two's-complement int64
addition wraps mod 2^64 exactly as the u64 pattern needs. Lane values
returned as tensors are int64 holding the u32 value (0..2^32-1).

These are the plain versions of the CUDA kernels in csrc/verify.cu,
csrc/fill.cu, csrc/ingest.cu and csrc/mesh_reduce.cu: the CPU tests hold
them against the original package, and chip_smoke.py holds the kernels
against them on the card. ops/verify_kernel.py, ops/fill_kernel.py and
ops/ingest_kernel.py call them for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

U64_MASK = (1 << 64) - 1
U32_MASK = 0xFFFFFFFF


def signed64(v: int) -> int:
    """The int64 value with the same 64 bits as the u64 value v."""
    v &= U64_MASK
    return v - (1 << 64) if v >> 63 else v


def join_u64(v) -> int:
    """A u64 given as an int or as a (lo, hi) u32 pair -> int."""
    if isinstance(v, (tuple, list)):
        lo, hi = v
        return (int(lo) & U32_MASK) | ((int(hi) & U32_MASK) << 32)
    return int(v) & U64_MASK


def split_u64(v: int) -> tuple[int, int]:
    return int(v & 0xFFFFFFFF), int((v >> 32) & 0xFFFFFFFF)


def expected_words(num_words: int, base: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """int64 words base + 8*i (mod 2^64), i = 0..num_words-1."""
    i = torch.arange(num_words, dtype=torch.int64, device=device)
    return i * 8 + signed64(base)


def expected_pattern_u32(num_words: int, file_off, salt,
                         device: torch.device | str = "cpu"):
    """Expected (lo, hi) u32 lanes for u64 words i = 0..num_words-1:
    value_i = file_off + 8*i + salt (mod 2^64).

    file_off and salt are ints or (lo, hi) u32 pairs, as in the original."""
    w = expected_words(num_words, join_u64(file_off) + join_u64(salt), device)
    return w & U32_MASK, (w >> 32) & U32_MASK


def verify_block_u32(block_u32: torch.Tensor, file_off, salt):
    """Verify a staged block against the offset+salt pattern.

    block_u32: int32 lanes of the block's raw bytes (pairs of lanes = one
    u64 little-endian word). Returns 0-d int64 tensors (num_bad_words,
    first_bad_word_index), where first_bad_word_index == num_words when the
    block is clean."""
    words = block_u32.contiguous().view(torch.int64)
    num_words = words.numel()
    exp = expected_words(num_words, join_u64(file_off) + join_u64(salt),
                         words.device)
    bad = words != exp
    num_bad = bad.sum()
    if num_words == 0:
        return num_bad, torch.zeros((), dtype=torch.int64)
    first_bad = torch.where(num_bad > 0, bad.to(torch.uint8).argmax(),
                            num_words)
    return num_bad, first_bad


def verify_block_lanes_plain(block_u32: torch.Tensor, file_off: int,
                             salt: int) -> int:
    """Count of u32 lanes that differ from the offset+salt pattern: the
    plain counterpart of the original's Pallas verify_block_pallas. Lane 2i
    is the low half of word i, lane 2i+1 its high half; an odd trailing
    lane is compared as a low half."""
    n = block_u32.numel()
    nw = n // 2
    base = join_u64(file_off) + join_u64(salt)
    lanes = block_u32.contiguous()
    x = lanes[:2 * nw].view(torch.int64) ^ expected_words(nw, base,
                                                          lanes.device)
    bad = int(((x & U32_MASK) != 0).sum()) + int(((x >> 32) != 0).sum())
    if n % 2:
        tail_exp = (base + 8 * nw) & U32_MASK
        bad += int((int(lanes[n - 1]) & U32_MASK) != tail_exp)
    return bad


def fill_block_u32(num_words: int, file_off, salt,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Generate the pattern as int32 lanes (for device-originated writes)."""
    base = join_u64(file_off) + join_u64(salt)
    return expected_words(num_words, base, device).view(torch.int32)


def checksum_block_u32(block_u32: torch.Tensor) -> torch.Tensor:
    """Cheap content checksum (sum of u32 lanes, mod 2^32), as int64."""
    return ((block_u32.to(torch.int64) & U32_MASK).sum()) & U32_MASK


def ingest_verify_step(block_u32: torch.Tensor, off_lo: int, off_hi: int,
                       salt_lo: int, salt_hi: int) -> dict:
    """The single-chip 'forward step' of the framework: given a staged block
    and its file offset, verify the integrity pattern and produce the
    per-block stats contribution (bytes ok, bad words, checksum)."""
    num_bad, first_bad = verify_block_u32(block_u32, (off_lo, off_hi),
                                          (salt_lo, salt_hi))
    checksum = checksum_block_u32(block_u32)
    nbytes = block_u32.numel() * 4
    ok_bytes = torch.where(num_bad == 0, nbytes, 0)
    return {"ok_bytes": ok_bytes, "bad_words": num_bad,
            "first_bad_word": first_bad, "checksum": checksum}


def ingest_bases(offsets, salt: int) -> torch.Tensor:
    """The per-rank pattern bases offsets[r] + salt (mod 2^64) as int64 u64
    bits on the CPU; offsets is an int64 tensor of u64 bits or a sequence
    of ints."""
    if isinstance(offsets, torch.Tensor):
        offs = offsets.to("cpu", torch.int64)
    else:
        offs = torch.from_numpy(
            np.asarray(offsets, dtype=np.uint64).view(np.int64).copy())
    return offs + signed64(salt)  # int64 addition wraps mod 2^64


def ingest_verify_batch_plain(blocks: torch.Tensor, offsets,
                              salt: int) -> torch.Tensor:
    """ingest_verify_step over each row of `blocks` (int32 lanes, [ranks,
    lanes], an even lane count), row r at file offset offsets[r]: the
    original's vmapped per-rank step (parallel/mesh.py). offsets is an int64
    tensor of u64 bits or a sequence of ints. Returns int64[ranks, 4] rows
    {ok_bytes, bad_words, first_bad_word, checksum}."""
    if blocks.dim() != 2 or blocks.shape[1] % 2:
        raise ValueError("ingest step: expected [ranks, lanes] int32 lanes "
                         f"with an even lane count, got {tuple(blocks.shape)}")
    n_ranks, n_lanes = blocks.shape
    num_words = n_lanes // 2
    bases = ingest_bases(offsets, salt).to(blocks.device)
    words = blocks.contiguous().view(torch.int64)
    i = torch.arange(num_words, dtype=torch.int64, device=blocks.device)
    bad = words != (i * 8 + bases[:, None])
    num_bad = bad.sum(dim=1)
    if num_words:
        first = torch.where(num_bad > 0, bad.to(torch.uint8).argmax(dim=1),
                            num_words)
    else:
        first = torch.zeros(n_ranks, dtype=torch.int64, device=blocks.device)
    checksum = (blocks.to(torch.int64) & U32_MASK).sum(dim=1) & U32_MASK
    ok = torch.where(num_bad == 0, (n_lanes * 4) & U32_MASK, 0)
    return torch.stack([ok, num_bad, first, checksum], dim=1)


def sum_rows_u64_plain(rows: torch.Tensor) -> torch.Tensor:
    """Column sums mod 2^64 of u64 counters carried in int64 [n, k]; the
    original's MeshStatsReducer reduction without its 16-bit limbs. The
    halves are summed apart, so no int64 sum overflows: exact for
    n < 2^31 rows."""
    lo = rows & U32_MASK
    hi = (rows >> 32) & U32_MASK
    s_lo = lo.sum(dim=0)
    s_hi = (hi.sum(dim=0) + (s_lo >> 32)) & U32_MASK
    s_hi = torch.where(s_hi >= 1 << 31, s_hi - (1 << 32), s_hi)
    return s_hi * (1 << 32) + (s_lo & U32_MASK)


def make_example_block(num_bytes: int = 1 << 16, file_off: int = 4096,
                       salt: int = 42) -> np.ndarray:
    """Host-side pattern generation for tests/examples (matches the native
    fillVerifyPattern byte-exactly)."""
    num_words = num_bytes // 8
    words = (np.arange(num_words, dtype=np.uint64) * 8 +
             np.uint64(file_off) + np.uint64(salt))
    return words.view(np.uint32)
