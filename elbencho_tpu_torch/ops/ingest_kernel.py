"""The ingest step (B4) and the mesh stats reduction (B5): binding and
wrappers.

csrc/ingest.cu and csrc/mesh_reduce.cu are compiled with the port's other
kernels into build/torch_kernels/libebt_torch_kernels.so (kernel_build.py).
They replace the original package's jitted device programs
integrity.checksum_block_u32 / ingest_verify_step and the reductions of
parallel/mesh.py:

    ingest_verify_step(block_u32, off_lo, off_hi, salt_lo, salt_hi) -> dict
        {ok_bytes, bad_words, first_bad_word, checksum} as 0-d int64 tensors
        on the block's device: the single-chip step of graft_entry.entry().
    ingest_verify_batch(blocks, offsets, salt) -> int64[ranks, 4]
        the same step over each row of a [ranks, lanes] batch, one launch:
        the per-device part of parallel/mesh.py sharded_ingest_step.
    sum_rows_u64(rows) -> int64[k]
        exact column sums mod 2^64 of u64 counters in int64 [n, k]: the
        cross-device totals of MeshStatsReducer and sharded_ingest_step.

For a CPU tensor each wrapper computes the plain version (ops/integrity.py).
For a CUDA tensor it launches its kernel on the device's current stream, or
raises: there is no fallback. LAUNCHES counts the launches per kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import integrity
from .kernel_build import library

LAUNCHES = {"ingest_verify_u32": 0, "sum_rows_u64": 0}
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# (device index, stream handle) -> (workspace, SM count, ranks it covers)
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int, int]] = {}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(kernel: str) -> None:
    with _count_lock:
        LAUNCHES[kernel] += 1


def load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(library())
            p, u64 = ctypes.c_void_p, ctypes.c_uint64
            lib.ebt_ingest_verify_u32.argtypes = [
                p, u64, u64, u64, p, p, p, ctypes.c_int, p]
            lib.ebt_ingest_verify_u32.restype = ctypes.c_int
            lib.ebt_ingest_workspace_bytes.argtypes = [ctypes.c_int, u64]
            lib.ebt_ingest_workspace_bytes.restype = u64
            lib.ebt_sum_rows_u64.argtypes = [p, u64, u64, p, p]
            lib.ebt_sum_rows_u64.restype = ctypes.c_int
            # an empty kernel of sum_rows' block shape: its launch floor
            lib.ebt_launch_floor.argtypes = [p]
            lib.ebt_launch_floor.restype = ctypes.c_int
            _lib = lib
        return _lib


def workspace(device: int, stream: int,
              n_ranks: int) -> tuple[torch.Tensor, int]:
    """The ingest kernel's cross-CTA workspace for batches of up to
    `n_ranks` ranks launched on `stream` of CUDA device `device`, and the
    device's SM count. Made (zeroed, on that stream) once per (device,
    stream) and again when a larger batch comes; the kernel leaves every
    ticket at 0, and launches on one stream run in order."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[2] < n_ranks:
        lib = load_lib()
        with _lib_lock:
            ws = _workspaces.get(key)
            if ws is None or ws[2] < n_ranks:
                sms = torch.cuda.get_device_properties(
                    device).multi_processor_count
                n = lib.ebt_ingest_workspace_bytes(sms, n_ranks) // 8
                ws = _workspaces[key] = (
                    torch.zeros(n, dtype=torch.int64, device=device), sms,
                    n_ranks)
    return ws[0], ws[1]


def _check_lanes(blocks: torch.Tensor) -> None:
    if blocks.dtype != torch.int32 or blocks.dim() != 2 or \
            blocks.stride(1) != 1 or blocks.shape[1] % 2 or \
            (blocks.shape[0] > 1 and blocks.stride(0) % 2):
        raise ValueError(
            "ingest step: expected int32 lanes [ranks, lanes] with an even "
            "lane count, rows contiguous and 8-byte aligned; got "
            f"{blocks.dtype} shape {tuple(blocks.shape)} strides "
            f"{blocks.stride()}")


def ingest_verify_batch(blocks: torch.Tensor, offsets,
                        salt: int) -> torch.Tensor:
    """The ingest step over each rank (row) of `blocks`, rank r's block at
    file offset offsets[r] (an int64 tensor of u64 bits, or a sequence of
    ints); one kernel launch. Returns int64[ranks, 4] {ok_bytes, bad_words,
    first_bad_word, checksum} on the blocks' device, without waiting."""
    _check_lanes(blocks)
    n_ranks, n_lanes = blocks.shape
    if blocks.is_cpu:
        return integrity.ingest_verify_batch_plain(blocks, offsets, salt)
    bases = integrity.ingest_bases(offsets, salt)
    if bases.shape != (n_ranks,):
        raise ValueError(f"ingest step: {n_ranks} ranks but offsets of "
                         f"shape {tuple(bases.shape)}")
    ptr = blocks.data_ptr()
    if ptr % 8:
        raise ValueError("ingest step: lanes must be 8-byte aligned")
    lib = load_lib()
    idx = blocks.get_device()
    with torch.cuda.device(idx):
        stream = torch._C._cuda_getCurrentRawStream(idx)
        ws, sms = workspace(idx, stream, n_ranks)
        bases = bases.to(blocks.device, non_blocking=True)
        out = torch.empty((n_ranks, 4), dtype=torch.int64,
                          device=blocks.device)
        rc = lib.ebt_ingest_verify_u32(
            ptr, n_lanes, n_ranks, blocks.stride(0) if n_ranks > 1 else 0,
            bases.data_ptr(), out.data_ptr(), ws.data_ptr(), sms, stream)
    if rc:
        raise RuntimeError(f"ingest kernel launch failed (CUDA error {rc})")
    _count("ingest_verify_u32")
    return out


def ingest_verify_step(block_u32: torch.Tensor, off_lo: int, off_hi: int,
                       salt_lo: int, salt_hi: int) -> dict:
    """The single-chip forward step of the original (integrity.
    ingest_verify_step): verify a staged block (int32 lanes, an even count)
    against the offset+salt pattern and return its stats contribution
    {ok_bytes, bad_words, first_bad_word, checksum} as 0-d int64 tensors
    on the block's device."""
    if block_u32.dtype != torch.int32 or block_u32.dim() != 1 or \
            not block_u32.is_contiguous() or block_u32.numel() % 2:
        raise ValueError("ingest_verify_step: expected a contiguous 1-D "
                         "int32 block with an even lane count, got "
                         f"{block_u32.dtype} shape {tuple(block_u32.shape)}")
    if block_u32.is_cpu:
        return integrity.ingest_verify_step(block_u32, off_lo, off_hi,
                                            salt_lo, salt_hi)
    off = integrity.join_u64((off_lo, off_hi))
    out = ingest_verify_batch(block_u32.view(1, -1), [off],
                              integrity.join_u64((salt_lo, salt_hi)))[0]
    return {"ok_bytes": out[0], "bad_words": out[1],
            "first_bad_word": out[2], "checksum": out[3]}


def sum_rows_u64(rows: torch.Tensor) -> torch.Tensor:
    """Column sums mod 2^64 of the contiguous int64 [n, k] `rows` (u64 bits),
    as int64[k] on the rows' device, without waiting."""
    if rows.dtype != torch.int64 or rows.dim() != 2 or \
            not rows.is_contiguous():
        raise ValueError("sum_rows_u64: expected a contiguous int64 [n, k] "
                         f"tensor, got {rows.dtype} shape {tuple(rows.shape)}")
    if rows.is_cpu:
        return integrity.sum_rows_u64_plain(rows)
    n, k = rows.shape
    out = torch.empty(k, dtype=torch.int64, device=rows.device)
    if k == 0:
        return out
    lib = load_lib()
    idx = rows.get_device()
    with torch.cuda.device(idx):
        rc = lib.ebt_sum_rows_u64(rows.data_ptr(), n, k, out.data_ptr(),
                                  torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        raise RuntimeError(f"sum_rows kernel launch failed (CUDA error {rc})")
    _count("sum_rows_u64")
    return out
