"""The on-device --verify kernel: build, binding and wrappers.

csrc/verify.cu is compiled with nvcc for sm_90a into
build/torch_kernels/libebt_torch_kernels.so at first use (kernel_build.py)
and loaded with ctypes. It replaces the original package's Pallas kernel
(ops/pallas_verify.py, verify_block_pallas) and its jitted verify_block_u32
device program with one kernel and two entry points:

  verify_block_lanes(block, file_off, salt) -> int
      count of bad u32 lanes, the counterpart of verify_block_pallas;
  verify_block_u32(block_bytes, file_off, salt) -> int64[2]
      {bad u64 words, first bad word} as a tensor on the block's device
      (it unpacks to the two 0-d results of integrity.verify_block_u32,
      its counterpart); the staged path verifies a whole block with one
      call and reads the result once.

A launch costs one torch.empty for its int64[3] result and one C call: the
kernel writes the whole result, and its cross-CTA workspace (one per device
and stream, zeroed once when it is made) needs no fill either. The SM count
is queried once per device.

For a CPU tensor each wrapper computes the plain version (ops/integrity.py).
For a CUDA tensor it builds and launches the kernel or raises: there is no
fallback. Each wrapper counts its kernel launches in LAUNCHES.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import integrity
from .kernel_build import LIB_PATH, build_lib

# u64 words one CTA of verify.cu covers per pass (kThreads x kUnroll x 2)
PASS_WORDS = 2048

# kernel launches per wrapper (the main path's proof that it ran the kernel)
LAUNCHES = {"verify_block_lanes": 0, "verify_block_u32": 0}
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# (device index, stream handle) -> (workspace, SM count)
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            build_lib()
            lib = ctypes.CDLL(LIB_PATH)
            lib.ebt_verify_u32.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p]
            lib.ebt_verify_u32.restype = ctypes.c_int
            lib.ebt_verify_workspace_bytes.argtypes = [ctypes.c_int]
            lib.ebt_verify_workspace_bytes.restype = ctypes.c_uint64
            _lib = lib
        return _lib


def workspace(device: int, stream: int) -> tuple[torch.Tensor, int]:
    """The kernel's cross-CTA workspace for launches on `stream` (a
    cudaStream_t handle) of CUDA device `device`, and the device's SM
    count. Made once per (device, stream), zeroed on that stream when it is
    made; the kernel leaves its ticket at 0 after every launch, and
    launches on one stream run in order, so they share it. Two streams
    never do."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None:
        lib = load_lib()
        with _lib_lock:
            ws = _workspaces.get(key)
            if ws is None:
                sms = torch.cuda.get_device_properties(
                    device).multi_processor_count
                n = lib.ebt_verify_workspace_bytes(sms) // 8
                ws = _workspaces[key] = (
                    torch.zeros(n, dtype=torch.int64, device=device), sms)
    return ws


def _launch(data: torch.Tensor, n_lanes: int, base: int,
            counter: str) -> torch.Tensor:
    """Launch the kernel over the first n_lanes u32 lanes of `data` on its
    device's current stream; returns the int64[3] result {bad lanes, bad
    words, first bad word} without waiting for it."""
    ptr = data.data_ptr()
    if ptr % 8:
        raise ValueError("verify kernel: data must be 8-byte aligned")
    lib = load_lib()
    idx = data.get_device()
    # the raw cudaStream_t, without building a torch.cuda.Stream per call
    stream = torch._C._cuda_getCurrentRawStream(idx)
    ws, sms = workspace(idx, stream)
    out = torch.empty(3, dtype=torch.int64, device=data.device)
    args = (ptr, n_lanes, base & integrity.U64_MASK, out.data_ptr(),
            ws.data_ptr(), sms, stream)
    if torch._C._cuda_getDevice() == idx:
        rc = lib.ebt_verify_u32(*args)
    else:
        with torch.cuda.device(idx):
            rc = lib.ebt_verify_u32(*args)
    if rc:
        raise RuntimeError(f"verify kernel launch failed (CUDA error {rc})")
    with _count_lock:
        LAUNCHES[counter] += 1
    return out


def _check_1d_contiguous(t: torch.Tensor, dtype: torch.dtype,
                         name: str) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype} "
                         f"tensor, got {t.dtype} shape {tuple(t.shape)}")


def verify_block_lanes(block: torch.Tensor, file_off: int, salt: int) -> int:
    """Count the u32 lanes of `block` (int32 raw bits) that differ from the
    offset+salt pattern; the counterpart of verify_block_pallas."""
    _check_1d_contiguous(block, torch.int32, "verify_block_lanes")
    if block.is_cpu:
        return integrity.verify_block_lanes_plain(block, file_off, salt)
    out = _launch(block, block.numel(), file_off + salt,
                  "verify_block_lanes")
    return int(out[0])


def verify_block_u32(block_bytes: torch.Tensor, file_off: int, salt: int):
    """Verify whole u64 words of a staged block (uint8, length a multiple
    of 8). Returns int64[2] {num_bad_words, first_bad_word} on the block's
    device, without waiting for it; first_bad_word == num_words when
    clean."""
    _check_1d_contiguous(block_bytes, torch.uint8, "verify_block_u32")
    if block_bytes.numel() % 8:
        raise ValueError("verify_block_u32: length must be a multiple of 8")
    if block_bytes.is_cpu:
        return torch.stack(integrity.verify_block_u32(
            block_bytes.view(torch.int32), integrity.split_u64(file_off),
            integrity.split_u64(salt)))
    return _launch(block_bytes, block_bytes.numel() // 4, file_off + salt,
                   "verify_block_u32")[1:]


def from_jax_verify_scalars(scalars) -> tuple[int, int]:
    """The original Pallas call's SMEM scalars (int32[3] carrying the raw
    u32 bits of base_lo, base_hi and the lane count) -> the kernel's
    (base, n_lanes)."""
    lo, hi, n = (int(v) & integrity.U32_MASK for v in list(scalars)[:3])
    return lo | (hi << 32), n
