"""The on-device pattern generator (B3): binding and wrapper.

csrc/fill.cu is compiled with the port's other kernels into
build/torch_kernels/libebt_torch_kernels.so (kernel_build.py). It replaces
the original package's device program integrity.fill_block_u32, which its
native engine ran for verified writes; the port's native engine
(csrc/cuda_path.cpp) launches the same C entry, ebt_fill_u64, from C++.

    fill_block_u32(num_words, file_off, salt, device) -> int32[2*num_words]
        the offset+salt pattern as u32 lanes (raw bits in int32), made on
        `device`.
    fill_u64_(out, base) -> out
        the same words written in place into an int64 tensor.

For a CPU tensor the wrappers compute the plain version (ops/integrity.py).
For a CUDA tensor they launch the kernel on the device's current stream or
raise: there is no fallback. LAUNCHES counts their launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import integrity
from .kernel_build import library

LAUNCHES = {"fill_block_u32": 0}
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["fill_block_u32"] = 0


def load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(library())
            lib.ebt_fill_u64.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_uint64, ctypes.c_void_p]
            lib.ebt_fill_u64.restype = ctypes.c_int
            _lib = lib
        return _lib


def fill_u64_(out: torch.Tensor, base: int) -> torch.Tensor:
    """Fill the contiguous int64 tensor `out` in place with the pattern
    words base + 8*i (mod 2^64); `out` may start at any 8-byte-aligned
    address. Returns `out`."""
    if out.dtype != torch.int64 or out.dim() != 1 or \
            not out.is_contiguous():
        raise ValueError("fill_u64_ needs a contiguous 1-D int64 tensor")
    base &= integrity.U64_MASK
    if out.device.type == "cpu":
        out.copy_(integrity.expected_words(out.numel(), base))
        return out
    if out.device.type != "cuda":
        raise ValueError(f"fill_u64_: unsupported device {out.device}")
    if out.numel():
        lib = load_lib()
        idx = out.device.index
        with torch.cuda.device(idx):
            rc = lib.ebt_fill_u64(out.data_ptr(), out.numel(), base,
                                  torch.cuda.current_stream(idx).cuda_stream)
        if rc:
            raise RuntimeError(f"fill kernel launch failed (CUDA error {rc})")
        with _count_lock:
            LAUNCHES["fill_block_u32"] += 1
    return out


def fill_block_u32(num_words: int, file_off, salt,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The pattern for `num_words` u64 words at `file_off` as int32 lanes;
    file_off and salt are ints or (lo, hi) u32 pairs, as in the original."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(num_words, dtype=torch.int64, device=dev)
    base = integrity.join_u64(file_off) + integrity.join_u64(salt)
    return fill_u64_(out, base).view(torch.int32)
