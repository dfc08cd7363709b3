"""Peaks of the card and the operations and bytes of the port's kernels,
for roofline shares. NVIDIA's data sheet, H100 SXM, dense rates, at the
full 700 W power limit."""

from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12

# csrc/verify.cu checks a block as 32-bit lanes of 64-bit pattern words:
# each byte is read once, and per byte about three integer operations
# (compare, fold into the mismatch count, track the first bad word)
VERIFY_OPS_PER_BYTE = 3


def verify_min_s(bytes_verified: int) -> float:
    """The least time the verify kernel could take over these bytes: the
    larger of the byte bound and the operation bound (the bytes bound)."""
    return max(bytes_verified / H100_HBM_BYTES_PER_S,
               VERIFY_OPS_PER_BYTE * bytes_verified / H100_FP32_OPS_PER_S)
