"""The plain reference: what a correct run of a cell must show.

Plain NumPy and integer arithmetic. It imports nothing of the port; it
restates, from the port's documented behaviour, the rules the comparison
needs:

- the --verify pattern: the 8-byte little-endian word at file offset o
  holds o + salt (a sub-word tail holds the leading bytes of its word);
- a sequential read pass reads whole --block blocks only: a file's tail
  shorter than one block is not read.
"""

from __future__ import annotations

import numpy as np

WORD = 8


def pattern(offset: int, length: int, salt: int) -> np.ndarray:
    """The bytes [offset, offset + length) of a file written with the
    --verify pattern for `salt`. offset must be a multiple of 8."""
    if offset % WORD:
        raise ValueError(f"offset {offset} is not a multiple of {WORD}")
    nwords = -(-length // WORD)
    first = offset // WORD
    words = (np.arange(first, first + nwords, dtype=np.uint64)
             * np.uint64(WORD) + np.uint64(salt))
    return words.astype("<u8").view(np.uint8)[:length]


def read_pass(files: int, file_bytes: int, block_bytes: int) -> dict:
    """What one sequential read phase over `files` files moves."""
    blocks = files * (file_bytes // block_bytes)
    return {"blocks": blocks, "bytes": blocks * block_bytes}

