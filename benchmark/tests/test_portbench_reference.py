"""The reference against known values, and its pattern against the bytes
the port itself writes with --verify."""

from __future__ import annotations

import numpy as np

from benchmark import reference


def test_pattern_known_words():
    got = reference.pattern(8, 16, 5)
    assert got.tobytes() == (13).to_bytes(8, "little") + \
        (21).to_bytes(8, "little")
    # a tail shorter than a word holds the leading bytes of its word
    assert reference.pattern(0, 3, 0x010203).tobytes() == b"\x03\x02\x01"
    # words wrap modulo 2**64, as the port's 64-bit words do
    top = reference.pattern(0, 8, 2**64 - 1)
    assert top.view("<u8")[0] == np.uint64(2**64 - 1)
    assert reference.pattern(8, 8, 2**64 - 1).view("<u8")[0] == 7


def test_pattern_refuses_unaligned_offset():
    import pytest

    with pytest.raises(ValueError):
        reference.pattern(4, 8, 1)


def test_read_pass_unet3d():
    # 146,600,628-byte files in 8 MiB blocks: 17 whole blocks each
    got = reference.read_pass(20, 146600628, 8 << 20)
    assert got == {"blocks": 340, "bytes": 340 * (8 << 20)}


def test_pattern_matches_what_the_port_writes(mock_env, tmp_path):
    """The frozen pattern is the one the port's -w --verify writes."""
    from elbencho_tpu_torch.cli import main

    path = tmp_path / "f"
    size = (1 << 20) + 12345
    rc = main(["-w", "-t", "1", "-s", str(size), "-b", "256K",
               "--verify", "1234567", "--tpubackend", "pjrt", "--nolive",
               str(path)])
    assert rc == 0
    data = np.fromfile(path, dtype=np.uint8)
    blocks = size // (256 << 10) * (256 << 10)
    assert np.array_equal(data[:blocks],
                          reference.pattern(0, blocks, 1234567))
