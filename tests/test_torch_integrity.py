"""The port's integrity ops against the original package's, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both sides; all
of this is integer arithmetic, so the stated tolerance is exact equality.
The Pallas kernel runs in interpret mode, as the original's own tests run
it; the port's verify and fill wrappers take their plain path for a CPU
tensor.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from elbencho_tpu.ops import integrity as jax_integrity
from elbencho_tpu.ops.pallas_verify import verify_block_pallas
from elbencho_tpu_torch.ops import fill_kernel, integrity
from elbencho_tpu_torch.ops import verify_kernel

U64 = (1 << 64) - 1
# (file offset, salt): the original tests' cases plus a base past 2^64
CASES = [(0, 1), (8192, 4242), ((1 << 33) + 64, (1 << 40) + 5),
         ((1 << 33) + 4096, (1 << 40) + 7), (U64 - 4095, 1 << 62)]


def _pattern(num_bytes: int, off: int, salt: int) -> np.ndarray:
    """The on-disk pattern as u32 lanes (u64 words off + 8*i + salt)."""
    words = (np.arange(num_bytes // 8, dtype=np.uint64) * np.uint64(8)
             + np.uint64(off & U64) + np.uint64(salt & U64))
    return words.view(np.uint32)


def _t(lanes: np.ndarray) -> torch.Tensor:
    """numpy u32 lanes -> the port's int32 lane tensor (same bits)."""
    return torch.from_numpy(lanes.view(np.int32).copy())


@pytest.mark.parametrize("off,salt", CASES)
def test_expected_pattern_and_fill_match_jax(off, salt):
    n = 777
    jlo, jhi = jax_integrity.expected_pattern_u32(
        n, integrity.split_u64(off), integrity.split_u64(salt))
    lo, hi = integrity.expected_pattern_u32(
        n, integrity.split_u64(off), integrity.split_u64(salt))
    assert np.array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
    assert np.array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    jfill = np.asarray(jax_integrity.fill_block_u32(
        n, integrity.split_u64(off), integrity.split_u64(salt)))
    fill = integrity.fill_block_u32(n, off, salt)
    assert np.array_equal(fill.numpy().view(np.uint32), jfill)


@pytest.mark.parametrize("off,salt", CASES)
def test_verify_block_u32_matches_jax(off, salt):
    rng = np.random.default_rng(1234)
    lanes = _pattern(1 << 13, off, salt).copy()
    for corrupt in ([], [100], sorted(rng.choice(lanes.size, 3, False))):
        bad = lanes.copy()
        bad[list(corrupt)] ^= 0xFF
        jn, jf = jax_integrity.verify_block_u32(
            jnp.asarray(bad), integrity.split_u64(off),
            integrity.split_u64(salt))
        n, f = integrity.verify_block_u32(_t(bad), integrity.split_u64(off),
                                          integrity.split_u64(salt))
        assert (int(n), int(f)) == (int(jn), int(jf))


def test_checksum_and_ingest_step_match_jax():
    rng = np.random.default_rng(7)
    lanes = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    assert int(integrity.checksum_block_u32(_t(lanes))) == \
        int(jax_integrity.checksum_block_u32(jnp.asarray(lanes)))
    off, salt = 4096, 42
    block = _pattern(1 << 14, off, salt).copy()
    block[9] ^= 1
    ours = integrity.ingest_verify_step(_t(block), *integrity.split_u64(off),
                                        *integrity.split_u64(salt))
    ref = jax_integrity.ingest_verify_step(
        jnp.asarray(block), *(jnp.uint32(v) for v in
                              integrity.split_u64(off)
                              + integrity.split_u64(salt)))
    assert {k: int(v) for k, v in ours.items()} == \
        {k: int(v) for k, v in ref.items()}


def test_make_example_block_and_split_match_jax():
    assert np.array_equal(integrity.make_example_block(2048, 512, 7),
                          jax_integrity.make_example_block(2048, 512, 7))
    for v in (0, 1, (1 << 32) + 5, U64):
        assert integrity.split_u64(v) == jax_integrity.split_u64(v)


def test_lanes_clean_and_three_corrupt_match_pallas():
    off, salt = (1 << 33) + 4096, (1 << 40) + 7
    b = _pattern(1 << 16, off, salt).copy()
    assert verify_kernel.verify_block_lanes(_t(b), off, salt) == \
        verify_block_pallas(jnp.asarray(b), off, salt, interpret=True) == 0
    b[[5, 1000, 16000]] ^= 0xDEAD
    assert verify_kernel.verify_block_lanes(_t(b), off, salt) == \
        verify_block_pallas(jnp.asarray(b), off, salt, interpret=True) == 3


@pytest.mark.parametrize("off,salt", [(512, 9), (U64 - 1023, 3)])
def test_lanes_partial_tile_matches_pallas(off, salt):
    b = _pattern(12 << 10, off, salt).copy()  # not a tile multiple
    assert verify_kernel.verify_block_lanes(_t(b), off, salt) == 0
    b[-1] ^= 0xFF  # corruption in the final partial tile still counts
    assert verify_kernel.verify_block_lanes(_t(b), off, salt) == \
        verify_block_pallas(jnp.asarray(b), off, salt, interpret=True) == 1


def test_lanes_odd_count_matches_pallas():
    off, salt = 4096, 11
    b = _pattern(4096, off, salt)[:1023].copy()  # odd: last lane is a low half
    assert verify_kernel.verify_block_lanes(_t(b), off, salt) == \
        verify_block_pallas(jnp.asarray(b), off, salt, interpret=True) == 0
    b[-1] ^= 1
    assert verify_kernel.verify_block_lanes(_t(b), off, salt) == \
        verify_block_pallas(jnp.asarray(b), off, salt, interpret=True) == 1


@settings(max_examples=20, deadline=None)
@given(off=st.integers(0, U64), salt=st.integers(0, U64),
       n_lanes=st.integers(1, 6000),
       corrupt=st.lists(st.integers(0, 1 << 30), max_size=6),
       flip=st.integers(1, (1 << 32) - 1))
def test_lanes_sweep_matches_pallas(off, salt, n_lanes, corrupt, flip):
    b = _pattern(((n_lanes + 1) // 2) * 8, off, salt)[:n_lanes].copy()
    for pos in corrupt:
        b[pos % n_lanes] ^= np.uint32(flip)
    ref = verify_block_pallas(jnp.asarray(b), off, salt, interpret=True)
    assert verify_kernel.verify_block_lanes(_t(b), off, salt) == ref
    assert integrity.verify_block_lanes_plain(_t(b), off, salt) == ref


def test_verify_block_u32_wrapper_cpu_plain_path():
    off, salt = 8 << 20, 42
    lanes = _pattern(1 << 12, off, salt).copy()
    raw = torch.from_numpy(lanes.view(np.uint8).copy())
    before = dict(verify_kernel.LAUNCHES)
    n, f = verify_kernel.verify_block_u32(raw, off, salt)
    assert (int(n), int(f)) == (0, 512)
    raw[8 * 77 + 3] ^= 0x10
    n, f = verify_kernel.verify_block_u32(raw, off, salt)
    assert (int(n), int(f)) == (1, 77)
    # the plain path launches nothing
    assert verify_kernel.LAUNCHES == before


def test_from_jax_verify_scalars_feeds_the_same_call():
    off, salt = (1 << 33) + 4096, (1 << 40) + 7
    b = _pattern(1 << 12, off, salt).copy()
    b[3] ^= 1
    base = (off + salt) & U64
    # the scalars exactly as verify_block_pallas builds them
    scalars = np.array([base & 0xFFFFFFFF, (base >> 32) & 0xFFFFFFFF,
                        b.size], dtype=np.uint32).view(np.int32)
    kbase, n_lanes = verify_kernel.from_jax_verify_scalars(scalars)
    assert (kbase, n_lanes) == (base, b.size)
    assert verify_kernel.verify_block_lanes(_t(b)[:n_lanes], kbase, 0) == \
        verify_block_pallas(jnp.asarray(b), off, salt, interpret=True) == 1


@pytest.mark.parametrize("bad", [
    torch.zeros(16, dtype=torch.int64),                 # wrong dtype
    torch.zeros((4, 4), dtype=torch.int32),             # not 1-D
    torch.zeros(32, dtype=torch.int32)[::2],            # not contiguous
])
def test_verify_block_lanes_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        verify_kernel.verify_block_lanes(bad, 0, 1)


def test_verify_block_u32_refuses_partial_words():
    with pytest.raises(ValueError):
        verify_kernel.verify_block_u32(torch.zeros(12, dtype=torch.uint8),
                                       0, 1)
    with pytest.raises(ValueError):
        verify_kernel.verify_block_u32(torch.zeros(4, dtype=torch.int32),
                                       0, 1)


# B3 (the pattern generator): (words, file offset, salt)
FILL_CASES = [(4096, (1 << 33) + 4096, (1 << 40) + 7),   # large offset/salt
              (1025, U64 - 4095, 7),                    # wraps past 2^64
              (1, 8192, 4242), (3, 0, 1), (777, 64, 9)]  # odd word counts


@pytest.mark.parametrize("n,off,salt", FILL_CASES)
def test_fill_wrapper_matches_jax_bit_for_bit(n, off, salt):
    """The fill wrapper's CPU path against the original's fill_block_u32,
    exact, and without a kernel launch."""
    before = dict(fill_kernel.LAUNCHES)
    ours = fill_kernel.fill_block_u32(n, off, salt, "cpu")
    ref = np.asarray(jax_integrity.fill_block_u32(
        n, integrity.split_u64(off), integrity.split_u64(salt)))
    assert ours.dtype == torch.int32 and ours.numel() == 2 * n
    assert np.array_equal(ours.numpy().view(np.uint32), ref)
    assert np.array_equal(ours.numpy().view(np.uint32), _pattern(8 * n, off,
                                                                  salt))
    assert fill_kernel.LAUNCHES == before


def test_fill_in_place_at_an_odd_word():
    """fill_u64_ into a view starting one word into its storage (a start 8
    mod 16 on the card) writes only its own words."""
    buf = torch.full((10,), -1, dtype=torch.int64)
    fill_kernel.fill_u64_(buf[1:8], 4096 + 42)
    words = buf.numpy().view(np.uint64)
    assert words[0] == words[8] == words[9] == U64
    assert list(words[1:8]) == [4096 + 42 + 8 * i for i in range(7)]


def test_fill_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        fill_kernel.fill_u64_(torch.zeros(4, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        fill_kernel.fill_u64_(torch.zeros(8, dtype=torch.int64)[::2], 0)
