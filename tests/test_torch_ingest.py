"""The ingest step (B4) of the port against the original's, on the CPU.

The same numpy inputs from fixed seeds go through the original's jitted
integrity.ingest_verify_step / checksum_block_u32 (and jax.vmap of the step
for a batch) and through the port's wrappers, which take their plain path
for a CPU tensor. All of it is integer arithmetic, so the stated tolerance
is exact equality.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from elbencho_tpu.ops import integrity as jax_integrity
from elbencho_tpu_torch import graft_entry
from elbencho_tpu_torch.ops import ingest_kernel, integrity

U64 = (1 << 64) - 1
FIELDS = ("ok_bytes", "bad_words", "first_bad_word", "checksum")
# (file offset, salt): small, carries into the high half, a wrap past 2^64
CASES = [(0, 1), (8192, 1234), ((1 << 33) + 4096, (1 << 40) + 7),
         (U64 - 4095, 1 << 62)]


def _pattern(num_bytes: int, off: int, salt: int) -> np.ndarray:
    words = (np.arange(num_bytes // 8, dtype=np.uint64) * np.uint64(8)
             + np.uint64(off & U64) + np.uint64(salt & U64))
    return words.view(np.uint32)


def _t(lanes: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(lanes.view(np.int32).copy())


def _jax_step(lanes: np.ndarray, off: int, salt: int) -> dict:
    lo, hi = jax_integrity.split_u64(off)
    slo, shi = jax_integrity.split_u64(salt)
    out = jax.jit(jax_integrity.ingest_verify_step)(
        jnp.asarray(lanes), jnp.uint32(lo), jnp.uint32(hi), jnp.uint32(slo),
        jnp.uint32(shi))
    return {k: int(out[k]) for k in FIELDS}


def _port_step(lanes: np.ndarray, off: int, salt: int) -> dict:
    out = ingest_kernel.ingest_verify_step(
        _t(lanes), *integrity.split_u64(off), *integrity.split_u64(salt))
    return {k: int(out[k]) for k in FIELDS}


@pytest.mark.parametrize("off,salt", CASES)
@pytest.mark.parametrize("corrupt", [(), (0,), (4095,), (17, 2048, 4000)],
                         ids=["clean", "first", "last", "three"])
def test_step_matches_jax(off, salt, corrupt):
    """Clean blocks and corrupt words at the first, last and inner words,
    with offsets whose sums carry into the high half and wrap past 2^64."""
    lanes = _pattern(32 << 10, off, salt).copy()
    for w in corrupt:
        lanes[2 * w + (w % 2)] ^= np.uint32(0x00A5A500)
    want = _jax_step(lanes, off, salt)
    assert _port_step(lanes, off, salt) == want
    assert want["bad_words"] == len(corrupt)
    assert want["first_bad_word"] == (min(corrupt) if corrupt else 4096)
    assert want["ok_bytes"] == (0 if corrupt else 32 << 10)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_checksum_matches_jax_on_random_lanes(seed):
    """The checksum (sum of u32 lanes mod 2^32) on random lanes, where it
    wraps many times."""
    lanes = np.random.default_rng(seed).integers(
        0, 1 << 32, 50_000, dtype=np.uint64).astype(np.uint32)
    want = int(jax.jit(jax_integrity.checksum_block_u32)(jnp.asarray(lanes)))
    assert int(integrity.checksum_block_u32(_t(lanes))) == want
    step = ingest_kernel.ingest_verify_step(_t(lanes), 0, 0, 0, 0)
    assert int(step["checksum"]) == want
    assert want == int(lanes.astype(np.uint64).sum()) & 0xFFFFFFFF


def test_batch_matches_jax_vmap():
    """A batch of ranks, each at its own offset (one crossing 2^64), one
    rank corrupt: the rows equal jax.vmap of the original's step."""
    rng = np.random.default_rng(20261016)
    salt = (1 << 40) + 7
    offs = np.array([0, 8192, (1 << 33) + 4096, U64 - 4095, 1 << 20,
                     3 << 30], dtype=np.uint64)
    blocks = np.stack([_pattern(8 << 10, int(o), salt) for o in offs])
    blocks[2, rng.integers(0, blocks.shape[1])] ^= np.uint32(1)
    slo, shi = jax_integrity.split_u64(salt)
    jout = jax.jit(jax.vmap(jax_integrity.ingest_verify_step,
                            in_axes=(0, 0, 0, None, None)))(
        jnp.asarray(blocks),
        jnp.asarray((offs & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((offs >> np.uint64(32)).astype(np.uint32)),
        jnp.uint32(slo), jnp.uint32(shi))
    want = np.stack([np.asarray(jout[k]).astype(np.int64) for k in FIELDS],
                    axis=1)
    got = ingest_kernel.ingest_verify_batch(_t(blocks), offs, salt)
    assert got.dtype == torch.int64 and tuple(got.shape) == (6, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[:, 1].sum()) == 1
    # offsets as an int64 tensor of the same u64 bits give the same rows
    as_t = torch.from_numpy(offs.view(np.int64).copy())
    assert torch.equal(ingest_kernel.ingest_verify_batch(_t(blocks), as_t,
                                                         salt), got)


def test_batch_rows_match_the_step():
    """Each row of a batch is the single step on that rank's block."""
    offs = [4096 * r for r in range(4)]
    blocks = np.stack([_pattern(4 << 10, o, 9) for o in offs])
    blocks[1, 5] ^= np.uint32(0xFF)
    rows = ingest_kernel.ingest_verify_batch(_t(blocks), offs, 9)
    for r, o in enumerate(offs):
        assert [int(v) for v in rows[r]] == list(
            _port_step(blocks[r], o, 9).values())


def test_odd_lane_count_refused_like_jax():
    """The original reshapes lanes to (-1, 2): an odd lane count fails
    there, and the port refuses it."""
    lanes = _pattern(4096, 0, 1)[:-1]
    with pytest.raises(TypeError):
        _jax_step(lanes, 0, 1)
    with pytest.raises(ValueError, match="even lane count"):
        _port_step(lanes, 0, 1)
    with pytest.raises(ValueError, match="even lane count"):
        ingest_kernel.ingest_verify_batch(_t(lanes).view(1, -1), [0], 1)


def test_cpu_wrappers_launch_nothing():
    ingest_kernel.reset_launches()
    _port_step(_pattern(4096, 0, 1), 0, 1)
    ingest_kernel.sum_rows_u64(torch.zeros((2, 3), dtype=torch.int64))
    assert ingest_kernel.LAUNCHES == {"ingest_verify_u32": 0,
                                      "sum_rows_u64": 0}


def test_entry_matches_jax_entry(monkeypatch):
    """The port's entry() on the CPU (asked for with device="cpu" and with
    EBT_TORCH_DEVICE=cpu) returns the same block and arguments as the
    original's, and its fn gives the same step."""
    jfn, jargs = jax_entry()
    want = {k: int(v) for k, v in jfn(*jargs).items()}
    for how in ("arg", "env"):
        if how == "env":
            monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
            fn, args = graft_entry.entry()
        else:
            monkeypatch.delenv("EBT_TORCH_DEVICE", raising=False)
            fn, args = graft_entry.entry(device="cpu")
        assert fn is ingest_kernel.ingest_verify_step
        block = args[0]
        assert block.device.type == "cpu" and block.dtype == torch.int32
        np.testing.assert_array_equal(block.numpy().view(np.uint32),
                                      np.asarray(jargs[0]))
        assert [int(a) for a in args[1:]] == [int(a) for a in jargs[1:]]
        assert {k: int(v) for k, v in fn(*args).items()} == want
    assert want["bad_words"] == 0 and want["ok_bytes"] == 1 << 16


def test_entry_without_a_card_or_a_cpu_request_refuses(monkeypatch):
    """entry() runs on the card unless the caller asks for the CPU: with
    neither, it raises the device error instead of using the CPU."""
    from elbencho_tpu_torch.exceptions import ProgException

    monkeypatch.delenv("EBT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ProgException, match="no CUDA device found"):
        graft_entry.entry()
    assert "EBT_TORCH_DEVICE" not in os.environ
