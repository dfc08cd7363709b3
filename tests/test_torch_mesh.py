"""The port's multi-device tier (parallel/mesh.py, B4 batched + B5) against
the original's, on the CPU.

The original runs on the conftest's virtual CPU devices (an n-device JAX
mesh); the port runs on n CPU devices (EBT_TORCH_DEVICE=cpu), where its
wrappers take their plain paths. Tolerances: ok_bytes, bad_words and iops
are sums of integers that float32 holds exactly at these sizes, so they
must be equal. The checksum total is a sum of u32 values rounded to
float32, in an order XLA picks on one side and as an exact integer sum
rounded once on the other, so it is compared with a relative tolerance of
1e-6. The counter reduction is exact u64 arithmetic: equality.
"""

import jax
import numpy as np
import pytest
import torch

from elbencho_tpu.ops.integrity import make_example_block
from elbencho_tpu.parallel import mesh as jax_mesh
from elbencho_tpu_torch.ops import ingest_kernel, integrity
from elbencho_tpu_torch.parallel import mesh

U64 = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")


def _blocks(n_ranks: int, words: int, salt: int, base_off: int = 0):
    blocks = np.stack([
        make_example_block(words * 8, file_off=base_off + r * words * 8,
                           salt=salt)
        for r in range(n_ranks)])
    offsets = (np.uint64(base_off) +
               np.arange(n_ranks, dtype=np.uint64) * np.uint64(words * 8))
    return blocks, offsets


def _both(n_dev: int, blocks, offsets, salt):
    want = jax_mesh.run_sharded_ingest(jax_mesh.make_mesh(n_dev), blocks,
                                       offsets, salt)
    got = mesh.run_sharded_ingest(mesh.make_mesh(n_dev), blocks, offsets,
                                  salt)
    assert set(got) == set(want) == {"ok_bytes", "bad_words", "iops",
                                     "checksum"}
    for k in ("ok_bytes", "bad_words", "iops"):
        assert got[k] == want[k], k
    assert got["checksum"] == pytest.approx(want["checksum"], rel=1e-6)
    return got


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_ingest_matches_jax(n_dev):
    """Two ranks per device, clean, at offsets carrying past 2^32."""
    blocks, offsets = _blocks(2 * n_dev, 256, 77, base_off=(1 << 33) + 4096)
    got = _both(n_dev, blocks, offsets, 77)
    assert got["bad_words"] == 0.0
    assert got["ok_bytes"] == float(2 * n_dev * 256 * 8)
    assert got["iops"] == float(2 * n_dev)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_ingest_detects_bad_shard(n_dev):
    """test_ops_and_mesh.py's case: 8 ranks of 128 words, rank 3 corrupt."""
    words, salt = 128, 5
    blocks, offsets = _blocks(8, words, salt)
    blocks[3, 10] ^= 0xFF
    got = _both(n_dev, blocks, offsets, salt)
    assert got["bad_words"] == 1.0
    assert got["ok_bytes"] == float(7 * words * 8)


def test_sharded_ingest_random_lanes_and_salt_wrap():
    """Random lanes (every word bad, large checksums) beside clean ranks
    whose base wraps past 2^64."""
    salt = U64 - 999
    blocks, offsets = _blocks(8, 512, salt)
    blocks[4:] = np.random.default_rng(3).integers(
        0, 1 << 32, blocks[4:].shape, dtype=np.uint64).astype(np.uint32)
    got = _both(4, blocks, offsets, salt)
    assert got["bad_words"] == float(4 * 512)


def test_sharded_ingest_takes_array_or_tensor():
    """A host u32 array and an int32 tensor of the same lanes give the same
    totals; ranks that do not shard evenly over the mesh are refused."""
    blocks, offsets = _blocks(4, 64, 11)
    step = mesh.sharded_ingest_step(mesh.make_mesh(2))
    lo = (offsets & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (offsets >> np.uint64(32)).astype(np.uint32)
    t = torch.from_numpy(blocks.view(np.int32).copy())
    a = step(blocks, lo, hi, 11, 0)
    b = step(t, lo, hi, 11, 0)
    assert {k: float(v) for k, v in a.items()} == \
        {k: float(v) for k, v in b.items()}
    with pytest.raises(ValueError, match="shard evenly"):
        step(t[:3], lo[:3], hi[:3], 11, 0)


def test_make_mesh_on_the_cpu():
    assert mesh.make_mesh(4) == [torch.device("cpu")] * 4
    devs = [torch.device("cpu")] * 2
    assert mesh.make_mesh(devices=devs) == devs


def test_mesh_stats_reducer_exact_u64():
    """test_ops_and_mesh.py's exactness case on 8 devices, against the
    original's limb reducer, and a second reduce on the same reducer."""
    rows = [[(1 << 40) + 977 * i, (1 << 33) * i + 3, i] for i in range(8)]
    want = jax_mesh.MeshStatsReducer(jax.devices()[:8]).reduce(rows)
    r = mesh.MeshStatsReducer(mesh.make_mesh(8))
    assert r.reduce(rows) == want == [sum(row[c] for row in rows)
                                      for c in range(3)]
    assert r.reduce([[1, 2, 3]] * 8) == [8, 16, 24]


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_mesh_stats_reducer_at_and_past_2_63(n_dev):
    """Counters of 2^63 and above (int64 storage with the same bits) and a
    column that wraps past 2^64: exact mod 2^64, equal to the original."""
    rows = [[(1 << 63) + d, U64 - d, (1 << 61) * (d + 1), 7]
            for d in range(n_dev)]
    want = [sum(row[c] for row in rows) & U64 for c in range(4)]
    assert mesh.MeshStatsReducer(mesh.make_mesh(n_dev)).reduce(rows) == want
    assert jax_mesh.MeshStatsReducer(jax.devices()[:n_dev]).reduce(rows) == \
        want


@pytest.mark.parametrize("seed", [1, 2])
def test_sum_rows_plain_matches_numpy_u64(seed):
    """The B5 plain version against numpy's wrapping u64 column sums."""
    rows = np.random.default_rng(seed).integers(
        0, U64, (37, 6), dtype=np.uint64, endpoint=True)
    want = rows.sum(axis=0, dtype=np.uint64)
    got = ingest_kernel.sum_rows_u64(torch.from_numpy(rows.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(
        integrity.sum_rows_u64_plain(
            torch.from_numpy(rows.view(np.int64))).numpy().view(np.uint64),
        want)
