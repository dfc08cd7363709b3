"""The host modules the port copied from the original (histogram,
utils/units, the block-device logic of config and the engine) held
against the original's on the same inputs: the counterparts of
tests/test_histogram.py, tests/test_units.py and tests/test_blockdev.py.

Each case calls each package's function on the same inputs and compares
the outputs (values, histograms, wire dicts, exception types and texts),
then holds the original's own assertions on them. The histogram's Python
bucket scheme is compared with each package's native engine library too,
and a histogram's wire form is read back by the other package.

Held by invariants, not by equality: nothing here follows the clock.

Every case of the three files has a counterpart here under the same name.
"""

from __future__ import annotations

import builtins
import ctypes
import os
import random
import stat as stat_mod
from types import SimpleNamespace

import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.engine as jax_engine
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.histogram as jax_histogram
import elbencho_tpu.utils.units as jax_units
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.engine as torch_engine
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.histogram as torch_histogram
import elbencho_tpu_torch.utils.units as torch_units
from test_torch_worker_state import worker_state  # noqa: F401

PKGS = (
    SimpleNamespace(name="jax", histogram=jax_histogram, units=jax_units,
                    engine=jax_engine, common=jax_common, config=jax_config,
                    ProgException=jax_exceptions.ProgException),
    SimpleNamespace(name="torch", histogram=torch_histogram,
                    units=torch_units, engine=torch_engine,
                    common=torch_common, config=torch_config,
                    ProgException=torch_exceptions.ProgException),
)


def agree(fn):
    """fn(pkg) for both packages; the result after checking they agree."""
    got = [fn(pkg) for pkg in PKGS]
    assert got[1] == got[0]
    return got[1]


def outcome(call):
    """A call's value, or the type name and text of what it raised."""
    try:
        return ("ok", call())
    except Exception as e:  # compared across packages, never swallowed
        return ("raised", type(e).__name__, str(e))


def hist(pkg, values):
    h = pkg.histogram.LatencyHistogram()
    for v in values:
        h.add(v)
    return h


def stats(h) -> tuple:
    return h.count, h.min_us, h.max_us, h.sum_us, h.avg_us


# --------------------------------------------------------------- histogram


def test_bucket_scheme_matches_native():
    rng = random.Random(7)
    samples = [rng.randrange(0, 1 << 45) for _ in range(2000)] + \
        list(range(0, 64)) + [1 << 60]

    def scheme(pkg):
        lib = pkg.engine.load_lib()
        hm = pkg.histogram
        py = ([hm.bucket_index(v) for v in samples],
              [hm.bucket_lower_edge(i) for i in range(hm.NUM_BUCKETS)])
        native = ([lib.ebt_histo_bucket_index(v) for v in samples],
                  [lib.ebt_histo_bucket_lower_edge(i)
                   for i in range(hm.NUM_BUCKETS)])
        assert lib.ebt_histo_num_buckets() == hm.NUM_BUCKETS
        assert py == native, pkg.name
        return hm.NUM_BUCKETS, py
    agree(scheme)


def test_bucket_edges_monotonic():
    edges = agree(lambda pkg: [pkg.histogram.bucket_lower_edge(i)
                               for i in range(pkg.histogram.NUM_BUCKETS)])
    assert edges == sorted(edges) and len(set(edges)) == len(edges)


def test_add_and_stats():
    vals = (5, 10, 100, 1000, 10000)
    got = agree(lambda pkg: stats(hist(pkg, vals)))
    assert got == (5, 5, 10000, sum(vals), sum(vals) / 5)


def test_percentiles_exact_small_values():
    got = agree(lambda pkg: [hist(pkg, range(16)).percentile_us(p)
                             for p in (0, 50, 100)])
    assert got == [0, 8, 15]  # exact buckets


def test_percentile_monotonic_and_clamped():
    rng = random.Random(3)
    vals = [rng.randrange(1, 1_000_000) for _ in range(5000)]
    ps = (1, 25, 50, 75, 90, 99, 99.9)

    def run(pkg):
        h = hist(pkg, vals)
        return h.min_us, h.max_us, [h.percentile_us(p) for p in ps]
    lo, hi, got = agree(run)
    assert got == sorted(got) and lo <= got[0] and got[-1] <= hi
    # the bucketed p50 lies within one sub-bucket (25%) of the true median
    true_p50 = sorted(vals)[len(vals) // 2]
    assert abs(got[2] - true_p50) <= true_p50 * 0.25 + 1


def test_merge():
    def run(pkg):
        a, b = hist(pkg, (1, 2, 3)), hist(pkg, (1000, 2000))
        a += b
        return stats(a), a.buckets
    (count, lo, hi, total, _), _ = agree(run)
    assert (count, lo, hi, total) == (5, 1, 2000, 1 + 2 + 3 + 1000 + 2000)


def test_wire_roundtrip():
    rng = random.Random(11)
    vals = [rng.randrange(0, 100000) for _ in range(500)]
    wires = [hist(pkg, vals).to_wire() for pkg in PKGS]
    assert wires[1] == wires[0]
    # each package reads back its own wire form and the other's
    for pkg in PKGS:
        for w in wires:
            h2 = pkg.histogram.LatencyHistogram.from_wire(w)
            h = hist(pkg, vals)
            assert h2.buckets == h.buckets
            assert stats(h2) == stats(h)
            assert h2.percentile_us(99) == h.percentile_us(99)


def test_verify_pattern_native():
    u64max = (1 << 64) - 1

    def run(pkg):
        lib = pkg.engine.load_lib()
        buf = ctypes.create_string_buffer(4096)
        lib.ebt_fill_verify_pattern(buf, 4096, 8192, 777)
        filled = buf.raw
        clean = lib.ebt_check_verify_pattern(buf, 4096, 8192, 777)
        # corrupt one byte -> the detector reports its file offset
        buf[100] = b"\xff" if buf[100] != b"\xff" else b"\x00"
        corrupt = lib.ebt_check_verify_pattern(buf, 4096, 8192, 777)
        lib.ebt_fill_verify_pattern(buf, 4096, 8192, 777)
        wrong_salt = lib.ebt_check_verify_pattern(buf, 4096, 8192, 778)
        return filled, clean, corrupt, wrong_salt != u64max
    _, clean, corrupt, wrong = agree(run)
    assert (clean, corrupt, wrong) == (u64max, 8192 + 100, True)


# ------------------------------------------------------------------- units


def _units(name, *calls):
    return agree(lambda pkg: [outcome(lambda a=a: getattr(pkg.units, name)(
        *a)) for a in calls])


def test_parse_plain_numbers():
    assert _units("parse_size", ("0",), ("123",), (42,)) == [
        ("ok", 0), ("ok", 123), ("ok", 42)]


def test_parse_binary_units():
    got = _units("parse_size", ("4K",), ("4k",), ("1M",), ("20g",), ("2T",),
                 ("1P",))
    assert got == [("ok", v) for v in (4096, 4096, 1 << 20, 20 << 30,
                                       2 << 40, 1 << 50)]


def test_parse_suffix_variants():
    assert _units("parse_size", ("4KiB",), ("4KB",), ("100b",)) == [
        ("ok", 4096), ("ok", 4096), ("ok", 100)]


def test_parse_fractional():
    assert _units("parse_size", ("1.5K",)) == [("ok", 1536)]


def test_parse_errors():
    got = _units("parse_size", ("",), ("12X",), ("K",))
    assert [g[:2] for g in got] == [("raised", "ValueError")] * 3


def test_format_bytes():
    assert _units("format_bytes", (512,), (1536,), (1 << 20,)) == [
        ("ok", "512B"), ("ok", "1.5KiB"), ("ok", "1.0MiB")]


def test_format_count():
    assert _units("format_count", (999,), (54200,)) == [
        ("ok", "999"), ("ok", "54.2k")]


def test_per_sec():
    got = _units("per_sec_from_us", (1000, 1_000_000), (1000, 500_000),
                 (1000, 0), (1 << 62, 1_000_000))
    assert got == [("ok", 1000), ("ok", 2000), ("ok", 0), ("ok", 1 << 62)]


def test_format_duration():
    assert _units("format_duration", (13,), (73,), (6013,)) == [
        ("ok", "13s"), ("ok", "1m13s"), ("ok", "1h40m13s")]


# ------------------------------------------------------------ block device

BLK_MODE = stat_mod.S_IFBLK | 0o600


@pytest.fixture
def fake_blockdev(monkeypatch, tmp_path):
    """Make `path` classify as a 512 MiB block device for both packages'
    config layers: os.stat reports S_IFBLK and open().seek(0, SEEK_END)
    reports the device size."""
    dev = tmp_path / "fakedev"
    dev.write_bytes(b"\0")
    real_stat, real_open = os.stat, builtins.open
    dev_size = 512 << 20

    def fake_stat(p, *a, **kw):
        if str(p) == str(dev):
            return os.stat_result((BLK_MODE, 1, 1, 1, 0, 0, 0, 0, 0, 0))
        return real_stat(p, *a, **kw)

    class FakeDevFile:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def seek(self, off, whence=0):
            assert whence == os.SEEK_END
            return dev_size

    def fake_open(p, *a, **kw):
        if str(p) == str(dev) and a and a[0] == "rb":
            return FakeDevFile()
        return real_open(p, *a, **kw)

    monkeypatch.setattr(os, "stat", fake_stat)
    monkeypatch.setattr(builtins, "open", fake_open)
    return str(dev), dev_size


def _config(args):
    return agree(lambda pkg: outcome(
        lambda: _cfg_view(pkg.config.config_from_args(args))))


def _cfg_view(cfg) -> tuple[int, int]:
    return int(cfg.path_type), cfg.file_size


def test_path_type_detects_blockdev(fake_blockdev):
    dev, _ = fake_blockdev
    got = _config(["-r", "-b", "1M", "-s", "4M", "--nolive", dev])
    assert got == ("ok", (int(torch_common.BenchPathType.BLOCKDEV), 4 << 20))


def test_blockdev_size_autodetect(fake_blockdev):
    """No -s: the size comes from seeking the device's end."""
    dev, dev_size = fake_blockdev
    got = _config(["-r", "-b", "1M", "--nolive", dev])
    assert got == ("ok", (int(torch_common.BenchPathType.BLOCKDEV), dev_size))


def test_blockdev_size_cap_enforced(fake_blockdev):
    """-s larger than the detected device is refused up front."""
    dev, _ = fake_blockdev
    got = _config(["-r", "-b", "1M", "-s", "1T", "--nolive", dev])
    assert got[:2] == ("raised", "ProgException")


def test_mixed_path_types_rejected(fake_blockdev, tmp_path):
    dev, _ = fake_blockdev
    reg = tmp_path / "plainfile"
    reg.write_bytes(b"x" * 4096)
    got = _config(["-r", "-b", "4k", "-s", "4k", "--nolive", dev, str(reg)])
    assert got[:2] == ("raised", "ProgException")


def _blockdev_engine(pkg, path, **kw):
    e = pkg.engine.NativeEngine()
    e.add_path(str(path))
    e.set("path_type", int(pkg.common.BenchPathType.BLOCKDEV))
    for k, v in kw.items():
        e.set(k, v)
    return e


def test_engine_blockdev_prepare_no_create(tmp_path):
    """Blockdev mode only opens the target (no create, no truncate),
    against a regular file standing in for the device node."""
    payload = os.urandom(1 << 16)

    def run(pkg):
        dev = tmp_path / f"dev-{pkg.name}"
        dev.write_bytes(payload)
        e = _blockdev_engine(pkg, dev, num_threads=1, num_dataset_threads=1,
                             block_size=1 << 12, file_size=1 << 16)
        try:
            e.prepare_paths()
            e.prepare()
            e.start_phase(int(pkg.common.BenchPhase.READFILES))
            while not e.wait_done(500):
                pass
            return (e.wait_done(0), e.error(),
                    sum(e.live(i).ops.bytes for i in range(e.num_workers)),
                    dev.read_bytes() == payload)
        finally:
            e.close()
    # content and size untouched: no create or truncate happened
    assert agree(run) == (1, "", 1 << 16, True)


def test_engine_blockdev_prepare_missing_device():
    def run(pkg):
        e = _blockdev_engine(pkg, "/nonexistent/dev/fake0", num_threads=1,
                             block_size=4096, file_size=4096)
        try:
            with pytest.raises(pkg.engine.EngineError) as exc:
                e.prepare_paths()
            return str(exc.value)
        finally:
            e.close()
    assert "open blockdev" in agree(run)
