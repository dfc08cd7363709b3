"""The port's deferred D2H fetch engine (--d2hdepth) against the original's,
on their mocks (see test_torch_native.py for the harness).

With a delayed mock completion (EBT_MOCK_CUDA_DELAY_US beside
EBT_MOCK_PJRT_DELAY_US) deferral is really exercised: a missing pre-write
barrier ships stale bytes and fails the content checks. Both packages must
write identical files, count the same deferred blocks and confirm the same
d2h tier.
"""

from __future__ import annotations

import pytest

from test_torch_native import (assert_parity, pattern, pkgs, run,  # noqa: F401
                               run_both)

import elbencho_tpu.config as jax_config
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions


def write_args(size="8M", block="1M", iodepth=4, extra=()):
    return ["-w", "-t", "1", "-s", size, "-b", block, "--iodepth",
            str(iodepth), *extra]


@pytest.mark.parametrize("depth,deferred", [(1, 0), (4, 8)])
def test_deferred_and_serial_write_identical_bytes(pkgs, tmp_path,
                                                   monkeypatch, depth,
                                                   deferred):
    """--d2hdepth 4 defers every block's fetch to the pre-write barrier,
    --d2hdepth 1 keeps the serial fetch-then-write path: the same bytes
    reach storage either way, and in both packages."""
    j, t, _ = run_both(pkgs, write_args(extra=("--d2hdepth", str(depth))),
                       tmp_path, ("w",), {"EBT_MOCK_PJRT_DELAY_US": 2000},
                       monkeypatch)
    assert_parity(j, t)
    assert t.first_error == "" and len(t.data) == 8 << 20
    assert t.d2h["deferred_count"] == deferred
    assert t.d2h_tier == ("deferred" if deferred else "serial")


def test_deferred_matches_serial_bytes(pkgs, tmp_path, monkeypatch):
    """The A/B itself: one package's deferred file equals its serial file."""
    serial = run(pkgs[1], write_args(extra=("--d2hdepth", "1")) +
                 [str(tmp_path / "s")], monkeypatch=monkeypatch)
    deferred = run(pkgs[1], write_args(extra=("--d2hdepth", "4")) +
                   [str(tmp_path / "d")],
                   env={"EBT_MOCK_PJRT_DELAY_US": 2000},
                   monkeypatch=monkeypatch)
    assert serial.data == deferred.data and any(deferred.data)


def test_sync_loop_pipeline_overlaps_and_reports(pkgs, tmp_path,
                                                 monkeypatch):
    """iodepth 1: block N+1's fetch is in flight while block N is written;
    every block goes through the deferred engine and the barriers record
    their time."""
    j, t, _ = run_both(pkgs, write_args(iodepth=1,
                                        extra=("--d2hdepth", "4")),
                       tmp_path, ("w",), {"EBT_MOCK_PJRT_DELAY_US": 1000},
                       monkeypatch)
    assert_parity(j, t)
    assert t.d2h["deferred_count"] == 8 and t.d2h["await_wait_ns"] > 0
    assert t.d2h_tier == "deferred" and t.from_hbm == 8 << 20


def test_d2hdepth_1_is_the_serial_path(pkgs, tmp_path, monkeypatch):
    """--d2hdepth 1: no deferred submissions and no overlap accounting."""
    j, t, _ = run_both(pkgs, write_args(iodepth=1,
                                        extra=("--d2hdepth", "1")),
                       tmp_path, ("w",), monkeypatch=monkeypatch)
    assert_parity(j, t)
    assert t.d2h == {"deferred_count": 0, "await_wait_ns": 0,
                     "overlap_bytes": 0}
    assert t.d2h_tier == "serial" and any(t.data)


def test_write_gen_deferred_exact_pattern(pkgs, tmp_path, monkeypatch):
    """Verified writes through the deferred engine: the fill kernel's
    pattern and its fetch ride the pending queue, and storage still gets
    the exact offset+salt bytes."""
    j, t, _ = run_both(pkgs, write_args(size="4M", iodepth=1,
                                        extra=("--verify", "4242",
                                               "--d2hdepth", "4")),
                       tmp_path, ("w",), {"EBT_MOCK_PJRT_DELAY_US": 1000},
                       monkeypatch)
    assert_parity(j, t)
    assert t.d2h["deferred_count"] == 4
    assert t.data == pattern(4 << 20, 4242)


@pytest.mark.parametrize("depth,iodepth,fail_at", [(4, 4, 3), (1, 1, 2)],
                         ids=["deferred", "serial"])
def test_fetch_failure_drains_and_surfaces(pkgs, tmp_path, monkeypatch,
                                           depth, iodepth, fail_at):
    """A fetch failing mid-pipeline (or on the serial path) fails the phase
    with the driver's cause behind the engine's message, drains every
    sibling fetch and leaks no device buffer."""
    for pkg in pkgs:
        def fail(p, mp):
            p.mock.ebt_mock_reset()
            mp.setenv(p.seam("EBT_MOCK_D2H_FAIL_AT"), str(fail_at))

        o = run(pkg, write_args(size="8M" if depth > 1 else "4M",
                                iodepth=iodepth,
                                extra=("--d2hdepth", str(depth))) +
                [str(tmp_path / pkg.name)], env={"EBT_MOCK_PJRT_DELAY_US":
                                                 1000},
                monkeypatch=monkeypatch, after_prepare=fail)
        monkeypatch.delenv(pkg.seam("EBT_MOCK_D2H_FAIL_AT"))
        assert pkg.seam("EBT_MOCK_D2H_FAIL_AT") in o.first_error, o
        assert pkg.seam("EBT_MOCK_D2H_FAIL_AT") in o.native_error
        assert o.live_buffers_after == 0


def test_rwmix_serial_branch_awaits_before_write(pkgs, tmp_path,
                                                 monkeypatch):
    """rwmix keeps the serial loop shape at --d2hdepth > 1 while the native
    layer defers the fetch: every written block holds the device source,
    and both packages write the same file."""
    j, t, _ = run_both(pkgs, ["-w", "-t", "1", "-s", "4M", "-b", "1M",
                              "--rwmixpct", "25", "--d2hdepth", "4"],
                       tmp_path, ("w",), {"EBT_MOCK_PJRT_DELAY_US": 2000},
                       monkeypatch)
    assert_parity(j, t)
    canon = run(pkgs[1], write_args(size="1M", iodepth=1,
                                    extra=("--d2hdepth", "1")) +
                [str(tmp_path / "canon")], monkeypatch=monkeypatch).data
    blocks = [t.data[i:i + (1 << 20)] for i in range(0, len(t.data), 1 << 20)]
    assert blocks[0] == canon
    assert all(b == canon for b in blocks if any(b))


def test_read_phase_untouched_by_depth(pkgs, tmp_path, monkeypatch):
    """--d2hdepth governs only the write direction."""
    j, t, data = run_both(pkgs, ["-r", "-t", "1", "-s", "4M", "-b", "1M",
                                 "--d2hdepth", "4"], tmp_path, ("r",),
                          monkeypatch=monkeypatch, seed_file=4 << 20)
    assert_parity(j, t)
    assert t.landed == 4 << 20 and t.checksum == sum(data) & ((1 << 64) - 1)
    assert t.d2h["deferred_count"] == 0 and t.d2h_tier is None


def test_depth_defaults_to_iodepth(pkgs, tmp_path, monkeypatch):
    """--d2hdepth 0 (the default) resolves to --iodepth."""
    j, t, _ = run_both(pkgs, write_args(iodepth=4), tmp_path, ("w",),
                       monkeypatch=monkeypatch)
    assert_parity(j, t)
    assert t.d2h_depth == 4 and t.d2h_tier == "deferred"
    assert t.d2h["deferred_count"] == 8
    assert t.tier is None  # write traffic invents no h2d tier


def test_verify_round_trip_mode_stays_serial(pkgs, tmp_path, monkeypatch):
    """--verify with --hostverify: the write source is the round trip of
    the block this rank just staged, which never defers, and the file
    still holds the exact pattern."""
    j, t, _ = run_both(pkgs, ["-w", "-t", "1", "-s", "2M", "-b", "1M",
                              "--verify", "99", "--hostverify",
                              "--d2hdepth", "4"], tmp_path, ("w",),
                       {"EBT_MOCK_PJRT_DELAY_US": 500}, monkeypatch)
    assert_parity(j, t)
    assert t.d2h["deferred_count"] == 0 and t.d2h_tier == "serial"
    assert t.data == pattern(2 << 20, 99)


@pytest.mark.parametrize("args", [
    ["--d2hdepth", "4", "--tpubackend", "staged", "--gpuids", "0"],
    ["--d2hdepth", "-1", "--tpubackend", "pjrt"],
])
def test_d2hdepth_requires_pjrt_backend(tmp_path, args):
    """The original's refusals, word for word."""
    msgs = []
    for parse, exc in ((jax_config.config_from_args,
                        jax_exceptions.ProgException),
                       (torch_config.config_from_args,
                        torch_exceptions.ProgException)):
        with pytest.raises(exc, match="d2hdepth") as e:
            parse(["-w", "-s", "1M", *args, "--nolive", str(tmp_path / "f")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
