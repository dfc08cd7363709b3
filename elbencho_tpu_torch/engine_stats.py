"""Engine-side counter readers.

Copies of the readers the worker group takes from the original package's
native device path module: each turns one of the engine's raw counter
arrays into the dict the result tree and the wire carry. None of them
touches a device; the key sets are unchanged, so the port's result tree
compares field for field with the original's.
"""

from __future__ import annotations

import ctypes

from .engine import load_lib


def uring_stats() -> dict[str, int]:
    """Storage-backend evidence counters of the unified registration
    authority (ebt/uring.h): fixed-op submits served by a shared slot
    (uring_fixed_hits), time inside io_uring_register (uring_register_ns),
    SQPOLL need-wakeup enters (uring_sqpoll_wakeups), bytes whose DmaMap
    pin also serves the fixed-buffer side (double_pin_avoided_bytes), and
    the kernel-AIO backend's io_setup retry-once count (aio_setup_retries).
    Process-cumulative — consumers (bench legs, result tree) record
    deltas. Handle-free: the slot table outlives path instances, so the
    group is reportable on plain storage runs too."""
    out = (ctypes.c_uint64 * 5)()
    load_lib().ebt_uring_stats(out)
    return {"uring_fixed_hits": out[0], "uring_register_ns": out[1],
            "uring_sqpoll_wakeups": out[2],
            "double_pin_avoided_bytes": out[3],
            "aio_setup_retries": out[4]}


def tenant_stats(engine) -> list[dict[str, int]]:
    """Per-tenant-class open-loop accounting of a NativeEngine (--arrival/
    --tenants): one dict per class — class index (tenant), scheduled
    arrivals that came due (arrivals), finished ops (completions), total
    issue-behind-schedule time (sched_lag_ns), the peak count of
    due-but-unissued arrivals (backlog_peak), and arrivals still unissued
    when the phase ended (dropped). Phase-scoped like the live counters;
    empty when no open-loop subsystem is active. The key set here is THE
    wire authority the counter-coverage audit traces (native → fan-in →
    result tree → bench JSON)."""
    out: list[dict[str, int]] = []
    for cls in range(engine.num_tenants):
        raw = engine.tenant_stats_raw(cls)
        out.append({"tenant": cls, "arrivals": raw[0],
                    "completions": raw[1], "sched_lag_ns": raw[2],
                    "backlog_peak": raw[3], "dropped": raw[4],
                    "slo_ok": raw[5]})
    return out


def engine_serving_stats(engine) -> dict[str, int]:
    """Engine-side serving-rotation evidence of a NativeEngine (--rotate/
    --bgbudget): rotation lifecycle counts (rotations_started /
    rotations_complete / rotations_failed — complete means restored,
    reconciled AND swapped), time-to-resident aggregates over completed
    rotations (ttr_last_ns / ttr_max_ns / ttr_total_ns), the storage-side
    background token bucket's throttle evidence (bg_throttle_ns /
    bg_read_bytes), the CURRENT budget the adaptive controller holds
    (bg_rate_bps) and its moves (bg_adapt_downs / bg_adapt_ups).
    Phase-scoped like the live counters. The key set here is THE wire
    authority the counter-coverage audit traces (native -> fan-in ->
    result tree -> bench JSON)."""
    raw = engine.serving_stats_raw()
    return {"rotations_started": raw[0], "rotations_complete": raw[1],
            "rotations_failed": raw[2], "ttr_last_ns": raw[3],
            "ttr_max_ns": raw[4], "ttr_total_ns": raw[5],
            "bg_throttle_ns": raw[6], "bg_read_bytes": raw[7],
            "bg_rate_bps": raw[8], "bg_adapt_downs": raw[9],
            "bg_adapt_ups": raw[10]}


def shuffle_sample(seed: int, epoch: int, rank: int, begin: int, end: int,
                   window: int, max_n: int = 1 << 16) -> list[int]:
    """Shuffled record indices of one (seed, epoch, rank) stream over
    [begin, end) with the given window, drawn from THE shipped native
    WindowShuffler (ebt_shuffle_sample) — determinism/quality tests
    exercise exactly the order the ingest hot loop reads in."""
    out = (ctypes.c_uint64 * max_n)()
    n = load_lib().ebt_shuffle_sample(int(seed), int(epoch), int(rank),
                                      int(begin), int(end), int(window),
                                      out, max_n)
    return [out[i] for i in range(n)]


def engine_fault_stats(engine) -> dict[str, int]:
    """Engine-side fault-tolerance evidence of a NativeEngine (--retry/
    --maxerrors): retried block ops (io_retry_attempts), ops that
    succeeded after >= 1 retry (io_retry_success), time spent in backoff
    sleeps (io_retry_backoff_ns), and op failures absorbed by the error
    budget (errors_tolerated). Phase-scoped like the live counters. The
    key set here is THE wire authority the counter-coverage audit traces
    (native -> fan-in -> result tree -> bench JSON)."""
    raw = engine.fault_stats_raw()
    return {"io_retry_attempts": raw[0], "io_retry_success": raw[1],
            "io_retry_backoff_ns": raw[2], "errors_tolerated": raw[3]}


def engine_reactor_stats(engine) -> dict[str, int]:
    """Completion-reactor evidence of a NativeEngine: blocking unified
    waits entered (reactor_waits), their wake causes (reactor_wakeups_cq /
    _onready / _arrival / _timeout / _interrupt — waits reconciles exactly
    with their sum), the poll slices the old spinning shape would have
    burned across the slept time (spin_polls_avoided), and the completion
    signals drained BEYOND the one that woke each sleeper
    (reactor_wakeups_coalesced — workers sharing a CQ pay one kernel
    wakeup for the whole pending batch; sits outside the waits
    reconciliation because it counts extra drained signals, not wake
    causes). Phase-scoped like the live counters. The key set here is THE
    wire authority the counter-coverage audit traces (native -> fan-in ->
    result tree -> bench JSON)."""
    raw = engine.reactor_stats_raw()
    return {"reactor_waits": raw[0], "reactor_wakeups_cq": raw[1],
            "reactor_wakeups_onready": raw[2],
            "reactor_wakeups_arrival": raw[3],
            "reactor_wakeups_timeout": raw[4],
            "reactor_wakeups_interrupt": raw[5],
            "spin_polls_avoided": raw[6],
            "reactor_wakeups_coalesced": raw[7]}


def engine_numa_stats(engine) -> dict[str, int]:
    """NUMA placement evidence of a NativeEngine (--numazones): the
    detected node topology (numa_nodes, >= 1 — the container fallback
    synthesizes one node), where worker buffer pools and regwindow spans
    actually landed (numa_local_bytes / numa_remote_bytes), and inert
    bind fallbacks (numa_bind_fallbacks). Session-cumulative; consumers
    record deltas. The key set here is THE wire authority the
    counter-coverage audit traces."""
    raw = engine.numa_stats_raw()
    return {"numa_nodes": raw[0], "numa_local_bytes": raw[1],
            "numa_remote_bytes": raw[2], "numa_bind_fallbacks": raw[3]}

