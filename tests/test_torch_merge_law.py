"""The merge laws mergecheck declares, proven on the port's fan-in, and the
port's merged values held against the original's.

The counterpart of tests/test_merge_law.py. For each entry of
mergecheck.property_plan(), retargeted at the port
(tools/torch_audit.property_plan), this suite drives the port's real merge
code with seeded random payloads and asserts the two tree-safety laws:

    merge(merge(a, b), c) == merge(a, merge(b, c))   (associativity)
    merge(a, b) == merge(b, a)                       (commutativity)

through the same implementations the original's suite drives: the
RemoteWorkerGroup merge methods over pseudo-host proxies,
merge_first_host_error, merge_host_keyed, and stats.aggregate_results by
re-injecting a partial aggregate as one pseudo host's result. Every payload
is built in both packages from one plain description (their histograms,
LiveOps and WorkerPhaseResults are classes of their own), and each merge
gives the same value in the port as in the original.
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys
import zlib
from types import SimpleNamespace

import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.histogram as jax_histogram
import elbencho_tpu.liveops as jax_liveops
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.workers.base as jax_base
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.histogram as torch_histogram
import elbencho_tpu_torch.liveops as torch_liveops
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.base as torch_base
import elbencho_tpu_torch.workers.remote as torch_remote

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import torch_audit  # noqa: E402
from tools.audit import mergecheck  # noqa: E402

SEED = 20260806
TRIALS = 4
WPR_KINDS = ("ops", "elapsed", "histo", "stonewall", "cpu")

# merge method -> the proxy attribute it folds (differs from the method
# name for two methods)
_METHOD_ATTR = {
    "reg_cache_stats": "reg_cache",
    "tenant_latency": "tenant_lat_histos",
}


def _pkg(common, histogram, liveops, stats, base, remote):
    return SimpleNamespace(
        Phase=common.BenchPhase, LatencyHistogram=histogram.LatencyHistogram,
        LiveOps=liveops.LiveOps, aggregate_results=stats.aggregate_results,
        WorkerPhaseResult=base.WorkerPhaseResult,
        RemoteWorkerGroup=remote.RemoteWorkerGroup,
        merge_first_host_error=remote.merge_first_host_error,
        merge_host_keyed=remote.merge_host_keyed)


JAX = _pkg(jax_common, jax_histogram, jax_liveops, jax_stats, jax_base,
           jax_remote)
TORCH = _pkg(torch_common, torch_histogram, torch_liveops, torch_stats,
             torch_base, torch_remote)

_PLAN = torch_audit.property_plan()


# ------------------------------------------------------ plain payloads

def _histo_spec(rng: random.Random) -> list[int]:
    return [rng.randint(1, 500000) for _ in range(rng.randint(1, 8))]


def _live_spec(rng: random.Random) -> dict:
    return dict(entries=rng.randint(0, 999), bytes=rng.randint(0, 10**9),
                iops=rng.randint(0, 999), read_bytes=rng.randint(0, 10**9),
                read_iops=rng.randint(0, 999))


def _native_dict(family: str, rng: random.Random) -> dict:
    out = {}
    for key in mergecheck.MERGE_CLASSES["native"][family]:
        if key in ("tenant", "lane", "generation"):
            continue
        out[key] = rng.randint(0, 2 if "restoring" in key else 100000)
    return out


def _spec(kind: str, rng: random.Random):
    """One pseudo host's payload of `kind` as plain data (what
    tests/test_merge_law.py generates, before it becomes objects)."""
    if kind.startswith("tier:"):
        return rng.choice(kind.split(":", 1)[1].split(","))
    if kind == "bool":
        return rng.choice([True, False])
    if kind == "int_list":
        return [rng.randint(0, 10**6) for _ in range(rng.randint(1, 4))]
    if kind.startswith("dict:"):
        name = kind.split(":", 1)[1]
        if name == "serving_merged":
            d = _native_dict("engine_serving_stats", rng)
            d.update(_native_dict("rotation_state", rng))
            return d
        return _native_dict(name, rng)
    if kind == "ingest":
        d = _native_dict("ingest_stats", rng)
        n_epochs = rng.randint(1, 3)
        d["shuffle_window"] = rng.randint(0, 4096)
        d["epochs"] = [
            {k: rng.randint(0, 9999)
             for k in mergecheck.MERGE_CLASSES["native"]
             ["ingest_epoch_records"]}
            for _ in range(n_epochs)]
        d["epoch_time_ns"] = [rng.randint(1, 10**9)
                              for _ in range(n_epochs)]
        return d
    if kind.startswith("rows:"):
        _, index_key, family = kind.split(":")
        rows = []
        for i in sorted(rng.sample(range(4), rng.randint(1, 3))):
            row = {index_key: i}
            for k in mergecheck.MERGE_CLASSES["native"][family]:
                if k != index_key:
                    row[k] = rng.randint(0, 99999)
            rows.append(row)
        return rows
    if kind == "pairs":
        keys = rng.sample([(s, d) for s in range(3) for d in range(3)],
                          rng.randint(1, 4))
        return [{"src": s, "dst": d, "moves": rng.randint(1, 99),
                 "bytes": rng.randint(1, 10**6)} for s, d in keys]
    if kind == "rotation":
        # a shared generation core keeps the common set non-empty through
        # re-injection, as in the original's suite
        gens = sorted({1, 2} | set(rng.sample(range(3, 8),
                                              rng.randint(0, 3))))
        recs = [{"generation": g,
                 **{k: rng.randint(0, 9999)
                    for k in mergecheck.MERGE_CLASSES["native"]
                    ["rotation_records"] if k != "generation"}}
                for g in gens]
        return ([rng.randint(1, 10**9) for _ in gens], recs)
    if kind == "histos_by_label":
        return {label: _histo_spec(rng)
                for label in rng.sample(["t0", "t1", "t2", "t3"],
                                        rng.randint(1, 3))}
    if kind == "framed":
        rank = rng.randint(0, 9)
        return (rank, f"service h{rank}: cause-{rank}")
    if kind == "union":
        return {rank: f"service h{rank}: frag" for rank in
                rng.sample(range(6), rng.randint(1, 3))}
    if kind in WPR_KINDS:
        return dict(ops=_live_spec(rng),
                    elapsed_us_list=[rng.randint(1, 10**7)
                                     for _ in range(rng.randint(1, 4))],
                    iops_histo=_histo_spec(rng),
                    entries_histo=_histo_spec(rng),
                    stonewall_ops=_live_spec(rng),
                    stonewall_us=rng.randint(1, 10**7), have_stonewall=True,
                    cpu_stonewall_pct=round(rng.uniform(0, 100), 2))
    raise AssertionError(f"unhandled payload kind {kind!r}")


def _histo(pkg, values: list[int]):
    h = pkg.LatencyHistogram()
    for v in values:
        h.add(v)
    return h


def _build(pkg, kind: str, spec):
    """The payload `spec` as `pkg`'s objects."""
    if kind == "histos_by_label":
        return {k: _histo(pkg, v) for k, v in spec.items()}
    if kind in WPR_KINDS:
        return pkg.WorkerPhaseResult(
            ops=pkg.LiveOps(**spec["ops"]),
            elapsed_us_list=list(spec["elapsed_us_list"]),
            iops_histo=_histo(pkg, spec["iops_histo"]),
            entries_histo=_histo(pkg, spec["entries_histo"]),
            stonewall_ops=pkg.LiveOps(**spec["stonewall_ops"]),
            stonewall_us=spec["stonewall_us"],
            have_stonewall=spec["have_stonewall"],
            cpu_stonewall_pct=spec["cpu_stonewall_pct"])
    return spec


# ------------------------------------------------------- merge drivers

def _group(pkg, payloads: list[tuple[str, object]]):
    """A RemoteWorkerGroup over stub pseudo-host proxies carrying the given
    (attr, value) payloads: the merge methods only read self.proxies."""
    g = object.__new__(pkg.RemoteWorkerGroup)
    proxies = []
    for i, (attr, value) in enumerate(payloads):
        p = SimpleNamespace(host=f"h{i}", host_index=i)
        if attr == "rotation":
            p.rotation_ttr_ns, p.rotation_records = value
        else:
            setattr(p, attr, value)
        proxies.append(p)
    g.proxies = proxies
    return g


def _merge2(pkg, impl: str, kind: str):
    if impl.startswith("method:"):
        method = impl.split(":", 1)[1]
        attr = "rotation" if kind == "rotation" \
            else _METHOD_ATTR.get(method, method)

        def merge2(x, y):
            g = _group(pkg, [(attr, x), (attr, y)])
            if kind == "rotation":
                return (g.rotation_ttr_ns(), g.rotation_records())
            return getattr(g, method)()
        return merge2
    if impl == "helper:merge_first_host_error":
        return pkg.merge_first_host_error
    if impl == "helper:merge_host_keyed":
        return pkg.merge_host_keyed
    if impl == "stats":
        def merge2(x, y):
            agg = pkg.aggregate_results(pkg.Phase.READFILES, [x, y])
            # the partial aggregate re-injected as one pseudo host's result
            return pkg.WorkerPhaseResult(
                ops=agg.last_ops, elapsed_us_list=list(agg.elapsed_us_list),
                iops_histo=agg.iops_histo, entries_histo=agg.entries_histo,
                stonewall_ops=agg.first_ops,
                stonewall_us=agg.first_elapsed_us,
                have_stonewall=agg.have_first,
                cpu_stonewall_pct=agg.cpu_util_stonewall_pct)
        return merge2
    raise AssertionError(f"unhandled impl {impl!r}")


def _canon(kind: str, v):
    """A form that compares across orders and across the two packages:
    concat classes are multiset laws, histograms compare by wire form and
    LiveOps by their fields."""
    if kind in WPR_KINDS:
        return (dataclasses.asdict(v.ops), sorted(v.elapsed_us_list),
                v.iops_histo.to_wire(), v.entries_histo.to_wire(),
                dataclasses.asdict(v.stonewall_ops), v.stonewall_us,
                v.have_stonewall, round(v.cpu_stonewall_pct, 6))
    if kind == "histos_by_label":
        return {k: h.to_wire() for k, h in v.items()}
    return v


# --------------------------------------------------------------- tests

def test_plan_covers_every_tree_safe_declared_field():
    """The completeness gate, as the original's: no result-tree field is
    declared tree-safe without a proof behind it, and the port's plan is
    the original's."""
    declared = set(mergecheck.MERGE_CLASSES["result_tree"])
    assert {field for field, _, _, _ in _PLAN} == \
        declared - mergecheck._NO_PROOF_NEEDED
    assert mergecheck._NO_PROOF_NEEDED <= declared
    assert _PLAN == mergecheck.property_plan()


@pytest.mark.parametrize("field,spec,impl,kind", _PLAN,
                         ids=[p[0] for p in _PLAN])
def test_merge_law(field, spec, impl, kind):
    rng = random.Random(SEED + zlib.crc32(field.encode()))
    merges = {"jax": _merge2(JAX, impl, kind),
              "torch": _merge2(TORCH, impl, kind)}
    for _ in range(TRIALS):
        specs = [_spec(kind, rng) for _ in range(3)]
        got = {}
        for name, pkg in (("jax", JAX), ("torch", TORCH)):
            a, b, c = (_build(pkg, kind, s) for s in specs)
            merge2 = merges[name]
            ab = merge2(a, b)
            assert _canon(kind, ab) == _canon(kind, merge2(b, a)), \
                f"{name} {field} ({spec}): merge(a,b) != merge(b,a)"
            ab_c = _canon(kind, merge2(ab, c))
            assert ab_c == _canon(kind, merge2(a, merge2(b, c))), \
                f"{name} {field} ({spec}): merge not associative"
            got[name] = (_canon(kind, ab), ab_c)
        assert got["torch"] == got["jax"], \
            f"{field} ({spec}): the port merges to another value"


def test_first_host_error_none_absorbs():
    for pkg in (JAX, TORCH):
        merge = pkg.merge_first_host_error
        assert merge(None, None) is None
        v = (3, "service h3: boom")
        assert merge(None, v) == v and merge(v, None) == v
        lower = (1, "service h1: boom")
        assert merge(v, lower) == lower
