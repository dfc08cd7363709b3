"""--chaos on the port (elbencho_tpu_torch/chaos.py) against the original's
(elbencho_tpu/chaos.py), on the same inputs.

The seam registry keeps the original's campaign names and points them at
the port's seams: the mock CUDA driver's EBT_MOCK_CUDA_* (layer "cuda")
and the storage engine's own (layer "native", shared by both packages).
The grammar, its refusals and the seeded draws are the original's, so one
spec, seed and device count derive the same injection points; an armed run
of each seam kind (nth, dev_nth, flag) on the mocks leaves the same cause
and the same result tree in both packages, once each package's seam name
and the driver's error-code wrapper are taken out of the texts.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.chaos as jax_chaos
import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu_torch.chaos as torch_chaos
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
from elbencho_tpu_torch import engine as torch_engine

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
BLK = 256 << 10
SOURCES = ("elbencho_tpu_torch/csrc/cuda_mock.cpp",
           "elbencho_tpu_torch/csrc/cuda_path.cpp",
           "core/src/uring.cpp", "core/src/engine.cpp",
           "core/src/reactor.cpp")
# the env of every seam either package can arm (restored after each test)
ALL_SEAM_ENVS = sorted({s.env for s in jax_chaos.SEAMS.values()}
                       | {s.env for s in torch_chaos.SEAMS.values()})


def _env_map() -> dict[str, str]:
    """The original's seam env -> the port's, through the campaign name."""
    return {jax_chaos.SEAMS[n].env: torch_chaos.SEAMS[n].env
            for n in jax_chaos.SEAMS}


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.ebt_mock_checksum.restype = ctypes.c_uint64
    lib.ebt_mock_live_buffers.restype = ctypes.c_int64
    return lib


@pytest.fixture
def clean_seams(monkeypatch):
    """arm_chaos writes os.environ directly: every seam variable is
    registered with monkeypatch first, so each test leaves it as it was."""
    for k in ALL_SEAM_ENVS:
        monkeypatch.setenv(k, "")  # records the value to restore
        monkeypatch.delenv(k)
    return monkeypatch


@pytest.fixture
def pkgs(clean_seams):
    """(original, port) on their mocks, 4 devices each."""
    monkeypatch = clean_seams
    if not os.path.exists(JAX_MOCK):
        subprocess.run(["make", "core"], cwd=REPO, check=True,
                       capture_output=True)
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.delenv("EBT_PJRT_XFER_MGR", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "4")
    made = tuple(
        SimpleNamespace(name=name, chaos=chaos,
                        config_from_args=cfg.config_from_args,
                        Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
                        ProgException=exc.ProgException,
                        Statistics=stats.Statistics, mock=_mock_lib(lib),
                        seams={s.env for s in chaos.SEAMS.values()})
        for name, chaos, cfg, local, common, exc, stats, lib in (
            ("jax", jax_chaos, jax_config, jax_local, jax_common,
             jax_exceptions, jax_stats, JAX_MOCK),
            ("torch", torch_chaos, torch_config, torch_local, torch_common,
             torch_exceptions, torch_stats, torch_mock)))
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


# ------------------------------------------------------ the seam matrix


def test_chaos_seam_matrix_every_fail_seam_reachable():
    """Every fault seam the port's sources read (a quoted EBT_MOCK_*FAIL*
    name: the mock driver, the CUDA engine, the storage engine) is reachable
    from --chaos, and every registered seam is still read there (no stale
    entry). Any other EBT_MOCK_*FAIL* name in those sources is the
    original's, named in a comment beside the port's counterpart."""
    read, named = set(), set()
    for rel in SOURCES:
        text = open(os.path.join(REPO, rel)).read()
        read |= set(re.findall(r'"(EBT_MOCK_\w*FAIL\w*)"', text))
        named |= set(re.findall(r"EBT_MOCK_\w*FAIL\w*", text))
    registered = {s.env for s in torch_chaos.SEAMS.values()}
    missing = read - registered
    assert not missing, (
        f"fault seams not reachable from --chaos: {sorted(missing)} — add "
        "them to elbencho_tpu_torch/chaos.py SEAMS")
    stale = registered - read
    assert not stale, (
        f"--chaos seams with no source behind them: {sorted(stale)}")
    original = {s.env for s in jax_chaos.SEAMS.values()}
    assert named - registered <= original, sorted(named - registered)
    # the same campaign names, each layer where its seam lives
    assert set(torch_chaos.SEAMS) == set(jax_chaos.SEAMS)
    for name, seam in torch_chaos.SEAMS.items():
        orig = jax_chaos.SEAMS[name]
        assert seam.kind == orig.kind, name
        if orig.layer == "native":
            assert (seam.env, seam.layer) == (orig.env, orig.layer), name
        else:
            assert seam.layer == "cuda", name
            assert seam.env.startswith("EBT_MOCK_CUDA_"), name


# ------------------------------------------- spec refusals, determinism


@pytest.mark.parametrize("bad", ["bogus=0.5", "stripe=2.0", "stripe=x",
                                 "stripe", "seed=x", "", "devices=x",
                                 "seed=1", "stripe=-0.1"])
def test_chaos_spec_refusals_and_determinism(bad):
    """Every malformed spec is refused, with the original's words."""
    got = []
    for exc, chaos in ((jax_exceptions.ProgException, jax_chaos),
                       (torch_exceptions.ProgException, torch_chaos)):
        with pytest.raises(exc) as e:
            chaos.parse_chaos_spec(bad)
        got.append(str(e.value))
    assert got[0] == got[1]


SPECS = ["stripe=0.2,uring=0.1,seed=9,devices=4",
         "submit=0.3,ready=0.05,d2h=0.5,xfer=0.4,xfermgr=0.5,seed=3",
         "dmamap=0.01,dmamap_after=0.2,dmamap_all=0.6,d2d=0.7,aio=0.5,"
         "reactor=0.3,stripe=0.9,seed=11,devices=2",
         "stripe=1.0,submit=1.0,xfermgr=1.0,seed=1"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [1, 7, 12345])
def test_chaos_derived_env_equals_the_original(clean_seams, spec, seed):
    """The same spec, seed and device count derive the same injection
    points: the port's environment is the original's with each seam's
    variable renamed through its campaign name."""
    spec = f"{spec},seed={seed}"
    for n in (4, 2, 1):
        clean_seams.setenv("EBT_MOCK_PJRT_DEVICES", str(n))
        clean_seams.setenv("EBT_MOCK_CUDA_DEVICES", str(n))
        j = jax_chaos.derive_env(jax_chaos.parse_chaos_spec(spec))
        t = torch_chaos.derive_env(torch_chaos.parse_chaos_spec(spec))
        assert t == {_env_map()[k]: v for k, v in j.items()}
        assert t == torch_chaos.derive_env(
            torch_chaos.parse_chaos_spec(spec))  # deterministic


def test_chaos_device_count_defaults(clean_seams):
    """The pick of a dev_nth seam is drawn over the mock's devices: the
    port's mock defaults to one (the original's to 4), so without a count
    the port always picks device 0, and p = 1 fails the first op after
    the construction probe."""
    picks = set()
    for seed in range(1, 40):
        env = torch_chaos.derive_env(torch_chaos.parse_chaos_spec(
            f"stripe=0.5,seed={seed}"))
        picks.add(env["EBT_MOCK_CUDA_DEV_FAIL_AT"].split(":")[0])
    assert picks == {"0"}
    certain = torch_chaos.derive_env(torch_chaos.ChaosSpec(
        probs={"submit": 1.0}, seed=1))
    assert certain == {"EBT_MOCK_CUDA_FAIL_AT": "2"}
    assert jax_chaos.derive_env(jax_chaos.ChaosSpec(
        probs={"submit": 1.0}, seed=1)) == {"EBT_MOCK_PJRT_FAIL_AT": "2"}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_chaos_refused_with_hosts_in_both(pkg):
    """--chaos cannot arm remote services (the seams are in-process env
    reads): master mode refuses instead of running an inject-nothing
    campaign, in both packages with the same words."""
    cfg = {"jax": jax_config, "torch": torch_config}[pkg]
    exc = {"jax": jax_exceptions, "torch": torch_exceptions}[pkg]
    with pytest.raises(exc.ProgException, match="master-local"):
        cfg.config_from_args(["-r", "-s", "1M", "--hosts", "h0,h1",
                              "--chaos", "stripe=0.5", "--nolive",
                              "/tmp/x"])


# ------------------------------------------------- arming at prepare


def test_chaos_flag_arms_env_at_prepare(pkgs, tmp_path):
    """--chaos arms the derived seam env at worker-group prepare, before
    the native layers read it, in both packages with the same points."""
    nblocks = 4
    armed = {}
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(b"\0" * (nblocks * BLK))
        cfg = pkg.config_from_args(
            ["-r", "-t", "1", "-s", str(nblocks * BLK), "-b", str(BLK),
             "--tpubackend", "pjrt", "--chaos", "stripe=0.5,seed=3",
             "--retry", "1", "--maxerrors", "10%", "--nolive", str(f)])
        (env,) = [s.env for n, s in pkg.chaos.SEAMS.items()
                  if n == "stripe"]
        assert env not in os.environ
        group = pkg.Group(cfg)
        group.prepare()
        try:
            armed[pkg.name] = os.environ.get(env)
            assert armed[pkg.name]
        finally:
            group.teardown()
    assert armed["jax"] == armed["torch"]


def test_chaos_mock_seam_against_another_driver_warns_inert(clean_seams,
                                                            capfd):
    """A mock-driver seam armed while the engine would load another driver
    injects nothing: arm_chaos names it INERT; an engine seam is not
    flagged."""
    clean_seams.setenv("EBT_CUDA_DRIVER", "libcuda.so.1")
    capfd.readouterr()
    env = torch_chaos.arm_chaos("submit=1.0,reactor=1.0,seed=1")
    assert env == {"EBT_MOCK_CUDA_FAIL_AT": "2",
                   "EBT_MOCK_REACTOR_FAIL_AT": "2"}
    (warned,) = [ln for ln in capfd.readouterr().err.splitlines()
                 if "INERT" in ln]
    assert "submit" in warned and "libcuda.so.1" in warned
    assert "reactor" not in warned
    assert torch_chaos.inert_seams(env) == ["submit"]
    clean_seams.setenv("EBT_CUDA_DRIVER", "/x/libebtcudamock.so")
    assert torch_chaos.inert_seams(env) == []


def test_chaos_dev_pick_outside_the_mock_warns_inert(clean_seams, capfd):
    """A dev_nth pick past the mock's devices would inject nothing: it is
    flagged as loudly as an inert seam."""
    clean_seams.setenv("EBT_CUDA_DRIVER", "/x/libebtcudamock.so")
    clean_seams.setenv("EBT_MOCK_CUDA_DEVICES", "1")
    seed = next(s for s in range(1, 100) if torch_chaos.derive_env(
        torch_chaos.parse_chaos_spec(f"stripe=1.0,devices=4,seed={s}"))[
            "EBT_MOCK_CUDA_DEV_FAIL_AT"].split(":")[0] != "0")
    capfd.readouterr()
    torch_chaos.arm_chaos(f"stripe=1.0,devices=4,seed={seed}")
    (warned,) = [ln for ln in capfd.readouterr().err.splitlines()
                 if "INERT" in ln]
    assert "stripe" in warned and "EBT_MOCK_CUDA_DEVICES" in warned


# ----------------------------------------- armed runs, one per seam kind


# the call a copy failed in: the PJRT plugin's, the CUDA driver's
SUBMIT_CALLS = r"\b(BufferFromHostBuffer|cuMemcpyHtoDAsync): "


def _norm(pkg, x):
    """Strings without the package's seam names, the driver's error-code
    wrapper and the name of the submitting call."""
    if isinstance(x, dict):
        return {k: _norm(pkg, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(pkg, v) for v in x]
    if isinstance(x, str):
        for env in sorted(pkg.seams, key=len, reverse=True):
            x = x.replace(env, "SEAM")
        x = re.sub(SUBMIT_CALLS, "SUBMIT: ", x)
        return re.sub(r"CUDA error \d+ \((.*?)\)", r"\1", x)
    return x


# clock readings in the result tree (tests/test_torch_result_tree.py);
# UringStats are process-cumulative and not what these runs inject
TIMING_TOP = ("CPUUtilStoneWall", "StoneWall", "StoneWallUSecs",
              "ElapsedUSecsList", "DevLatHistos", "UringStats")
TIMING_NESTED = {
    "LaneStats": ("lock_wait_ns",),
    "StripeStats": ("barrier_wait_ns",),
    "D2HStats": ("await_wait_ns", "overlap_bytes"),
    "FaultStats": ("dev_retry_backoff_ns",),
}


def _strip_timing(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        if k in TIMING_TOP or k.startswith("LatHisto"):
            continue
        if k in TIMING_NESTED and v is not None:
            drop = TIMING_NESTED[k]
            v = ([{a: b for a, b in d.items() if a not in drop} for d in v]
                 if isinstance(v, list) else
                 {a: b for a, b in v.items() if a not in drop})
        out[k] = v
    return out


def armed_run(pkg, tmp_path, args, spec, data) -> dict:
    """One package's read under --chaos; the cause, the result tree and
    the landed checksum."""
    f = tmp_path / pkg.name
    f.write_bytes(data)
    pkg.mock.ebt_mock_reset()
    cfg = pkg.config_from_args(["-r", "--tpubackend", "pjrt", "--nolive",
                                "--chaos", spec, *args, str(f)])
    group = pkg.Group(cfg)
    group.prepare()
    try:
        group.start_phase(pkg.Phase.READFILES, "chaos")
        while not group.wait_done(1000):
            pass
        tree = pkg.Statistics(cfg, group).bench_result_wire(
            pkg.Phase.READFILES, "chaos", [])
        return {"error": _norm(pkg, group.first_error()),
                "tree": _norm(pkg, _strip_timing(tree)),
                "checksum": pkg.mock.ebt_mock_checksum()}
    finally:
        group.teardown()


@pytest.mark.parametrize("kind,spec,args", [
    # nth: the first copy after the warm-up fails at submit (one lane)
    ("nth", "submit=1.0,seed=1",
     ["-t", "1", "-s", str(8 * BLK), "-b", str(BLK), "--gpuids", "0"]),
    # dev_nth: the picked device's first striped block fails in flight;
    # the fault policy ejects it and recovers the block onto a survivor
    ("dev_nth", "stripe=1.0,seed=5,devices=4",
     ["-t", "1", "-s", str(12 * BLK), "-b", str(BLK), "--stripe", "rr",
      "--regwindow", str(2 * BLK), "--retry", "1", "--maxerrors", "5%"]),
    # flag: every registration fails, the path stays on the staged tier
    ("flag", "dmamap_all=1.0,seed=1",
     ["-t", "2", "-s", str(8 * BLK), "-b", str(BLK)]),
])
def test_chaos_armed_run_matches_the_original(pkgs, tmp_path, kind, spec,
                                              args):
    data = np.random.default_rng(4).integers(
        0, 256, int(args[args.index("-s") + 1]), dtype=np.uint8).tobytes()
    out = {p.name: armed_run(p, tmp_path, args, spec, data) for p in pkgs}
    j, t = out["jax"], out["torch"]
    assert t["error"] == j["error"]
    assert t["checksum"] == j["checksum"]
    assert t["tree"] == j["tree"]
    if kind == "nth":
        assert "mock transfer failure (SEAM)" in t["error"]
    elif kind == "dev_nth":
        assert t["error"] == ""
        assert t["tree"]["FaultStats"]["ejected_devices"] == 1
        assert "SEAM" in t["tree"]["EjectedDevices"]
        assert t["checksum"] == sum(data)
    else:
        assert t["error"] == ""
        assert t["tree"]["DataPathTier"] == "staged"
        assert t["checksum"] == sum(data)


# ------------------------------------------------- the warm-up floor


def _prepare_outcome(pkg, tmp_path, args, spec) -> str:
    """"" when the path's construction passed with `spec` armed, else the
    cause of its failure."""
    for k in ALL_SEAM_ENVS:
        os.environ.pop(k, None)  # restored by the clean_seams fixture
    pkg.mock.ebt_mock_reset()
    f = tmp_path / f"floor_{pkg.name}"
    f.write_bytes(b"\0" * (4 * BLK))
    cfg = pkg.config_from_args(["-r", "-s", str(4 * BLK), "-b", str(BLK),
                                "--tpubackend", "pjrt", "--nolive",
                                "--chaos", spec, *args, str(f)])
    group = pkg.Group(cfg)
    try:
        group.prepare()
        return ""
    except pkg.ProgException as e:
        return str(e)
    finally:
        group.teardown()


@pytest.mark.parametrize("spec,args,holds", [
    # one lane: op #1 of the copy and completion counters is the warm-up
    ("submit=1.0,seed=1", ["--gpuids", "0"], True),
    ("ready=1.0,seed=1", ["--gpuids", "0"], True),
    # op #1 of the registration counter is the registration probe
    ("dmamap=1.0,seed=1", ["--gpuids", "0,1"], True),
    # per device: one warm-up per device, two devices
    ("stripe=1.0,seed=1,devices=1", ["--gpuids", "0,1"], True),
    # two lanes: op #2 is the second lane's warm-up
    ("submit=1.0,seed=1", ["--gpuids", "0,1"], False),
    ("ready=1.0,seed=1", ["--gpuids", "0,1"], False),
    # two lanes on one device: its op #2 is the second lane's warm-up
    ("stripe=1.0,seed=1,devices=1", ["--gpuids", "0,0"], False),
])
def test_chaos_warmup_floor(pkgs, tmp_path, spec, args, holds):
    """The floor of 2 spares the construction probe where construction
    makes one op of the counter, and not where it makes more (one warm-up
    per lane): there the draw fails the path's init, in both packages."""
    got = [_prepare_outcome(p, tmp_path, args, spec) for p in pkgs]
    for cause in got:
        if holds:
            assert cause == ""
        else:
            assert "warmup transfer failed" in cause


def test_chaos_warmup_floor_with_the_transfer_manager(pkgs, tmp_path,
                                                      monkeypatch):
    """With the tier requested, op #1 of the tier's copy counter is its
    probe's copy, so xfer=1.0 passes construction and fails the first hot
    block. The probe attaches two completions in the port (its chunk and
    its block) where the original takes one ReadyEvent, so ready=1.0 (op
    #2) fails the original's warm-up, and the port's probe, which
    downgrades the tier instead."""
    monkeypatch.setenv("EBT_PJRT_XFER_MGR", "1")
    for pkg in pkgs:
        assert _prepare_outcome(pkg, tmp_path, ["--gpuids", "0"],
                                "xfer=1.0,seed=1") == ""
    j, t = pkgs
    assert "warmup transfer failed" in _prepare_outcome(
        j, tmp_path, ["--gpuids", "0"], "ready=1.0,seed=1")
    for k in ALL_SEAM_ENVS:
        os.environ.pop(k, None)
    t.mock.ebt_mock_reset()
    f = tmp_path / "ready"
    f.write_bytes(b"\0" * (4 * BLK))
    cfg = t.config_from_args(["-r", "-s", str(4 * BLK), "-b", str(BLK),
                              "--tpubackend", "pjrt", "--nolive", "--chaos",
                              "ready=1.0,seed=1", "--gpuids", "0", str(f)])
    group = t.Group(cfg)
    group.prepare()
    try:
        assert not group._native_path.xfer_mgr_active
        assert group._native_path.reg_error().startswith(
            "transfer-manager probe failed: ")
    finally:
        group.teardown()
