"""The port's scenario campaign engine (elbencho_tpu_torch/campaign.py, its
CLIs tools/torch_campaign.py and tools/torch_chaos.py) against the
original's (elbencho_tpu/campaign.py, tools/campaign.py, tools/chaos.py),
case for case with tests/test_campaign.py and the two campaign-driven chaos
cases of tests/test_faults.py and tests/test_serving.py.

Both packages run on the same inputs: the original on its mock plugin
(elbencho_tpu/libebtpjrtmock.so, EBT_MOCK_PJRT_DEVICES=4), the port on the
mock CUDA driver (build/torch_core/libebtcudamock.so, EBT_TORCH_DEVICE=cpu,
EBT_MOCK_CUDA_DEVICES=4), the shipped spec files from campaigns/ unmodified,
and the same seeds. They must give the same refusals (once the module path
is normalised), the same parsed stages (each `env` key mapped through the
port's ORIGINAL_SEAM_ENVS), and per stage the same invariant names,
outcomes, violations and skips, the same deterministic counters
(_DET_KEYS, ops, the tenants' ledgers) and the same injection points by
campaign seam name. Every compared field is an exact integer, string or
boolean and is compared exactly. Fingerprints are compared within a
package only: chaos_env names each package's own seam variables.
"""

import copy
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import elbencho_tpu.campaign as jax_campaign
import elbencho_tpu.chaos as jax_chaos
import elbencho_tpu_torch.campaign as torch_campaign
import elbencho_tpu_torch.chaos as torch_chaos
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.campaign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
CAMPAIGNS = os.path.join(REPO, "campaigns")
SHIPPED = sorted(f for f in os.listdir(CAMPAIGNS) if f.endswith(".json"))
ALL_SEAM_ENVS = sorted({s.env for s in jax_chaos.SEAMS.values()}
                       | {s.env for s in torch_chaos.SEAMS.values()})
# the device-selection and driver variables the port's --mock defaults
PORT_ENV = ("EBT_TORCH_DEVICE", "EBT_CUDA_DRIVER", "EBT_MOCK_CUDA_DEVICES")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCENARIOS = _tool("torch_chaos").SCENARIOS


def _pkg(name, campaign, chaos):
    return SimpleNamespace(
        name=name, campaign=campaign, chaos=chaos,
        seam_of={s.env: n for n, s in chaos.SEAMS.items()})


JAX = _pkg("jax", jax_campaign, jax_chaos)
TORCH = _pkg("torch", torch_campaign, torch_chaos)
PKGS = (JAX, TORCH)


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port), each on its mock with 4 devices; every seam
    variable is registered with monkeypatch so each test leaves it as it
    was."""
    for k in ALL_SEAM_ENVS:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.delenv("EBT_PJRT_XFER_MGR", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "4")
    libs = [ctypes.CDLL(JAX_MOCK), ctypes.CDLL(torch_mock)]
    for lib in libs:
        lib.ebt_mock_reset()
    yield PKGS
    for lib in libs:
        lib.ebt_mock_reset()


def _norm(text: str, pkg=None) -> str:
    """A text with the port's module path written as the original's and,
    given the package, each of its seam variables named by campaign seam."""
    text = text.replace("elbencho_tpu_torch/", "elbencho_tpu/")
    if pkg is not None:
        for env, name in sorted(pkg.seam_of.items(), key=lambda kv:
                                -len(kv[0])):
            text = text.replace(env, f"<seam {name}>")
    return text


def _refusal(pkg, fn, *args) -> str:
    with pytest.raises(pkg.campaign.CampaignError) as e:
        fn(pkg, *args)
    return _norm(str(e.value))


def _same_refusal(fn, *args) -> str:
    j, t = (_refusal(p, fn, *args) for p in PKGS)
    assert j == t
    return t


def _view(pkg, report: dict, workdir) -> dict:
    """What the two packages must agree on in a campaign report: ok, the
    violations and, per stage, the fingerprint's projection with chaos_env
    by campaign seam name and argv free of the workdir, plus the skips."""
    stages = []
    for st in report["stages"]:
        v = pkg.campaign._stage_view(st)
        v["chaos_env"] = {pkg.seam_of[k]: x
                          for k, x in v["chaos_env"].items()}
        v["argv"] = [a.replace(str(workdir), "{workdir}")
                     for a in v["argv"]]
        v["skipped"] = [r["skipped"] for r in st["invariants"]]
        stages.append(v)
    return {"ok": report["ok"],
            "violations": [_norm(x, pkg) for x in report["violations"]],
            "stages": stages}


def _run_both(spec_of, tmp_path, tag="r"):
    """Run one campaign per package (spec_of(pkg) -> CampaignSpec), each in
    its own workdir; returns [(report, view)] for (original, port)."""
    out = []
    for pkg in PKGS:
        wd = tmp_path / f"{tag}_{pkg.name}"
        os.makedirs(wd, exist_ok=True)
        rep = pkg.campaign.CampaignRunner(spec_of(pkg), str(wd)).run()
        out.append((rep, _view(pkg, rep, wd)))
    assert out[0][1] == out[1][1]
    return out


def _shipped(name, seed=None):
    def spec_of(pkg):
        spec = pkg.campaign.load_campaign(os.path.join(CAMPAIGNS, name))
        if seed is not None:
            spec.seed = seed
        return spec
    return spec_of


VALID = {
    "campaign": {"name": "t", "seed": 1, "spec_version": 1},
    "stages": [
        {"name": "s0", "phase": "read", "flags": ["-r", "-s", "1M"],
         "path": "f.bin", "create": "random",
         "invariants": ["phase_clean"]},
    ],
}


def _mutate(**kw):
    d = copy.deepcopy(VALID)
    for k, v in kw.items():
        if k.startswith("stage_"):
            d["stages"][0][k[len("stage_"):]] = v
        else:
            d["campaign"][k] = v
    return d


def _parse(pkg, data):
    return pkg.campaign.parse_campaign(copy.deepcopy(data))


def _head(spec) -> dict:
    """A parsed spec's campaign table and provenance."""
    return {k: v for k, v in vars(spec).items() if k != "stages"}


def _stages(spec, pkg) -> list:
    """A parsed spec's stages, each env key by campaign seam name."""
    return [dict(vars(st), env={pkg.seam_of[k]: v
                                for k, v in st.env.items()})
            for st in spec.stages]


# ------------------------------------------------- what the port keeps


def test_campaign_tables_equal_the_original():
    """The names downstream gates key on, the phase families, the
    invariant catalog (names, when, params), the refusal tables, the
    fixture kit and the fingerprint's deterministic keys are the
    original's."""
    j, t = jax_campaign, torch_campaign
    assert t.REPORT_FIELDS == j.REPORT_FIELDS
    assert t.STAGE_REPORT_FIELDS == j.STAGE_REPORT_FIELDS
    assert {k: (int(p), m) for k, (p, m) in t.PHASE_FAMILIES.items()} == \
        {k: (int(p), m) for k, (p, m) in j.PHASE_FAMILIES.items()}
    assert {k: v[1:] for k, v in t.INVARIANTS.items()} == \
        {k: v[1:] for k, v in j.INVARIANTS.items()}
    assert len(t.INVARIANTS) == 15
    assert t._SKIPPABLE == j._SKIPPABLE
    assert t._FORBIDDEN_FLAGS == j._FORBIDDEN_FLAGS
    assert t._CREATE_MODES == j._CREATE_MODES
    assert (t._MODEL_SHARDS, t._MODEL_TRACE) == \
        (j._MODEL_SHARDS, j._MODEL_TRACE)
    assert t._DET_KEYS == j._DET_KEYS


# -------------------------------------------------- spec refusal-with-cause


def test_parse_valid_spec():
    j, t = (_parse(p, VALID) for p in PKGS)
    assert _head(t) == _head(j) and _stages(t, TORCH) == _stages(j, JAX)
    assert t.name == "t" and len(t.stages) == 1
    assert t.stages[0].phase == "read"


@pytest.mark.parametrize("data,needle", [
    ([], "top level must be a table"),
    ({"campaign": {"name": "x"}, "stages": [], "bogus": 1},
     "unknown top-level key"),
    ({"stages": [{}]}, "missing [campaign] table"),
    (_mutate(name=""), "campaign.name"),
    (_mutate(seed="7"), "campaign.seed"),
    (_mutate(spec_version=9), "spec_version"),
    ({"campaign": {"name": "x"}, "stages": []}, "non-empty list"),
    (_mutate(stage_phase="warp"), "unknown phase family"),
    (_mutate(stage_bogus=1), "unknown key"),
    (_mutate(stage_name=""), "'name' must be a non-empty string"),
    (_mutate(stage_path="/abs/path"), "inside the campaign workdir"),
    (_mutate(stage_path="../escape"), "inside the campaign workdir"),
    (_mutate(stage_create="maybe"), "'create' must be one of"),
    (_mutate(stage_chaos={"warp": 0.5}), "unknown chaos seam"),
    (_mutate(stage_chaos={"stripe": 1.5}), "in [0, 1]"),
    (_mutate(stage_env={"RANDOM_ENV": "1"}), "not a registered fault seam"),
    (_mutate(stage_invariants=["not_an_invariant"]), "unknown invariant"),
    (_mutate(stage_invariants=[{"name": "phase_clean", "window_ops": 3}]),
     "takes no parameter"),
    (_mutate(stage_flags=["-r", "--hosts", "h1"]), "not stage-settable"),
    (_mutate(stage_flags=["-r", "--chaos", "stripe=0.5"]),
     "not stage-settable"),
    (_mutate(stage_flags=["-w"]), "needs one of"),
])
def test_spec_refusals(data, needle):
    assert needle in _same_refusal(_parse, data)


def test_port_env_name_of_another_package_refused():
    """A mock seam variable of the port is refused by the original, as any
    unregistered name is; the port's own registry accepts it."""
    data = _mutate(stage_env={"EBT_MOCK_CUDA_DEV_FAIL_AT": "2:2"})
    assert "not a registered fault seam (elbencho_tpu/chaos.py SEAMS)" in \
        _refusal(JAX, _parse, data)
    spec = _parse(TORCH, data)
    assert spec.stages[0].env == {"EBT_MOCK_CUDA_DEV_FAIL_AT": "2:2"}


@pytest.mark.parametrize("orig_env", sorted(torch_chaos.ORIGINAL_SEAM_ENVS))
def test_original_env_names_accepted(orig_env):
    """Each original env name of a seam the port has (the shipped specs pin
    EBT_MOCK_STRIPE_FAIL_AT and EBT_MOCK_D2D_FAIL_AT) parses in both
    packages; the port arms its own variable for the same seam."""
    data = _mutate(stage_env={orig_env: "2"})
    j, t = (_parse(p, data) for p in PKGS)
    assert j.stages[0].env == {orig_env: "2"}
    name = torch_chaos.ORIGINAL_SEAM_ENVS[orig_env]
    assert t.stages[0].env == {torch_chaos.SEAMS[name].env: "2"}
    assert _stages(j, JAX) == _stages(t, TORCH)


def test_duplicate_stage_name_refused():
    d = copy.deepcopy(VALID)
    d["stages"].append(copy.deepcopy(d["stages"][0]))
    assert "duplicate stage name" in _same_refusal(_parse, d)


def _load(pkg, path):
    return pkg.campaign.load_campaign(str(path))


def test_load_campaign_bad_json(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    assert "JSON parse error" in _same_refusal(_load, p)


def test_load_campaign_missing_file(tmp_path):
    assert "unreadable" in _same_refusal(_load, tmp_path / "nope.json")


def test_load_campaign_toml_gated(tmp_path):
    """TOML specs parse on >= 3.11 interpreters and are refused with the
    cause when tomllib is absent, in both packages alike."""
    p = tmp_path / "c.toml"
    p.write_text('[campaign]\nname = "t"\nseed = 2\n'
                 '[[stages]]\nname = "s0"\nphase = "read"\n'
                 'flags = ["-r", "-s", "1M"]\npath = "f.bin"\n'
                 'create = "random"\ninvariants = ["phase_clean"]\n')
    try:
        import tomllib  # noqa: F401
    except ImportError:
        assert "tomllib" in _same_refusal(_load, p)
        return
    j, t = (_load(pk, p) for pk in PKGS)
    assert _head(t) == _head(j) and _stages(t, TORCH) == _stages(j, JAX)
    assert t.name == "t" and t.seed == 2


def _run_inline(pkg, data, workdir):
    spec = pkg.campaign.parse_campaign(copy.deepcopy(data))
    return pkg.campaign.CampaignRunner(spec, str(workdir)).run()


def test_stage_config_refusal_names_stage(pkgs, tmp_path):
    """A stage whose flags the Config layer refuses surfaces the stage name
    and the config cause, in the same words."""
    data = {"campaign": {"name": "t", "seed": 1},
            "stages": [{"name": "badflags", "phase": "read",
                        "flags": ["-r", "-s", "1M", "-b", "0"],
                        "path": "f.bin", "create": "random"}]}
    got = _same_refusal(_run_inline, data, tmp_path)
    assert "badflags" in got


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_campaign_specs_parse(name):
    """Every shipped spec parses in both packages to the same stages
    (names, phases, flags, invariants, chaos tables; env by seam)."""
    j, t = (p.campaign.load_campaign(os.path.join(CAMPAIGNS, name))
            for p in PKGS)
    assert _head(t) == _head(j)
    assert t.stages and _stages(t, TORCH) == _stages(j, JAX)
    for st in t.stages:
        assert st.phase in torch_campaign.PHASE_FAMILIES
        assert set(st.env) <= {s.env for s in torch_chaos.SEAMS.values()}


def test_shipped_specs_are_all_held():
    assert len(SHIPPED) == 9


# --------------------------------------------------------- invariant units


def _inv(pkg, name):
    return pkg.campaign.INVARIANTS[name][0]


def _ctx(pkg, **kw):
    return pkg.campaign.StageContext(spec=None, **copy.deepcopy(kw))


def test_invariant_catalog_ledger_checks():
    stats = {"tenants": [{"tenant": 0, "label": "hot", "arrivals": 10,
                          "completions": 8, "dropped": 1,
                          "backlog_peak": 2}]}
    got = []
    for pkg in PKGS:
        ctx = _ctx(pkg, stats=stats)
        fn = _inv(pkg, "open_loop_ledger")
        broken = fn(ctx, {})
        ctx.stats["tenants"][0]["dropped"] = 2
        got.append((broken, fn(ctx, {})))
    assert got[0] == got[1]
    assert "ledger broken" in got[1][0][0] and got[1][1] == []


def test_invariant_expected_ejections_params():
    got = []
    for pkg in PKGS:
        fn = _inv(pkg, "expected_ejections")
        ctx = _ctx(pkg, stats={"faults": {"ejected_devices": 1}})
        got.append([fn(ctx, p) for p in ({"equals": 1}, {"equals": 2},
                                         {"min": 2}, {"max": 0})])
    assert got[0] == got[1]
    ok, eq2, mn, mx = got[1]
    assert ok == [] and "!= expected 2" in eq2[0]
    assert "< expected minimum" in mn[0] and "> allowed maximum" in mx[0]


def test_invariant_injection_visible_in_window():
    got = []
    for pkg in PKGS:
        fn = _inv(pkg, "injection_visible")
        ctx = _ctx(pkg, chaos_env={pkg.chaos.SEAMS["stripe"].env: "2:3"},
                   stats={"faults": {"dev_errors": 0}, "engine_faults": {}})
        res = [fn(ctx, {"seam": "stripe", "window_ops": 5}),
               fn(ctx, {"seam": "stripe", "window_ops": 2})]  # off-window
        ctx.stats["faults"]["dev_errors"] = 1
        res.append(fn(ctx, {"seam": "stripe", "window_ops": 5}))
        got.append([[_norm(v, pkg) for v in r] for r in res])
    assert got[0] == got[1]
    assert "fired silently" in got[1][0][0]
    assert got[1][1] == [] and got[1][2] == []


def test_stage_seed_deterministic():
    for s in (torch_campaign.stage_seed, jax_campaign.stage_seed):
        assert s(7, 2) == s(7, 2)
        assert s(7, 2) != s(7, 3)
        assert s(7, 2) != s(8, 2)
    assert [torch_campaign.stage_seed(c, i) for c in (1, 7, 99)
            for i in range(4)] == \
        [jax_campaign.stage_seed(c, i) for c in (1, 7, 99) for i in range(4)]


def test_mock_only_invariants_skip_on_another_driver(monkeypatch):
    """On any driver but the mock, _load_mock finds no gauges and the two
    mock-only invariants record themselves as skipped, with the original's
    words: never a silent pass."""
    monkeypatch.setenv("EBT_CUDA_DRIVER", "libcuda.so.1")
    assert torch_campaign._load_mock() is None
    monkeypatch.delenv("EBT_CUDA_DRIVER")
    assert torch_campaign._load_mock() is None
    got = []
    for pkg in PKGS:
        st = pkg.campaign.parse_campaign(_mutate(
            stage_invariants=["byte_exact_landing", "no_leaks"])).stages[0]
        ctx = pkg.campaign.StageContext(spec=st)
        res: list = []
        for when in ("stage", "teardown"):
            pkg.campaign.CampaignRunner._eval(st, ctx, when, res)
        got.append(res)
    assert got[0] == got[1]
    assert [r["skipped"][0].startswith("skipped: ") for r in got[1]] == \
        [True, True]
    assert all(r["violations"] == [] for r in got[1])


def test_no_leaks_reads_the_port_mock_gauges(pkgs):
    """The port's leak check reads the mock driver's host-registration
    gauge and its signed live-buffer count: a double free (-1) is a leak,
    not 2^64 - 1 read as one."""
    mock = torch_campaign._load_mock()
    assert mock is not None
    assert mock.ebt_mock_live_buffers.restype is ctypes.c_int64
    fn = _inv(TORCH, "no_leaks")
    for live, reg, want in ((0, 0, 0), (-1, 0, 1), (2, 0, 1), (0, 3, 1)):
        fake = SimpleNamespace(ebt_mock_live_buffers=lambda v=live: v,
                               ebt_mock_hostreg_active=lambda v=reg: v)
        assert len(fn(_ctx(TORCH, mock=fake), {})) == want, (live, reg)


@pytest.mark.parametrize("acked", [False, True])
def test_mock_checksum_takes_back_a_copy_whose_completion_is_dropped(
        pkgs, monkeypatch, acked):
    """byte_exact_landing on the port's mock: two workers' copies share a
    lane's stream, so one worker's copy can land just before another's
    faulting copy while its completion is queued after the fault, which
    drops it; the engine then lands that block again on a survivor. The
    mock takes such a copy back out of its checksum (the original's mock
    counts each transfer once, behind its own ready event); a copy whose
    completion ran before the fault stays counted."""
    lib = ctypes.CDLL(os.environ["EBT_CUDA_DRIVER"])
    for fn in ("ebt_mock_checksum", "ebt_mock_total_bytes"):
        getattr(lib, fn).restype = ctypes.c_uint64
    ctx, stream = ctypes.c_void_p(), ctypes.c_void_p()
    dptr = ctypes.c_ulonglong()
    n = 4096
    src = ctypes.create_string_buffer(bytes(range(256)) * (n // 256), n)
    done = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(lambda _arg: None)
    assert lib.cuInit(0) == 0
    assert lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), 0) == 0
    assert lib.cuCtxSetCurrent(ctx) == 0
    assert lib.cuStreamCreate(ctypes.byref(stream), 0) == 0
    assert lib.cuMemAlloc_v2(ctypes.byref(dptr), ctypes.c_size_t(2 * n)) == 0
    lib.ebt_mock_reset()
    monkeypatch.setenv("EBT_MOCK_CUDA_DEV_FAIL_AT", "0:2")
    try:
        def copy(off):
            assert lib.cuMemcpyHtoDAsync_v2(
                ctypes.c_ulonglong(dptr.value + off), src,
                ctypes.c_size_t(n), stream) == 0

        copy(0)  # lands
        if acked:
            assert lib.cuLaunchHostFunc(stream, done, None) == 0
        copy(n)  # device 0's second copy fails in flight
        if not acked:  # the first copy's completion, behind the fault
            assert lib.cuLaunchHostFunc(stream, done, None) == 0
        assert lib.cuStreamSynchronize(stream) != 0
        want = sum(range(256)) * (n // 256) if acked else 0
        assert (lib.ebt_mock_checksum(), lib.ebt_mock_total_bytes()) == \
            (want, n if acked else 0)
    finally:
        lib.cuStreamDestroy_v2(stream)
        lib.cuMemFree_v2(dptr)
        lib.ebt_mock_reset()


# ------------------------------------------------------ end-to-end running


def test_ci_smoke_campaign_end_to_end(pkgs, tmp_path):
    """The 2-stage CI smoke: write fill + chaos-armed striped read; both
    packages agree stage by stage, the report carries every pinned field
    and the armed injection is accounted for by the invariants."""
    (_, jv), (report, _) = _run_both(_shipped("ci-smoke.json"), tmp_path)
    assert report["ok"], report["violations"]
    assert set(torch_campaign.REPORT_FIELDS) == set(report)
    assert len(report["stages"]) == 2
    for st in report["stages"]:
        assert set(torch_campaign.STAGE_REPORT_FIELDS) == set(st)
        assert st["ok"] and st["error"] == ""
        assert st["stats"]["ops"]["bytes"] == 2 << 20
    read = report["stages"][1]
    (pin,) = jv["stages"][1]["chaos_env"].values()
    assert read["chaos_env"] == {"EBT_MOCK_CUDA_DEV_FAIL_AT": pin}
    assert read["stats"]["stripe"]["units_awaited"] == \
        read["stats"]["stripe"]["units_submitted"]


def test_soak_campaign_reproducible_through_ejection(pkgs, tmp_path):
    """The >= 4-stage lifecycle campaign (restore -> open-loop ramp ->
    pinned ejection through the original's EBT_MOCK_STRIPE_FAIL_AT=2:2 ->
    reshard/drain) runs twice in each package with identical stage-level
    reports, the same in both packages, the ejection stage really ejects,
    and every inter-stage invariant holds."""
    first = _run_both(_shipped("soak-smoke.json"), tmp_path, "a")
    second = _run_both(_shipped("soak-smoke.json"), tmp_path, "b")
    for (r1, _), (r2, _) in zip(first, second):
        assert r1["ok"], r1["violations"]
        assert r1["fingerprint"] == r2["fingerprint"] == \
            torch_campaign.fingerprint(r1)
    rep = first[1][0]
    assert [s["stage"] for s in rep["stages"]] == \
        ["restore", "ramp", "fault-eject", "reshard-drain"]
    eject = rep["stages"][2]
    assert eject["chaos_env"] == {"EBT_MOCK_CUDA_DEV_FAIL_AT": "2:2"}
    assert eject["stats"]["faults"]["ejected_devices"] == 1
    assert "device 2" in eject["stats"]["ejected"]
    inv_names = {r["name"] for s in rep["stages"] for r in s["invariants"]}
    assert "metrics_consistent" in inv_names
    assert all("timing" in s for s in rep["stages"])


def test_soak_campaign_different_seed_changes_fingerprint(pkgs, tmp_path):
    """The seed is part of the identity in each package: another campaign
    seed moves the chaos draws and the fingerprint."""
    a = _run_both(_shipped("ci-smoke.json"), tmp_path, "a")
    b = _run_both(_shipped("ci-smoke.json", seed=99), tmp_path, "b")
    for (ra, _), (rb, _) in zip(a, b):
        assert ra["ok"] and rb["ok"]
        assert ra["fingerprint"] != rb["fingerprint"]


def test_campaign_invariant_violation_fails_report(pkgs, tmp_path):
    """A declared ejection that never happens fails the report with the
    stage-attributed cause, in the same words in both packages."""
    data = {"campaign": {"name": "noeject", "seed": 1},
            "stages": [{"name": "clean-read", "phase": "read",
                        "flags": ["-r", "-t", "1", "-s", "1M", "-b", "256K",
                                  "--tpubackend", "pjrt"],
                        "path": "f.bin", "create": "random",
                        "invariants": [
                            {"name": "expected_ejections", "min": 1}]}]}
    _, (report, view) = _run_both(
        lambda p: p.campaign.parse_campaign(copy.deepcopy(data)), tmp_path)
    assert not report["ok"]
    assert any("clean-read" in v and "ejected_devices 0" in v
               for v in view["violations"])


def test_campaign_stage_phase_error_fails_report(pkgs, tmp_path):
    """A stage whose phase errors fails the campaign even without a
    phase_clean invariant."""
    data = {"campaign": {"name": "phase-err", "seed": 1},
            "stages": [{"name": "missing-src", "phase": "read",
                        "flags": ["-r", "-t", "1", "-s", "1M", "-b", "256K"],
                        "path": "does-not-exist.bin",
                        "invariants": ["no_leaks"]}]}
    reports = []
    for pkg in PKGS:
        wd = tmp_path / pkg.name
        reports.append(_run_inline(pkg, data, wd))
        rep = reports[-1]
        assert not rep["stages"][0]["ok"] and not rep["ok"]
        assert any("missing-src" in v and "phase error" in v
                   for v in rep["violations"])
    j, t = ([_norm(v).replace(str(tmp_path / p.name), "{workdir}")
             for v in r["violations"]] for p, r in zip(PKGS, reports))
    assert j == t


def test_campaign_fixture_create_refused_with_cause(pkgs, tmp_path):
    """create='random' against an uncreatable target is a refusal naming
    the stage and the OS cause, not a raw traceback."""
    data = {"campaign": {"name": "badfix", "seed": 1},
            "stages": [{"name": "fix", "phase": "read",
                        "flags": ["-r", "-t", "1", "-s", "1M", "-b", "256K"],
                        "create": "random", "invariants": []}]}
    got = _same_refusal(_run_inline, data, tmp_path)
    assert "stage 'fix'" in got and "fixture" in got


def test_chaos_serving_campaign_runs_clean(pkgs, tmp_path):
    """The chaos-serving campaign (rotation under an in-flight fault) holds
    every invariant in both packages, with the same stage report."""
    _, (report, _) = _run_both(_shipped("chaos-serving.json"), tmp_path)
    assert report["ok"], report["violations"]
    stage = report["stages"][0]
    assert stage["stats"]["serving"]["rotations_complete"] >= 1
    assert stage["stats"]["rotation_records"]


def _chaos_round(scen, rnd=0, seed=1, rate=0.05):
    """One round of a tools/chaos.py scenario as the tools build it: the
    spec re-seeded from seed + round, every armed seam at `rate`, a fresh
    shuffle order (ingest) and a walked D2D injection point (reshard)."""
    def spec_of(pkg):
        spec = pkg.campaign.load_campaign(
            os.path.join(CAMPAIGNS, SCENARIOS[scen]))
        spec.seed = seed + rnd
        for st in spec.stages:
            if st.chaos:
                st.chaos = {k: rate for k in st.chaos}
            if scen == "ingest" and "--shuffleseed" in st.flags:
                st.flags[st.flags.index("--shuffleseed") + 1] = str(rnd + 1)
            if scen == "reshard":
                st.env[pkg.chaos.SEAMS["d2d"].env] = str(1 + rnd % 3)
        return spec
    return spec_of


def test_chaos_scenarios_equal_the_original_tool():
    assert SCENARIOS == _tool("chaos").SCENARIOS


@pytest.mark.parametrize("scen", sorted(SCENARIOS))
def test_chaos_round_matches_the_original(pkgs, tmp_path, scen):
    """Round 0 of each chaos scenario: the same injection points by seam
    name, the same invariant outcomes and deterministic counters."""
    (_, jv), (report, _) = _run_both(_chaos_round(scen), tmp_path)
    assert report["ok"], report["violations"]
    if scen == "reshard":  # the recovered move is visible
        st = report["stages"][0]
        assert st["chaos_env"] == {"EBT_MOCK_CUDA_D2D_FAIL_AT": "1"}
        assert st["stats"]["reshard"]["move_recovered"] >= 1
    else:
        assert any(s["chaos_env"] for s in jv["stages"])


def test_chaos_reshard_spec_recovers_the_pinned_move(pkgs, tmp_path):
    """chaos-reshard.json pins the original's EBT_MOCK_D2D_FAIL_AT=2: the
    port arms its own D2D seam, the second move fails in flight and is
    recovered through the bounce tier, byte-exact."""
    _, (report, _) = _run_both(_shipped("chaos-reshard.json"), tmp_path)
    st = report["stages"][0]
    assert report["ok"], report["violations"]
    assert st["chaos_env"] == {"EBT_MOCK_CUDA_D2D_FAIL_AT": "2"}
    rs = st["stats"]["reshard"]
    assert rs["move_recovered"] == 1 and rs["bounce_moves"] >= 1


# ------------------------------------------------------------- the tools


def _cli_env(pkg) -> dict:
    """The environment a user would start each package's tool with: the
    original needs only JAX on the CPU; the port gets nothing (its --mock
    asks for the CPU and the mock driver itself)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in PORT_ENV + tuple(ALL_SEAM_ENVS):
        env.pop(k, None)
    return env


def _cli(pkg, tool, *args, timeout=600):
    script = {"jax": tool, "torch": f"torch_{tool}"}[pkg.name]
    extra = ["--mock"] if pkg.name == "torch" else []
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{script}.py"),
         *args, *extra], cwd=REPO, env=_cli_env(pkg), capture_output=True,
        text=True, timeout=timeout)


def _stdout_lines(pkg, r, workdir=None) -> list[str]:
    """The tool's own output lines, seams by campaign name (a round line's
    seams sorted again: each tool sorts them by its own variable names)."""
    out = []
    for line in r.stdout.splitlines():
        if line.startswith(("campaign ", "  stage ", "round ", "chaos ")):
            if workdir is not None:
                line = line.replace(str(workdir), "{workdir}")
            line = _norm(line, pkg)
            head, sep, seams = line.partition(": seams <")
            if sep:
                line = head + ": seams " + ", ".join(
                    sorted(("<" + seams).split(", ")))
            out.append(line)
    return out


def test_campaign_runner_cli_report_and_exit(tmp_path):
    """tools/torch_campaign.py --mock: exit 0, the original's output lines
    and a report file on success; exit 2 with the cause on a refused
    spec."""
    lines = []
    for pkg in PKGS:
        out = tmp_path / f"{pkg.name}.json"
        wd = tmp_path / f"w_{pkg.name}"
        r = _cli(pkg, "campaign", os.path.join(CAMPAIGNS, "ci-smoke.json"),
                 "--dir", str(wd), "--report", str(out))
        assert r.returncode == 0, r.stderr
        report = json.loads(out.read_text())
        assert report["ok"] and report["campaign"] == "ci-smoke"
        lines.append([ln.split(" (fingerprint ")[0]
                      for ln in _stdout_lines(pkg, r, wd)])
    assert lines[0] == lines[1]

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"campaign": {"name": "x"}, "stages": [
        {"name": "s", "phase": "warp", "flags": []}]}))
    errs = []
    for pkg in PKGS:
        r = _cli(pkg, "campaign", str(bad), timeout=120)
        assert r.returncode == 2
        assert "REFUSED" in r.stderr and "unknown phase family" in r.stderr
        errs.append([ln for ln in r.stderr.splitlines()
                     if ln.startswith("campaign: ")])
    assert errs[0] == errs[1]


def test_campaign_cli_print_fingerprint_reproducible(tmp_path):
    """--print-fingerprint prints only the fingerprint, the same over two
    runs of one spec and seed."""
    prints = []
    for i in range(2):
        r = _cli(TORCH, "campaign", os.path.join(CAMPAIGNS, "ci-smoke.json"),
                 "--dir", str(tmp_path / f"w{i}"), "--print-fingerprint")
        assert r.returncode == 0, r.stderr
        prints.append(r.stdout.split())
    assert prints[0] == prints[1] and len(prints[0][0]) == 64


def test_campaign_cli_without_mock_refuses_without_cuda(tmp_path):
    """Without --mock and without EBT_TORCH_DEVICE=cpu the port runs on the
    card; with no CUDA device the tool exits 2 with the port's cause before
    the first stage, and never falls back to the mock."""
    wd = tmp_path / "w"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_campaign.py"),
         os.path.join(CAMPAIGNS, "ci-smoke.json"), "--dir", str(wd)],
        cwd=REPO, env=_cli_env(TORCH), capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no CUDA device found" in r.stderr
    assert "stage" not in r.stdout + r.stderr
    assert not wd.exists()


def test_campaign_cli_mock_keeps_an_explicit_environment(tmp_path):
    """--mock sets its defaults only where the environment has none: with
    EBT_MOCK_CUDA_DEVICES=2 soak-smoke's pinned device 2 does not exist,
    nothing is ejected, and the report says so (exit 1)."""
    env = dict(_cli_env(TORCH), EBT_MOCK_CUDA_DEVICES="2")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_campaign.py"),
         os.path.join(CAMPAIGNS, "soak-smoke.json"), "--mock",
         "--dir", str(tmp_path / "w")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "[expected_ejections]: ejected_devices 0 != expected 1" in \
        r.stderr


def test_chaos_cli_without_mock_refuses():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_chaos.py"),
         "--rounds", "1"], cwd=REPO, env=_cli_env(TORCH),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert "the fault seams are mock-only" in r.stderr
    assert "round" not in r.stdout


def test_chaos_wrapper_back_compat():
    """tools/torch_chaos.py --mock: one seeded round of one scenario prints
    the original's summary lines, with the same seams by name, exit 0."""
    lines = []
    for pkg in PKGS:
        r = _cli(pkg, "chaos", "--rounds", "1", "--scenario", "read",
                 "--seed", "5")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "every recovery invariant held" in r.stdout
        assert "round 0 read" in r.stdout
        lines.append(_stdout_lines(pkg, r)[1:])  # past the dir line
    assert lines[0] == lines[1]


def test_chaos_wrapper_explicit_spec_override():
    """--spec overrides --rate with the chaos grammar in both tools, and a
    malformed spec is refused loudly with the same words."""
    errs = []
    for pkg in PKGS:
        r = _cli(pkg, "chaos", "--rounds", "1", "--scenario", "load",
                 "--spec", "stripe=0.5,seed=9")
        assert r.returncode == 0, r.stdout + r.stderr
        r = _cli(pkg, "chaos", "--rounds", "1", "--spec", "bogus=zzz",
                 timeout=120)
        assert r.returncode == 2
        errs.append(r.stderr.strip().splitlines()[-1])
    assert errs[0] == errs[1] and "REFUSED" in errs[1]


def test_chaos_campaign_runner_smoke(tmp_path):
    """One seeded round across every scenario, with every invariant held
    and the same seams by name in both tools."""
    lines = []
    for pkg in PKGS:
        r = _cli(pkg, "chaos", "--rounds", "1", "--seed", "2", "--dir",
                 str(tmp_path / pkg.name))
        assert r.returncode == 0, r.stdout + r.stderr
        assert "every recovery invariant held" in r.stdout
        lines.append(_stdout_lines(pkg, r)[1:])
    assert lines[0] == lines[1]
    assert len([ln for ln in lines[1] if ln.startswith("round 0 ")]) == \
        len(SCENARIOS)
