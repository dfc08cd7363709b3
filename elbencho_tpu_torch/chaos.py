"""Chaos campaign support (--chaos) for the port.

The native layers carry a per-layer fault-injection seam family:
environment variables that the mock CUDA driver (csrc/cuda_mock.cpp) and
the shared storage engine (core/src/{uring,engine,reactor}.cpp) read to
fail the Nth operation of a given kind. They are deterministic by design
(tests pin exact injection points); a chaos campaign wants probabilities
instead. This module is the bridge: `--chaos "stripe=0.05,uring=0.05,
seed=7"` turns each per-operation probability into a concrete seeded
injection point (the first failure of a Bernoulli(p) process is geometric,
so sampling the geometric gives the exact distribution a per-op coin flip
would) and arms the environment before the engine and the native path
start.

The grammar, the refusals, the seeded draws (_xorshift, _geometric with
its floor of 2) and derive_env are the original package's
(elbencho_tpu/chaos.py), so one spec and seed give the same injection
points in both packages wherever the device count is the same. SEAMS keeps
the original's campaign names and points them at the port's seams; the
seam-matrix test (tests/test_torch_chaos.py) greps the port's sources for
EBT_MOCK_*FAIL* variables and asserts that every one is reachable from
here and that no entry is stale.

The warm-up floor. _geometric never returns 1, because op #1 of a counter
is meant to be the path's construction probe, and failing that fails the
path's init (a fatal configuration error, not a phase fault). On the
port's mock this holds, with one lane, for every nth and dev_nth counter:
  - EBT_MOCK_CUDA_FAIL_AT and _DEV_FAIL_AT: op #1 is the lane's warm-up
    copy (copies into transfer-manager block buffers are not counted);
  - EBT_MOCK_CUDA_HOSTREG_FAIL_AT / _AFTER: op #1 is the registration
    probe;
  - EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT: op #1 is the tier probe's copy
    (one 8-byte chunk, on lane 0 only);
  - EBT_MOCK_CUDA_FAIL_READY_AT: op #1 is the warm-up's completion;
  - EBT_MOCK_CUDA_XFER_FAIL_AT and _D2D_FAIL_AT: construction makes no
    such call, so op #1 is already a phase's.
It does not hold where construction makes more than one op of a counter,
in the original package as in the port: each lane makes one warm-up copy
and one completion, so with N lanes (--gpuids 0,1, or --gpuids 0,0 for
_DEV_FAIL_AT, whose counter is per device) ops #2..#N of those counters
are warm-ups too; and with the transfer-manager tier requested its probe
attaches two completions (its chunk and its block) before the warm-up's,
as the original's probe takes ReadyEvent #1 before it. A draw of 2 there
fails the path's init ("warmup transfer failed: ..."), and
tests/test_torch_chaos.py shows it for both packages.

The device pick of a dev_nth seam comes from the spec's `devices=N`, else
EBT_MOCK_CUDA_DEVICES, else 1 — the port's mock defaults to one device
where the original's (EBT_MOCK_PJRT_DEVICES) defaults to 4, so the default
differs but the same count gives the same pick. A pick outside the mock's
devices would inject nothing, and arm_chaos says so as loudly as it flags
a mock seam armed against the real driver (INERT).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

from .exceptions import ProgException
from .logger import LOGGER


@dataclass
class Seam:
    """One armable fault seam. kind:
      "nth"     — env takes the 1-based index of the operation to fail
      "dev_nth" — env takes "<device>:<n>" (per-device op counter)
      "flag"    — env is boolean (armed with probability p)
    layer:
      "cuda"    — lives in the CPU test mock driver (inert on the real
                  driver)
      "native"  — lives in the shipped native code (the storage engine),
                  reachable whatever the driver
    """

    env: str
    kind: str
    layer: str = "cuda"
    doc: str = ""


# campaign seam name -> env seam (THE registry; see the module docstring)
SEAMS: dict[str, Seam] = {
    "stripe": Seam("EBT_MOCK_CUDA_DEV_FAIL_AT", "dev_nth", "cuda",
                   "Nth copy targeting one device fails IN FLIGHT"),
    "submit": Seam("EBT_MOCK_CUDA_FAIL_AT", "nth", "cuda",
                   "Nth cuMemcpyHtoDAsync fails at submit"),
    "ready": Seam("EBT_MOCK_CUDA_FAIL_READY_AT", "nth", "cuda",
                  "Nth completion attach (host function or event) fails"),
    "d2h": Seam("EBT_MOCK_CUDA_XFER_FAIL_AT", "nth", "cuda",
                "Nth cuMemcpyDtoHAsync fails"),
    "xfer": Seam("EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT", "nth", "cuda",
                 "Nth copy into a transfer-manager block buffer fails"),
    "xfermgr": Seam("EBT_MOCK_CUDA_XFERMGR_FAIL", "flag", "cuda",
                    "every cuMemAllocAsync fails (the tier's probe "
                    "downgrades it)"),
    "dmamap": Seam("EBT_MOCK_CUDA_HOSTREG_FAIL_AT", "nth", "cuda",
                   "Nth cuMemHostRegister fails"),
    "dmamap_after": Seam("EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER", "nth", "cuda",
                         "every cuMemHostRegister after the Nth fails"),
    "dmamap_all": Seam("EBT_MOCK_CUDA_HOSTREG_FAIL", "flag", "cuda",
                       "every cuMemHostRegister fails (staged-fallback "
                       "path)"),
    "uring": Seam("EBT_MOCK_URING_REGISTER_FAIL_AT", "nth", "native",
                  "Nth fixed-buffer register push fails"),
    "aio": Seam("EBT_MOCK_AIO_SETUP_FAIL", "flag", "native",
                "first io_setup refused (retry-once path)"),
    "reactor": Seam("EBT_MOCK_REACTOR_FAIL_AT", "nth", "native",
                    "Nth completion-reactor eventfd-bridge arm fails "
                    "(that worker keeps the polling shape, cause latched)"),
    "d2d": Seam("EBT_MOCK_CUDA_D2D_FAIL_AT", "nth", "cuda",
                "Nth device-to-device copy fails IN FLIGHT (the reshard "
                "move recovers via the host-bounce tier, byte-exact)"),
}

# the original package's env name of each mock seam -> the campaign name the
# port registers it under (the storage engine's seams keep one name in both
# packages). A campaign spec written for the original pins these names; the
# campaign parser (campaign.py) arms the port's env in their place.
ORIGINAL_SEAM_ENVS: dict[str, str] = {
    "EBT_MOCK_STRIPE_FAIL_AT": "stripe",
    "EBT_MOCK_PJRT_FAIL_AT": "submit",
    "EBT_MOCK_PJRT_FAIL_READY_AT": "ready",
    "EBT_MOCK_D2H_FAIL_AT": "d2h",
    "EBT_MOCK_PJRT_XFER_FAIL_AT": "xfer",
    "EBT_MOCK_PJRT_XFERMGR_FAIL": "xfermgr",
    "EBT_MOCK_PJRT_DMAMAP_FAIL_AT": "dmamap",
    "EBT_MOCK_PJRT_DMAMAP_FAIL_AFTER": "dmamap_after",
    "EBT_MOCK_PJRT_DMAMAP_FAIL": "dmamap_all",
    "EBT_MOCK_D2D_FAIL_AT": "d2d",
}

MOCK_DRIVER_NAME = "libebtcudamock.so"


@dataclass
class ChaosSpec:
    probs: dict[str, float] = field(default_factory=dict)
    seed: int = 1
    devices: int = 0  # device count for dev_nth seams (0 = env, else 1)


def parse_chaos_spec(spec: str) -> ChaosSpec:
    """Parse the --chaos grammar ("seam=prob[,seam=prob...][,seed=N]
    [,devices=N]"), refusing every malformed input with a cause."""
    out = ChaosSpec()
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        key, sep, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or not val:
            raise ProgException(
                f"--chaos entry {part!r}: expected seam=probability")
        if key == "seed":
            try:
                out.seed = int(val)
            except ValueError:
                raise ProgException(f"--chaos seed={val!r}: not an integer")
            continue
        if key == "devices":
            try:
                out.devices = int(val)
            except ValueError:
                raise ProgException(
                    f"--chaos devices={val!r}: not an integer")
            continue
        if key not in SEAMS:
            raise ProgException(
                f"--chaos: unknown seam {key!r} (known: "
                f"{', '.join(sorted(SEAMS))})")
        try:
            p = float(val)
        except ValueError:
            raise ProgException(
                f"--chaos {key}={val!r}: probability is not a number")
        if not 0.0 <= p <= 1.0:
            raise ProgException(
                f"--chaos {key}={p}: probability must be in [0, 1]")
        out.probs[key] = p
    if not out.probs:
        raise ProgException("--chaos: no seams armed (empty spec)")
    return out


def _xorshift(state: int) -> int:
    state ^= (state << 13) & 0xFFFFFFFFFFFFFFFF
    state ^= state >> 7
    state ^= (state << 17) & 0xFFFFFFFFFFFFFFFF
    return state & 0xFFFFFFFFFFFFFFFF


def _geometric(p: float, state: int) -> tuple[int, int]:
    """(first-success index of a Bernoulli(p) process under the xorshift
    state, next state). Failing the Nth op with N geometric IS failing each
    op independently with probability p. Floored at 2: op #1 of a counter
    is the path's construction probe (see the module docstring for where
    that holds), and failing it fails the path's init, not a phase."""
    state = _xorshift(state)
    if p >= 1.0:
        return 2, state
    u = (state >> 11) / float(1 << 53)
    n = 1 + int(math.log(max(1e-18, 1.0 - u)) / math.log(1.0 - p))
    return max(2, n), state


def derive_env(spec: ChaosSpec) -> dict[str, str]:
    """Concrete env assignments for the armed seams: probabilities are
    converted to seeded geometric injection points (nth seams), a seeded
    device pick + geometric point (dev_nth), or a seeded Bernoulli arm
    (flag seams). Deterministic for a given spec, seed and device count."""
    # the spec's count, else the mock's (its default is one device)
    ndev = spec.devices or int(os.environ.get("EBT_MOCK_CUDA_DEVICES", "1")
                               or 1)
    state = (spec.seed * 0x9E3779B97F4A7C15 + 1) & 0xFFFFFFFFFFFFFFFF
    env: dict[str, str] = {}
    for name in sorted(spec.probs):
        p = spec.probs[name]
        seam = SEAMS[name]
        if p <= 0.0:
            continue
        if seam.kind == "nth":
            n, state = _geometric(p, state)
            env[seam.env] = str(n)
        elif seam.kind == "dev_nth":
            state = _xorshift(state)
            dev = state % max(1, ndev)
            n, state = _geometric(p, state)
            env[seam.env] = f"{dev}:{n}"
        else:  # flag
            state = _xorshift(state)
            if (state >> 11) / float(1 << 53) < p:
                env[seam.env] = "1"
    return env


def inert_seams(env: dict[str, str]) -> list[str]:
    """The campaign names of the armed mock-driver seams when the engine
    will load another driver than the mock (EBT_CUDA_DRIVER): they inject
    nothing there."""
    driver = os.path.basename(os.environ.get("EBT_CUDA_DRIVER", ""))
    if MOCK_DRIVER_NAME in driver:
        return []
    return sorted(n for n, s in SEAMS.items()
                  if s.env in env and s.layer == "cuda")


def arm_chaos(chaos_spec: str) -> dict[str, str]:
    """Parse + derive + apply the chaos env (must run BEFORE the engine and
    the native path start). Returns what was applied and logs it, so a
    chaos run is self-describing. A mock-driver seam armed against another
    driver, or a device pick outside the mock's devices, injects nothing
    and is flagged loudly: a "chaos" run that injects nothing must never
    read as a clean pass."""
    spec = parse_chaos_spec(chaos_spec)
    env = derive_env(spec)
    inert = inert_seams(env)
    if inert:
        driver = os.environ.get("EBT_CUDA_DRIVER", "")
        LOGGER.warning(
            "chaos: seam(s) %s live in the CPU mock driver and are INERT "
            "against %s — point EBT_CUDA_DRIVER at %s to inject them" % (
                ", ".join(inert), os.path.basename(driver) or
                "the real CUDA driver", MOCK_DRIVER_NAME))
    have = int(os.environ.get("EBT_MOCK_CUDA_DEVICES", "1") or 1)
    for name, seam in sorted(SEAMS.items()):
        if seam.kind != "dev_nth" or seam.env not in env:
            continue
        dev = int(env[seam.env].split(":")[0])
        if dev >= have and name not in inert:
            LOGGER.warning(
                "chaos: seam %s picked device %d but the mock driver has "
                "%d device(s) (EBT_MOCK_CUDA_DEVICES): it is INERT — set "
                "devices=N in the spec or EBT_MOCK_CUDA_DEVICES" % (
                    name, dev, have))
    for k, v in env.items():
        os.environ[k] = v
    if env:
        LOGGER.info("chaos armed (seed=%d): %s" % (
            spec.seed, ", ".join(f"{k}={v}" for k, v in sorted(env.items()))))
    else:
        LOGGER.info("chaos: no seam fired for this seed/probability draw")
    return env
