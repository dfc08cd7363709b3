#!/usr/bin/env python3
"""Campaign runner CLI for the PyTorch/CUDA port (docs/CAMPAIGNS.md).

Runs one declarative scenario campaign (elbencho_tpu_torch/campaign.py) end
to end: loads + validates the spec (refusal-with-cause for every malformed
input), executes each stage with its chaos seams armed from the campaign
seed, evaluates the declared invariants between stages, and writes the
machine-readable campaign report. Optionally serves live Prometheus-text
metrics for the whole run (--metricsport) so a multi-hour soak is
watchable while it runs.

Usage:
  python3 tools/torch_campaign.py SPEC [--mock] [--seed N] [--dir DIR]
                                  [--report OUT] [--metricsport N]
                                  [--print-fingerprint]

Exit codes:
  0  every stage ran and every invariant held
  1  >= 1 invariant violation (report still written)
  2  the spec (or a stage config) was refused, or no CUDA device was
     found — the cause is printed

The port runs on the card unless asked for the CPU: without --mock the
stages run on the CUDA device (the real driver; the mock-only invariants
then record themselves as skipped, never silently pass), and with no CUDA
device the tool refuses before the first stage. --mock asks for the CPU
and the mock CUDA driver, where the chaos seams live: it sets
EBT_TORCH_DEVICE=cpu, EBT_CUDA_DRIVER=build/torch_core/libebtcudamock.so
(built at first use) and EBT_MOCK_CUDA_DEVICES=4, each unless already set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def use_mock_driver() -> None:
    """Ask for the CPU and the mock CUDA driver with 4 devices (an explicit
    environment wins)."""
    os.environ.setdefault("EBT_TORCH_DEVICE", "cpu")
    if "EBT_CUDA_DRIVER" not in os.environ:
        from elbencho_tpu_torch.engine import build_mock

        os.environ["EBT_CUDA_DRIVER"] = build_mock()
    os.environ.setdefault("EBT_MOCK_CUDA_DEVICES", "4")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spec", help="campaign spec file (.json, or .toml on "
                                 "Python >= 3.11)")
    ap.add_argument("--mock", action="store_true",
                    help="run on the CPU against the mock CUDA driver "
                         "(4 devices), where the chaos seams live")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the spec's campaign seed")
    ap.add_argument("--dir", default="",
                    help="campaign workdir (default: a fresh tempdir)")
    ap.add_argument("--report", default="",
                    help="write the campaign report JSON here")
    ap.add_argument("--metricsport", type=int, default=0,
                    help="serve Prometheus /metrics on this port for the "
                         "duration of the campaign")
    ap.add_argument("--print-fingerprint", action="store_true",
                    help="print only the deterministic report fingerprint "
                         "on success (reproducibility checks)")
    args = ap.parse_args()

    if args.mock:
        use_mock_driver()

    from elbencho_tpu_torch.campaign import CampaignRunner, load_campaign
    from elbencho_tpu_torch.cuda.devices import resolve_devices
    from elbencho_tpu_torch.exceptions import ProgException

    try:
        resolve_devices([])  # no CUDA device (and no --mock): refuse here
        spec = load_campaign(args.spec)
        if args.seed is not None:
            spec.seed = args.seed
        workdir = args.dir or tempfile.mkdtemp(prefix="ebt-campaign-")
        runner = CampaignRunner(spec, workdir,
                                metrics_port=args.metricsport)
        if not args.print_fingerprint:
            print(f"campaign {spec.name!r}: {len(spec.stages)} stage(s), "
                  f"seed {spec.seed}, dir {workdir}")
        report = runner.run()
    except ProgException as e:  # CampaignError is one
        print(f"campaign: REFUSED: {e}", file=sys.stderr)
        return 2

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.print_fingerprint:
        print(report["fingerprint"])
    else:
        for st in report["stages"]:
            held = sum(1 for r in st["invariants"] if r["ok"])
            print(f"  stage {st['stage']!r} ({st['phase']}): "
                  f"{'ok' if st['ok'] else 'FAILED'}, "
                  f"{held}/{len(st['invariants'])} invariant(s) held")
        if report["violations"]:
            for v in report["violations"]:
                print(f"campaign: FAIL: {v}", file=sys.stderr)
            print(f"campaign {spec.name!r}: "
                  f"{len(report['violations'])} invariant violation(s)",
                  file=sys.stderr)
        else:
            print(f"campaign {spec.name!r}: every invariant held "
                  f"(fingerprint {report['fingerprint'][:16]})")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
