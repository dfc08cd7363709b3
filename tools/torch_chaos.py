#!/usr/bin/env python3
"""Chaos campaign runner for the PyTorch/CUDA port — a thin wrapper over
the port's campaign engine.

The rounds (striped read, checkpoint restore, DL ingest, N->M reshard,
open-loop paced read, serving under rotation) are the declarative campaign
specs under campaigns/chaos-*.json, executed by
elbencho_tpu_torch/campaign.py with the recovery invariants asserted
(docs/CAMPAIGNS.md):

  1. byte-exact completion after replanning (mock additive checksum ==
     source checksum; shard/unit byte reconciliation);
  2. settle accounting reconciles (stripe units, ckpt bytes, reshard
     pair matrix);
  3. the open-loop ledger stays exact (arrivals == completions +
     dropped per tenant class);
  4. nothing leaks (mock live-buffer + host-registration gauges, uring op
     holds);
  5. an armed in-window injection is VISIBLE, never silent.

Each round re-seeds the specs' chaos draws from --seed + round, so a longer
campaign still walks different failure sites: a fresh --shuffleseed per
ingest round and a walked device-to-device injection point
(EBT_MOCK_CUDA_D2D_FAIL_AT) per reshard round. Exit 0 = every invariant
held in every round; 1 = a violation (printed with its round and cause);
2 = setup refused.

Usage:
  python3 tools/torch_chaos.py --mock [--rounds N] [--rate P] [--seed N]
                               [--dir DIR] [--spec SPEC] [--scenario NAME]

Mock-only by construction: the fault seams live in the mock CUDA driver and
the storage engine's shims. The port runs on the card unless asked for the
CPU, so the tool refuses without --mock; --mock sets EBT_TORCH_DEVICE=cpu,
EBT_CUDA_DRIVER to the mock (built at first use) and EBT_MOCK_CUDA_DEVICES=4
unless already set.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

# scenario name -> campaign spec file
SCENARIOS = {
    "read": "chaos-read.json",
    "ckpt": "chaos-restore.json",
    "ingest": "chaos-ingest.json",
    "reshard": "chaos-reshard.json",
    "load": "chaos-load.json",
    "serving": "chaos-serving.json",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mock", action="store_true",
                    help="run on the CPU against the mock CUDA driver "
                         "(required: the fault seams are mock-only)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dir", default="")
    ap.add_argument("--spec", default="",
                    help="explicit chaos spec (overrides --rate; "
                         "elbencho_tpu_torch/chaos.py grammar)")
    ap.add_argument("--scenario", default="all",
                    choices=["all"] + sorted(SCENARIOS),
                    help="run one campaign scenario only (default: the "
                         "full round)")
    args = ap.parse_args()

    if not args.mock:
        print("chaos: --mock not given — the fault seams are mock-only "
              "(the port runs on the card unless asked for the CPU)",
              file=sys.stderr)
        return 2
    from torch_campaign import use_mock_driver

    use_mock_driver()
    from elbencho_tpu_torch.campaign import (MOCK_LIB_TAG, CampaignError,
                                             CampaignRunner, load_campaign)
    from elbencho_tpu_torch.chaos import SEAMS, parse_chaos_spec
    from elbencho_tpu_torch.exceptions import ProgException

    if MOCK_LIB_TAG not in os.path.basename(os.environ["EBT_CUDA_DRIVER"]):
        print("chaos: EBT_CUDA_DRIVER is not the mock driver — the fault "
              "seams are mock-only", file=sys.stderr)
        return 2

    override_probs = None
    if args.spec:
        try:
            override_probs = parse_chaos_spec(args.spec).probs
        except ProgException as e:
            print(f"chaos: REFUSED: {e}", file=sys.stderr)
            return 2

    scenarios = sorted(SCENARIOS) if args.scenario == "all" \
        else [args.scenario]
    workdir = args.dir or tempfile.mkdtemp(prefix="ebt-chaos-")
    os.makedirs(workdir, exist_ok=True)
    print(f"chaos campaign: {args.rounds} round(s), rate {args.rate}, "
          f"seed {args.seed}, dir {workdir}")

    failures: list[str] = []
    for rnd in range(args.rounds):
        for scen in scenarios:
            spec_path = os.path.join(REPO, "campaigns", SCENARIOS[scen])
            try:
                spec = load_campaign(spec_path)
            except CampaignError as e:
                print(f"chaos: REFUSED: {e}", file=sys.stderr)
                return 2
            spec.seed = args.seed + rnd
            for st in spec.stages:
                if st.chaos:
                    probs = override_probs if override_probs is not None \
                        else {k: args.rate for k in st.chaos}
                    st.chaos = dict(probs)
                # per-round workload variation: a fresh shuffle order per
                # ingest round, a walked D2D injection point per reshard
                # round
                if scen == "ingest" and "--shuffleseed" in st.flags:
                    st.flags[st.flags.index("--shuffleseed") + 1] = \
                        str(rnd + 1)
                if scen == "reshard":
                    st.env[SEAMS["d2d"].env] = str(1 + rnd % 3)
            rdir = os.path.join(workdir, f"r{rnd}_{scen}")
            try:
                report = CampaignRunner(spec, rdir).run()
            except CampaignError as e:
                failures.append(f"round {rnd} {scen}: {e}")
                print(f"chaos: FAIL: round {rnd} {scen}: {e}",
                      file=sys.stderr)
                continue
            armed = {k: v for s in report["stages"]
                     for k, v in s["chaos_env"].items()}
            print(f"round {rnd} {scen}: seams "
                  + (", ".join(f"{k}={v}"
                               for k, v in sorted(armed.items()))
                     or "(none fired this draw)"))
            for v in report["violations"]:
                failures.append(f"round {rnd} {scen}: {v}")
                print(f"chaos: FAIL: round {rnd} {scen}: {v}",
                      file=sys.stderr)

    if failures:
        print(f"chaos campaign: {len(failures)} invariant violation(s)",
              file=sys.stderr)
        return 1
    print("chaos campaign: every recovery invariant held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
