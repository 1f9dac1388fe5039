"""``tosem_tpu_torch chaos`` — run a named fault plan and print the
survival report.

The port's copy of ``tosem_tpu/chaos/cli.py``, with its flags, output
and exit codes, plus ``--device``: the plans whose workloads compute on
tensors run on the card unless ``--device=cpu`` asks for the CPU.

    python -m tosem_tpu_torch.cli chaos --list
    python -m tosem_tpu_torch.cli chaos --plan decode-chaos
    python -m tosem_tpu_torch.cli chaos --plan split-survival --seed 42 --json
    python -m tosem_tpu_torch.cli chaos --plan-file my_plan.json \\
        --scenario serve-flap --device=cpu

Exit code 0 = the workload survived every injected fault; 1 = it did
not.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from tosem_tpu_torch.chaos.plan import CANNED_PLANS, FaultPlan
from tosem_tpu_torch.chaos.runner import SCENARIOS, run_plan


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tosem_tpu_torch chaos",
        description="deterministic fault injection: run a plan, report "
                    "survival")
    ap.add_argument("--plan", default=None,
                    help=f"canned plan name, one of {sorted(CANNED_PLANS)}")
    ap.add_argument("--plan-file", default=None,
                    help="JSON FaultPlan file (pair with --scenario)")
    ap.add_argument("--scenario", default="",
                    help="workload to run the plan against "
                    f"({sorted(SCENARIOS)}; defaults to the plan name)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the plan's seed (replay knob)")
    ap.add_argument("--json", action="store_true",
                    help="emit the survival report as JSON")
    ap.add_argument("--list", action="store_true",
                    help="list canned plans and exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tensor workloads run (default: the "
                    "card)")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(CANNED_PLANS):
            p = CANNED_PLANS[name]
            faults = ", ".join(f"{f.site}:{f.action}@{f.at}"
                               for f in p.faults)
            print(f"{name:16s} seed={p.seed:<4d} {faults}")
        return 0

    if bool(args.plan) == bool(args.plan_file):
        ap.error("exactly one of --plan / --plan-file is required")
    if args.plan is not None:
        if args.plan not in CANNED_PLANS:
            ap.error(f"unknown plan {args.plan!r}; see --list")
        plan = CANNED_PLANS[args.plan]
    else:
        with open(args.plan_file) as f:
            plan = FaultPlan.from_json(f.read())
    if args.seed is not None:
        plan = dataclasses.replace(plan, seed=args.seed)

    report = run_plan(plan, scenario=args.scenario, device=args.device)
    print(report.to_json() if args.json else report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
