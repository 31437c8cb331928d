"""The check's two readings on the chip, for one cell, in one process:

    python3 -m port_bench.control --workload <cell> --seconds <s> --seeds 1,2,3 [--rate r]

For each seed a run of the cell (set-up, ramp, a window of ``--seconds``,
the drain) and the check, which reads beside the program's widest logit gap
the control's: the family's reference computed with float8 activations
(``families/<family>.py``, ``logits(..., lowered=True)``), put in the
program's place at the same positions.  The limit of ``check.logit_gap_limit`` lies between the
largest program reading over a dozen seeds or more and the smallest control
reading (PERF.md gives both).  Prints one JSON line a seed, and with
``--rate`` (an open loop) the knee sweep's readings: the waiting queue at
the window's two ends and the tails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rate", default=None,
                    help="comma-separated request rates (open loop): one run per rate and seed")
    ap.add_argument("--no-control", action="store_true", help="read the program's gap only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    from port_bench import harness
    from port_bench.cells import Bench

    bench = Bench(os.getcwd())
    rates = [float(r) for r in args.rate.split(",")] if args.rate else [None]
    for rate in rates:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            res = harness.run(bench, args.workload, seed, args.seconds, False, t0,
                              rate=rate, control=not args.no_control)
            v = res["verdict"]
            w = res["info"]["window"]
            print(json.dumps(dict(
                seed=seed, rate=rate, correct=v["correct"],
                logit_gap=v["numbers"]["logit_gap"][0], control_gap=v.get("control_gap"),
                tokens=v["tokens"], attempted=res["attempted"], failed=res["failed"],
                queue=w["queue"], late_s=w["late_s"],
                captures_in_window=len(res["info"]["captures_in_window"]),
                values=res["values"], peak=res["peak"], detail=v["detail"],
                run_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
