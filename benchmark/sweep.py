"""The knee sweep of a serving cell: the cell run at each offered rate in
turn, each with its own set-up, printing one JSON line a rate (offered and
served rate, p50 and p95 latency, failures). The knee is the highest rate
served without a growing backlog; the cell's file holds 0.8 x it.

    python benchmark/sweep.py --workload serve.iemocap-mix --seed 7 --seconds 15 \\
        --rates 80 120 160 200 240
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

T_START = time.monotonic()

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark.lib import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    harness.set_cache_dirs()
    base = harness.load_json(harness.BENCH_DIR / "workloads" / f"{args.workload}.json")
    for i, rate in enumerate(args.rates):
        wl = copy.deepcopy(base)
        wl["params"]["rate_rps"] = rate
        wl["params"]["sample"] = 2
        r = harness.run_cell(args.workload, args.seed + i, args.seconds, False, workload=wl)
        m = {k: v["value"] for k, v in r["metrics"].items()}
        print(json.dumps({"offered_rps": rate, **m, "failed": r["failed"],
                          "attempted": r["attempted"]}), flush=True)
