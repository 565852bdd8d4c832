"""The control of a cell, at the cell's own size, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

For each seed: the cell's inputs as a run makes them, the reference, and
the control (`traffic/<kind>.py` `control`: the reference computed in the
precision below the configuration's, put in the program's place), judged
by the cell's own comparison. One JSON line a seed, each number beside the
cell's limit. The control has to fail at least one limit on every seed;
the smallest reading it gives is the upper end a limit is set below
(PERF.md). The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.cells import Bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 2
    bench = Bench()
    cell, config = bench.cell(args.workload)
    control = bench.driver(cell["traffic"]["kind"]).control
    limits = cell["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, numbers in control(cell, config, seed, args.device).items():
            fails = [k for k in limits if numbers[k] > limits[k]]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": name, "numbers": numbers,
                              "limits": limits, "fails": fails}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
