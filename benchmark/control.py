"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.control --workload gssdpp-300.train-b32 \
        --seeds 11,12,13 --seconds 3

For each seed, one process-long run of the cell as ``benchmark.run``
makes it (set-up, a short window of ``--seconds``, the comparison), and
then the control: the reference put in the program's place in the next
precision below the configuration's (fp8), and for training a planted
fault (half of each batch left out). Prints one JSON line a seed: the
program's numbers, the control's and the fault's. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from benchmark import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = run.load_json("BENCHMARK.json")
    cell = run.cell_of(bench, args.workload)
    config = run.load_json("benchmark", "configs", f"{cell['config']}.json")
    traffic = run.load_json("benchmark", "traffic", f"{cell['traffic']}.json")
    kind = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        d = kind.Driver(config, traffic, seed, args.device)
        d.setup()
        d.window(args.seconds)
        d.release()
        line = {"seed": seed, "program": d.check(), **d.control()}
        print(json.dumps(line), flush=True)
        del d
        if args.device == "cuda":
            import torch

            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
