"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload gssdpp-300.train-b32 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. The cell, its configuration, its traffic mix
and its per-layer metrics are found by name from ``BENCHMARK.json``:
``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``
(whose ``kind`` names ``benchmark/drivers/<kind>.py``),
``benchmark/limits/<workload>.json`` (the limit of each number that
decides ``correct``) and ``benchmark/metrics/<metric>.py`` (a reader
``read(ctx)`` returning the value, or None where it finds nothing).

A run: set-up (data and weights from the seed, the program built, the
steps the reference follows, warm-up), the measured window of
``--seconds``, with ``--trace 1`` a traced stretch after it, then the
comparison with the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; its last key, ``checks``, gives
each compared number with its limit, which also close standard error.

Exits non-zero without a result where no CUDA card is there, or fewer
than the cell asks for, and where JAX or the JAX package got loaded.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's nvcc libraries go to gssd_torch/_build/ inside the checkout;
# transformers, where something imports it, must not load JAX
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "gssd_tpu"}


def process_start() -> float:
    """Seconds since this process started, from /proc (the host clock)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(*parts: str) -> Dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_of(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: Dict, kind: str, workload: str) -> List[Dict]:
    return [m for m in bench[kind] if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: Optional[Dict] = None, config: Optional[Dict] = None,
             traffic: Optional[Dict] = None, limits: Optional[Dict] = None,
             t_start: Optional[float] = None) -> Dict:
    """One run of ``workload`` -> the result dict (without printing).
    ``t_start``: the process's start on ``time.perf_counter``'s clock
    (default: now). Tests pass ``device`` 'cpu' and their own small
    ``config``, ``traffic`` and ``limits``."""
    import torch

    bench = bench or load_json("BENCHMARK.json")
    cell = cell_of(bench, workload)
    config = config or load_json("benchmark", "configs", f"{cell['config']}.json")
    traffic = traffic or load_json("benchmark", "traffic", f"{cell['traffic']}.json")
    limits = limits or load_json("benchmark", "limits", f"{workload}.json")
    t0 = time.perf_counter() if t_start is None else t_start
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}").Driver(
        config, traffic, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t0
    e2e = driver.window(seconds)
    e2e["setup_s"] = setup_s
    tr = driver.traced() if trace else None
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    result: Dict = {"correct": False, "attempted": e2e.pop("attempted"),
                    "failed": e2e.pop("failed"), "metrics": {}}
    kind = "per_layer" if trace else "end_to_end"
    flops: Dict[bool, float] = {}

    def model_flops(backward: bool) -> float:
        if backward not in flops:
            from benchmark.work import model_flops as count

            flops[backward] = count(config["model"], backward)
        return flops[backward]

    ctx = SimpleNamespace(config=config, model=config["model"], traffic=traffic,
                          batch=traffic["batch"], trace=tr, window=driver.window_stats,
                          e2e=e2e, model_flops=model_flops)
    for m in metrics_of(bench, kind, workload):
        value = e2e.get(m["name"]) if not trace else reader(m["name"])(ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    driver.release()
    numbers = driver.check()
    # a number that is not finite (NaN, inf) is printed as 1e30
    result["checks"] = {k: {"value": v if math.isfinite(v) else 1e30, "limit": limits[k]}
                        for k, v in numbers.items()}
    result["correct"] = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items()) \
        and result["failed"] == 0
    return result


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    cell = cell_of(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed % 2**63, args.seconds, bool(args.trace),
                      bench=bench, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
