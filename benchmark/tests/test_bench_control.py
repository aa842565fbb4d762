"""The control: the plain reference put in the program's place in fp8,
the precision below the configuration's bfloat16 (on the CPU, at a small
size; on the card at the cell's own size through
``python3 -m benchmark.control``). It fails the cell's own limits, and so
does the planted half batch of training."""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_bench_faults import INFER, TRAIN, small  # noqa: E402

from benchmark import run  # noqa: E402


def fails(workload, numbers):
    limits = run.load_json("benchmark", "limits", f"{workload}.json")
    return any(v > limits[k] for k, v in numbers.items())


def control_of(workload, seed):
    import importlib

    s = small(workload)
    driver = importlib.import_module(f"benchmark.drivers.{s['traffic']['kind']}").Driver(
        s["config"], s["traffic"], seed, "cpu")
    driver.setup()
    driver.window(0.01)
    driver.release()
    driver.check()
    return driver.control()


def test_training_control_reads_past_bf16_and_half_batch_fails():
    out = control_of(TRAIN, 2**31 + 3)
    assert fails(TRAIN, out["fp8"]), out["fp8"]
    assert fails(TRAIN, out["half_batch"]), out["half_batch"]


def test_serving_control_fails():
    out = control_of(INFER, 2**31 + 4)
    assert fails(INFER, out["fp8"]), out["fp8"]
