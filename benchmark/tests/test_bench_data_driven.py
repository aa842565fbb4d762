"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files plus entries in BENCHMARK.json, and edits no file
of the harness: here in a copy of the benchmark, run on the CPU."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "benchmark").rglob("*.py"))}
    b = tmp_path / "benchmark"

    cfg = json.loads((b / "configs" / "gssdpp-300.json").read_text())
    cfg.update(name="gssd-f32", slices=4)
    cfg["model"].update(use_self_attention=False, use_self_attention_base=False,
                        num_dcn_layers=0, dcn_cat_sab=False, compute_dtype="float32")
    (b / "configs" / "gssd-f32.json").write_text(json.dumps(cfg))
    (b / "traffic" / "train-b2.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "source_size": 96, "max_lesions": 1, "check_steps": 1,
         "warm_steps": 0, "trace_steps": 1}))
    # the program in float32 sits far closer to float64 than bfloat16 rounding
    (b / "limits" / "gssd-f32.train-b2.json").write_text(json.dumps(
        {"grad": 0.5, "change": 0.5}))
    (b / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx.window['steps'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gssd-f32", "source": "test", "file":
                             "benchmark/configs/gssd-f32.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gssd-f32.train-b2", "config": "gssd-f32",
                               "traffic": "train-b2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "step dispatch",
                               "moves": "train_slices_per_s",
                               "workloads": ["gssd-f32.train-b2"]})
    bench["end_to_end"][0]["workloads"].append("gssd-f32.train-b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json\nfrom benchmark import run\n"
            "r = run.run_cell('gssd-f32.train-b2', 3, 0.01, True, device='cpu')\n"
            "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["steps_seen.train"]["value"] >= 1
    assert set(res["checks"]) == {"grad", "change"} and res["correct"], res["checks"]
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
