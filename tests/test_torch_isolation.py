"""The port stands alone: gssd_torch and chip_smoke.py import nothing of
JAX, flax, gssd_tpu or the root train.py, and the entry points refuse to
fall back to the CPU without being asked. OpenCV is imported only inside
the functions of the four modules whose JAX counterparts call it (the
--visualize drawing, the VOC JPEG reader, and the preprocessing's mask
smoothing and resize), so that importing the port loads none."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "gssd_tpu", "train")
# the modules that may import cv2, inside their functions only
CV2_ALLOWED = ("gssd_torch/utils/visualize.py", "gssd_torch/data/voc.py",
               "gssd_torch/preprocessing/mask2bbox.py", "gssd_torch/preprocessing/snuh.py")
# the offline preprocessing and the legacy h5 reader (host programs)
PREPROCESSING = ("gssd_torch.preprocessing", *(
    f"gssd_torch.preprocessing.{m}" for m in (
        "windowing", "mask2bbox", "dicom_io", "builder", "snuh", "registration",
        "volume_io", "ircadb", "legacy_v1", "hygiene", "roi_bmp", "checker")),
    "gssd_torch.data.legacy_h5")


def _imports(tree):
    """(root module name, node) of every absolute import under ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name.split(".")[0], node) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], node


def _imported_roots(path):
    return {name for name, _ in _imports(ast.parse(path.read_text()))}


def test_sources_import_nothing_of_jax():
    files = sorted((ROOT / "gssd_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        allowed = {"cv2"} if str(f.relative_to(ROOT)) in CV2_ALLOWED else set()
        bad = _imported_roots(f) & (set(BLOCKED) - allowed)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_cv2_only_inside_functions_of_the_allowed_modules():
    for rel in CV2_ALLOWED:
        tree = ast.parse((ROOT / rel).read_text())
        inside = {id(node) for fn in ast.walk(tree)
                  if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for _, node in _imports(fn)}
        cv2 = [node for name, node in _imports(tree) if name == "cv2"]
        assert cv2 and all(id(node) in inside for node in cv2), rel
    # the decode and the native library stand in for OpenCV: neither calls it
    for f in [ROOT / "gssd_torch/eval/pixellink_decode.py",
              *sorted((ROOT / "gssd_torch/native").glob("*.py"))]:
        assert "cv2" not in _imported_roots(f), f


def test_imports_with_jax_blocked():
    # a None entry in sys.modules makes any import of that name fail
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import gssd_torch, gssd_torch.infer, gssd_torch.models, gssd_torch.params\n"
        "import gssd_torch.data, gssd_torch.ops.nms, gssd_torch.ops.kernels\n"
        "import gssd_torch.train, gssd_torch.train.trainer, gssd_torch.ops.losses\n"
        "import gssd_torch.ops.matcher, gssd_torch.data.augment\n"
        "import gssd_torch.eval, gssd_torch.eval.ap_iobb, gssd_torch.train.checkpoint\n"
        "import gssd_torch.utils.logging, gssd_torch.ops.deform_fused\n"
        "import gssd_torch.ops.kernels.deform_sample, gssd_torch.ops.kernels.stem_conv\n"
        "import gssd_torch.train_pixellink, gssd_torch.models.pixellink\n"
        "import gssd_torch.eval.pixellink_decode, gssd_torch.ops.pixellink_loss\n"
        "import gssd_torch.data.pixellink_targets, gssd_torch.data.dataset\n"
        "import gssd_torch.data.augment_device, gssd_torch.data.device_cache\n"
        "import gssd_torch.parallel, gssd_torch.parallel.folds\n"
        "import gssd_torch.models.fssd, gssd_torch.models.unet, gssd_torch.train_unet\n"
        "import gssd_torch.native, gssd_torch.native.build, gssd_torch.utils.visualize\n"
        "import gssd_torch.data.voc, gssd_torch.eval.voc_map, gssd_torch.train_voc\n"
        f"import {', '.join(PREPROCESSING)}\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "isolated" in res.stdout, res.stderr


def test_preprocessing_import_loads_no_opencv():
    # nothing blocked: importing the preprocessing loads no cv2 of its own
    code = (f"import sys\nimport {', '.join(PREPROCESSING)}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'cv2'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr


def test_default_device_refuses_cpu(monkeypatch, tmp_path):
    from gssd_torch import infer
    from gssd_torch.config import ModelConfig
    from gssd_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--weights", str(tmp_path / "none.pt"),
                    "--datapath", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(ModelConfig())


def _refuses_without_card(module, out, **env):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **env)
    res = subprocess.run([sys.executable, "-m", module, "--max_iter", "1",
                          "--output", str(out)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not list(out.iterdir())  # nothing generated or trained
    return res


def test_trainer_module_refuses_without_card(tmp_path):
    # python -m gssd_torch.train defaults to --device cuda: no card, no run
    _refuses_without_card("gssd_torch.train", tmp_path)


def test_pixellink_trainer_module_refuses_without_card(tmp_path):
    _refuses_without_card("gssd_torch.train_pixellink", tmp_path)


def test_voc_trainer_module_refuses_without_card(tmp_path):
    _refuses_without_card("gssd_torch.train_voc", tmp_path)


def test_unet_trainer_module_refuses_without_card(tmp_path):
    # python -m gssd_torch.train_unet defaults to --device cuda: no card, no
    # data generated, nothing trained; --device cpu is what runs here
    _refuses_without_card("gssd_torch.train_unet", tmp_path)


@pytest.mark.parametrize("module", ["gssd_torch.train", "gssd_torch.train_pixellink",
                                    "gssd_torch.train_voc"])
def test_data_parallel_trainer_refuses_without_card(module, tmp_path):
    # two ranks asked for on a host with no card: no run, and no gloo
    # ranks on the CPU in their place
    res = _refuses_without_card(module, tmp_path, GSSD_DP_DEVICES="2")
    assert "parallelism:" not in res.stdout


def test_parallel_modules_import_nothing_of_jax():
    code = ("import sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "import gssd_torch.parallel.mesh, gssd_torch.parallel.launch\n"
            "import gssd_torch.parallel.collectives, gssd_torch.native.build\n"
            "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "isolated" in res.stdout, res.stderr


def test_spawned_ranks_import_nothing_of_jax():
    # this process has JAX loaded; the ranks the launcher spawns do not
    from torch_ranks import loaded_roots

    from gssd_torch.parallel.launch import launch
    from gssd_torch.parallel.mesh import plan_parallelism

    ranks = launch(loaded_roots, plan_parallelism(1, 2, devices=["cpu"] * 2), deadline=240)
    for roots in ranks:
        assert "gssd_torch" in roots and "torch" in roots
        assert not set(roots) & set(BLOCKED), set(roots) & set(BLOCKED)


def test_chip_smoke_refuses_without_card(tmp_path):
    # no card here: fails, prints no result, and so does a lone copy
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
