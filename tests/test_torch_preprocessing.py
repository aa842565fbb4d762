"""The offline preprocessing of the port (``gssd_torch.preprocessing``:
windowing, mask2bbox, dicom_io, builder, registration, volume_io,
ircadb) against gssd_tpu's, on the CPU.

Both sides run the same numpy and OpenCV calls, so the tolerance is
exact: every array equal, with equal dtypes and shapes (``assert_same``),
and every tree they write equal file by file, arrays compared array by
array (``assert_same_tree``: npy and h5 datasets by value, JPEGs by
their decoded pixels, other files by their bytes). Inputs are seeded
numpy fixtures of 16-64 px and a few slices, as the JAX package's own
tests size them. DICOM series go through a stand-in ``pydicom`` module
(``stub_pydicom``: each ``.dcm`` file is an npz of the pixels and the
tags ``read_dicom_series`` reads), so ``read_dicom_series`` itself runs;
with ``pydicom`` blocked both sides raise the same ``ImportError``. The
``Pool`` paths (``build_dataset(num_workers=2)``, ``snuh --workers 2``)
run in a fresh interpreter, which forks no JAX or torch threads.
"""

import os
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest
from PIL import Image

import gssd_torch.preprocessing as tp
import gssd_tpu.preprocessing as jp
from gssd_torch.preprocessing import builder as t_builder
from gssd_torch.preprocessing import dicom_io as t_dicom
from gssd_torch.preprocessing import ircadb as t_ircadb
from gssd_torch.preprocessing import registration as t_registration
from gssd_tpu.preprocessing import builder as j_builder
from gssd_tpu.preprocessing import dicom_io as j_dicom
from gssd_tpu.preprocessing import ircadb as j_ircadb
from gssd_tpu.preprocessing import registration as j_registration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# shared by the test_torch_{snuh,qa_tools,legacy_h5} files
# ---------------------------------------------------------------------------

def assert_same(got, want, where="value"):
    """Exact equality of two results: arrays of one dtype and shape with
    equal elements (NaN equal to NaN), recursively through tuples, lists
    and dicts; anything else by ==."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, (
            where, got.dtype, want.dtype, got.shape, want.shape)
        assert np.array_equal(got, want, equal_nan=got.dtype.kind in "fc"), where
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def same_outcome(fn_got, fn_want, *args, **kwargs):
    """Both calls return equal results, or both raise the same error type
    with the same message; returns the result (or the error)."""
    outcomes = []
    for fn in (fn_got, fn_want):
        try:
            outcomes.append(("ok", fn(*args, **kwargs)))
        except Exception as e:  # noqa: BLE001 - the error is the outcome compared
            outcomes.append(("raised", e))
    (kind_g, got), (kind_w, want) = outcomes
    assert kind_g == kind_w, (got, want)
    if kind_g == "raised":
        assert type(got) is type(want) and str(got) == str(want), (got, want)
    else:
        assert_same(got, want)
    return got


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
        layout = {name: (f[name].compression, f[name].compression_opts) for name in out}
    return out, layout


def assert_same_tree(got_dir, want_dir):
    """The same relative file names, and each file the same content."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, n), d)
                      for r, _, ns in os.walk(d) for n in ns)

    names = files(want_dir)
    assert files(got_dir) == names
    assert names, want_dir
    for rel in names:
        g, w = os.path.join(got_dir, rel), os.path.join(want_dir, rel)
        if rel.endswith(".npy"):
            assert_same(np.load(g), np.load(w), rel)
        elif rel.endswith(".h5"):
            assert_same(_h5_arrays(g), _h5_arrays(w), rel)
        elif rel.endswith(".jpg"):
            with Image.open(g) as a, Image.open(w) as b:
                assert a.mode == b.mode
                assert_same(np.asarray(a), np.asarray(b), rel)
        else:
            with open(g, "rb") as a, open(w, "rb") as b:
                assert a.read() == b.read(), rel


def stub_pydicom():
    """A stand-in ``pydicom`` whose ``dcmread`` reads the npz written by
    ``write_dicom_slice``: ``pixel_array`` and the tags stored with it."""
    mod = types.ModuleType("pydicom")

    def dcmread(path):
        with np.load(path) as z:
            ds = types.SimpleNamespace(pixel_array=z["pixel_array"])
            for tag in z.files:
                if tag != "pixel_array":
                    setattr(ds, tag, z[tag].item())
        return ds

    mod.dcmread = dcmread
    return mod


def write_dicom_slice(path, pixels, **tags):
    with open(path, "wb") as f:  # a file object: np.savez adds no suffix
        np.savez(f, pixel_array=pixels, **{k: np.asarray(v) for k, v in tags.items()})


def write_dicom_series(directory, prefix, vol, slope=1.0, intercept=0.0):
    """[H, W, Z] -> ``<prefix><n>.dcm`` for n = 1..Z (natural order, not
    lexicographic, past 9), InstanceNumber n, and the rescale tags."""
    os.makedirs(directory, exist_ok=True)
    for z in range(vol.shape[2]):
        write_dicom_slice(os.path.join(directory, f"{prefix}{z + 1}.dcm"), vol[:, :, z],
                          InstanceNumber=z + 1, RescaleSlope=slope,
                          RescaleIntercept=intercept)


# a raw SNUH drop (tests/test_torch_snuh.py; the Pool test here)
H = 48
PHASES = ("A", "D", "P", "Pre")
# subject, z, pivot phase, mask id, lesions, deltas (A, D, P, Pre); the
# third subject's "A1_Pre" masks share the first's id: a bare prefix match
# of "A1_P" would take them too
SUBJECTS = (("HCC_1104", 8, "P", "A1", 2, (1, 0, 2, 3)),
            ("HCC_1105", 9, "A", "A2", 1, (3, 2, 0, 1)),
            ("HCC_1106", 7, "Pre", "A1", 1, (0, 4, 1, 1)))


def npy_series_reader(directory, pattern):
    return np.load(os.path.join(directory, pattern.split("*")[0] + "vol.npy"))


def make_drop(root, dicom=False, seed=7):
    """A raw drop in the layout of the snuh module's docstring, H x H:
    per-phase int16 volumes (``<phase>_vol.npy``, or with ``dicom`` a
    stand-in DICOM series ``<phase>_<n>.dcm``), uint8 raw masks with
    ``delta`` extra leading slices, and the tab-separated metadata."""
    rng = np.random.default_rng(seed)
    rows = []
    mdir = os.path.join(root, "segmentation_mask")
    os.makedirs(mdir, exist_ok=True)
    for subject, z, pivot, mask_id, n_lesions, deltas in SUBJECTS:
        for phase in PHASES:
            d = os.path.join(root, "dicom_image", subject, phase)
            vol = rng.integers(-1000, 200, (H, H, z)).astype(np.int16)
            vol[12:28, 16:32, 2:6] = 80
            if dicom:
                write_dicom_series(d, phase + "_", vol)
            else:
                os.makedirs(d)
                np.save(os.path.join(d, f"{phase}_vol.npy"), vol)
        delta = deltas[PHASES.index(pivot)]
        for li in range(n_lesions):
            m = np.zeros((H, H, z + delta), np.uint8)
            y0 = 8 + 18 * li
            m[y0:y0 + 12, 14 + 4 * li:30, 2 + delta:6 + delta] = 1
            suffix = str(li + 1) if n_lesions > 1 else ""
            m.transpose(2, 0, 1).tofile(os.path.join(mdir, f"{mask_id}_{pivot}{suffix}.raw"))
        rows.append("\t".join([subject, *map(str, deltas), pivot, mask_id]))
    with open(os.path.join(root, "metadata.txt"), "w") as f:
        f.write("ID\tDelta_A\tDelta_D\tDelta_P\tDelta_Pre\tMask_Phase\tMask_ID\n"
                + "\n".join(rows) + "\n")
    return root


# ---------------------------------------------------------------------------
# windowing
# ---------------------------------------------------------------------------

def _hu(rng, shape=(24, 20), lo=-1000, hi=400, dtype=np.int16):
    return rng.integers(lo, hi, shape).astype(dtype)


def _window_cases():
    rng = np.random.default_rng(0)
    plain = _hu(rng)
    artifact = _hu(rng)
    artifact.flat[:2] = (-3024, 1166)  # the scanner-artifact range
    pad2000 = _hu(rng)
    pad2000.flat[:3] = -2000  # out-of-FOV padding
    pad2048 = _hu(rng).astype(np.float32)
    pad2048.flat[:3] = -2048
    extreme = _hu(rng)
    extreme.flat[0] = -3000  # below -2000: warn and zero the negatives
    coded = _hu(rng, lo=0, hi=2048)  # intensity-coded: mean > 0 shifts by -1024
    bright = _hu(rng, lo=-1000, hi=1500).astype(np.float64)  # > 1200 zeroed
    return {"plain": plain, "artifact": artifact, "pad2000": pad2000, "pad2048": pad2048,
            "extreme": extreme, "coded": coded, "bright": bright}


@pytest.mark.parametrize("case", sorted(_window_cases()))
@pytest.mark.parametrize("window", [(400.0, 50.0), (350.0, 40.0)])
def test_apply_window_matches_jax(case, window, capsys):
    img = _window_cases()[case]
    before = img.copy()
    want = jp.apply_window(img, *window)
    want_out = capsys.readouterr().out
    got = tp.apply_window(img, *window)
    assert capsys.readouterr().out == want_out
    assert ("WARNING" in want_out) == (case == "extreme")
    assert_same(got, want)
    assert_same(img, before)  # the input is not written


def test_normalize_and_ircadb_window_match_jax():
    rng = np.random.default_rng(1)
    phases = rng.normal(0, 300, (4, 16, 16, 3)).astype(np.float32)
    assert_same(tp.window_and_normalize(phases), jp.window_and_normalize(phases))
    assert_same(tp.window_and_normalize(list(phases), 300, 20),
                jp.window_and_normalize(list(phases), 300, 20))
    same_outcome(tp.normalize01, jp.normalize01, phases[0])
    same_outcome(tp.normalize01, jp.normalize01, np.full((4, 4), 3.0))  # raises
    img = rng.integers(-600, 1400, (16, 16)).astype(np.int16)
    assert_same(tp.ircadb_window(img), jp.ircadb_window(img))


# ---------------------------------------------------------------------------
# mask2bbox
# ---------------------------------------------------------------------------

def _disk(h, cy, cx, r):
    yy, xx = np.mgrid[0:h, 0:h]
    return (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.uint8)


def _masks():
    rng = np.random.default_rng(2)
    ragged = (rng.uniform(size=(48, 48)) < 0.08).astype(np.uint8)
    ragged[10:30, 12:26] = 1
    return {"one": _disk(64, 30, 35, 9), "two": _disk(64, 30, 35, 9) | _disk(64, 12, 10, 6),
            "ragged": ragged, "empty": np.zeros((32, 32), np.uint8),
            "speck": np.pad(np.ones((1, 1), np.uint8), 15),  # smoothing removes it
            "not_binary": (_disk(32, 16, 16, 5) * 2).astype(np.uint8)}


@pytest.mark.parametrize("case", sorted(_masks()))
@pytest.mark.parametrize("smooth", [True, False])
def test_mask_slice_to_boxes_matches_jax(case, smooth):
    m = _masks()[case]
    want = jp.mask_slice_to_boxes(m, smooth=smooth)
    assert_same(tp.mask_slice_to_boxes(m, smooth=smooth), want)
    if case == "two":
        assert want[0].shape == (2, 5)


def _volume(rng, h=48, z=6):
    mask = np.zeros((h, h, z), np.uint8)
    for k in range(1, z - 1):
        mask[:, :, k] = _disk(h, 14 + 3 * k, 20, 7)
    mask[:, :, 3] |= _disk(h, 36, 36, 5)
    phases = rng.integers(-1000, 300, (4, h, h, z)).astype(np.int16)
    return phases, mask


def test_volume_to_samples_matches_jax():
    phases, mask = _volume(np.random.default_rng(3))
    norm = np.stack(jp.window_and_normalize(list(phases)))
    want = jp.volume_to_samples(norm, mask)
    assert len(want) == 4  # the interior slices with a lesion
    assert_same(tp.volume_to_samples(norm, mask), want)


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _subjects(n=3):
    rng = np.random.default_rng(4)
    return {f"s{i:02d}": _volume(rng) for i in range(n)}


@pytest.mark.parametrize("window", [True, False])
def test_build_dataset_matches_jax(tmp_path, window):
    subjects = _subjects()
    if not window:  # already windowed volumes, as extract_to_ml_ready passes
        subjects = {k: (np.stack(jp.window_and_normalize(list(p))), m)
                    for k, (p, m) in subjects.items()}
    lines = [mod.build_dataset(str(tmp_path / name), subjects, window=window)
             for mod, name in ((t_builder, "got"), (j_builder, "want"))]
    assert lines[0] == lines[1] and len(lines[0]) == 12
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))
    p, m = subjects["s01"]
    assert_same(t_builder.build_subject(str(tmp_path / "got"), "x", p, m, window),
                j_builder.build_subject(str(tmp_path / "want"), "x", p, m, window))


POOL_SCRIPT = r"""
import os, sys
import numpy as np
sys.path.insert(0, {tests!r})
from test_torch_preprocessing import _subjects, make_drop, stub_pydicom
sys.modules["pydicom"] = stub_pydicom()
from gssd_torch.preprocessing import builder as tb, snuh as ts
from gssd_tpu.preprocessing import builder as jb, snuh as js
out = {out!r}
for name, mod in (("got", tb), ("want", jb)):
    print(name, mod.build_dataset(os.path.join(out, "builder", name), _subjects(), num_workers=2))
drop = make_drop(os.path.join(out, "drop"), dicom=True)
for name, mod in (("got", ts), ("want", js)):
    mod.main(["--datapath", drop, "--output", os.path.join(out, "snuh", name), "--img_size",
              "48", "--workers", "2"])
"""


def test_pool_paths_match_jax(tmp_path):
    """build_dataset(num_workers=2) and ``snuh --workers 2`` (its Pool runs
    only without a series_reader: the stub pydicom reads the series)."""
    code = POOL_SCRIPT.format(tests=os.path.join(ROOT, "tests"), out=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got, want = [line.split(" ", 1)[1] for line in res.stdout.splitlines()
                 if line.startswith(("got ", "want "))]
    assert got == want and "s02_3|s02" in got
    for part in ("builder", "snuh"):
        assert_same_tree(str(tmp_path / part / "got"), str(tmp_path / part / "want"))
    assert os.path.isdir(tmp_path / "snuh" / "got" / "HCC_1104")


# ---------------------------------------------------------------------------
# dicom_io
# ---------------------------------------------------------------------------

def test_natsort_and_raw_mask_match_jax(tmp_path):
    names = ["P_10.dcm", "P_2.dcm", "P_1.dcm", "Pre_3", "a11b2", "a2b10"]
    assert sorted(names, key=t_dicom.natsort_key) == sorted(names, key=j_dicom.natsort_key)
    rng = np.random.default_rng(5)
    vol = (rng.uniform(size=(3, 16, 24)) < 0.3).astype(np.uint8) * 255
    vol[0, 0, :4] = 1
    path = str(tmp_path / "m.raw")
    vol.tofile(path)
    assert_same(t_dicom.read_raw_mask(path, 16, 24), j_dicom.read_raw_mask(path, 16, 24))
    same_outcome(t_dicom.read_raw_mask, j_dicom.read_raw_mask, path, 16, 25)  # not divisible
    bad = vol.copy()
    bad[1, 1, 1] = 7
    bad.tofile(path)
    same_outcome(t_dicom.read_raw_mask, j_dicom.read_raw_mask, path, 16, 24)  # not binary


@pytest.mark.parametrize("rescale", [(1.0, 0.0), (1.0, -1024.0), (0.5, 10.0)])
def test_read_dicom_series_matches_jax(tmp_path, monkeypatch, rescale):
    rng = np.random.default_rng(6)
    vol = rng.integers(0, 2000, (12, 10, 11)).astype(np.uint16)
    d = str(tmp_path / "P")
    write_dicom_series(d, "P_", vol, *rescale)
    (tmp_path / "P" / "notes").mkdir()  # a directory among the files is skipped
    monkeypatch.setitem(sys.modules, "pydicom", stub_pydicom())
    want = j_dicom.read_dicom_series(d, "P_*")
    assert want.shape == (12, 10, 11) and want.dtype == np.int16
    assert_same(t_dicom.read_dicom_series(d, "P_*"), want)
    same_outcome(t_dicom.read_dicom_series, j_dicom.read_dicom_series, d + "_missing")


def test_gated_readers_raise_import_error(monkeypatch):
    for name in ("pydicom", "SimpleITK", "nibabel", "vtk"):
        monkeypatch.setitem(sys.modules, name, None)
    e = same_outcome(t_dicom.read_dicom_series, j_dicom.read_dicom_series, "/nonexistent")
    assert isinstance(e, ImportError) and "pydicom" in str(e)
    for fn in ("register_slice_to_portal", "register_volume_to_portal"):
        e = same_outcome(getattr(t_registration, fn), getattr(j_registration, fn),
                         np.zeros((4, 8, 8, 2)))
        assert isinstance(e, ImportError) and "SimpleITK" in str(e)
    for fn, dep in (("load_nii_volume", "nibabel"), ("load_vtk_mesh_points", "vtk")):
        e = same_outcome(getattr(tp, fn), getattr(jp, fn), "/nonexistent")
        assert isinstance(e, ImportError) and dep in str(e)


# ---------------------------------------------------------------------------
# volume_io
# ---------------------------------------------------------------------------

def test_volume_io_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    vol = rng.normal(0, 200, (12, 9, 3)).astype(np.float32)
    assert_same(tp.canonicalize_nii_orientation(vol), jp.canonicalize_nii_orientation(vol))
    for name, mod in (("got", tp), ("want", jp)):
        paths = mod.dump_volume_slices(vol, str(tmp_path / name), prefix="lbl_")
        assert [os.path.basename(p) for p in paths] == ["lbl_0.jpg", "lbl_1.jpg", "lbl_2.jpg"]
    flat = np.zeros((6, 5, 2))  # constant volume: scale 0
    tp.dump_volume_slices(flat, str(tmp_path / "got"), prefix="flat_")
    jp.dump_volume_slices(flat, str(tmp_path / "want"), prefix="flat_")
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))


# ---------------------------------------------------------------------------
# ircadb
# ---------------------------------------------------------------------------

def _ircadb_tree(root, rng, h=32, z=6):
    """3Dircadb patients as .npy series: PATIENT_DICOM, and MASKS_DICOM
    with two tumor masks and a liver mask (not merged)."""
    for p in ("3Dircadb1.1", "3Dircadb1.2"):
        pdir = os.path.join(root, p)
        os.makedirs(os.path.join(pdir, "PATIENT_DICOM"))
        np.save(os.path.join(pdir, "PATIENT_DICOM", "vol.npy"),
                rng.integers(-1000, 1500, (h, h, z)).astype(np.int16))
        for k, name in enumerate(("livertumor01", "livertumor02", "liver")):
            os.makedirs(os.path.join(pdir, "MASKS_DICOM", name))
            m = np.zeros((h, h, z), np.int16)
            m[6 + 10 * k:14 + 10 * k, 8:20, 1:5] = 255
            np.save(os.path.join(pdir, "MASKS_DICOM", name, "vol.npy"), m)
    os.makedirs(os.path.join(root, "empty", "MASKS_DICOM", "liver"))
    return [os.path.join(root, p) for p in ("3Dircadb1.1", "3Dircadb1.2")]


@pytest.fixture()
def npy_series(monkeypatch):
    """One npy series reader in place of read_dicom_series in both
    packages' ircadb modules."""
    def read(directory, filepattern="*"):
        return np.load(os.path.join(directory, "vol.npy"))

    monkeypatch.setattr(t_ircadb, "read_dicom_series", read)
    monkeypatch.setattr(j_ircadb, "read_dicom_series", read)


def test_ircadb_matches_jax(tmp_path, npy_series):
    patients = _ircadb_tree(str(tmp_path / "raw"), np.random.default_rng(8))
    assert_same(t_ircadb.extract_patient(patients[0]), j_ircadb.extract_patient(patients[0]))
    same_outcome(t_ircadb.read_liver_lesion_masks, j_ircadb.read_liver_lesion_masks,
                 str(tmp_path / "raw" / "empty" / "MASKS_DICOM"))  # no tumor: raises
    lines = [mod.extract_to_ml_ready(patients, str(tmp_path / "ml" / name))
             for mod, name in ((t_ircadb, "got"), (j_ircadb, "want"))]
    assert lines[0] == lines[1] and "3Dircadb1_1_0|3Dircadb1_1" in lines[0]
    assert_same_tree(str(tmp_path / "ml" / "got"), str(tmp_path / "ml" / "want"))
    for name, mod in (("got", t_ircadb), ("want", j_ircadb)):
        os.makedirs(tmp_path / "h5" / name)
        mod.extract_to_h5(patients[1], str(tmp_path / "h5" / name / "p2.h5"))
    assert_same_tree(str(tmp_path / "h5" / "got"), str(tmp_path / "h5" / "want"))
    arrays, _ = _h5_arrays(str(tmp_path / "h5" / "got" / "p2.h5"))
    assert arrays["ct/ct_0"].shape == (4, 4, 3, 32, 32)


def test_the_five_clis_run_as_modules():
    """``python -m gssd_torch.preprocessing.<name> --help`` for the five
    CLIs (run as ``-m`` does, in one fresh interpreter)."""
    code = ("import runpy, sys\n"
            "for name in ('snuh', 'legacy_v1', 'hygiene', 'roi_bmp', 'checker'):\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module(f'gssd_torch.preprocessing.{name}', run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        print(name, e.code)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    codes = [line for line in res.stdout.splitlines() if line.endswith((" 0", " 2"))]
    assert codes == ["snuh 0", "legacy_v1 0", "hygiene 0", "roi_bmp 0", "checker 0"]
    assert "--datapath" in res.stdout and "fix-structure" in res.stdout
