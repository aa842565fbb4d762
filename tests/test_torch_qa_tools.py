"""The annotation and QA tools of the port (``gssd_torch.preprocessing.
roi_bmp``, ``checker``, ``hygiene``) against gssd_tpu's, on the CPU, on
the fixtures of tests/test_qa_tools.py, exact (``assert_same``,
``same_outcome``, ``assert_same_tree`` of tests/test_torch_preprocessing.py):
each result or error, each printed report, and each CLI's ``main(argv)``
writing the same tree (bmp files read by PIL, DICOM series through the
stand-in pydicom, raw masks from disk). The contact sheets' noise fill
keeps ``default_rng(i_slice)``, so they match bit for bit too."""

import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image
from test_qa_tools import _box_image, _mask, _vol
from test_torch_preprocessing import (assert_same, assert_same_tree, same_outcome, stub_pydicom,
                                      write_dicom_series)

from gssd_torch.preprocessing import checker as tc
from gssd_torch.preprocessing import hygiene as th
from gssd_torch.preprocessing import roi_bmp as tr
from gssd_tpu.preprocessing import checker as jc
from gssd_tpu.preprocessing import hygiene as jh
from gssd_tpu.preprocessing import roi_bmp as jr

YELLOW, RED = jr.RGB_YELLOW, jr.RGB_RED


def _printed(capsys, tmp_path, name):
    return capsys.readouterr().out.replace(str(tmp_path / name), "<out>")


# ---------------------------------------------------------------------------
# roi_bmp
# ---------------------------------------------------------------------------

def _roi_cases():
    a258 = _box_image(5, 10, 30, 40, RED)
    a258[48:52, 45:55] = YELLOW
    rgba = np.concatenate([_box_image(3, 4, 9, 12, RED, size=16),
                           np.full((16, 16, 1), 255, np.uint8)], axis=-1)
    line = np.zeros((16, 16, 3), np.uint8)
    line[5, 2:9] = YELLOW  # zero height
    return {"yellow": (_box_image(5, 10, 30, 40, YELLOW), False),
            "red": (_box_image(12, 3, 20, 22, RED), False),
            "both": (_box_image(5, 10, 30, 40, RED, extra=(50, 50, YELLOW)), False),
            "a258": (a258, True), "none": (np.zeros((32, 32, 3), np.uint8), False),
            "none_allowed": (np.zeros((32, 32, 3), np.uint8), True),
            "rgba": (rgba, False), "gray": (np.zeros((16, 16), np.uint8), False),
            "degenerate": (line, False)}


@pytest.mark.parametrize("case", sorted(_roi_cases()))
def test_extract_roi_box_matches_jax(case):
    img, both = _roi_cases()[case]
    same_outcome(tr.extract_roi_box, jr.extract_roi_box, img, allow_both_colors=both)


def _bmp_tree(root):
    """<root>/<subject>/<phase>/<phase>_<nnnn>.bmp, RGB bmp files; A196 is
    on the skip list, A258 carries both colours."""
    colours = {"A1": YELLOW, "A2": RED, "A196": RED, "A258": RED}
    for s, (subject, colour) in enumerate(colours.items()):
        for phase in ("A", "P"):
            d = os.path.join(root, subject, phase)
            os.makedirs(d)
            for k in range(2):
                img = _box_image(4 + s + k, 6 + k, 20 + s, 25 + 2 * k, colour)
                if subject == "A258":
                    img[40:44, 30:41] = YELLOW
                Image.fromarray(img).save(os.path.join(d, f"{phase}_{7 + 5 * k:04d}.bmp"))
    return root


def test_roi_cli_matches_jax(tmp_path, capsys):
    """``python -m gssd_torch.preprocessing.roi_bmp`` on bmp files (PIL)."""
    root = _bmp_tree(str(tmp_path / "roi_image"))
    printed = []
    for name, mod in (("got", tr), ("want", jr)):
        mod.main(["--roi_image_path", root, "--roi_coordinate_path", str(tmp_path / name)])
        printed.append(_printed(capsys, tmp_path, name))
    assert printed[0] == printed[1] == "wrote 12 coordinate files to <out>\n"
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))
    assert not (tmp_path / "got" / "A196").exists()
    assert sorted(os.listdir(tmp_path / "got" / "A258" / "P")) == ["P_0007.txt", "P_0012.txt"]


def test_roi_tree_with_injected_reader_matches_jax(tmp_path):
    root = _bmp_tree(str(tmp_path / "roi_image"))
    images = {}
    for r, _, names in os.walk(root):
        for n in names:
            with Image.open(os.path.join(r, n)) as im:
                images[os.path.join(r, n)] = np.asarray(im.convert("RGB"))
    counts = [mod.extract_roi_tree(root, str(tmp_path / name), skip_subjects=("A2",),
                                   both_colors_ok=("A258", "A196"),
                                   image_reader=images.__getitem__)
              for mod, name in ((tr, "got"), (jr, "want"))]
    assert counts == [12, 12]
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))


# ---------------------------------------------------------------------------
# checker
# ---------------------------------------------------------------------------

def _year1_readers(phase_z, masks):
    def sread(directory, pattern):
        ph = os.path.basename(directory)
        if ph not in phase_z:
            raise FileNotFoundError(directory)
        return _vol(phase_z[ph])

    def mread(path):
        name = os.path.basename(path)
        if name not in masks:
            raise ValueError(f"unreadable {name}")
        return masks[name]

    return sread, mread


def _disjoint():
    m2 = np.zeros((16, 16, 10), np.uint8)
    m2[10:12, 10:12, :] = 1
    return m2


@pytest.mark.parametrize("case", ["clean", "mismatch_overlap", "mask_z", "missing_mask",
                                  "unreadable", "non_binary"])
def test_check_year1_extended_matches_jax(tmp_path, case):
    mask_dir = tmp_path / "segmentation_mask"
    mask_dir.mkdir()
    for n in ("A1_P1.raw", "A1_P2.raw", "A1_Pre.raw", "B2_D.raw"):
        (mask_dir / n).write_bytes(b"")
    phase_z = {ph: 10 for ph in ("A", "D", "P", "Pre")}
    masks = {"A1_P1.raw": _mask(10), "A1_P2.raw": _disjoint(), "A1_Pre.raw": _mask(10),
             "B2_D.raw": _mask(10)}
    pairs = [("HCC_1", "A1", "P"), ("HCC_2", "B2", "D")]
    if case == "mismatch_overlap":
        phase_z["D"] = 12
        masks["A1_P2.raw"] = _mask(10)  # the same lesion twice
    elif case == "mask_z":
        masks["A1_P2.raw"] = _disjoint()[:, :, :9]  # the merge raises on both sides
    elif case == "missing_mask":
        pairs.append(("HCC_9", "A9", "A"))
    elif case == "unreadable":
        del masks["B2_D.raw"]
    elif case == "non_binary":
        masks["B2_D.raw"] = _mask(10) * 3
    sread, mread = _year1_readers(phase_z, masks)
    want = same_outcome(tc.check_year1_extended, jc.check_year1_extended, str(tmp_path), pairs,
                        series_reader=sread, mask_reader=mread)
    if case == "mask_z":
        assert isinstance(want, ValueError)
        return
    # the prefix match of the checker (unlike snuh's) takes A1_Pre for A1_P
    assert want[0]["mask_names"] == ["A1_P1.raw", "A1_P2.raw", "A1_Pre.raw"]
    assert bool(want[-1]["findings"]) == (case != "clean")


@pytest.mark.parametrize("case", ["clean", "fixable", "not_fixable", "shapes_zero_hu",
                                  "mask_z", "missing"])
def test_check_year2_matches_jax(tmp_path, case):
    for s in ("S1", "S2"):
        (tmp_path / s).mkdir()
    (tmp_path / "notes.txt").write_text("not a subject")

    def sread(directory, pattern):
        if case == "missing" and "S2" in directory and "pre-CT" in directory:
            raise FileNotFoundError(directory)
        z = 8 if (case == "shapes_zero_hu" and "pre-CT" in directory) else 9
        return _vol(z, fill=0 if case == "shapes_zero_hu" else -500 + len(pattern))

    def mread(path):
        m = _mask(7 if case == "mask_z" else 9)
        if case in ("fixable", "not_fixable") and "S2" in path:
            m[0, 0, 0] = 10 if case == "fixable" else 7
        return m

    want = same_outcome(tc.check_year2, jc.check_year2, str(tmp_path), series_reader=sread,
                        mask_reader=mread, window=(350.0, 40.0))
    assert [r["subject"] for r in want] == ["S1", "S2"]


@pytest.mark.parametrize("i_slice", [0, 2, 3, 99])
def test_contact_sheets_match_jax(i_slice):
    rng = np.random.default_rng(9)
    phases = [rng.normal(0, 100, (8, 8, 4)) for _ in range(3)] + [np.full((8, 8, 2), 5.0)]
    mask = _mask(3, 8, 8)
    assert_same(tc.contact_sheet(phases, mask, i_slice), jc.contact_sheet(phases, mask, i_slice))
    assert_same(tc.contact_sheet_year2(phases, phases[::-1], mask, i_slice),
                jc.contact_sheet_year2(phases, phases[::-1], mask, i_slice))


def test_load_pair_list_matches_jax(tmp_path):
    p = tmp_path / "pairs.txt"
    p.write_text("HCC_1106\tA1\tA\nHCC_1107 A20 A\n\n  \n")
    assert tc.load_pair_list(str(p)) == jc.load_pair_list(str(p)) == [
        ("HCC_1106", "A1", "A"), ("HCC_1107", "A20", "A")]


def _qa_drop(root, rng):
    """The checker CLI's two layouts at 512 x 512 (its raw-mask reader's
    default size): year1 dicom_image/segmentation_mask with the pair
    list, year2 <subject>/{pre-CT,CT}/<phase> with <subject>_D.raw."""
    def mask(z):
        m = np.zeros((512, 512, z), np.uint8)
        m[100:140, 200:260, :] = 1
        return m

    y1, y2 = os.path.join(root, "y1"), os.path.join(root, "y2")
    os.makedirs(os.path.join(y1, "segmentation_mask"))
    for subject, mask_id, z in (("HCC_1", "A1", 3), ("HCC_2", "A2", 2)):
        for ph in ("A", "D", "P", "Pre"):
            extra = int(subject == "HCC_2" and ph == "D")  # HCC_2's phases disagree on z
            write_dicom_series(os.path.join(y1, "dicom_image", subject, ph), ph + "_",
                               rng.integers(-900, 300, (16, 16, z + extra)))
        mask(z).transpose(2, 0, 1).tofile(os.path.join(y1, "segmentation_mask",
                                                       f"{mask_id}_P.raw"))
    with open(os.path.join(y1, "image_mask_pair_list.txt"), "w") as f:
        f.write("HCC_1 A1 P\nHCC_2 A2 P\nHCC_3 A3 P\n")
    for subject, z in (("S1", 2), ("S2", 3)):
        for part in ("pre-CT", "CT"):
            for ph in ("A", "D", "P", "Pre"):
                write_dicom_series(os.path.join(y2, subject, part, ph), ph + "_",
                                   rng.integers(-900, 300, (512, 512, z)).astype(np.int16))
        mask(z).transpose(2, 0, 1).tofile(os.path.join(y2, subject, f"{subject}_D.raw"))
    return y1, y2


def test_checker_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Both flavours of ``python -m gssd_torch.preprocessing.checker``; year2
    with --save_sheets (a JPEG a slice)."""
    y1, y2 = _qa_drop(str(tmp_path / "raw"), np.random.default_rng(10))
    monkeypatch.setitem(sys.modules, "pydicom", stub_pydicom())
    printed = []
    for name, mod in (("got", tc), ("want", jc)):
        mod.main(["--datapath", y1, "--flavor", "year1_extended"])
        mod.main(["--datapath", y2, "--flavor", "year2", "--save_sheets",
                  str(tmp_path / name)])
        printed.append(_printed(capsys, tmp_path, name))
    assert printed[0] == printed[1]
    assert "1/3 subjects clean" in printed[0] and "2/2 subjects clean" in printed[0]
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))
    assert sorted(os.listdir(tmp_path / "got" / "S2")) == ["0.jpg", "1.jpg", "2.jpg"]


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def _messy_drop(root):
    """ct and roi trees with V/LA phases, a P+V collision and a subject
    missing from the roi tree."""
    for tree in ("ct", "roi"):
        for subject, phases in (("S1", ("V", "A")), ("S2", ("P", "V")), ("S3", ("LA", "D"))):
            if tree == "roi" and subject == "S3":
                continue
            for ph in phases:
                d = os.path.join(root, tree, subject, ph)
                os.makedirs(d)
                for k in range(2):
                    with open(os.path.join(d, f"{ph}_{k:04d}.DCM"), "w") as f:
                        f.write(f"{tree}{subject}{ph}{k}")
    open(os.path.join(root, "ct", "README"), "w").close()  # a file among the subjects
    return root


def test_fix_drop_structure_matches_jax(tmp_path, capsys):
    _messy_drop(str(tmp_path / "want"))
    shutil.copytree(tmp_path / "want", tmp_path / "got")
    reports = [mod.fix_drop_structure(str(tmp_path / name / "ct"), str(tmp_path / name / "roi"))
               for mod, name in ((th, "got"), (jh, "want"))]
    assert_same(reports[0], reports[1])
    assert "*" in reports[0] and "both" in reports[0]["S2"][0]
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))
    assert sorted(os.listdir(tmp_path / "got" / "ct" / "S3" / "A")) == ["A_0000.DCM",
                                                                         "A_0001.DCM"]


def _aligned_set(root, rng):
    src, orig = os.path.join(root, "align"), os.path.join(root, "orig")
    for d in (src, orig):
        os.makedirs(os.path.join(d, "S1"))
    with open(os.path.join(orig, "metadata.txt"), "w") as f:
        f.write("S1/S1_0|S1\nS1/S1_1|S1\nS1/S1_2|S1\nflat_0|flat\n\n")
    for k, n_orig in enumerate((2, 1)):
        ct = rng.uniform(-0.3, 1.3, (4, 3, 16, 16)).astype(np.float32)
        mask = np.zeros((16, 16), np.float32)
        mask[2:6, 2:6] = 0.9
        mask[9:12, 9:13] = 0.4 + 0.3 * k  # survives the 0.5 cut only for k = 1
        np.save(os.path.join(src, "S1", f"S1_{k}_ct.npy"), ct)
        np.save(os.path.join(src, "S1", f"S1_{k}_mask.npy"), mask)
        np.save(os.path.join(orig, "S1", f"S1_{k}_bbox.npy"), np.zeros((n_orig, 5), np.float32))
    np.save(os.path.join(src, "flat_0_ct.npy"), np.ones((4, 3, 8, 8), np.float32))
    np.save(os.path.join(src, "flat_0_mask.npy"), np.zeros((8, 8), np.float32))  # no lesion
    return src, orig


def test_clean_sample_and_aligned_set_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(11)
    ct = rng.uniform(-0.5, 1.5, (4, 3, 8, 8))
    mask = rng.uniform(0, 1, (32, 32))
    same_outcome(th.clean_sample, jh.clean_sample, ct, mask)
    same_outcome(th.clean_sample, jh.clean_sample, ct, np.zeros((8, 8)))
    src, orig = _aligned_set(str(tmp_path / "raw"), rng)
    warnings = [mod.clean_aligned_set(os.path.join(orig, "metadata.txt"), src,
                                      str(tmp_path / name))
                for mod, name in ((th, "got"), (jh, "want"))]
    assert warnings[0] == warnings[1] == ["S1/S1_0: lesion count 2 -> 1",
                                          "S1/S1_1: lesion count 1 -> 2"]
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))
    printed = []
    for name, mod in (("got", th), ("want", jh)):
        mod.main(["clean-aligned", "--metadata", os.path.join(orig, "metadata.txt"), "--src",
                  src, "--out", str(tmp_path / f"cli_{name}"), "--orig", orig])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0].endswith("done (2 lesion-count changes)\n")
    assert_same_tree(str(tmp_path / "cli_got"), str(tmp_path / "cli_want"))


def test_hygiene_fix_structure_cli_matches_jax(tmp_path, capsys):
    _messy_drop(str(tmp_path / "want"))
    shutil.copytree(tmp_path / "want", tmp_path / "got")
    printed = []
    for name, mod in (("got", th), ("want", jh)):
        mod.main(["fix-structure", "--ct_path", str(tmp_path / name / "ct"),
                  "--roi_image_path", str(tmp_path / name / "roi")])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0].endswith("4 subjects needed fixes\n")
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))
