"""SNUH ingestion of the port (``gssd_torch.preprocessing.snuh``) against
gssd_tpu's, on the CPU, exact (``assert_same``, ``assert_same_tree`` of
tests/test_torch_preprocessing.py): the metadata (xlsx extraction with
pandas' reader replaced by a seeded table, the lookup merge and its
phase assertion), ``load_subject`` (delta alignment, the ``<mask_id>_
<phase>[n].raw`` match that keeps ``Pre`` masks out of ``P``, the lesion
merge, the cv2 resize when ``img_size`` is not the drop's), the skips and
the negative-delta error, ``build_snuh_dataset`` through the injected
series reader and the CLI through ``read_dicom_series`` itself (stand-in
pydicom); then the slice as a whole: raw drop -> ml_ready -> both
packages' ``LesionDataset`` item by item, and one step of the port's mini
detector (tests/mini_model.py's size) on the port's ml_ready."""

import math
import os
import sys

import numpy as np
import pytest
import torch
from mini_model import build_mini
from test_torch_folds import MiniTwin, _tensors
from test_torch_preprocessing import (SUBJECTS, H, assert_same, assert_same_tree, make_drop,
                                      npy_series_reader, same_outcome, stub_pydicom)

from gssd_torch.config import LossConfig, OptimConfig
from gssd_torch.data import BaseTransform, LesionDataset, collate
from gssd_torch.preprocessing import snuh as ts
from gssd_torch.train import make_optimizer, train_step
from gssd_tpu.data import LesionDataset as JaxLesionDataset
from gssd_tpu.preprocessing import snuh as js

@pytest.fixture(scope="module")
def drop(tmp_path_factory):
    return make_drop(str(tmp_path_factory.mktemp("drop")))


def _both(capsys, name, *args, **kwargs):
    """One function of both packages on the same arguments: the same
    result (or error) and the same printed lines."""
    outs = []

    def run(mod):
        def call():
            try:
                return getattr(mod, name)(*args, **kwargs)
            finally:
                outs.append(capsys.readouterr().out)
        return call

    res = same_outcome(run(ts), run(js))
    assert outs[0] == outs[1]
    return res, outs[0]


@pytest.mark.parametrize("img_size", [H, 300])
@pytest.mark.parametrize("row", range(len(SUBJECTS)))
def test_load_subject_matches_jax(drop, capsys, row, img_size):
    meta = js.load_metadata(os.path.join(drop, "metadata.txt"))
    assert ts.load_metadata(os.path.join(drop, "metadata.txt")) == meta
    out, printed = _both(capsys, "load_subject", drop, meta[row], img_size,
                         series_reader=npy_series_reader)
    phases, masks, merged, (subject, base) = out
    _, z, pivot, mask_id, n_lesions, _ = SUBJECTS[row]
    assert phases.shape == (4, img_size, img_size, z) and len(masks) == n_lesions
    assert base == f"{mask_id}_{pivot}"
    found = ([f"{mask_id}_{pivot}{i + 1}.raw" for i in range(n_lesions)] if n_lesions > 1
             else [f"{mask_id}_{pivot}.raw"])
    assert printed == f"found dicom & masks pair: {subject} {found}\n"
    np.testing.assert_array_equal(np.where(merged.any(axis=(0, 1)))[0], [2, 3, 4, 5])


def test_load_subject_skips_and_refuses_as_jax(drop, capsys):
    for row in (["HCC_9999", "0", "0", "0", "0", "P", "A9"],  # no dicom dir
                ["HCC_1105", "0", "0", "0", "0", "D", "A9"]):  # no mask
        res, printed = _both(capsys, "load_subject", drop, row,
                             series_reader=npy_series_reader)
        assert res is None and "WARNING" in printed
    e, _ = _both(capsys, "load_subject", drop, ["HCC_1104", "0", "0", "-1", "0", "P", "A1"],
                 series_reader=npy_series_reader)
    assert isinstance(e, ValueError) and "negative z-delta" in str(e)
    e, _ = _both(capsys, "load_subject", drop, ["HCC_1104", "0", "0", "9", "0", "P", "A1"],
                 series_reader=npy_series_reader)  # the mask cannot cover the pivot
    assert isinstance(e, AssertionError)


def test_build_snuh_dataset_and_datasets_match_jax(drop, tmp_path, capsys):
    """The slice as a whole: raw drop -> ml_ready (the same files) -> both
    packages' LesionDataset, item by item."""
    out = {name: str(tmp_path / name) for name in ("got", "want")}
    lines, printed = [], []
    for name, mod in (("got", ts), ("want", js)):
        lines.append(mod.build_snuh_dataset(drop, out[name], img_size=H,
                                            series_reader=npy_series_reader))
        printed.append(capsys.readouterr().out.replace(out[name], "<out>"))
    assert lines[0] == lines[1] and printed[0] == printed[1]
    assert len(lines[0]) == 12 and lines[0][0] == "HCC_1104/HCC_1104_0|HCC_1104"
    assert_same_tree(out["got"], out["want"])
    token = np.load(os.path.join(out["got"], "HCC_1106", "HCC_1106_0_phase.npy"))
    assert_same(token, np.asarray(np.int64(3)))  # the pivot phase Pre's scalar token

    ids = [line.split("|")[0] for line in lines[0]]
    got, want = LesionDataset(out["got"], ids), JaxLesionDataset(out["want"], ids)
    assert len(got) == len(want) == 12
    for i in range(len(want)):
        assert_same(got.pull_image(i), want.pull_image(i))
        assert_same(got.pull_anno(i), want.pull_anno(i))
        assert_same(got[i], want[i])


def test_merge_mask_metadata_matches_jax(tmp_path, capsys):
    lookup, meta = tmp_path / "lookup.txt", tmp_path / "meta.txt"
    lookup.write_text("HCC_1104 A5 P\nHCC_1105 A9 D\n\n")
    meta.write_text("ID\tA\tD\tP\tPre\tMEDIP\nHCC_1104\t0\t0\t10\t0\tP\n"
                    "HCC_1105\t0\t14\t0\t0\tD\n")
    for name, mod in (("got", ts), ("want", js)):
        mod.merge_mask_metadata(str(lookup), str(meta), str(tmp_path / f"{name}.txt"))
    assert (tmp_path / "got.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()
    assert ts.load_metadata(str(tmp_path / "got.txt"))[1] == ["HCC_1105", "0", "14", "0", "0",
                                                              "D", "A9"]
    lookup.write_text("HCC_1104 A5 A\nHCC_1105 A9 D\n")  # phase mismatch
    e, _ = _both(capsys, "merge_mask_metadata", str(lookup), str(meta), str(tmp_path / "x.txt"))
    assert isinstance(e, AssertionError)


def _excel_frame():
    """The metadata_preprocessed sheet: a units row first, NaN and string
    deltas, the drop's subjects and pivots."""
    import pandas as pd

    rows = [("", "units", "units", "units", "units", "")]
    for subject, _, pivot, _, _, (a, d, p, pre) in SUBJECTS:
        rows.append((subject, str(a), float(d), math.nan if p == 0 else p, pre, pivot))
    return pd.DataFrame(rows, columns=["Index_New", "A", "D", "P", "Pre", "MEDIP"])


def test_excel_metadata_matches_jax(tmp_path, monkeypatch, capsys):
    import pandas as pd

    monkeypatch.setitem(sys.modules, "openpyxl", None)  # no xlsx engine: both refuse
    _both(capsys, "extract_metadata_from_excel", str(tmp_path / "none.xlsx"),
          str(tmp_path / "x.txt"))
    monkeypatch.setattr(pd, "read_excel", lambda path: _excel_frame())
    for name, mod in (("got", ts), ("want", js)):
        mod.extract_metadata_from_excel("sheet.xlsx", str(tmp_path / f"{name}.txt"))
    text = (tmp_path / "want.txt").read_text()
    assert (tmp_path / "got.txt").read_text() == text
    assert text.splitlines()[2] == "HCC_1105\t3\t2\t0\t1\tA"  # NaN -> 0, "3" -> 3


@pytest.mark.parametrize("xlsx", [False, True])
def test_cli_matches_jax(tmp_path, monkeypatch, capsys, xlsx):
    """``python -m gssd_torch.preprocessing.snuh`` as main(argv), reading
    the DICOM series with read_dicom_series (stand-in pydicom); with
    --xlsx and --lookup the metadata is extracted and merged first."""
    import pandas as pd

    drop = make_drop(str(tmp_path / "drop"), dicom=True)
    monkeypatch.setitem(sys.modules, "pydicom", stub_pydicom())
    monkeypatch.setattr(pd, "read_excel", lambda path: _excel_frame())
    lookup = tmp_path / "lookup.txt"
    lookup.write_text("".join(f"{s} {m} {p}\n" for s, _, p, m, _, _ in SUBJECTS))
    printed = []
    for name, mod in (("got", ts), ("want", js)):
        argv = ["--datapath", drop, "--output", str(tmp_path / name), "--img_size", "64"]
        if xlsx:
            argv += ["--metadata", str(tmp_path / f"meta_{name}.txt"), "--xlsx", "s.xlsx",
                     "--lookup", str(lookup)]
        mod.main(argv)
        printed.append(capsys.readouterr().out.replace(str(tmp_path / name), "<out>"))
    assert printed[0] == printed[1] and "wrote 12 slices from 3 subjects" in printed[0]
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))
    if xlsx:
        assert (tmp_path / "meta_got.txt").read_text() == (tmp_path / "meta_want.txt").read_text()
        assert (tmp_path / "meta_got.txt").read_text() == (
            open(os.path.join(drop, "metadata.txt")).read())


def test_mini_detector_trains_on_the_ports_ml_ready(drop, tmp_path):
    """One step of the port's mini detector (tests/mini_model.py's twin) on
    a batch of the ml_ready that the port's build_snuh_dataset wrote."""
    out = str(tmp_path / "ml")
    lines = ts.build_snuh_dataset(drop, out, img_size=H, series_reader=npy_series_reader)
    ds = LesionDataset(out, [line.split("|")[0] for line in lines], transform=BaseTransform(64))
    batch = _tensors(collate([ds[i] for i in range(4)], max_gt=4))
    assert batch["image"].shape == (4, 64, 64, 12) and batch["valid"].any(axis=1).all()
    torch.manual_seed(0)
    model = MiniTwin()
    before = [p.detach().clone() for p in model.parameters()]
    optim = OptimConfig(lr=1e-3, stepvalues=(100,))
    _, priors = build_mini()
    res = train_step(model, make_optimizer(model, optim), torch.tensor(np.asarray(priors)),
                     batch, LossConfig(max_gt_boxes=4), optim, 0)
    assert math.isfinite(float(res["loss"])) and float(res["num_pos"]) > 0
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
