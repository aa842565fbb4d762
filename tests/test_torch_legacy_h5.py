"""The legacy v1 h5 path of the port (``gssd_torch.preprocessing.legacy_v1``
and ``gssd_torch.data.legacy_h5.H5LesionDataset``) against gssd_tpu's, on
the CPU, exact (``assert_same``, ``same_outcome``, ``assert_same_tree`` of
tests/test_torch_preprocessing.py; h5 files compared dataset by dataset,
never byte by byte, as h5py stamps times): the v1 HU preprocessing, the
subject walk (matched slices, 4- and 5-value coordinates, the skips),
``write_v1_h5``, the CLI through the default readers (stand-in pydicom,
pickled coordinates), both readers item by item on the ``label`` and
``coordinate`` layouts, the ``[phase, channel, 5]`` v1 tensor, labels
that hold no box and a ``ct_<i>`` without its labels; then the slice as
a whole: v1 tree -> h5 -> H5LesionDataset -> run_detection_eval."""

import os
import pickle
import sys
import zlib

import h5py
import numpy as np
import pytest
from test_torch_preprocessing import (assert_same, assert_same_tree, same_outcome, stub_pydicom,
                                      write_dicom_slice)

from gssd_torch.data.legacy_h5 import H5LesionDataset
from gssd_torch.eval import ap_iobb as teval
from gssd_torch.preprocessing import legacy_v1 as tv
from gssd_tpu.data.legacy_h5 import H5LesionDataset as JaxH5LesionDataset
from gssd_tpu.eval import ap_iobb as jeval
from gssd_tpu.preprocessing import legacy_v1 as jv

HW = 32


def _raw(path, hw=HW):
    """A raw slice (0..2048, max 2048) seeded by the file's last three
    path parts."""
    key = "/".join(os.path.normpath(path).split(os.sep)[-3:])
    img = np.random.default_rng(zlib.crc32(key.encode())).integers(0, 2049, (hw, hw))
    img.flat[0] = 2048
    return img


# subject -> (annotated slices, coordinate values per slice)
TREE = {"A001": (6, 4), "A002": (5, 5), "A003": (4, 10), "A004": (2, 4), "A391": (4, 4)}


def _v1_tree(root, dicom=False):
    """ct/<subject>/P/sNNN.DCM and roi_coordinate/<subject>/P/sNNN.txt
    (pickled boxes); each subject's last slice has no coordinates; A003's
    pickles hold two boxes (skipped), A004 has too few slices, A999 no P
    directory. With ``dicom`` each .DCM holds its pixels for the stand-in
    pydicom."""
    ct_root, roi_root = os.path.join(root, "ct"), os.path.join(root, "roi_coordinate")
    for subject, (n, values) in TREE.items():
        os.makedirs(os.path.join(ct_root, subject, "P"))
        os.makedirs(os.path.join(roi_root, subject, "P"))
        for i in range(n + 1):
            path = os.path.join(ct_root, subject, "P", f"s{i:03d}.DCM")
            pixels = np.clip(_raw(path) - 1024, -1024, 1024) if subject == "A391" else _raw(path)
            if dicom:
                write_dicom_slice(path, pixels)
            else:
                open(path, "wb").close()
            if i < n:
                box = [2 + i, 3 + i, 18 + i, 20 + i, 0, 1, 2, 3, 4, 5][:values]
                with open(os.path.join(roi_root, subject, "P", f"s{i:03d}.txt"), "wb") as f:
                    pickle.dump(np.asarray(box, np.float32), f)
    os.makedirs(os.path.join(roi_root, "A999"))
    return ct_root, roi_root


def _read_dicom(path):
    raw = _raw(path)
    return np.clip(raw - 1024, -1024, 1024) if "A391" in path else raw


@pytest.mark.parametrize("subject", ["B123", "A391", "A452"])
def test_preprocess_slice_matches_jax(subject):
    img = _raw("x/y/z.DCM")
    same_outcome(tv.preprocess_slice_for_detection, jv.preprocess_slice_for_detection, img,
                 subject)
    low = np.clip(img - 1024, -1024, 600)  # max < 1700: refused unless pre-offset
    same_outcome(tv.preprocess_slice_for_detection, jv.preprocess_slice_for_detection, low,
                 subject)
    assert_same(tv.normalize_image(img.astype(np.float32)),
                jv.normalize_image(img.astype(np.float32)))


def test_generate_and_write_match_jax(tmp_path):
    ct_root, roi_root = _v1_tree(str(tmp_path / "v1"))
    logs = {"got": [], "want": []}
    data = {name: mod.generate_v1_dataset(ct_root, roi_root, read_dicom=_read_dicom,
                                          log=logs[name].append)
            for name, mod in (("got", tv), ("want", jv))}
    assert_same(data["got"], data["want"])
    assert logs["got"] == logs["want"]
    assert sorted(data["got"]) == ["A001", "A002", "A391"]
    assert any("A003" in m and "expected one" in m for m in logs["got"])
    assert any("A004" in m and "fewer than 3" in m for m in logs["got"])
    assert data["got"]["A001"][0].shape == (4, 4, 3, HW, HW)
    # one phase directory, and an empty one
    assert_same(tv.generate_v1_subject(os.path.join(ct_root, "A002", "P"),
                                       os.path.join(roi_root, "A002", "P"), "A002",
                                       read_dicom=_read_dicom),
                jv.generate_v1_subject(os.path.join(ct_root, "A002", "P"),
                                       os.path.join(roi_root, "A002", "P"), "A002",
                                       read_dicom=_read_dicom))
    os.makedirs(tmp_path / "empty")
    assert_same(tv.generate_v1_subject(str(tmp_path / "empty"), str(tmp_path / "empty"), "A"),
                jv.generate_v1_subject(str(tmp_path / "empty"), str(tmp_path / "empty"), "A"))
    for name, mod in (("got", tv), ("want", jv)):
        mod.write_v1_h5(str(tmp_path / name / "v1.h5"), data[name])
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))


def test_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """``python -m gssd_torch.preprocessing.legacy_v1`` with its default
    readers: pydicom (stand-in) and the pickled coordinates."""
    ct_root, roi_root = _v1_tree(str(tmp_path / "v1"), dicom=True)
    monkeypatch.setitem(sys.modules, "pydicom", stub_pydicom())
    printed = []
    for name, mod in (("got", tv), ("want", jv)):
        mod.main(["--ct_path", ct_root, "--roi_coordinate_path", roi_root, "--output",
                  str(tmp_path / name / "out.h5")])
        printed.append(capsys.readouterr().out.replace(str(tmp_path / name), "<out>"))
    assert printed[0] == printed[1]
    assert printed[0].endswith("wrote <out>/out.h5: 3 subjects, 9 samples\n")
    assert_same_tree(str(tmp_path / "got"), str(tmp_path / "want"))


def _layouts(rng):
    """name -> (label group, {ct key: [n, 4, 3, H, W]}, {label key: array})."""
    cts = {f"ct_{i}": rng.uniform(0, 1, (2 + i % 2, 4, 3, 16, 16)).astype(np.float32)
           for i in (0, 1, 10)}
    n = {k: v.shape[0] for k, v in cts.items()}

    def boxes(k, shape):
        b = rng.uniform(0, 8, (n[k],) + shape).astype(np.float32)
        b[..., 2:4] += 6
        b[..., 4] = 0
        return b

    def per_ct(shape, prefix="coordinate"):
        return {k.replace("ct", prefix): boxes(k, shape) for k in cts}

    return {
        "label_rows": ("label", cts, per_ct((5,))),
        "label_multi": ("label", cts, per_ct((3, 5), "label")),
        "coordinate_v1": ("coordinate", cts, per_ct((4, 3, 5))),
        "one_dim": ("label", cts, {k.replace("ct", "coordinate"): np.arange(n[k], dtype=np.float32)
                                   for k in cts}),
        "not_boxes": ("label", cts, {k: v[..., :4] for k, v in per_ct((4, 5)).items()}),
        "missing_key": ("coordinate", cts, {"coordinate_0": boxes("ct_0", (4, 3, 5))}),
    }


def _write(path, group, cts, labels):
    with h5py.File(path, "w") as f:
        g = f.create_group("ct")
        for k, v in cts.items():
            g.create_dataset(k, data=v)
        g = f.create_group(group)
        for k, v in labels.items():
            g.create_dataset(k, data=v)


def _halve(img, boxes, labels):
    # one numpy transform for both readers
    return img[:, ::2, ::2] / 255.0, boxes * 0.5, labels + 1


@pytest.mark.parametrize("layout", ["label_rows", "label_multi", "coordinate_v1", "one_dim",
                                    "not_boxes", "missing_key"])
def test_h5_readers_match_jax(tmp_path, layout):
    group, cts, labels = _layouts(np.random.default_rng(12))[layout]
    path = str(tmp_path / "legacy.h5")
    _write(path, group, cts, labels)
    for transform in (None, _halve):
        got, want = H5LesionDataset(path, transform), JaxH5LesionDataset(path, transform)
        assert len(got) == len(want) == 7  # ct_0, ct_1, ct_10 in sorted key order
        for i in range(len(want)):
            assert_same(got.pull_image(i), want.pull_image(i))
            assert_same(got.pull_anno(i), want.pull_anno(i))
            assert_same(got[i], want[i])
    n_boxes = [len(want.pull_anno(i)) for i in range(len(want))]
    expect = {"label_rows": [1] * 7, "label_multi": [3] * 7, "coordinate_v1": [1] * 7,
              "one_dim": [0] * 7, "not_boxes": [0] * 7, "missing_key": [1, 1, 0, 0, 0, 0, 0]}
    assert n_boxes == expect[layout]


def test_v1_tree_to_detection_eval_matches_jax(tmp_path):
    """The slice as a whole: v1 tree -> write_v1_h5 -> H5LesionDataset ->
    run_detection_eval, one stub detector (the ground truth plus a miss
    and a false positive) fed to both packages."""
    ct_root, roi_root = _v1_tree(str(tmp_path / "v1"))
    results = []
    for mod, ds_cls, ev in ((tv, H5LesionDataset, teval), (jv, JaxH5LesionDataset, jeval)):
        path = str(tmp_path / f"{mod.__name__}.h5")
        mod.write_v1_h5(path, mod.generate_v1_dataset(ct_root, roi_root, read_dicom=_read_dicom,
                                                      log=lambda m: None))
        ds = ds_cls(path)
        table = np.zeros((len(ds), 2, 4, 5))
        for i in range(len(ds)):
            box = ds.pull_anno(i)[0, :4] / HW
            table[i, 1, 0] = [0.9, *box]
            table[i, 1, 1] = [0.5, 0.0, 0.0, 0.1, 0.1]
        table[3, 1, 0, 0] = 0.0  # one lesion missed
        seen = []

        def stub(batch):
            out = np.zeros((len(batch), 2, 4, 5))
            for b, img in enumerate(batch):
                if img.any():  # the JAX package pads its last batch with zeros
                    out[b] = table[len(seen)]
                    seen.append(b)
            return out

        from gssd_torch.data import BaseTransform
        from gssd_tpu.data import BaseTransform as JaxBaseTransform

        tf = (BaseTransform if ev is teval else JaxBaseTransform)(HW)
        results.append(ev.run_detection_eval(stub, ds, tf, (0.3, 0.5), (0.5,), 0.2, False, 4))
        assert len(seen) == len(ds) == 9
    got, want = results
    assert got == want
    assert all(0.0 <= v <= 1.0 for v in got.values()) and 0.5 < got["ap50"] < 1.0
