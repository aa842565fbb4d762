"""The training input path of the port against the JAX package's, on the
CPU: the epoch permutation and the multi-process loader's stream
(``gssd_torch.data.dataset``), the device cache with its on-device
augmentation (``gssd_torch.data.device_cache``, run on the CPU here),
``device_prefetch`` (a pass-through off the card), and the trainer's
``--aug_method device_cached`` and ``--num_workers 2`` paths with exact
resume.

A stream's draws come from numpy Generators seeded by Python-int
expressions of (seed, batch index) in both packages, so batch j must be
the same bits in both, whatever the worker count; images that pass
through the warp's f32 products are held within 1e-5 (in [0, 1]).
"""

import os
import sys

import numpy as np
import pytest
import torch

from gssd_torch.data import dataset as tdata
from gssd_torch.data.device_cache import DeviceCacheLoader
from gssd_torch.data.synthetic import make_synthetic_dataset
from gssd_tpu.data import dataset as jdata
from gssd_tpu.data.device_cache import DeviceCacheLoader as JaxDeviceCacheLoader

IMG_TOL = 1e-5


def _ids(path):
    return [line.split("|")[0] for line in
            open(os.path.join(path, "metadata.txt")).read().splitlines() if line]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """18 random 32x32 slices with one box each."""
    root = tmp_path_factory.mktemp("ml_tiny")
    rng = np.random.default_rng(0)
    ids = []
    for s in range(6):
        for i in range(3):
            sid = f"subj{s}_{i}"
            np.save(root / f"{sid}_ct.npy", rng.uniform(0, 1, (4, 3, 32, 32)).astype(np.float32))
            np.save(root / f"{sid}_bbox.npy", np.asarray([[4, 4, 20, 20, 0]], np.float32))
            ids.append(sid)
    return str(root), ids


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ml_synth"))
    make_synthetic_dataset(path, num_subjects=2, slices_per_subject=2, image_size=64)
    return path, _ids(path)


class _Jitter:
    """Stand-in augmentation with the ``rng`` attribute the workers reseed."""

    def __init__(self):
        self.rng = np.random.default_rng(0)

    def __call__(self, img, boxes, labels):
        return img + self.rng.uniform(0, 0.01), boxes, labels


def _take(loader, n):
    """n batches as numpy copies (a slot's tensors are refilled later)."""
    it = iter(loader)
    out = [{k: np.array(v) for k, v in next(it).items()} for _ in range(n)]
    close = getattr(loader, "close", None) or getattr(loader, "shutdown", None)
    if close is not None:
        close()
    return out


def _assert_same(got, want, keys=("image", "boxes", "labels", "valid")):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        for key in keys:
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"batch {j} {key}")


def test_epoch_permuter_matches_jax():
    for seed, n, shuffle in ((1111, 18, True), (2**31 + 5, 7, True), (3, 5, False)):
        a, b = tdata._EpochPermuter(seed, n, shuffle), jdata._EpochPermuter(seed, n, shuffle)
        for j in (0, 1, 5, 40, 3):
            assert a.indices_for_batch(j, 4) == b.indices_for_batch(j, 4)


@pytest.fixture(scope="module")
def jax_stream(tiny):
    path, ids = tiny
    ld = jdata.MPBatchLoader(jdata.LesionDataset(path, ids, transform=_Jitter()),
                             batch_size=4, seed=11, num_workers=2)
    return _take(ld, 6)


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_mp_stream_matches_jax(tiny, jax_stream, workers):
    """The port's stream with 1-3 workers: JAX's bits (two workers),
    batch for batch, as tensors in shared memory."""
    path, ids = tiny
    ld = tdata.MPBatchLoader(tdata.LesionDataset(path, ids, transform=_Jitter()),
                             batch_size=4, seed=11, num_workers=workers)
    it, got = iter(ld), []
    for _ in range(6):
        batch = next(it)
        assert all(torch.is_tensor(v) and v.is_shared() for v in batch.values())
        got.append({k: v.numpy().copy() for k, v in batch.items()})
    ld.close()
    _assert_same(got, jax_stream)


def test_mp_stream_covers_epochs_and_resumes(tiny, jax_stream):
    path, ids = tiny
    # 18 items, 6 a batch: each epoch of 3 batches covers every item once
    seen = []
    for b in _take(tdata.MPBatchLoader(tdata.LesionDataset(path, ids), batch_size=6, seed=3,
                                       num_workers=2), 6):
        seen.extend(b["image"].sum(axis=(1, 2, 3)).round(3).tolist())
    assert len(set(seen[:18])) == len(set(seen[18:])) == len(ids)
    resumed = _take(tdata.MPBatchLoader(tdata.LesionDataset(path, ids, transform=_Jitter()),
                                        batch_size=4, seed=11, num_workers=2, start_batch=2), 4)
    _assert_same(resumed, jax_stream[2:])


def test_mp_pixellink_stream_matches_jax_and_resumes(tiny):
    """The PixelLink collate through the workers (host augmentation with
    the target maps): maps, boxes and valid JAX's bits, images within
    IMG_TOL (torch's resize against OpenCV's); resumed at batch 2, the
    port's own continuous stream bit for bit."""
    from gssd_torch.data.augment import SSDAugmentation
    from gssd_tpu.data.augment import SSDAugmentation as JaxSSDAugmentation

    path, ids = tiny
    kw = dict(pixeljitter=0.01, size=32, seed=7, pixel_link_size=32, pixel_link_version="4s")

    def stream(pkg, aug, start, n, workers):
        ld = pkg.MPBatchLoader(pkg.LesionDataset(path, ids, transform=aug(**kw)), batch_size=4,
                               seed=11, num_workers=workers, start_batch=start,
                               collate_fn=pkg.collate_pixellink)
        return _take(ld, n)

    maps = ("pixel_mask", "neg_pixel_mask", "pixel_pos_weight", "link_mask", "boxes", "valid")
    got = stream(tdata, SSDAugmentation, 0, 4, 1)
    want = stream(jdata, JaxSSDAugmentation, 0, 4, 2)
    _assert_same(got, want, maps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["image"], w["image"], atol=IMG_TOL, rtol=0)
    _assert_same(stream(tdata, SSDAugmentation, 2, 2, 3), got[2:], maps + ("image",))


class _Dies:
    def __init__(self):
        self.rng = None

    def __call__(self, img, boxes, labels):
        os._exit(3)


def test_mp_worker_death_raises_with_its_exit_code(tiny):
    path, ids = tiny
    ld = tdata.MPBatchLoader(tdata.LesionDataset(path, ids, transform=_Dies()), batch_size=2,
                             num_workers=2)
    with pytest.raises(RuntimeError, match="exit code 3"):
        next(iter(ld))
    ld.close()
    assert not any(p.is_alive() for p in ld._procs)


def test_collate_raw_matches_jax(tiny):
    path, ids = tiny
    items = [tdata.LesionDataset(path, ids)[i] for i in (0, 4, 7)]
    got, want = tdata.collate_raw(items), jdata.collate_raw(items)
    assert got["raw_image"].dtype == np.uint8 and got["raw_image"].shape == (3, 32, 32, 12)
    np.testing.assert_array_equal(got["raw_image"], want["raw_image"])
    for key in ("boxes_list", "labels_list"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w)


def test_device_prefetch_off_the_card_passes_through():
    batch = {"image": np.arange(6, dtype=np.float32).reshape(1, 2, 3),
             "valid": torch.ones(2, dtype=torch.bool), "boxes_list": [np.zeros((1, 4))]}
    out = list(tdata.device_prefetch(iter([batch, batch]), "cpu", cast={"image": torch.bfloat16}))
    assert len(out) == 2
    for b in out:
        assert b["image"].dtype == torch.float32 and b["image"].data_ptr() == \
            batch["image"].__array_interface__["data"][0]
        assert b["valid"] is batch["valid"] and b["boxes_list"] is batch["boxes_list"]


def _cache(ds, pkg=None, **kw):
    kw.setdefault("batch_size", 3)
    kw.setdefault("size", 32)
    kw.setdefault("seed", 7)
    if pkg is None:
        return DeviceCacheLoader(ds, device="cpu", **kw)
    return JaxDeviceCacheLoader(ds, **kw)


def test_device_cache_matches_jax(synth):
    """Three batches of the cache loader: boxes, labels and valid JAX's
    bits, images within IMG_TOL, every leaf on the loader's device; the
    stack is the uint8 phase-collapsed split."""
    path, ids = synth
    loader = _cache(tdata.LesionDataset(path, ids))
    want = _take(_cache(jdata.LesionDataset(path, ids), "jax"), 3)
    assert loader.cache.dtype == torch.uint8 and loader.cache.shape == (len(ids), 64, 64, 12)
    it = iter(loader)
    got = []
    for _ in range(3):
        b = next(it)
        assert all(v.device.type == "cpu" for v in b.values())
        got.append({k: v.numpy() for k, v in b.items()})
    _assert_same(got, want, ("boxes", "labels", "valid"))
    for g, w in zip(got, want):
        assert g["image"].shape == (3, 32, 32, 12)
        np.testing.assert_allclose(g["image"], w["image"], atol=IMG_TOL, rtol=0)


@pytest.mark.parametrize("src", [64, 128])
def test_device_cache_is_deterministic_and_resumes_exactly(tmp_path, synth, src):
    """The same seed gives the same stream; start_batch=2 gives batch 2
    bit for bit. At 128 the pixel jitter is non-zero, so a second
    generator inside the host sampler would show in the boxes."""
    if src == 64:
        path, ids = synth
    else:
        path = str(tmp_path / "ml_big")
        make_synthetic_dataset(path, num_subjects=2, slices_per_subject=2, image_size=src)
        ids = _ids(path)
    ds = tdata.LesionDataset(path, ids)
    first = [{k: v.clone() for k, v in b.items()}
             for b, _ in zip(_cache(ds, batch_size=2, size=64), range(3))]
    again = next(iter(_cache(ds, batch_size=2, size=64)))
    resumed = next(iter(_cache(ds, batch_size=2, size=64, start_batch=2)))
    for key in ("image", "boxes", "labels", "valid"):
        assert torch.equal(again[key], first[0][key]), key
        assert torch.equal(resumed[key], first[2][key]), key
    assert not torch.equal(first[1]["image"], first[2]["image"])


def test_device_cache_on_device_matrices_and_cap(synth, monkeypatch):
    """The gather-warp's device-built matrices against the host-built
    ``interp_matrices`` and the warp of the gathered items (within
    1e-5); above GSSD_DEVICE_CACHE_GB the loader refuses."""
    from gssd_torch.data.augment_device import GeomParams, warp

    path, ids = synth
    loader = _cache(tdata.LesionDataset(path, ids), batch_size=2)
    geom = GeomParams(scale=np.array([[1.3, 0.9], [2.0, 1.7]], np.float32),
                      offset=np.array([[-3.0, 5.0], [10.0, -8.0]], np.float32),
                      flip=np.array([False, True]),
                      brightness=np.array([4.0, -10.0], np.float32),
                      contrast=np.array([1.2, 0.8], np.float32))
    idx = torch.tensor([0, 3])
    got = loader._gather_warp(idx, *geom.to("cpu"))
    my, mx = loader._geom.interp_matrices(geom)
    want = warp(loader.cache[idx], torch.from_numpy(my), torch.from_numpy(mx),
                torch.from_numpy(geom.brightness), torch.from_numpy(geom.contrast))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    monkeypatch.setenv("GSSD_DEVICE_CACHE_GB", "1e-4")
    with pytest.raises(ValueError, match="GSSD_DEVICE_CACHE_GB"):
        _cache(tdata.LesionDataset(path, ids))


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ml_train"))
    make_synthetic_dataset(path, num_subjects=6, slices_per_subject=1, image_size=64)
    return path


@pytest.mark.parametrize("flag", [["--aug_method", "device_cached"], ["--num_workers", "2"]])
def test_trainer_resumes_the_stream_exactly(train_data, tmp_path, monkeypatch, capsys, flag):
    """python -m gssd_torch.train on the CPU (f32, batch 2): two iterations
    with a checkpoint at iteration 1, then --resume 1; the resumed run's
    batch is the uninterrupted run's iteration-1 batch, bit for bit.

    The loop, the loaders, the checkpoint and the resume are the
    trainer's; the SGD step, the validation loss and the AP/IoBB sweep
    record or return constants (a full-size CPU step costs seconds; the
    step on each input path is held in test_torch_train.py)."""
    import gssd_torch.eval
    from gssd_torch.train import steps, trainer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = []
    one = torch.tensor(1.0)

    def recording(model, opt, priors, batch, *a):
        seen.append({k: v.clone() for k, v in batch.items()})
        return {"loss": one, "loss_l": one, "loss_c": one, "grad_norm": one, "lr": 1e-3}

    def no_sweep(*args, score_sink, **kw):
        score_sink.update(raw=np.zeros(1), filtered=np.zeros(1))
        return {"ap50": 0.0}

    monkeypatch.setattr(steps, "train_step", recording)
    monkeypatch.setattr(steps, "eval_step", lambda *a: {"loss": one, "loss_l": one,
                                                        "loss_c": one})
    monkeypatch.setattr(gssd_torch.eval, "run_detection_eval", no_sweep)
    argv = ["--reference_recipe", "gssd++", "--datapath", train_data, "--num_test_subjects", "1",
            "--batch_size", "2", "--compute_dtype", "float32", "--device", "cpu",
            "--output", str(tmp_path), *flag]
    first = trainer.main(argv + ["--max_iter", "2", "--val_every", "1", "--speedrun", "1"])
    assert [e["iter"] for e in first["evals"]] == [1]
    resumed = trainer.main(argv + ["--max_iter", "2", "--speedrun", "5", "--resume", "1"])
    assert [r["iter"] for r in resumed["records"]] == [1] and resumed["step"] == 3
    assert len(seen) == 3 and seen[2]["image"].shape == (2, 300, 300, 12)
    for key in ("image", "boxes", "labels", "valid"):
        assert torch.equal(seen[2][key], seen[1][key]), key
    assert not torch.equal(seen[0]["image"], seen[1]["image"])
    text = capsys.readouterr().out
    assert ("input: device_cached" if flag[1] == "device_cached"
            else "input: host: 2 worker processes, from batch 1") in text
