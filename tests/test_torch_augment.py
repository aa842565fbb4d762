"""The training augmentations of the port against the JAX package's, on
the CPU: the host pipeline (``gssd_torch.data.augment.SSDAugmentation``)
and the device augmentation (``gssd_torch.data.augment_device``), run on
the CPU here.

Both packages draw from numpy ``default_rng`` Generators in the same
order, so everything decided by a draw (the geometry, the boxes, the
labels) must be the same bits; the pixels go through another resize
(torch's bilinear against OpenCV's) or other f32 sums (the warp's
products), so they are held within 1e-5 of images in [0, 1].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_torch.data.augment import SSDAugmentation
from gssd_torch.data.augment_device import DeviceAugmentation, GeomParams, hat_matrices, warp
from gssd_tpu.data.augment import SSDAugmentation as JaxSSDAugmentation
from gssd_tpu.data.augment_device import DeviceAugmentation as JaxDeviceAugmentation

IMG_TOL = 1e-5


def _item(rng, size=96):
    img = rng.uniform(0, 255, (4, size, size, 3)).astype(np.float32)
    n = int(rng.integers(1, 4))
    x1 = rng.uniform(0.05, 0.6, n)
    y1 = rng.uniform(0.05, 0.6, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.1, 0.35, n),
                      y1 + rng.uniform(0.1, 0.35, n)], 1).astype(np.float32)
    return img, boxes, rng.integers(0, 2, n).astype(np.float32)


@pytest.mark.parametrize("pixel_link", [False, True])
def test_host_augmentation_matches_jax(pixel_link):
    """96x96 -> 64 over 20 seeds: boxes and labels (and the PixelLink
    target maps) the same bits, images within IMG_TOL."""
    rng = np.random.default_rng(5)
    for seed in range(20):
        img, boxes, labels = _item(rng)
        kw = dict(size=64, seed=seed, pixel_link_size=64 if pixel_link else None)
        got = SSDAugmentation(**kw)(img.copy(), boxes.copy(), labels.copy())
        want = JaxSSDAugmentation(**kw)(img.copy(), boxes.copy(), labels.copy())
        assert got[0].shape == want[0].shape == (4, 64, 64, 3)
        np.testing.assert_allclose(got[0], want[0], atol=IMG_TOL, rtol=0, err_msg=f"seed {seed}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"seed {seed}")
        if pixel_link:
            assert set(got[2]) == set(want[2])
            for key in got[2]:
                np.testing.assert_array_equal(np.asarray(got[2][key]), np.asarray(want[2][key]),
                                              err_msg=f"seed {seed} {key}")
        else:
            np.testing.assert_array_equal(got[2], want[2], err_msg=f"seed {seed}")


def _raw_batch(rng, B=3, S=128):
    imgs = rng.integers(0, 256, (B, S, S, 12)).astype(np.uint8)
    boxes, labels = [], []
    for _ in range(B):
        _, b, lab = _item(rng)
        boxes.append(b)
        labels.append(lab)
    return imgs, boxes, labels


def _jax_geometry(aug, boxes_list, labels_list):
    items = [aug.sample_geometry(b, lab) for b, lab in zip(boxes_list, labels_list)]
    return [np.asarray([it[k] for it in items]) for k in range(5)]


@pytest.mark.parametrize("mean,normalize", [(0.0, True), (12.5, False)])
def test_device_augmentation_matches_jax(mean, normalize):
    """128 -> 64 (the jitter is non-zero from 128 up), three seeds: the
    geometry, boxes, labels and valid the same bits as JAX's, the image
    within IMG_TOL of JAX's warp on the CPU (f32 products in other
    orders; with the mean fill where the canvas shows)."""
    rng = np.random.default_rng(9)
    for seed in range(3):
        raw, boxes, labels = _raw_batch(rng)
        kw = dict(size=64, src_size=128, mean=mean, use_normalize=normalize, seed=seed)
        aug, jaug = DeviceAugmentation(device="cpu", **kw), JaxDeviceAugmentation(**kw)
        want_geom = _jax_geometry(jaug, boxes, labels)
        jaug.rng = np.random.default_rng(seed)
        want = jaug(raw, boxes, labels)
        geom, _ = aug.sample_batch(boxes, labels)
        for name, a, b in zip(("scale", "offset", "flip", "brightness", "contrast"),
                              (geom.scale, geom.offset, geom.flip, geom.brightness,
                               geom.contrast), want_geom):
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f"seed {seed} {name}")
        aug.rng = np.random.default_rng(seed)
        got = aug(raw, boxes, labels)
        assert all(t.device.type == "cpu" for t in got.values())
        assert got["image"].shape == (3, 64, 64, 12) and got["image"].dtype == torch.float32
        for key in ("boxes", "labels", "valid"):
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=f"seed {seed}")
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                                   atol=IMG_TOL * (1 if normalize else 255), rtol=0)


def test_device_matrices_and_warp_match_jax_and_f64():
    """``hat_matrices`` against the host-built ``interp_matrices`` (and
    JAX's), flip included, within 1e-5; ``warp`` in f32 within IMG_TOL of
    JAX's ``_warp`` and of the same warp in f64."""
    rng = np.random.default_rng(3)
    geom = GeomParams(scale=np.array([[1.3, 0.9], [2.0, 1.7]], np.float32),
                      offset=np.array([[-3.0, 5.0], [10.0, -8.0]], np.float32),
                      flip=np.array([False, True]),
                      brightness=np.array([4.0, -10.0], np.float32),
                      contrast=np.array([1.2, 0.8], np.float32))
    aug = DeviceAugmentation(size=40, src_size=64, device="cpu")
    jaug = JaxDeviceAugmentation(size=40, src_size=64)
    my, mx = hat_matrices(*[torch.from_numpy(a) for a in (geom.scale, geom.offset, geom.flip)],
                          40, 64)
    for got, host, jax_host in zip((my, mx), aug.interp_matrices(geom),
                                   jaug.interp_matrices(geom)):
        np.testing.assert_array_equal(host, jax_host)
        np.testing.assert_allclose(got.numpy(), host, atol=1e-5, rtol=0)
    raw = rng.integers(0, 256, (2, 64, 64, 12)).astype(np.uint8)
    bright, contr = torch.from_numpy(geom.brightness), torch.from_numpy(geom.contrast)
    got = warp(torch.from_numpy(raw), my, mx, bright, contr)
    ref = warp(torch.from_numpy(raw), my, mx, bright, contr, dtype=torch.float64)
    want = np.asarray(jaug._warp(jnp.asarray(raw), jnp.asarray(my.numpy()),
                                 jnp.asarray(mx.numpy()), jnp.asarray(geom.brightness),
                                 jnp.asarray(geom.contrast)))
    assert ref.dtype == torch.float64 and float(got.min()) >= 0 and float(got.max()) <= 1
    np.testing.assert_allclose(got.numpy(), want, atol=IMG_TOL, rtol=0)
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), atol=IMG_TOL, rtol=0)
    # the input is not changed in place (uint8 or float alike)
    f = torch.from_numpy(raw.astype(np.float32))
    warp(f, my, mx, bright, contr)
    assert torch.equal(f, torch.from_numpy(raw.astype(np.float32)))
