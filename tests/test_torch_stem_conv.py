"""The stem conv boundary of the port (gssd_torch.ops.kernels.stem_conv,
on the CPU its plain versions) against gssd_tpu's Pallas conv3x3_wide in
interpret mode, forward and backward, and the port's ConvBNRelu with the
wide-conv switch on against gssd_tpu.ops.layers._PallasWideConv.

Tolerances: bf16 outputs (the forward and dx of a bf16 model) within one
bf16 ulp per element, since both sides round the same f32 sums (summed
in another order) once; f32 outputs, dW and db within 1e-5 of their
largest magnitude (f32 sums of bf16-exact products in another order).
The f32 forward's kernel takes f32 weights as three bf16 parts: its
plain emulation (``stem_conv_fwd_split``) is held to the same 1e-5
against JAX, and to ``STEM_F32_MEAN_TOL`` (mean error over mean value)
against the function in f64, which a two-part split fails by 5x.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gssd_tpu.ops import layers as jl
from gssd_tpu.ops.pallas.stem_conv import conv3x3_wide, pack_weights
from gssd_torch.ops import layers as tl
from gssd_torch.ops.kernels import stem_conv as sc
from gssd_torch.params import from_jax_variables

# tests/test_stem_conv.py's shapes (B, H, W, Cin, Cout, G), plus the two
# PixelLink++ stem sites at 4 groups with H not a multiple of 20, so that
# the TPU kernel's row tiles (12 rows here) cross halo rows
CASES = [
    (2, 20, 20, 12, 16, 4),
    (1, 30, 30, 16, 16, 4),
    (2, 24, 18, 8, 8, 1),
    (1, 19, 21, 8, 16, 2),
    (1, 36, 28, 12, 64, 4),
    (1, 24, 30, 64, 64, 4),
]


def _ordered(a):
    """bf16 values as integers in their order (adjacent values differ by 1)."""
    i = np.asarray(a).astype(ml_dtypes.bfloat16).view(np.int16).astype(np.int32)
    return np.where(i < 0, -(i + 32768), i)


def _nchw_np(t):
    return t.detach().float().numpy()


def _jax_case(x, wg, b, g, groups, dtype):
    """conv3x3_wide through pack_weights as _PallasWideConv calls it ->
    (y, dx, dW grouped [3, 3, Cin/G, Cout], db) as numpy, NHWC."""
    def f(xx, ww, bb):
        return conv3x3_wide(xx, pack_weights(ww, groups).astype(dtype), bb)

    y, vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(wg), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g, dtype))
    return y, dx, dw, db


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,W,C,Cout,G", CASES)
def test_plain_matches_conv3x3_wide(B, H, W, C, Cout, G, dtype):
    rng = np.random.default_rng(B * 1000 + H * 10 + C)
    x = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    wg = rng.uniform(-0.3, 0.3, (3, 3, C // G, Cout)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, (Cout,)).astype(np.float32)
    g = rng.normal(size=(B, H, W, Cout)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    y, dx, dw, db = _jax_case(x, wg, b, g, G, jdt)
    assert dw.dtype == jnp.float32  # the grouped dW reaches the f32 param unrounded

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt).requires_grad_()
    wt = torch.from_numpy(wg.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    yt = sc.stem_conv(xt, wt, bt, G)
    assert yt.dtype == tdt
    yt.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).to(tdt))
    assert wt.grad.dtype == torch.float32

    outs = [("y", y, yt), ("dx", dx, xt.grad)]
    if dtype == "float32":
        # the f32 forward kernel's arithmetic: three bf16 parts of w
        outs.append(("y, three parts", y, sc.stem_conv_fwd_split(xt, wt, bt, G, 3)))
    for name, want, got in outs:
        want = np.asarray(want).transpose(0, 3, 1, 2)
        if dtype == "bfloat16":
            ulps = np.abs(_ordered(want) - _ordered(got.detach().float().numpy()))
            assert ulps.max() <= 1, (name, ulps.max())
        else:
            err = np.abs(np.asarray(want, np.float32) - _nchw_np(got)).max()
            assert err <= 1e-5 * np.abs(want).max(), (name, err)
    for name, want, got in (("dW", np.asarray(dw).transpose(3, 2, 0, 1), wt.grad),
                            ("db", np.asarray(db), bt.grad)):
        err = np.abs(want - got.numpy()).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("B,Cin,Cout,G,H,W", [
    (2, 8, 16, 2, 33, 65),
    (2, 64, 64, 4, 33, 65),   # conv1_2's channels
    (2, 12, 64, 4, 33, 65),   # conv1_1's
])
def test_three_part_split_keeps_the_f32_contract(B, Cin, Cout, G, H, W):
    rng = np.random.default_rng(Cin * 7 + Cout)
    x = torch.from_numpy(rng.uniform(0, 1, (B, Cin, H, W)).astype(np.float32))
    w = torch.from_numpy((rng.normal(0, 1, (Cout, Cin // G, 3, 3))
                          / np.sqrt(9 * Cin / G)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, (Cout,)).astype(np.float32))
    hi, mid, lo = sc.split_bf16(w, 3)
    assert all(p.dtype == torch.bfloat16 for p in (hi, mid, lo))
    assert torch.equal(hi.float() + mid.float() + lo.float(), w)  # exact
    y64 = sc.stem_conv_fwd_f64(x, w, b, G)
    three = sc.f32_mean_err(sc.stem_conv_fwd_split(x, w, b, G, 3), y64)
    two = sc.f32_mean_err(sc.stem_conv_fwd_split(x, w, b, G, 2), y64)
    assert three <= sc.STEM_F32_MEAN_TOL, three
    assert two >= 5 * sc.STEM_F32_MEAN_TOL, two


def test_plain_backward_skips_dx():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 12, 9, 9)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(16, 3, 3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 16, 9, 9)).astype(np.float32)).bfloat16()
    dx, dw = sc.stem_conv_bwd(x, w, g, 4, need_dx=False)
    assert dx is None and dw.shape == (16, 3, 3, 3) and dw.dtype == torch.float32
    # the image needs no gradient: autograd asks for none
    b = torch.zeros(16, requires_grad=True)
    sc.stem_conv(x, w.requires_grad_(), b, 4).float().sum().backward()
    assert w.grad is not None and b.grad is not None


def test_boundary_rejects_bad_inputs():
    x = torch.zeros(1, 12, 8, 8, dtype=torch.bfloat16)
    w = torch.zeros(16, 3, 3, 3, dtype=torch.bfloat16)
    b = torch.zeros(16)
    with pytest.raises(TypeError):
        sc.stem_conv_fwd(x.half(), w.half(), b, 4)  # neither bf16 nor f32
    with pytest.raises(TypeError):
        sc.stem_conv_fwd(x, w.float(), b, 4)  # weights not in x's dtype
    with pytest.raises(ValueError):
        sc.stem_conv_fwd(x.transpose(2, 3), w, b, 4)  # not contiguous NCHW
    with pytest.raises(ValueError):
        sc.stem_conv_fwd(x, w, b, 3)  # 12 -> 16 does not split into 3 groups
    with pytest.raises(ValueError):
        sc.stem_conv_fwd(x, torch.zeros(16, 3, 5, 5, dtype=torch.bfloat16), b, 4)


def test_dw_bands_cover_the_map():
    for B, H, per_band in ((16, 300, 4), (2, 36, 4), (1, 7, 1), (64, 75, 16)):
        rows, bands = sc.dw_bands(B, H, per_band)
        assert rows % 8 == 0 and (bands - 1) * rows < H <= bands * rows


def _wide_site(rng, H=72, W=72, cin=12, cout=64, groups=4):
    x = rng.uniform(0, 1, (1, H, W, cin)).astype(np.float32)
    wg = rng.normal(0, 0.3, (3, 3, cin // groups, cout)).astype(np.float32)
    b = rng.normal(0, 0.5, (cout,)).astype(np.float32)
    return x, {"params": {"Conv_0": {"kernel": wg, "bias": b}}}


def test_conv_bn_relu_switch_matches_pallas_wide_conv(monkeypatch):
    """72 x 72 = 5184 output pixels: the gate's 5000 is passed."""
    rng = np.random.default_rng(11)
    x, v = _wide_site(rng)
    want = np.asarray(jl._PallasWideConv(64, 4, jnp.bfloat16).apply(
        {"params": v["params"]["Conv_0"]}, jnp.asarray(x, jnp.bfloat16)))
    mod = tl.ConvBNRelu(12, 64, 3, 1, 1, 1, groups=4, relu=False)
    mod.load_state_dict(from_jax_variables(v), strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16()

    monkeypatch.setattr(tl, "USE_WIDE_CONV_KERNEL", True)
    assert mod.wide(xt)
    got = mod(xt).detach().float().numpy().transpose(0, 2, 3, 1)
    assert np.abs(_ordered(want) - _ordered(got)).max() <= 1
    # the plain grouped conv rounds the conv and then adds a bf16 bias
    monkeypatch.setattr(tl, "USE_WIDE_CONV_KERNEL", False)
    assert not mod.wide(xt)
    plain = mod(xt).detach().float().numpy().transpose(0, 2, 3, 1)
    assert np.abs(_ordered(want) - _ordered(plain)).max() > 1


@pytest.mark.parametrize("hw,cin,cout,k,pad", [
    (70, 12, 64, 3, 1),    # 4900 pixels: below the gate
    (72, 64, 128, 3, 1),   # 128 output channels
    (72, 12, 64, 1, 0),    # a 1x1 conv
])
def test_switch_leaves_other_sites_alone(monkeypatch, hw, cin, cout, k, pad):
    monkeypatch.setattr(tl, "USE_WIDE_CONV_KERNEL", True)
    mod = tl.ConvBNRelu(cin, cout, k, 1, pad, 1, groups=4)
    assert not mod.wide(torch.zeros(1, cin, hw, hw))
