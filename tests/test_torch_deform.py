"""The port's deformable conv (gssd_torch.ops.deform_conv and the plain
version of the CUDA kernel in gssd_torch.ops.kernels.deform_hat) against
gssd_tpu's gather path and its Pallas hat kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.ops import deform_conv as jdc
from gssd_tpu.ops.pallas.deform_hat import deform_conv2d_hat as jax_hat
from gssd_torch.ops.deform_conv import DCN, deform_conv2d
from gssd_torch.ops.kernels.deform_hat import deform_conv2d_hat
from gssd_torch.params import from_jax_variables


def _inputs(rng, B=2, H=9, W=9, C=8, G=4, K=9, Cout=6):
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    # offsets up to +-2 px reach outside the 9x9 map; a third of them are
    # whole numbers, so some samples land exactly on integer coordinates
    oy = rng.uniform(-2, 2, (B, H, W, G, K)).astype(np.float32)
    ox = rng.uniform(-2, 2, (B, H, W, G, K)).astype(np.float32)
    whole = rng.uniform(size=oy.shape) < 1 / 3
    oy[whole], ox[whole] = np.round(oy[whole]), np.round(ox[whole])
    m = rng.uniform(0, 1, (B, H, W, G, K)).astype(np.float32)
    w = (rng.normal(size=(K, C, Cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return x, oy, ox, m, w, b


def test_gather_matches_jax_f32(rng):
    args = _inputs(rng)
    want = np.asarray(jdc.deform_conv2d(*map(jnp.asarray, args)))
    got = deform_conv2d(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # f32 sum order


def test_kernel_plain_version_matches_hat_interpret(rng):
    args = _inputs(rng)
    want = np.asarray(jax_hat(*map(jnp.asarray, args)))
    got = deform_conv2d_hat(*map(torch.from_numpy, args)).numpy()
    # the same roundings (corner weights bf16(ay*bx*m), the sample to
    # bf16, f32 accumulation): only the f32 summation order differs, and
    # with it, rarely, the bf16 rounding of one sample (2^-8 of that
    # sample times its weight, ~1e-3 of max|out| here). Measured 6e-8;
    # the forward that kept the corner weights in f32 gave 2.2e-3.
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(), rtol=0)
    f32 = deform_conv2d(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, f32, atol=2e-2 * np.abs(f32).max(), rtol=0)


@pytest.mark.parametrize("impl", ["xla", "hat"])
def test_dcn_block_matches_flax(rng, impl):
    B, H, W, C, G, Cout = 2, 9, 9, 16, 4, 8
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    ref = jdc.DCN(features=Cout, deformable_groups=G, dtype=jnp.float32, impl=impl)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-zero offset/mask predictor: fractional offsets of about +-2 px
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.normal(0, 0.1 if "conv_offset_mask" in str(p) else 0.3,
                                a.shape).astype(np.float32), v)
    want_out, want_offs = ref.apply(v, jnp.asarray(x))
    want_out, want_offs = np.asarray(want_out), np.asarray(want_offs)
    assert np.abs(want_offs).max() > 1.0

    mod = DCN(C, Cout, deformable_groups=G, impl=impl)
    mod.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        out, offs = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(offs.numpy(), want_offs, rtol=1e-5, atol=1e-5)
    # f32 gather: sum order only; hat: the same bf16 roundings in another
    # sum order (see above; measured 1.1e-7 of max, 3.7e-3 with f32
    # corner weights)
    atol = 1e-5 if impl == "xla" else 1e-3 * np.abs(want_out).max()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), want_out,
                               atol=atol, rtol=1e-5 if impl == "xla" else 0)


# ---- the backward kernel's dx: samples bucketed by corner cell, gathered ----


def _dx_gather(x, py, px, m, wg, g):
    """A mirror of the dx of csrc/deform_conv_bwd.cu: the samples (b, p,
    g, k) bucketed by their top-left corner cell (floor(py), floor(px)) in
    [-1, H-1] x [-1, W-1], each bucket in flat-index order; each dx
    element the f32 sum, in the order of the cells (qy, qx), (qy, qx - 1),
    (qy - 1, qx), (qy - 1, qx - 1) and of their samples, of bf16(ay * bx *
    m) * dU with the plain version's dU."""
    B, H, W, C = x.shape
    _, P, G, K = py.shape
    Cg = C // G
    gb = g.to(torch.bfloat16).float()
    du = torch.stack([torch.einsum("bpn,gcn->bpgc", gb, wg[:, k].float())
                      .to(torch.bfloat16).float() for k in range(K)], dim=3).reshape(-1, Cg)
    fy, fx, mk = py.reshape(-1), px.reshape(-1), m.reshape(-1)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wi = torch.arange(fy.numel())
    valid = (y0 >= -1) & (y0 <= H - 1) & (x0 >= -1) & (x0 <= W - 1)
    cell = (((wi // (P * G * K)) * G + (wi // K) % G) * (H + 1) + y0.long() + 1) * (W + 1) \
        + x0.long() + 1
    buckets = [[] for _ in range(B * G * (H + 1) * (W + 1))]
    for i in wi[valid].tolist():  # ascending flat index
        buckets[cell[i]].append(i)
    dx = torch.zeros(B, H, W, G, Cg)
    for b in range(B):
        for qy in range(H):
            for qx in range(W):
                for gg in range(G):
                    acc = torch.zeros(Cg)
                    for dy, dxx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                        c = ((b * G + gg) * (H + 1) + qy - dy + 1) * (W + 1) + qx - dxx + 1
                        for i in buckets[c]:
                            ay = torch.clamp(1 - (fy[i] - (y0[i] + dy)).abs(), min=0)
                            bx = torch.clamp(1 - (fx[i] - (x0[i] + dxx)).abs(), min=0)
                            w = (ay * bx * mk[i]).to(torch.bfloat16).float()
                            acc = acc + w * du[i]
                    dx[b, qy, qx, gg] = acc
    return dx.reshape(B, H, W, C)


def test_hat_bwd_dx_gather_matches_plain(rng):
    from gssd_torch.ops.kernels import deform_hat as dh

    B, H, W, C, G, K, Cout = 2, 5, 6, 8, 2, 9, 6
    x, oy, ox, m, w, _ = _inputs(rng, B, H, W, C, G, K, Cout)
    # offsets over +-3 px (outside the map), a third whole numbers
    # (integer coordinates), a quarter of the masks zero
    oy, ox = oy * 1.5, ox * 1.5
    whole = rng.uniform(size=oy.shape) < 1 / 3
    oy[whole], ox[whole] = np.round(oy[whole]), np.round(ox[whole])
    m[rng.uniform(size=m.shape) < 1 / 4] = 0
    py, px = dh.sample_coords(torch.from_numpy(oy), torch.from_numpy(ox))
    P = H * W
    args = (torch.from_numpy(x).bfloat16(), py.reshape(B, P, G, K).contiguous(),
            px.reshape(B, P, G, K).contiguous(),
            torch.from_numpy(m).reshape(B, P, G, K).contiguous(),
            torch.from_numpy(w).reshape(K, G, C // G, Cout).permute(1, 0, 2, 3)
            .bfloat16().contiguous(),
            torch.from_numpy(rng.normal(size=(B, P, Cout)).astype(np.float32)))
    got = _dx_gather(*args)
    want = dh.deform_conv_bwd_f32(*args)[3]
    # the same exact terms w_q * dU, f32 sums in another order
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err
