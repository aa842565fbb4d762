"""The port's separable deformable sampler and the two DCN routes built on
it against gssd_tpu: ``abx_sample`` (the plain versions of the three CUDA
kernels behind an autograd Function) against the Pallas kernels in
interpret mode, ``deform_conv2d_pallas`` and ``deform_conv2d_fused``
in output and in every gradient at fractional, zero and integer offsets,
and the DCN block on both routes against the flax block.

Everything is f32 outside the kernels' own bf16 roundings, which the two
packages make at the same places on the same values; what is left is the
f32 summation order (measured below 1e-6 of each tensor's largest entry)
and, rarely, a bf16 rounding that a last-bit difference flips. The
tolerances are 1e-4 of the largest entry, which no flip-free difference
approaches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.ops import deform_conv as jdc
from gssd_tpu.ops.deform_fused import deform_conv2d_fused as jax_fused
from gssd_tpu.ops.pallas import deform_sample as jds
from gssd_torch.ops.deform_conv import DCN
from gssd_torch.ops.deform_fused import deform_conv2d_fused
from gssd_torch.ops.kernels import deform_sample as ds
from gssd_torch.params import from_jax_variables

TOL = 1e-4


def _close(got, want, name, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max err {err:.3g} > {tol} * {scale:.3g}"


def test_hat_weights_derivative_is_jax_at_integers():
    pos = np.array([2.0, 2.5, -1.0, 4.0, 5.0, 0.0, 3.25], np.float32)
    g = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    want_v, vjp = jax.vjp(lambda p: jds.hat_weights(p, 5), jnp.asarray(pos))
    want_d = np.asarray(vjp(jnp.asarray(g))[0])
    p = torch.from_numpy(pos).requires_grad_()
    got = ds.hat_weights(p, 5)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want_v))
    # exact: at most three non-zero terms of +-1, +-0.5 times g
    np.testing.assert_allclose(p.grad.numpy(), want_d, rtol=1e-6, atol=1e-6)


def test_abx_sample_forward_and_vjp_match_pallas(rng):
    N, G, P, H, W, Cg = 2, 2, 20, 5, 6, 8
    A = rng.uniform(0, 1, (N, G, P, H)).astype(np.float32)
    B = rng.uniform(0, 1, (N, G, P, W)).astype(np.float32)
    xg = rng.normal(size=(N, G, H, W, Cg)).astype(np.float32)
    g = rng.normal(size=(N, G, P, Cg)).astype(np.float32)
    want, vjp = jax.vjp(jds.abx_sample, *map(jnp.asarray, (A, B, xg)))
    want_grads = vjp(jnp.asarray(g))

    ts = [torch.from_numpy(a).requires_grad_() for a in (A, B, xg)]
    got = ds.abx_sample(*ts)
    got.backward(torch.from_numpy(g))
    _close(got.detach(), want, "sampled")
    for name, t, w in zip(("dA", "dB", "dx"), ts, want_grads):
        _close(t.grad, w, name)


def _inputs(rng, case, B=2, H=6, W=6, C=8, G=2, K=9, Cout=4):
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    shape = (B, H, W, G, K)
    if case == "fractional":  # up to +-2 px, past the border
        oy, ox = (rng.uniform(-2, 2, shape).astype(np.float32) for _ in range(2))
    elif case == "zero":  # the zero-initialised offset conv: every sample on the grid
        oy = ox = np.zeros(shape, np.float32)
    else:  # whole pixels, some outside the map
        oy, ox = (rng.integers(-2, 3, shape).astype(np.float32) for _ in range(2))
    m = rng.uniform(0, 1, shape).astype(np.float32)
    w = (rng.normal(size=(K, C, Cout)) * 0.3).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    gout = rng.normal(size=(B, H, W, Cout)).astype(np.float32)
    return (x, oy, ox, m, w, b), gout


@functools.lru_cache(maxsize=None)
def _jax_vjp(route):
    fn = jds.deform_conv2d_pallas if route == "pallas" else jax_fused

    @jax.jit
    def run(args, gout):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(gout)

    return run


@pytest.mark.parametrize("case", ["fractional", "zero", "integer"])
@pytest.mark.parametrize("route", ["pallas", "fused"])
def test_deform_conv2d_routes_match_jax(rng, route, case):
    args, gout = _inputs(rng, case)
    want, want_grads = _jax_vjp(route)(tuple(map(jnp.asarray, args)), jnp.asarray(gout))
    fn = ds.deform_conv2d_pallas if route == "pallas" else deform_conv2d_fused
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got = fn(*ts)
    got.backward(torch.from_numpy(gout))
    _close(got.detach(), want, f"{route} out")
    for name, t, w in zip(("x", "offset_y", "offset_x", "mask", "weight", "bias"),
                          ts, want_grads):
        _close(t.grad, w, f"{route} d{name}")


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_dcn_block_matches_flax(rng, impl):
    B, H, W, C, G, Cout = 2, 6, 6, 16, 4, 8
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    ref = jdc.DCN(features=Cout, deformable_groups=G, dtype=jnp.float32, impl=impl)
    v = jax.eval_shape(ref.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.normal(0, 0.1 if "conv_offset_mask" in str(p) else 0.3,
                                a.shape).astype(np.float32), v)
    want_out, want_offs = map(np.asarray, jax.jit(ref.apply)(v, jnp.asarray(x)))
    assert np.abs(want_offs).max() > 1.0

    mod = DCN(C, Cout, deformable_groups=G, impl=impl)
    mod.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        out, offs = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(offs.numpy(), want_offs, rtol=1e-5, atol=1e-5)
    _close(out.permute(0, 2, 3, 1), want_out, f"DCN[{impl}]")


# ---- the dx kernel's order: non-zero ranges, zero terms skipped ----


def _ranges(rows):
    """The dx kernel's pre-pass: (first, last) non-zero index of each
    row of rows [..., n], (1, 0) for an all-zero row."""
    nz = rows != 0
    idx = torch.arange(rows.shape[-1])
    first = torch.where(nz, idx, rows.shape[-1]).amin(-1)
    last = torch.where(nz, idx, -1).amax(-1)
    empty = last < 0
    return torch.where(empty, 1, first), torch.where(empty, 0, last)


def _dx_skipping_zeros(a, b, g):
    """A mirror of csrc/deform_sample_dx.cu: per (n, g), p ascending, add
    A[p, qy] * (B[p, qx] * g[p]) to the cells inside both rows' non-zero
    ranges only."""
    af, bf, gf = a.float(), b.float(), g.float()
    N, G, P, H = a.shape
    out = torch.zeros(N, G, H, b.shape[-1], g.shape[-1])
    (alo, ahi), (blo, bhi) = _ranges(af), _ranges(bf)
    for n in range(N):
        for gg in range(G):
            for p in range(P):
                y0, y1, x0, x1 = (int(t[n, gg, p]) for t in (alo, ahi, blo, bhi))
                if y0 > y1 or x0 > x1:
                    continue
                e = bf[n, gg, p, x0:x1 + 1, None] * gf[n, gg, p]
                out[n, gg, y0:y1 + 1, x0:x1 + 1] += af[n, gg, p, y0:y1 + 1, None, None] * e
    return out


def _dx_dense_order(a, b, g):
    """Every term of the dense contraction, one p at a time."""
    af, bf, gf = a.float(), b.float(), g.float()
    out = torch.zeros(*a.shape[:2], a.shape[-1], b.shape[-1], g.shape[-1])
    for p in range(a.shape[2]):
        out += af[:, :, p, :, None, None] * (bf[:, :, p, None, :, None] * gf[:, :, p, None, None])
    return out


def _hat_rows(rng, N=2, G=2, H=7, W=6):
    """Hat weights A (times the mask) and B of the sampler at the centre
    tap with offsets over +-3 px (samples outside the map), a third of
    them whole numbers (integer coordinates), a quarter of the mask rows
    zero; and, in the last 5 p, dense rows (more than two non-zeros)."""
    P = H * W
    off = rng.uniform(-3, 3, (2, N, G, P)).astype(np.float32)
    whole = rng.uniform(size=off.shape) < 1 / 3
    off[whole] = np.round(off[whole])
    py = np.repeat(np.arange(H), W).astype(np.float32) + off[0]
    px = np.tile(np.arange(W), H).astype(np.float32) + off[1]
    m = rng.uniform(0, 1, (N, G, P)).astype(np.float32)
    m[rng.uniform(size=m.shape) < 1 / 4] = 0
    a = ds.hat_weights(torch.from_numpy(py), H) * torch.from_numpy(m)[..., None]
    b = ds.hat_weights(torch.from_numpy(px), W)
    a[:, :, -5:] = torch.from_numpy(rng.uniform(0.1, 1, (N, G, 5, H)).astype(np.float32))
    b[:, :, -5:, ::2] = torch.from_numpy(rng.uniform(0.1, 1, (N, G, 5, (W + 1) // 2))
                                         .astype(np.float32))
    return a.bfloat16(), b.bfloat16()


def test_sample_dx_skipping_zeros_matches_plain_and_pallas(rng):
    a, b = _hat_rows(rng)
    assert (a == 0).all(-1).any() and ((a != 0).sum(-1) > 2).any()
    g = torch.from_numpy(rng.normal(size=(*a.shape[:3], 16)).astype(np.float32)).bfloat16()
    got = _dx_skipping_zeros(a, b, g)
    # the terms skipped are exact zeros: the dense order's sum bit for bit
    assert torch.equal(got, _dx_dense_order(a, b, g))
    # against the plain version and the Pallas kernel (interpret mode):
    # the same exact terms, f32 sums in another order
    _close(got, ds.abx_dx_plain(a, b, g), "dx vs plain", tol=1e-6)
    want = jds._abx_bwd_dx(*(jnp.asarray(t.float().numpy()) for t in (a, b, g)))
    _close(got, want, "dx vs pallas", tol=1e-6)


# ---- the forward kernel's order: non-zero ranges, multiply and add apart ----


def _fwd_skipping_zeros(a, b, x):
    """A mirror of csrc/deform_sample_fwd.cu: per (n, g, p), for qx in B's
    non-zero range, ascending, T = the products a * x over A's range
    added in ascending qy, then acc = acc + b * T; f32, every multiply
    and add rounded on its own."""
    af, bf, xf = a.float(), b.float(), x.float()
    N, G, P, H = a.shape
    out = torch.zeros(N, G, P, x.shape[-1])
    (alo, ahi), (blo, bhi) = _ranges(af), _ranges(bf)
    for n in range(N):
        for gg in range(G):
            for p in range(P):
                y0, y1, x0, x1 = (int(t[n, gg, p]) for t in (alo, ahi, blo, bhi))
                acc = out[n, gg, p]
                for qx in range(x0, x1 + 1):
                    t = torch.zeros(x.shape[-1])
                    for qy in range(y0, y1 + 1):
                        t = t + af[n, gg, p, qy] * xf[n, gg, qy, qx]
                    acc = acc + bf[n, gg, p, qx] * t
                out[n, gg, p] = acc
    return out


def test_sample_fwd_skipping_zeros_matches_plain_and_pallas(rng):
    a, b = _hat_rows(rng)
    x = torch.from_numpy(rng.normal(size=(*a.shape[:2], a.shape[-1], b.shape[-1], 16))
                         .astype(np.float32)).bfloat16()
    got = _fwd_skipping_zeros(a, b, x)
    # hat rows (all but the last 5 p): at most two non-zero exact terms
    # in each sum, so the plain version's dense order gives the same bits
    plain = ds.abx_fwd_plain(a, b, x)
    assert torch.equal(got[:, :, :-5], plain[:, :, :-5])
    # dense rows too, against the plain version and the Pallas kernel
    # (interpret mode): f32 sums in another order
    _close(got, plain, "fwd vs plain", tol=1e-6)
    want = jds._abx_fwd_impl(*(jnp.asarray(t.float().numpy()) for t in (a, b, x)))
    _close(got, want, "fwd vs pallas", tol=1e-6)


# ---- the dA/dB kernel's buckets: pixels by the first non-zero of a row ----


def _dab_buckets(rows, tile):
    """A mirror of csrc/deform_sample_dab.cu's dab_buckets for one (n, g)
    and one pass: the p sorted (stably) by the first non-zero index of
    their hat row, all-zero rows last, cut into tiles of up to ``tile``
    p; [(lo, [p, ...])]."""
    lo, hi = _ranges(rows)
    R = rows.shape[-1]
    key = torch.where(lo <= hi, lo, R)
    order = sorted(range(rows.shape[0]), key=lambda p: int(key[p]))
    tiles = []
    for k in sorted(set(int(key[p]) for p in order)):
        ps = [p for p in order if int(key[p]) == k]
        tiles += [(k, ps[i:i + tile]) for i in range(0, len(ps), tile)]
    return tiles


def _dab_skipping_zeros(x, g, a, b, tile):
    """dA and dB as the bucketed kernel forms them: each tile walks r from
    its bucket's lo to the largest last non-zero index of its p, adding
    bf16(S[p, r] * g[p]) . x over channels; all-zero rows give zero rows."""
    xf, gf, af, bf = x.float(), g.float(), a.float(), b.float()
    N, G, P, H = a.shape
    W = b.shape[-1]
    out = []
    for side, (S, Q) in enumerate(((bf, H), (af, W))):
        d = torch.full((N, G, P, Q), float("nan"))
        for n in range(N):
            for gg in range(G):
                lo, hi = _ranges(S[n, gg])
                tiles = _dab_buckets(S[n, gg], tile)
                # every p once, in a tile of its own bucket
                assert sorted(p for _, ps in tiles for p in ps) == list(range(P))
                for r0, ps in tiles:
                    if r0 == S.shape[-1]:
                        d[n, gg, ps] = 0.0
                        continue
                    r1 = max(int(hi[p]) for p in ps)
                    # the walk covers every p's non-zero range
                    assert all(int(lo[p]) == r0 and int(hi[p]) <= r1 for p in ps)
                    acc = torch.zeros(len(ps), Q)
                    for r in range(r0, r1 + 1):
                        e = (S[n, gg, ps, r, None] * gf[n, gg, ps]).bfloat16().float()
                        xr = xf[n, gg, :, r] if side == 0 else xf[n, gg, r]
                        acc = acc + e @ xr.T
                    d[n, gg, ps] = acc
        out.append(d)
    return out


@pytest.mark.parametrize("tile", [64, 3])  # 64: the kernel's tile (TPB)
def test_sample_dab_buckets_match_plain_and_pallas(rng, tile):
    a, b = _hat_rows(rng)
    N, G, P, H = a.shape
    W = b.shape[-1]
    assert (a == 0).all(-1).any()
    x = torch.from_numpy(rng.normal(size=(N, G, H, W, 16)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(N, G, P, 16)).astype(np.float32)).bfloat16()
    da, db = _dab_skipping_zeros(x, g, a, b, tile)
    # a p whose A row is all zero (a zero mask) has a zero dB row, and one
    # whose B row is (a sample left of or right of the map) a zero dA row
    assert (db[(a == 0).all(-1)] == 0).all() and (da[(b == 0).all(-1)] == 0).all()
    for name, got, want in zip(("dA", "dB"), (da, db), ds.abx_dab_plain(x, g, a, b)):
        _close(got, want, f"{name} vs plain", tol=1e-6)
    want_da, want_db, _ = jds._abx_bwd(tuple(jnp.asarray(t.float().numpy()) for t in (a, b, x)),
                                       jnp.asarray(g.float().numpy()))
    _close(da, want_da, "dA vs pallas", tol=1e-6)
    _close(db, want_db, "dB vs pallas", tol=1e-6)
