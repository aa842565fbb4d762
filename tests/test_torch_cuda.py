"""The port's CUDA kernels against their plain PyTorch versions on the
card, at ragged shapes the serving and training paths do not reach
(chip_smoke.py covers their shapes). CUDA kernels have no CPU mode: without a card
every test here skips.

    python -m pytest tests/test_torch_cuda.py -m cuda    # on a GPU host
"""

import pytest
import torch

from gssd_torch.ops.kernels import dcn_contract as dc
from gssd_torch.ops.kernels import deform_hat as dh
from gssd_torch.ops.kernels import deform_sample as ds
from gssd_torch.ops.kernels import flash_attn as fa
from gssd_torch.ops.kernels import flash_contract as fc
from gssd_torch.ops.kernels import stem_conv as sc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,N,M,dk,dv", [
    (2, 70, 9, 16, 48), (1, 1, 1, 32, 16), (3, 130, 130, 128, 512), (2, 64, 200, 64, 96),
    # the new design's edges: ragged 128-row and 64-key tiles at the 75x75
    # site, N and M off both, dv 512 (two column slices), dk 128, N < 64
    # with M > N
    (2, 5625, 5625, 32, 128), (2, 130, 70, 64, 256), (2, 200, 200, 128, 512),
    (2, 100, 100, 128, 256), (2, 30, 100, 32, 128)])
def test_flash_kernel_matches_plain(gen, B, N, M, dk, dv):
    q = torch.randn(B, N, dk, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, M, dk, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, M, dv, device="cuda", generator=gen).bfloat16()
    before = fa.KERNEL.launches
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    # a bf16 rounding of P can flip between the two summation orders
    assert (o - o_ref).abs().max() <= 1e-2 * o_ref.abs().max()
    assert (lse - lse_ref).abs().max() <= 1e-4 * lse_ref.abs().max().clamp(min=1)
    # the rounding contract, on inputs whose logits are exact in any order
    qc, kc, vc = fc.contract_inputs(q, k, v)
    oc, _ = fa.flash_attention_fwd(qc, kc, vc)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 2
    oc_ref, _ = fa.flash_attention_fwd_plain(qc, kc, vc)
    assert fc.mean_rel_err(oc, oc_ref) <= fc.mean_limit("o", oc_ref)


@pytest.mark.parametrize("B,H,W,C,G,Cout,stride", [
    (2, 9, 11, 24, 4, 36, 1), (1, 20, 20, 512, 4, 256, 2), (1, 3, 3, 16, 1, 8, 1),
    # the tiling's edges: batch 1 at the serving site (P = 1444, not a
    # multiple of the 64-pixel tile; Cout 512 over two warpgroups, Cg
    # 256), Cg 128 at Cout 256, Cout 300 (the second warpgroup's columns
    # ragged), Cout 520 (two column slices), Cg 512
    (1, 38, 38, 1024, 4, 512, 1), (3, 13, 11, 512, 4, 256, 1), (2, 9, 9, 1024, 4, 300, 1),
    (1, 10, 10, 128, 2, 520, 1), (1, 7, 7, 1024, 2, 64, 1)])
def test_dcn_kernel_matches_plain(gen, B, H, W, C, G, Cout, stride):
    K = 9
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, H, W, C, device="cuda", generator=gen)
    oy, ox = (torch.randn(B, Ho, Wo, G, K, device="cuda", generator=gen) * 2
              for _ in range(2))
    m = torch.rand(B, Ho, Wo, G, K, device="cuda", generator=gen)
    w = torch.randn(K, C, Cout, device="cuda", generator=gen) * 0.1
    b = torch.randn(Cout, device="cuda", generator=gen)
    before = dh.KERNEL.launches
    out = dh.deform_conv2d_hat(x, oy, ox, m, w, b, stride=stride)
    torch.cuda.synchronize()
    assert dh.KERNEL.launches == before + 1
    ref = dh.deform_conv2d_hat(*(t.cpu() for t in (x, oy, ox, m, w, b)), stride=stride)
    assert (out.cpu() - ref).abs().max() <= 1e-2 * ref.abs().max()
    # the rounding contract: the plain version's roundings, f32 sums in
    # another order
    assert dc.mean_rel_err(out.cpu(), ref) <= dc.mean_limit("out", ref)


def test_wrappers_reject_bad_inputs(gen):
    q = torch.randn(1, 8, 16, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, q, q)  # f32, not bf16
    qb = q.bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(qb.transpose(1, 2).contiguous().transpose(1, 2), qb, qb)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(torch.zeros(1, 8, 24, device="cuda").bfloat16(),
                               torch.zeros(1, 8, 24, device="cuda").bfloat16(), qb)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("B,N,M,dk,dv", [
    (2, 70, 9, 16, 48), (1, 1, 1, 32, 16), (2, 200, 200, 128, 512), (3, 9, 200, 48, 96),
    (1, 130, 1, 64, 256),
    # the new design's edges: ragged 128-key and 64-query tiles at the
    # 75x75 site, N and M off both, dv 512 (two walks), dk 128, N < 64
    # with M > N
    (2, 5625, 5625, 32, 128), (2, 130, 70, 64, 256), (3, 130, 130, 128, 512),
    (2, 100, 100, 128, 256), (2, 30, 100, 32, 128),
    # dV's chain in segments of 1024 queries: three with a ragged last at
    # PixelLink++ 2s's widths (dk 16, dv 64), and two walks of dV (dv 272)
    (1, 2100, 300, 16, 64), (1, 1090, 70, 64, 272)])
def test_flash_bwd_kernel_matches_plain(gen, B, N, M, dk, dv):
    q = torch.randn(B, N, dk, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, M, dk, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, M, dv, device="cuda", generator=gen).bfloat16()
    do = torch.randn(B, N, dv, device="cuda", generator=gen).bfloat16()
    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    before = fa.BWD_KERNEL.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert fa.BWD_KERNEL.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    # against the largest of the three gradients: at M = 1 the softmax is
    # constant, so dq and dk are 0 in exact arithmetic and rounding noise
    scale = max(t.float().abs().max().item() for t in want)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        # same roundings; f32 sums in another order can move a bf16
        # rounding of P or of the result by one step
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-2 * scale, (name, err, scale)
    # the rounding contract, on inputs whose logits and dP are exact in
    # any order: f32 dS into dq and dk, per output
    qc, kc, vc, doc = fc.contract_inputs(q, k, v, do)
    oc, lsec = fa.flash_attention_fwd_plain(qc, kc, vc)
    gotc = fa.flash_attention_bwd(qc, kc, vc, oc, lsec, doc)
    torch.cuda.synchronize()
    assert fa.BWD_KERNEL.launches == before + 2
    wantc = fa.flash_attention_bwd_plain(qc, kc, vc, oc, lsec, doc)
    errs, limits = fc.bwd_mean_errs(gotc, wantc, M), fc.bwd_mean_limits(wantc, M)
    assert all(e <= lim for e, lim in zip(errs, limits)), (errs, limits)


@pytest.mark.parametrize("B,H,W,C,G,Cout", [
    (2, 9, 11, 24, 4, 36), (1, 5, 4, 12, 2, 8), (1, 6, 5, 16, 4, 24), (1, 20, 20, 512, 4, 256),
    (2, 3, 3, 16, 1, 40),
    # the tiling's edges: batch 1 at the training site (B*P = 1444, not a
    # multiple of the 128-row dU tile; Cg 256, Cout 512), Cg 128 at Cout
    # 256 with B*P = 646 (ten 64-pixel chunks and a ragged one, over the
    # dW splits), Cg 512 (dU in two column chunks) at Cout 136
    (1, 38, 38, 1024, 4, 512), (2, 19, 17, 512, 4, 256), (3, 7, 9, 1024, 2, 136)])
def test_dcn_bwd_kernel_matches_plain(gen, B, H, W, C, G, Cout):
    K = 9
    P = H * W
    x = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
    base_y = torch.arange(H, device="cuda").repeat_interleave(W).float() - 1
    base_x = torch.arange(W, device="cuda").repeat(H).float() - 1
    tap = torch.arange(K, device="cuda")
    # offsets over +-3 px (corners outside the map), a third of them whole
    # numbers (samples on integer coordinates)
    off = torch.rand(2, B, P, G, K, device="cuda", generator=gen) * 6 - 3
    whole = torch.rand(off.shape, device="cuda", generator=gen) < 1 / 3
    off = torch.where(whole, off.round(), off)
    py = (base_y[None, :, None, None] + (tap // 3).float() + off[0]).contiguous()
    px = (base_x[None, :, None, None] + (tap % 3).float() + off[1]).contiguous()
    m = torch.rand(B, P, G, K, device="cuda", generator=gen)
    wg = (torch.randn(G, K, C // G, Cout, device="cuda", generator=gen) * 0.1).bfloat16()
    g = torch.randn(B, P, Cout, device="cuda", generator=gen)
    before = dh.BWD_KERNEL.launches
    got = dh.deform_conv_bwd(x, py, px, m, wg, g)
    torch.cuda.synchronize()
    assert dh.BWD_KERNEL.launches == before + 1
    want = dh.deform_conv_bwd_plain(x, py, px, m, wg, g)
    for name, a, b in zip(["dpy", "dpx", "dm", "dx", "dwg"], got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        # same roundings; f32 sums in another order
        assert _rel_err(a, b) <= 1e-2, (name, _rel_err(a, b))
    errs = dc.readings(dc.BWD_OUTPUTS, got, want)
    assert not dc.violations(errs, dc.limits(dc.BWD_OUTPUTS, want)), errs


def test_autograd_goes_through_both_kernels(gen):
    q, k = (torch.randn(2, 30, 16, device="cuda", generator=gen).requires_grad_()
            for _ in range(2))
    v = torch.randn(2, 30, 32, device="cuda", generator=gen).requires_grad_()
    before = (fa.KERNEL.launches, fa.BWD_KERNEL.launches)
    fa.flash_attention(q, k, v).sum().backward()
    assert (fa.KERNEL.launches, fa.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    x = torch.randn(1, 6, 7, 8, device="cuda", generator=gen).requires_grad_()
    oy, ox = (torch.randn(1, 6, 7, 2, 9, device="cuda", generator=gen).requires_grad_()
              for _ in range(2))
    mk = torch.rand(1, 6, 7, 2, 9, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(9, 8, 8, device="cuda", generator=gen).requires_grad_()
    b = torch.randn(8, device="cuda", generator=gen).requires_grad_()
    before = (dh.KERNEL.launches, dh.BWD_KERNEL.launches)
    dh.deform_conv2d_hat(x, oy, ox, mk, w, b).square().sum().backward()
    assert (dh.KERNEL.launches, dh.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (x, oy, ox, mk, w, b))


def _hat_rows(gen, N, G, P, H, W):
    """The sampler's hat rows: positions over the map and 3 px past each
    border (samples outside the map), a third of them whole numbers
    (integer coordinates), A times a mask with a quarter of it zero."""
    pos = []
    for n in (H, W):
        t = torch.rand(N, G, P, device="cuda", generator=gen) * (n + 5) - 3
        whole = torch.rand(t.shape, device="cuda", generator=gen) < 1 / 3
        pos.append(torch.where(whole, t.round(), t))
    m = torch.rand(N, G, P, 1, device="cuda", generator=gen)
    m = torch.where(torch.rand(m.shape, device="cuda", generator=gen) < 1 / 4, 0.0, m)
    with torch.no_grad():
        return ((ds.hat_weights(pos[0], H) * m).bfloat16().contiguous(),
                ds.hat_weights(pos[1], W).bfloat16().contiguous())


@pytest.mark.parametrize("N,G,P,H,W,Cg,rows", [
    (1, 2, 30, 5, 7, 8, "dense"), (2, 3, 200, 17, 13, 72, "dense"),
    (1, 1, 1444, 38, 38, 256, "dense"), (1, 1, 300, 64, 64, 16, "dense"),
    (1, 1, 1, 1, 1, 8, "dense"),
    # H or W past 64: no hat row is held whole in registers
    (1, 2, 300, 70, 90, 24, "dense"),
    # hat rows: the forward is the plain version's bit for bit; the 75x75
    # site of PixelLink++ (P = 5625, Cg = 128) and a ragged map
    (2, 3, 200, 17, 13, 72, "hat"), (1, 2, 5625, 75, 75, 128, "hat"),
    (2, 2, 777, 33, 130, 40, "hat"),
    # a map too tall for the range pass's and the buckets' shared memory
    (1, 1, 100, 3000, 2, 8, "hat")])
def test_deform_sample_kernels_match_plain(gen, N, G, P, H, W, Cg, rows):
    if rows == "dense":  # dense hat rows with a few zeros, as the sampler's are mostly zero
        a, b = (torch.rand(N, G, P, n, device="cuda", generator=gen) for n in (H, W))
        a, b = (torch.where(t < 0.3, 0.0, t).bfloat16() for t in (a, b))
    else:
        a, b = _hat_rows(gen, N, G, P, H, W)
    x = torch.randn(N, G, H, W, Cg, device="cuda", generator=gen).bfloat16()
    g = torch.randn(N, G, P, Cg, device="cuda", generator=gen).bfloat16()
    kernels = (ds.FWD_KERNEL, ds.DX_KERNEL, ds.DAB_KERNEL)
    before = [k.launches for k in kernels]
    got = (ds.abx_fwd(a, b, x), ds.abx_dx(a, b, g), *ds.abx_dab(x, g, a, b))
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [n + 1 for n in before]
    want = (ds.abx_fwd_plain(a, b, x), ds.abx_dx_plain(a, b, g), *ds.abx_dab_plain(x, g, a, b))
    for name, u, v in zip(("fwd", "dx", "dA", "dB"), got, want):
        assert u.dtype == v.dtype == torch.float32 and u.shape == v.shape
        # the same roundings; only the f32 summation order differs (the
        # tensor cores' for dA and dB; the order over p for dx; the order
        # over a dense row's cells for fwd). With dense rows that is up to
        # ~1e-6 of max over 1444 terms; a bf16 E or T, or a TF32 product,
        # reads ~1e-4 to ~2e-3
        assert _rel_err(u, v) <= 1e-5, (name, _rel_err(u, v))
    if rows == "hat":
        # at most two non-zero exact terms in each sum: one rounding in any
        # order, so the forward is the dense order's bit for bit
        assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_dcn_routes_go_through_the_sample_kernels(gen, impl):
    from gssd_torch.ops.deform_conv import resolve_deform_impl

    fn = resolve_deform_impl(impl, 7 * 9, "cuda")
    x = torch.randn(2, 7, 9, 16, device="cuda", generator=gen).bfloat16().requires_grad_()
    oy, ox = (torch.randn(2, 7, 9, 2, 9, device="cuda", generator=gen).requires_grad_()
              for _ in range(2))
    mk = torch.rand(2, 7, 9, 2, 9, device="cuda", generator=gen).requires_grad_()
    w = (torch.randn(9, 16, 8, device="cuda", generator=gen) * 0.1).requires_grad_()
    b = torch.randn(8, device="cuda", generator=gen).requires_grad_()
    kernels = (ds.FWD_KERNEL, ds.DX_KERNEL, ds.DAB_KERNEL)
    before = [k.launches for k in kernels]
    fn(x, oy, ox, mk, w, b).float().square().sum().backward()
    torch.cuda.synchronize()
    want = [9, 9, 9] if impl == "pallas" else [0, 9, 0]
    assert [k.launches - n for k, n in zip(kernels, before)] == want
    assert all(torch.isfinite(t.grad).all() for t in (x, oy, ox, mk, w, b))


def _repeat_case(name, gen):
    """(a kernel boundary, its inputs) at a ragged shape of each boundary
    that sums in a fixed order instead of with atomics, that skips the
    hat rows' zeros, or whose blocks walk a persistent tile loop (the hat
    DCN forward)."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    if name == "flash_attn_bwd":
        q, k = randn(2, 700, 32).bfloat16(), randn(2, 700, 32).bfloat16()
        v, do = randn(2, 700, 128).bfloat16(), randn(2, 700, 128).bfloat16()
        o, lse = fa.flash_attention_fwd_plain(q, k, v)
        return fa.flash_attention_bwd, (q, k, v, o, lse, do)
    if name in ("deform_conv_fwd", "deform_conv_bwd"):
        B, H, W, C, G, K, Cout = 2, 19, 17, 64, 4, 9, 48
        P = H * W
        base_y = torch.arange(H, device="cuda").repeat_interleave(W).float() - 1
        base_x = torch.arange(W, device="cuda").repeat(H).float() - 1
        tap = torch.arange(K, device="cuda")
        off = torch.rand(2, B, P, G, K, device="cuda", generator=gen) * 6 - 3
        off = torch.where(torch.rand(off.shape, device="cuda", generator=gen) < 1 / 3,
                          off.round(), off)
        py = (base_y[None, :, None, None] + (tap // 3).float() + off[0]).contiguous()
        px = (base_x[None, :, None, None] + (tap % 3).float() + off[1]).contiguous()
        m = torch.rand(B, P, G, K, device="cuda", generator=gen)
        wg = (randn(G, K, C // G, Cout) * 0.1).bfloat16()
        x = randn(B, H, W, C).bfloat16()
        if name == "deform_conv_fwd":
            return dh.deform_conv_fwd, (x, py, px, m, wg, randn(Cout))
        return dh.deform_conv_bwd, (x, py, px, m, wg, randn(B, P, Cout))
    if name.startswith("deform_sample"):
        N, G, P, H, W, Cg = 2, 2, 300, 19, 17, 72
        pos = [torch.rand(N, G, P, device="cuda", generator=gen) * (n + 4) - 2 for n in (H, W)]
        with torch.no_grad():
            a = (ds.hat_weights(pos[0], H) * torch.rand(N, G, P, 1, device="cuda",
                                                        generator=gen)).bfloat16()
            b = ds.hat_weights(pos[1], W).bfloat16()
        g = randn(N, G, P, Cg).bfloat16()
        if name == "deform_sample_dx":
            return ds.abx_dx, (a, b, g)
        # the forward and the dA/dB passes (whose pixels are placed into
        # buckets by a scatter) at the same shape
        x = randn(N, G, H, W, Cg).bfloat16()
        if name == "deform_sample_fwd":
            return ds.abx_fwd, (a, b, x)
        return ds.abx_dab, (x, g, a, b)
    x = torch.rand(2, 64, 45, 70, device="cuda", generator=gen).bfloat16()
    w = randn(64, 16, 3, 3) / 12
    if name == "stem_conv_fwd":
        return (lambda *t: sc.stem_conv_fwd(*t, 4)), (x, w.bfloat16(), randn(64))
    return (lambda *t: sc.stem_conv_bwd(*t, 4)), (x, w, randn(2, 64, 45, 70).bfloat16())


@pytest.mark.parametrize("name", ["flash_attn_bwd", "deform_conv_fwd", "deform_conv_bwd",
                                  "deform_sample_fwd", "deform_sample_dx", "deform_sample_dab",
                                  "stem_conv_fwd", "stem_conv_bwd"])
def test_kernels_repeat_bit_equal(gen, name):
    # the same inputs twice: every output the same bits (no sum whose
    # order depends on the blocks' schedule)
    fn, args = _repeat_case(name, gen)
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b), name


def test_sample_dx_is_the_dense_order(gen):
    # the dx kernel adds only the terms inside each hat row's non-zero
    # range, in ascending p; every term is exact in f32, so that is the
    # dense order's sum bit for bit: sum_p A[p, qy] * (B[p, qx] * g[p])
    # one p at a time. Rows with more than two non-zeros and all-zero
    # rows (a zero mask) included
    fn, (a, b, g) = _repeat_case("deform_sample_dx", gen)
    a[:, :, :5] = torch.rand(a[:, :, :5].shape, device="cuda", generator=gen).bfloat16()
    a[:, :, 5:9] = 0
    got = fn(a, b, g)
    af, bf, gf = a.float(), b.float(), g.float()
    want = torch.zeros_like(got)
    for p in range(a.shape[2]):
        want += af[:, :, p, :, None, None] * (bf[:, :, p, None, :, None] * gf[:, :, p, None, None])
    assert torch.equal(got, want)


# chip_smoke.py's limits for the stem kernels: bf16 outputs within one
# ulp of the plain version (at the element's magnitude, or at max / 256
# for smaller ones: near-cancelling sums carry their large terms' f32
# order noise), with at most STEM_DIFF_SHARE of the elements differing
# (the same roundings, f32 sums in another order); f32 outputs and dW
# within STEM_DW_TOL of max |plain|; the f32 forward (three bf16 parts of
# w) also within stem_conv.STEM_F32_MEAN_TOL of the function in f64 (mean
# error over mean value), which a planted two-part split must read at
# least STEM_F32_PLANTED_MIN times above
STEM_ULP_MAX = 1
STEM_DIFF_SHARE = 2e-4
STEM_DW_TOL = 2e-5
STEM_F32_PLANTED_MIN = 5


def _bf16_ulp_err(got, want):
    g, w = got.float(), want.float()
    scale = torch.maximum(w.abs(), w.abs().max() / 256).clamp(min=1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)


@pytest.mark.parametrize("B,Cin,Cout,G,H,W,dtype", [
    (2, 12, 24, 4, 23, 37, torch.bfloat16),    # ragged tiles, 6 channels a group out
    (2, 12, 64, 4, 23, 37, torch.bfloat16),    # conv1_1's 3 channels a group (folded), ragged
    (1, 64, 64, 1, 9, 70, torch.bfloat16),     # one group of 64: channel chunks
    (2, 8, 16, 2, 33, 65, torch.float32),      # an f32 model: f32 weights and outputs
    (2, 12, 64, 4, 33, 65, torch.float32),     # f32 at conv1_1's channels
    (2, 64, 64, 4, 33, 64, torch.float32),     # f32 at conv1_2's channels, 4-pixel rows
    (16, 64, 64, 4, 300, 300, torch.bfloat16),  # conv1_2 of PixelLink++ at batch 16
])
def test_stem_conv_kernels_match_plain(gen, monkeypatch, B, Cin, Cout, G, H, W, dtype):
    # the plain versions are f32 cuDNN convs: full f32, as chip_smoke.py sets it
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x = torch.rand(B, Cin, H, W, device="cuda", generator=gen).to(dtype)
    w = torch.randn(Cout, Cin // G, 3, 3, device="cuda", generator=gen) / (3 * Cin / G) ** 0.5
    b = torch.randn(Cout, device="cuda", generator=gen) * 0.5
    g = torch.randn(B, Cout, H, W, device="cuda", generator=gen).to(dtype)
    # each boundary is one launch: the forward (weights packed, then the
    # conv) and the backward (dx's weights and conv, dW, its sum)
    before = (sc.FWD_KERNEL.launches, sc.BWD_KERNEL.launches)
    y = sc.stem_conv_fwd(x, w.to(dtype), b, G)
    assert (sc.FWD_KERNEL.launches, sc.BWD_KERNEL.launches) == (before[0] + 1, before[1])
    dx, dw = sc.stem_conv_bwd(x, w, g, G)
    assert (sc.FWD_KERNEL.launches, sc.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    _, dw_only = sc.stem_conv_bwd(x, w, g, G, need_dx=False)
    torch.cuda.synchronize()
    assert (sc.FWD_KERNEL.launches, sc.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 2)
    yp = sc.stem_conv_fwd_plain(x, w.to(dtype), b, G)
    dxp, dwp = sc.stem_conv_bwd_plain(x, w, g, G)
    # the share limit was read at 144 summed terms (conv1_2: 16 channels x 9
    # taps); the order noise, and with it the share of flipped roundings,
    # grows with the number of terms
    limit = STEM_DIFF_SHARE * max(1.0, 9 * Cin / G / 144)
    for name, got, want in (("y", y, yp), ("dx", dx, dxp)):
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        if dtype == torch.bfloat16:
            ulp, share = _bf16_ulp_err(got, want).max(), (got != want).float().mean()
            assert ulp <= STEM_ULP_MAX and share <= limit, (name, ulp.item(), share.item())
        else:
            assert _rel_err(got, want) <= STEM_DW_TOL, (name, _rel_err(got, want))
    if dtype == torch.float32:
        y64 = sc.stem_conv_fwd_f64(x, w, b, G)
        err = sc.f32_mean_err(y, y64)
        planted = sc.f32_mean_err(sc.stem_conv_fwd_split(x, w, b, G, 2), y64)
        assert err <= sc.STEM_F32_MEAN_TOL, err
        assert planted >= STEM_F32_PLANTED_MIN * sc.STEM_F32_MEAN_TOL, planted
    assert dw.dtype == torch.float32 and torch.equal(dw, dw_only)
    assert _rel_err(dw, dwp) <= STEM_DW_TOL, _rel_err(dw, dwp)


@pytest.mark.parametrize("Cin,G", [(64, 1), (12, 1), (64, 4)])
def test_stem_dw_against_f64_at_fssd_sites(gen, monkeypatch, Cin, G):
    """dW of the kernel and of the plain version at the FSSD trunk's stem
    sites (batch 32, 300x300, 64 output channels, ungrouped and 4 groups)
    within STEM_DW_TOL of max |dW| against the same sum in f64. The plain
    version's earlier dW, cuDNN's f32 weight gradient, read 1.46e-4 at 64
    -> 64 ungrouped (PERF.md §6, PR 14)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    B, H, W, Cout = 32, 300, 300, 64
    x = torch.rand(B, Cin, H, W, device="cuda", generator=gen).bfloat16()
    w = torch.randn(Cout, Cin // G, 3, 3, device="cuda", generator=gen) / (3 * Cin / G) ** 0.5
    g = torch.randn(B, Cout, H, W, device="cuda", generator=gen).bfloat16()
    _, dw = sc.stem_conv_bwd(x, w, g, G, need_dx=False)
    torch.cuda.synchronize()
    _, dwp = sc.stem_conv_bwd_plain(x, w, g, G, need_dx=False)
    dw64 = sum(torch.nn.grad.conv2d_weight(x[i:i + 4].double(), tuple(w.shape),
                                           g[i:i + 4].double(), padding=1, groups=G)
               for i in range(0, B, 4))
    for name, got in (("kernel", dw), ("plain", dwp)):
        err = ((got - dw64).abs().max() / dw64.abs().max()).item()
        assert err <= STEM_DW_TOL, (name, err)


def test_stem_conv_wrappers_reject_bad_inputs(gen):
    x = torch.rand(1, 12, 16, 16, device="cuda", generator=gen).bfloat16()
    w = torch.randn(16, 3, 3, 3, device="cuda", generator=gen).bfloat16()
    b = torch.zeros(16, device="cuda")
    with pytest.raises(TypeError):
        sc.stem_conv_fwd(x, w.float(), b, 4)
    with pytest.raises(ValueError):
        sc.stem_conv_fwd(x.transpose(2, 3), w, b, 4)
    odd = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape)
    odd.copy_(x)  # contiguous, 2 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        sc.stem_conv_fwd(odd, w, b, 4)
