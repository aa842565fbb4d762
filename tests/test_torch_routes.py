"""The port's route gates by device (the fused attention boundaries and
the hat DCN), the hat route against gssd_tpu's gather route just past the
JAX package's hat gate, and the f64 references of the hat backward's dW
(``dcn_contract.dw_exact``) and of the attention backward
(``flash_contract.bwd_exact``). Each check states its tolerance."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gssd_tpu.ops import deform_conv as jdc
from gssd_tpu.ops.pallas import flash_attn as jfa
from gssd_torch.ops import deform_conv as tdc
from gssd_torch.ops import layers
from gssd_torch.ops.kernels import dcn_contract as dc
from gssd_torch.ops.kernels import deform_hat as dh
from gssd_torch.ops.kernels import flash_attn as fa
from gssd_torch.ops.kernels import flash_contract as fc


@pytest.mark.parametrize("m", [1, 8192, 8193, 22500])
def test_flash_gate_by_device(m):
    """The CPU keeps the JAX package's key limit, so that the CPU tests
    compare its route; a CUDA device admits every key count (deciding
    launches nothing, so no card is needed)."""
    assert fa.flash_eligible(m, "cpu") == jfa.flash_eligible(m) == (m <= 8192)
    assert fa.flash_eligible(m, torch.device("cuda"))
    assert fa.flash_eligible(m, "cuda:0")


@pytest.mark.parametrize("max_m", [8192, 8])
def test_self_attention_asks_the_gate_for_its_device(monkeypatch, max_m):
    """SelfAttention passes its tensors' device to the gate; on the CPU a
    key count past MAX_M (here lowered to 8: a 4 x 4 map has 16 keys)
    takes the plain path, as the JAX package does."""
    asked, fused = [], []
    real_gate, real_flash = layers.flash_eligible, layers.flash_attention

    def gate(m, device):
        asked.append((m, torch.device(device)))
        return real_gate(m, device)

    def flash(*a):
        fused.append(a[1].shape[1])
        return real_flash(*a)

    monkeypatch.setattr(fa, "MAX_M", max_m)
    monkeypatch.setattr(layers, "flash_eligible", gate)
    monkeypatch.setattr(layers, "flash_attention", flash)
    mod = layers.SelfAttention(16, generator=torch.Generator().manual_seed(0))
    mod.sigma.data.fill_(0.5)
    x = torch.randn(1, 16, 4, 4, generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.no_grad():
        out, _, _ = mod(x)
    assert asked == [(16, torch.device("cpu"))]
    assert fused == ([16] if max_m >= 16 else [])
    assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("hw", [6000, 6001, 22500])
def test_hat_gate_by_device(monkeypatch, hw):
    """On the CPU 'hat' falls back to the gather route past the JAX
    package's 6000 positions (its route, by name); on a CUDA device it
    takes the hat kernels at every map size, unless GSSD_HAT_MAX_HW is
    set, which both devices honour."""
    monkeypatch.delenv("GSSD_HAT_MAX_HW", raising=False)
    cpu = tdc.resolve_deform_impl("hat", hw, "cpu")
    assert cpu.__name__ == jdc.resolve_deform_impl("hat", hw).__name__
    assert cpu is (dh.deform_conv2d_hat if hw <= 6000 else tdc.deform_conv2d)
    assert tdc.resolve_deform_impl("hat", hw, torch.device("cuda")) is dh.deform_conv2d_hat
    monkeypatch.setenv("GSSD_HAT_MAX_HW", "6000")
    want = dh.deform_conv2d_hat if hw <= 6000 else tdc.deform_conv2d
    for device in ("cpu", "cuda"):
        assert tdc.resolve_deform_impl("hat", hw, device) is want
    assert tdc.resolve_deform_impl("xla", hw, "cuda") is tdc.deform_conv2d


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def test_hat_route_matches_jax_gather_past_its_gate(rng):
    """Just past the JAX package's hat gate (78 x 78 = 6084 positions),
    where JAX runs its gather route: the port's hat route (the kernels'
    plain versions on the CPU) computes the same DCNv2, forward and the
    gradients of all six inputs, and differs only in its bf16 roundings
    (corner weights, samples, g and dU; x and the weights are bf16 values
    here): within 2e-2 of each output's max (the forward's bound in
    test_torch_deform.py), direction within cosine 0.9999 (measured at
    most 4.9e-3, at least 0.999994)."""
    B, H, W, C, G, K, Cout = 1, 78, 78, 8, 4, 9, 8
    x = _bf16(rng.normal(size=(B, H, W, C)).astype(np.float32))
    oy = rng.uniform(-2, 2, (B, H, W, G, K)).astype(np.float32)
    ox = rng.uniform(-2, 2, (B, H, W, G, K)).astype(np.float32)
    m = rng.uniform(0, 1, (B, H, W, G, K)).astype(np.float32)
    w = _bf16((rng.normal(size=(K, C, Cout)) * 0.2).astype(np.float32))
    b = rng.normal(size=(Cout,)).astype(np.float32)
    r = rng.normal(size=(B, H, W, Cout)).astype(np.float32)
    args = (x, oy, ox, m, w, b)
    assert H * W > 6000
    assert jdc.resolve_deform_impl("hat", H * W) is jdc.deform_conv2d

    def jloss(*a):
        out = jdc.deform_conv2d(*a)
        return jnp.sum(out * r), out

    (_, want_out), want_grads = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                                   has_aux=True)(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = dh.deform_conv2d_hat(*ts)
    (out * torch.from_numpy(r)).sum().backward()
    pairs = [("out", out.detach().numpy(), np.asarray(want_out))]
    pairs += [(n, t.grad.numpy(), np.asarray(g))
              for n, t, g in zip(("x", "oy", "ox", "m", "w", "b"), ts, want_grads)]
    for name, got, want in pairs:
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(), rtol=0,
                                   err_msg=name)
        cos = np.sum(got * want) / np.sqrt(np.sum(got ** 2) * np.sum(want ** 2))
        assert cos >= 0.9999, (name, cos)


def _grid_inputs(rng, B=2, H=5, W=5, C=8, G=2, K=9, Cout=6):
    """Hat DCN backward operands on which every f32 sum of the plain
    version is exact: x and g on a 1/4 grid, offsets on a 1/2 grid, m in
    {1/2, 1} (corner weights in {0, 1/8, 1/4, 1/2, 1}, samples on a 1/32
    grid, dW sums on a 1/128 grid far below 2^24 steps)."""
    P = H * W
    x = torch.from_numpy(rng.integers(-8, 9, (B, H, W, C)) / 4).bfloat16()
    off = torch.from_numpy(rng.integers(-3, 4, (2, B, H, W, G, K)) / 2).float()
    py, px = dh.sample_coords(off[0], off[1])
    m = torch.from_numpy(rng.integers(1, 3, (B, P, G, K)) / 2).float()
    wg = torch.from_numpy(rng.normal(size=(G, K, C // G, Cout))).bfloat16()
    g = torch.from_numpy(rng.integers(-8, 9, (B, P, Cout)) / 4).float()
    return (x, py.reshape(B, P, G, K).contiguous(), px.reshape(B, P, G, K).contiguous(), m,
            wg, g)


def test_dw_exact_is_the_plain_dw_where_f32_is_exact(rng):
    """``dcn_contract.dw_exact`` (samples and g rounded to bf16, dW summed
    in f64, rounded once to bf16) equals the plain backward's dW bit for
    bit where every f32 sum of the plain version is exact; on random
    inputs the two differ by f32 summation only (within the contract's
    mean limit for dW), while a planted unrounded sample reads above it."""
    args = _grid_inputs(rng)
    exact = dc.dw_exact(*args)
    plain = dh.deform_conv_bwd_plain(*args)[4]
    assert exact.dtype == torch.float64 and exact.shape == plain.shape
    assert torch.equal(plain.double(), exact)
    assert exact.abs().max() > 0

    B, H, W, C, G, K, Cout = 2, 9, 9, 8, 4, 9, 6
    x = torch.from_numpy(rng.normal(size=(B, H, W, C))).bfloat16()
    off = torch.from_numpy(rng.uniform(-2, 2, (2, B, H, W, G, K))).float()
    py, px = (t.reshape(B, H * W, G, K).contiguous() for t in dh.sample_coords(off[0], off[1]))
    m = torch.from_numpy(rng.uniform(0, 1, (B, H * W, G, K))).float()
    wg = torch.from_numpy(rng.normal(size=(G, K, C // G, Cout))).bfloat16()
    g = torch.from_numpy(rng.normal(size=(B, H * W, Cout))).float()
    args = (x, py, px, m, wg, g)
    exact = dc.dw_exact(*args)
    limit = dc.mean_limit("dwg", exact)
    assert dc.mean_rel_err(dh.deform_conv_bwd_plain(*args)[4], exact) <= limit
    assert dc.mean_rel_err(dc.bwd_fault(*args, "unrounded_sample")[4], exact) > limit


@pytest.mark.parametrize("n,dk,dv", [(1, 32, 16), (300, 16, 64)])
def test_bwd_exact_is_the_attention_contract(n, dk, dv):
    """``flash_contract.bwd_exact`` (P, dS and the products in f64, each
    gradient rounded once to bf16) on contract inputs: the plain
    backward (f32 sums) reads within the contract's limits against it,
    the planted bf16 dS above them (dq and dk; with one key dq and dk are
    0 in exact arithmetic, as the plain version's are)."""
    g = torch.Generator().manual_seed(n)
    q, k, v, do = fc.contract_inputs(*(torch.randn(2, n, d, generator=g)
                                       for d in (dk, dk, dv, dv)))
    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    exact = fc.bwd_exact(q, k, v, o, lse, do)
    assert all(t.dtype == torch.float64 for t in exact)
    limits = fc.bwd_mean_limits(exact, n)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert all(e <= lim for e, lim in zip(fc.bwd_mean_errs(plain, exact, n), limits))
    planted = fc.bwd_mean_errs(fc.bwd_split(q, k, v, o, lse, do, 1), exact, n)
    if n == 1:
        assert torch.equal(exact[0], torch.zeros_like(exact[0])) and not plain[0].any()
    else:
        assert all(e > lim for e, lim in zip(planted[:2], limits[:2])), (planted, limits)
