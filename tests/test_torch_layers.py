"""The port's layers (gssd_torch.ops.layers) against their flax
counterparts in gssd_tpu.ops.layers, weights carried by
gssd_torch.params, inputs made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.ops import layers as jl
from gssd_tpu.ops.pallas.flash_attn import _fwd_impl as jax_flash_fwd
from gssd_tpu.ops.pallas.flash_attn import flash_attention as jax_flash
from gssd_torch.ops import layers as tl
from gssd_torch.ops.kernels.flash_attn import flash_attention, flash_attention_fwd
from gssd_torch.params import from_jax_variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _init(module, x, rng, **kw):
    """flax variables with every leaf re-drawn from the seeded rng (BN
    variances positive, sigma non-zero) so that each path contributes."""
    v = module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if "var" in str(p[-1])
                      else rng.normal(0, 0.3, a.shape)).astype(np.float32), v)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("k,s,p,d", [(3, 1, 1, 1), (1, 1, 0, 1), (3, 2, 1, 1), (3, 1, 6, 6)],
                         ids=["3x3", "1x1", "3x3s2", "conv6_dil6"])
def test_conv_bn_relu(rng, k, s, p, d):
    x = rng.normal(size=(2, 13, 13, 8)).astype(np.float32)
    ref = jl.ConvBNRelu(16, kernel=k, stride=s, padding=p, dilation=d,
                        groups=4, use_bn=True, dtype=jnp.float32)
    v = _init(ref, x, rng)
    want = np.asarray(ref.apply(v, jnp.asarray(x)))
    mod = tl.ConvBNRelu(8, 16, k, s, p, d, groups=4, use_bn=True).eval()
    mod.load_state_dict(from_jax_variables(v), strict=True)
    got = _nhwc(mod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # f32 sum order


@pytest.mark.parametrize("hw,window,stride,ceil,pad", [
    (75, 2, 2, True, 0), (19, 3, 1, False, 1), (38, 2, 2, False, 0)],
    ids=["ceil_75_to_38", "pool5", "floor"])
def test_max_pool(rng, hw, window, stride, ceil, pad):
    x = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    want = np.asarray(jl.max_pool(jnp.asarray(x), window, stride,
                                  ceil_mode=ceil, padding=pad))
    got = _nhwc(tl.max_pool(_nchw(x), window, stride, ceil_mode=ceil, padding=pad))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # a max is exact


def test_adaptive_avg_pool(rng):
    x = rng.normal(size=(2, 7, 7, 4)).astype(np.float32)
    for t in (3, 7):
        want = np.asarray(jl.adaptive_avg_pool(jnp.asarray(x), t))
        got = _nhwc(tl.adaptive_avg_pool(_nchw(x), t))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_l2norm(rng):
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32)
    ref = jl.L2Norm()
    v = _init(ref, x, rng)
    mod = tl.L2Norm(16)
    mod.load_state_dict(from_jax_variables(v), strict=True)
    np.testing.assert_allclose(_nhwc(mod(_nchw(x))),
                               np.asarray(ref.apply(v, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_sndense(rng):
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    ref = jl.SNDense(8, dtype=jnp.float32)
    v = _init(ref, x, rng)
    mod = tl.SNDense(16, 8).eval()  # the frozen-vector form flax applies by default
    mod.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(v, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,pool_factor", [("float32", 1), ("float32", 2), ("bfloat16", 1)],
                         ids=["f32", "f32_pooled_kv", "bf16_flash"])
def test_self_attention(rng, dtype, pool_factor):
    x = rng.normal(size=(2, 6, 6, 32)).astype(np.float32)
    ref = jl.SelfAttention(max_pool_factor=pool_factor, dtype=jnp.dtype(dtype))
    v = _init(ref, x, rng)
    out_j, scaled_j, attn_j = ref.apply(v, jnp.asarray(x, dtype))
    mod = tl.SelfAttention(32, pool_factor).eval()  # flax's default train=False
    mod.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        out_t, scaled_t, attn_t = mod(_nchw(x).to(getattr(torch, dtype)),
                                      return_attn=True)
    if dtype == "float32":
        tol = dict(rtol=1e-4, atol=1e-4)  # f32, sum order only
    else:
        # bf16 activations round at different places in the two
        # frameworks (matmul epilogues, the flash output cast)
        tol = dict(rtol=0.05, atol=0.05 * np.abs(np.asarray(scaled_j, np.float32)).max())
    np.testing.assert_allclose(_nhwc(scaled_t), np.asarray(scaled_j, np.float32), **tol)
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j, np.float32),
                               rtol=tol["rtol"], atol=max(tol["atol"], 1e-4))
    np.testing.assert_allclose(attn_t.float().numpy(), np.asarray(attn_j, np.float32),
                               rtol=tol["rtol"], atol=0.01 if dtype != "float32" else 1e-5)


def test_flash_plain_matches_pallas_interpret(rng):
    # N != M, ragged key count (9 of a 128-wide TPU key tile)
    B, N, M, dk, dv = 2, 36, 9, 8, 16
    q = rng.normal(0, 1, (B, N, dk)).astype(np.float32)
    k = rng.normal(0, 1, (B, M, dk)).astype(np.float32)
    v = rng.normal(0, 1, (B, M, dv)).astype(np.float32)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want_o, want_l = jax_flash_fwd(qb, kb, vb)  # Pallas, interpret mode off-TPU
    want = np.asarray(jax_flash(qb, kb, vb), np.float32)

    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv)
    # P = exp(s - lse) here vs exp(s - max) / sum on the TPU: equal up to
    # f32 rounding, which can flip a bf16 rounding of P (2^-8 relative)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_l)[:, :N, 0], rtol=1e-6, atol=1e-5)
    got = flash_attention(tq, tk, tv).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


def test_params_reject_unknown_and_missing_keys(rng):
    from gssd_torch.params import load_jax_variables

    x = rng.normal(size=(1, 5, 5, 8)).astype(np.float32)
    v = _init(jl.ConvBNRelu(8, use_bn=True, dtype=jnp.float32), x, rng)
    flat = {"params/Conv_0/kernel": v["params"]["Conv_0"]["kernel"],
            "params/Conv_0/bias": v["params"]["Conv_0"]["bias"]}
    mod = tl.ConvBNRelu(8, 8, use_bn=True)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_variables(mod, flat)  # no BatchNorm_0 entries
    with pytest.raises(KeyError):
        from_jax_variables({**flat, "params/Conv_0/scale_x": np.ones(8)})
    load_jax_variables(mod, v)
