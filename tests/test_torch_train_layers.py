"""Train forms of the port's layers against flax on the CPU: BatchNorm
with batch statistics and their running update (also a 1x1 map at batch
1), SNDense with its power iteration, and the gradients of
SelfAttention (plain f32 path and bf16 flash path) and of the DCN block
(gather and hat kernel) against jax.grad of the flax modules. Weights
are carried by gssd_torch.params; inputs are made from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.ops import deform_conv as jdc
from gssd_tpu.ops import layers as jl
from gssd_torch.ops import layers as tl
from gssd_torch.ops.deform_conv import DCN
from gssd_torch.params import from_jax_variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _redraw(v, rng, scale=0.3):
    """Every leaf re-drawn from the seeded rng (BN variances positive)."""
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if "var" in str(p[-1])
                      else rng.normal(0, scale, a.shape)).astype(np.float32), v))


def _grads_by_name(mod):
    return {k: p.grad.numpy() for k, p in mod.named_parameters()}


def _assert_grads(mod, jgrads, tol):
    """Each parameter gradient of ``mod`` against the flax gradient tree
    (mapped by from_jax_variables), within tol times the largest flax
    gradient of the module: some gradients are 0 in exact arithmetic (a
    bias on the attention keys shifts every logit of a row alike), so
    their own scale is rounding noise."""
    want = {k: v.numpy() for k, v in from_jax_variables({"params": jgrads}).items()}
    got = _grads_by_name(mod)
    assert set(got) == set(want), (set(got) ^ set(want))
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=tol * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape,k,p", [((2, 9, 9, 8), 3, 1), ((1, 1, 1, 8), 1, 0)],
                         ids=["3x3_batch2", "1x1_map_batch1"])
def test_conv_bn_relu_train(rng, shape, k, p):
    x = rng.normal(size=shape).astype(np.float32)
    ref = jl.ConvBNRelu(16, kernel=k, padding=p, groups=4, use_bn=True, dtype=jnp.float32)
    v = _redraw(ref.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want, mut = ref.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    mod = tl.ConvBNRelu(8, 16, k, 1, p, groups=4, use_bn=True).train()
    mod.load_state_dict(from_jax_variables(v), strict=True)
    got = mod(_nchw(x))
    # f32; the batch statistics sum in another order
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(mod.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)


def test_sndense_train(rng):
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    ref = jl.SNDense(8, dtype=jnp.float32)
    v = _redraw(ref.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    g = rng.normal(size=(2, 10, 8)).astype(np.float32)

    def loss(params):
        y, mut = ref.apply({**v, "params": params}, jnp.asarray(x), train=True,
                           mutable=["spectral"])
        return jnp.sum(y * g), (y, mut)

    (_, (want, mut)), jgrads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    mod = tl.SNDense(16, 8).train()
    mod.load_state_dict(from_jax_variables(v), strict=True)
    got = mod(torch.from_numpy(x))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(mod, name).numpy(),
                                   np.asarray(mut["spectral"][name]), rtol=1e-5, atol=1e-6)
    _assert_grads(mod, jgrads, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32_plain", "bf16_flash"])
def test_self_attention_gradients(rng, dtype):
    x = rng.normal(size=(2, 5, 5, 32)).astype(np.float32)
    g = rng.normal(size=(2, 5, 5, 32)).astype(np.float32)
    ref = jl.SelfAttention(dtype=jnp.dtype(dtype))
    v = _redraw(ref.init(jax.random.PRNGKey(0), jnp.asarray(x, dtype)), rng)
    v["params"]["sigma"] = np.full((1,), 0.7, np.float32)

    def loss(params, xx):
        (out, _, _), mut = ref.apply({**v, "params": params}, xx.astype(dtype), train=True,
                                     mutable=["spectral"])
        return jnp.sum(out.astype(jnp.float32) * g)

    jgrads, jdx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    mod = tl.SelfAttention(32).train()
    mod.load_state_dict(from_jax_variables(v), strict=True)
    xt = _nchw(x).requires_grad_()
    out, _, _ = mod(xt.to(getattr(torch, dtype)))
    (out.float() * _nchw(g)).sum().backward()
    # f32: sum order only; bf16: activations round at other places in
    # the two frameworks (matmul epilogues, casts around the kernel)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _assert_grads(mod, jgrads, tol)
    w = np.asarray(jdx)
    np.testing.assert_allclose(_nhwc(xt.grad), w, atol=tol * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("impl", ["xla", "hat"])
def test_dcn_gradients(rng, impl):
    B, H, W, C, G, Cout = 1, 7, 6, 16, 4, 8
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, H, W, Cout)).astype(np.float32)
    ref = jdc.DCN(features=Cout, deformable_groups=G, dtype=jnp.float32, impl=impl)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # offsets of about +-2 px: border taps sample outside the map
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.normal(0, 0.1 if "conv_offset_mask" in str(p) else 0.3,
                                a.shape).astype(np.float32), v)

    def loss(params, xx):
        out, _ = ref.apply({"params": params}, xx)
        return jnp.sum(out * g)

    jgrads, jdx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    mod = DCN(C, Cout, deformable_groups=G, impl=impl)
    mod.load_state_dict(from_jax_variables(v), strict=True)
    xt = _nchw(x).requires_grad_()
    out, _ = mod(xt)
    (out * _nchw(g)).sum().backward()
    # xla: f32, sum order only. hat: the same bf16 roundings on both
    # sides (g, dU, corner weights, samples, and dx / dW at the end); f32
    # sums in another order can move a bf16 result by one step
    tol = 1e-4 if impl == "xla" else 2e-2
    _assert_grads(mod, jgrads, tol)
    w = np.asarray(jdx)
    np.testing.assert_allclose(_nhwc(xt.grad), w, atol=tol * np.abs(w).max(), rtol=0)
