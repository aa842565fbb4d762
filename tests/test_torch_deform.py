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
