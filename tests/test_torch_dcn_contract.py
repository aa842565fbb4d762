"""The hat DCN kernels' rounding contract on the CPU: the mean-error check
of ``dcn_contract`` (``MEAN_TOL`` per output) reads 0 for the plain
versions against themselves and rejects each planted fault (corner
weights kept in f32, the sample not rounded, g not rounded, dU not
rounded) on every output it touches; the plain versions are held against
JAX's Pallas hat kernels (``_fwd_impl``, ``_bwd_impl``) in interpret
mode. Small shapes, a few seconds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.ops.pallas.deform_hat import _bwd_impl as jax_hat_bwd
from gssd_tpu.ops.pallas.deform_hat import _fwd_impl as jax_hat_fwd
from gssd_torch.ops.kernels import dcn_contract as dc
from gssd_torch.ops.kernels import deform_hat as dh


def _inputs(seed, B, H, W, C, G, Cout, K=9):
    """Seeded kernel inputs: offsets over +-3 px (corners outside the
    map), a third of them whole numbers (integer coordinates)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    x = t(rng.normal(size=(B, H, W, C))).bfloat16()
    off = rng.uniform(-3, 3, (2, B, H, W, G, K))
    whole = rng.uniform(size=off.shape) < 1 / 3
    off[whole] = np.round(off[whole])
    py, px = dh.sample_coords(t(off[0]), t(off[1]))
    P = H * W
    m = t(rng.uniform(0, 1, (B, P, G, K)))
    w = t(rng.uniform(-1, 1, (K, C, Cout)) / np.sqrt(K * C))
    wg = w.reshape(K, G, C // G, Cout).permute(1, 0, 2, 3).bfloat16().contiguous()
    return (x, py.reshape(B, P, G, K).contiguous(), px.reshape(B, P, G, K).contiguous(), m, wg,
            t(rng.normal(size=Cout) * 0.1), t(rng.normal(size=(B, P, Cout))))


@pytest.fixture(scope="module")
def site():
    x, py, px, m, wg, bias, g = _inputs(0, 2, 6, 7, 32, 4, 24)
    fwd, bwd = (x, py, px, m, wg, bias), (x, py, px, m, wg, g)
    return fwd, bwd, dh.deform_conv_fwd_plain(*fwd), dh.deform_conv_bwd_plain(*bwd)


def test_plain_against_itself_reads_zero(site):
    fwd, bwd, out, grads = site
    assert dc.readings(dc.FWD_OUTPUTS, (dh.deform_conv_fwd_plain(*fwd),), (out,)) == {"out": 0.0}
    errs = dc.readings(dc.BWD_OUTPUTS, dh.deform_conv_bwd_plain(*bwd), grads)
    assert errs == dict.fromkeys(dc.BWD_OUTPUTS, 0.0)


@pytest.mark.parametrize("fault", sorted(dc.FAULTS))
def test_fault_reads_above_the_limit(site, fault):
    fwd, bwd, out, grads = site
    lims = dc.limits(dc.FWD_OUTPUTS + dc.BWD_OUTPUTS, (out,) + tuple(grads))
    faults = dc.bwd_faults(bwd, grads)
    if "out" in dc.AFFECTS[fault]:
        faults[fault].update(dc.fwd_faults(fwd)[fault])
    assert not dc.faults_missed({fault: faults[fault]}, lims), faults[fault]
    # each violation moves the outputs it touches by ~1.5-2.6e-3 of their
    # mean (a bf16 step of what it leaves unrounded): far above the limits
    assert min(faults[fault][n] for n in dc.AFFECTS[fault]) > 20 * max(dc.MEAN_TOL.values())


def test_plain_versions_match_jax_hat_interpret():
    B, H, W, C, G, Cout, K = 2, 8, 8, 16, 2, 8, 9
    x, py, px, m, wg, _, g = _inputs(1, B, H, W, C, G, Cout)
    P, Cg = H * W, C // G

    def bgpk(t):  # [B, P, G, K] -> [B, G, P, K]
        return jnp.asarray(t.permute(0, 2, 1, 3).numpy())

    xf = jnp.asarray(x.float().reshape(B, P, G, Cg).permute(0, 2, 1, 3).numpy(), jnp.bfloat16)
    wj = jnp.asarray(wg.float().reshape(G, K * Cg, Cout).numpy(), jnp.bfloat16)
    out = dh.deform_conv_fwd_plain(x, py, px, m, wg, torch.zeros(Cout))
    want = torch.from_numpy(np.array(jax_hat_fwd(bgpk(py), bgpk(px), bgpk(m), xf, wj, W)))
    # the same roundings; f32 sums in another order, which can flip the
    # bf16 rounding of a sample now and then (2^-8 of that one term)
    assert dc.mean_rel_err(out, want) <= dc.MEAN_TOL["out"]

    got = dh.deform_conv_bwd_plain(x, py, px, m, wg, g)
    jdpy, jdpx, jdm, jdx, jdw = jax_hat_bwd(bgpk(py), bgpk(px), bgpk(m), xf,
                                            jnp.swapaxes(wj, 1, 2), jnp.asarray(g.numpy()), W)

    def back(a):  # [B, G, P, K] -> [B, P, G, K]
        return torch.from_numpy(np.array(a)).permute(0, 2, 1, 3)

    want = (back(jdpy), back(jdpx), back(jdm),
            torch.from_numpy(np.array(jdx.astype(jnp.bfloat16).astype(jnp.float32)))
            .permute(0, 2, 1, 3).reshape(B, H, W, C),
            torch.from_numpy(np.array(jdw.astype(jnp.bfloat16).astype(jnp.float32)))
            .reshape(G, K, Cg, Cout))
    errs = dc.readings(dc.BWD_OUTPUTS, got, want)
    # the JAX kernel forms dS, dx and dW through dense hat matrices: the
    # same roundings, f32 sums in another order (a bf16 rounding of dU, dx
    # or dW can flip)
    assert all(e <= dc.MEAN_TOL[n] for n, e in errs.items()), errs
