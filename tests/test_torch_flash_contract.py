"""The attention kernels' rounding contract on the CPU: the mean-error
check (``flash_contract.mean_rel_err`` against ``MEAN_TOL``) passes the
exact reorderings a kernel may make and rejects the usual violations,
measured against the plain versions, and for the forward also against
the contract computed in f64 (``fwd_exact``), the reference the card
check holds the forward kernel to.

- exact: exp2 in place of exp in the forward; dS split into three bf16
  parts for the dQ and dK products (the split sums back to dS exactly);
- violations: an online-softmax forward, a two-part split, a bf16 dS.

At the 38x38 GSSD++ site (N = M = 1444, dk 64, dv 256) at batch 8, on
``contract_inputs`` (logits exact in any summation order), as on the
card; the
plain backward is also held against JAX's Pallas backward in interpret
mode at a small ragged shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.ops.pallas.flash_attn import _bwd_impl as jax_flash_bwd
from gssd_tpu.ops.pallas.flash_attn import _fwd_impl as jax_flash_fwd
from gssd_torch.ops.kernels import flash_attn as fa
from gssd_torch.ops.kernels import flash_contract as fc


def _inputs(seed, B, N, M, dk, dv):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()

    return bf16(B, N, dk), bf16(B, M, dk), bf16(B, M, dv), bf16(B, N, dv)


@pytest.fixture(scope="module")
def site():
    q, k, v, do = fc.contract_inputs(*_inputs(0, 8, 1444, 1444, 64, 256))
    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    return q, k, v, do, o, lse, fa.flash_attention_bwd_plain(q, k, v, o, lse, do)


def test_exact_forward_reads_below_the_limit(site):
    q, k, v, _, o, lse, _ = site
    got, got_lse = fc.fwd_exp2(q, k, v)
    assert fc.mean_rel_err(got, o) < fc.MEAN_TOL["o"] / 10
    assert fc.mean_rel_err(got_lse, lse) < fc.MEAN_TOL["o"] / 10


def test_online_softmax_reads_above_the_limit(site):
    q, k, v, _, o, lse, _ = site
    got, got_lse = fc.fwd_online_softmax(q, k, v)
    assert fc.mean_rel_err(got, o) > 10 * fc.MEAN_TOL["o"]
    assert fc.mean_rel_err(got_lse, lse) < fc.MEAN_TOL["o"]  # the lse is not at fault


def test_three_part_split_reads_below_the_limit(site):
    q, k, v, do, o, lse, want = site
    errs = fc.bwd_mean_errs(fc.bwd_split(q, k, v, o, lse, do, 3), want, 1444)
    assert all(e < lim for e, lim in zip(errs, fc.bwd_mean_limits(want, 1444))), errs


@pytest.mark.parametrize("parts", [1, 2], ids=["bf16_ds", "two_part_split"])
def test_split_violations_read_above_the_limit(site, parts):
    q, k, v, do, o, lse, want = site
    dq, dk, dv = fc.bwd_mean_errs(fc.bwd_split(q, k, v, o, lse, do, parts), want, 1444)
    assert dv == 0  # dV does not consume dS
    lim_q, lim_k, _ = fc.bwd_mean_limits(want, 1444)
    assert dq > lim_q and dk > lim_k, (dq, dk)


def test_three_part_split_is_exact():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(64, 96)) * 10.0 ** rng.integers(-20, 20, (64, 96)))
                         .astype(np.float32))
    parts = fc.split_bf16(x, 3)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    assert torch.equal((parts[0].float() + parts[1].float()) + parts[2].float(), x)
    # dS K through the parts: each part product is exact, so the sum
    # differs from the f32 product only in the order of the f32 sums
    ds = torch.from_numpy(rng.normal(size=(2, 80, 70)).astype(np.float32))
    kf = torch.from_numpy(rng.normal(size=(2, 70, 32)).astype(np.float32)).bfloat16().float()
    split = sum(torch.matmul(p.float(), kf) for p in fc.split_bf16(ds, 3))
    exact = torch.matmul(ds.double(), kf.double())
    f32_err = (torch.matmul(ds, kf).double() - exact).abs().max()
    assert (split.double() - exact).abs().max() <= 4 * f32_err


def test_bwd_plain_matches_pallas_interpret():
    # N != M, ragged key count (9 of a 128-wide TPU key tile)
    q, k, v, do = _inputs(2, 2, 36, 9, 16, 32)
    qj, kj, vj, doj = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do))
    oj, lj = jax_flash_fwd(qj, kj, vj)  # Pallas, interpret mode off-TPU
    want = [np.asarray(t.astype(jnp.bfloat16), np.float32)
            for t in jax_flash_bwd(qj, kj, vj, oj, lj, doj)]
    o = torch.from_numpy(np.array(oj))
    lse = torch.from_numpy(np.asarray(lj)[:, :36, 0])
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a = a.float().numpy()
        # the same f32 arithmetic in another summation order: a bf16
        # rounding of P or of the result can move by one step
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=2 ** -8 * np.abs(b).max(),
                                   err_msg=name)
        assert np.mean(a != b) <= 0.02, name


def test_contract_inputs_make_the_logits_exact():
    q, k, _, _ = fc.contract_inputs(*_inputs(3, 2, 50, 40, 128, 16))
    s32 = torch.matmul(q.float(), k.float().transpose(1, 2))
    assert torch.equal(s32.double(), torch.matmul(q.double(), k.double().transpose(1, 2)))


def test_exact_rounding_is_the_bf16_cast():
    # on f32 values, round_bf16_exact is the f32 -> bf16 cast (nearest
    # even), ties and values across 33 binades included
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.random(100_000) * 2.0 ** rng.integers(-30, 3, 100_000))
                         .astype(np.float32))
    ties = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, 0.5 + 2 ** -9, 2 ** -20 * (1 + 2 ** -8)])
    x = torch.cat([x, ties])
    assert torch.equal(fc.round_bf16_exact(x.double()), x.bfloat16().double())


@pytest.mark.parametrize("name", ["plain", "exp2", "online_softmax"])
def test_forward_readings_against_the_exact_contract(site, name):
    # the reference the card holds the forward kernel to: the plain
    # version and the exp2 softmax keep the contract against it (their
    # f32 softmaxes flip the odd bf16 element of P: ~1.7e-6 here), the
    # online softmax does not; its lse is the plain version's
    q, k, v, _, o, lse, _ = site
    want, want_lse = fc.fwd_exact(q, k, v)
    assert want.dtype == torch.float64 and want.shape == o.shape
    assert fc.mean_rel_err(lse, want_lse) < 1e-7
    got = {"plain": o, "exp2": fc.fwd_exp2(q, k, v)[0],
           "online_softmax": fc.fwd_online_softmax(q, k, v)[0]}[name]
    err = fc.mean_rel_err(got, want)
    if name == "online_softmax":
        assert err > 10 * fc.mean_limit("o", want)
    else:
        assert err < fc.mean_limit("o", want) / 4
