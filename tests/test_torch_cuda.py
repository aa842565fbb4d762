"""The port's CUDA kernels against their plain PyTorch versions on the
card, at ragged shapes the serving path does not reach (chip_smoke.py
covers the serving shapes). CUDA kernels have no CPU mode: without a card
every test here skips.

    python -m pytest tests/test_torch_cuda.py -m cuda    # on a GPU host
"""

import pytest
import torch

from gssd_torch.ops.kernels import deform_hat as dh
from gssd_torch.ops.kernels import flash_attn as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,N,M,dk,dv", [
    (2, 70, 9, 16, 48), (1, 1, 1, 32, 16), (3, 130, 130, 128, 512), (2, 64, 200, 64, 96)])
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


@pytest.mark.parametrize("B,H,W,C,G,Cout,stride", [
    (2, 9, 11, 24, 4, 36, 1), (1, 20, 20, 512, 4, 256, 2), (1, 3, 3, 16, 1, 8, 1)])
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
