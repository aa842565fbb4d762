"""The work counts against hand arithmetic at small shapes, and the
model FLOPs of both configurations."""

import json
import os

import pytest

from benchmark import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


def test_attention_forward_work_by_hand():
    s = {"N": 4, "M": 3, "dk": 2, "dv": 5}
    w = work.attention_work(2, s, backward=False)
    # q k^T: 2*4*3 logits x dk 2 MACs; p v: 2*4*3 x dv 5 MACs; 2 flops a MAC
    assert w["flops"] == 2 * (2 * 4 * 3 * 2 + 2 * 4 * 3 * 5)
    assert w["exps"] == 2 * 4 * 3
    # q [2,4,2] + k [2,3,2] + v [2,3,5] read, o [2,4,5] written, bf16
    assert w["bytes"] == 2 * (16 + 12 + 30 + 40)


def test_attention_backward_counts_each_product_once():
    s = {"N": 4, "M": 3, "dk": 2, "dv": 5}
    w = work.attention_work(2, s, backward=True)
    logits = 2 * 4 * 3
    # dV = p^T dO and dP = dO v^T (dv each), dQ = dS k and dK = dS^T q (dk each)
    assert w["flops"] == 2 * logits * (5 + 5 + 2 + 2)
    # chip_smoke.py's attn_work counts dQ and dK as three bf16 passes each
    # (the port's design, not the function's work): not the count used here
    chip_smoke_ops = 2 * logits * (2 + 2 * 5) + 3 * 2 * logits * 2 * 2
    assert w["flops"] != chip_smoke_ops
    # q, k, v, dO read; dq, dk, dv written
    assert w["bytes"] == 2 * (16 + 12 + 30 + 40 + 16 + 12 + 30)


def test_dcn_work_by_hand():
    s = {"H": 2, "W": 3, "C": 8, "Cout": 4, "G": 2, "K": 9}
    f = work.dcn_work(1, s, backward=False)
    b = work.dcn_work(1, s, backward=True)
    macs = 6 * 8 * 9 * 4
    assert f["flops"] == 2 * macs and b["flops"] == 4 * macs
    ins = 6 * 8 * 2 + 3 * 6 * 2 * 9 * 4 + 9 * 8 * 4 * 2
    assert f["bytes"] == ins + 6 * 4 * 2
    assert b["bytes"] == 2 * ins + 6 * 4 * 2


def test_bound_is_the_largest_term():
    w = {"flops": 989e12, "bytes": 3.35e12 / 2, "exps": 0.0}
    assert work.bound_s(w) == pytest.approx(1.0)
    w = {"flops": 0.0, "bytes": 3.35e12 * 3, "exps": work.PEAK_EXP}
    assert work.bound_s(w) == pytest.approx(3.0)


def test_sites_of_both_configurations():
    s300 = work.attention_sites(config("gssdpp-300"))
    assert len(s300) == 12
    # chip_smoke.py's ATTN_SITES: (N, dk, dv), two sites each
    assert sorted({(s["N"], s["dk"], s["dv"]) for s in s300}) == sorted(
        [(1444, 64, 256), (361, 128, 512), (100, 64, 256), (25, 32, 128), (9, 32, 128),
         (1, 32, 128)])
    s512 = work.attention_sites(config("gssdpp-512"))
    assert len(s512) == 14 and max(s["M"] for s in s512) == 4096
    assert work.dcn_sites(config("gssdpp-300")) == [
        {"H": 38, "W": 38, "C": 1024, "Cout": 512, "G": 4, "K": 9}]
    assert work.dcn_sites(config("gssdpp-512"))[0]["H"] == 64


def test_grouped_conv_backward_is_twice_its_forward():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.ones(1, 64, 8, 8, device="meta", requires_grad=True)
    w = torch.ones(128, 16, 3, 3, device="meta", requires_grad=True)
    mapping = {torch.ops.aten.convolution_backward: work._conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as c:
        y = torch.nn.functional.conv2d(x, w, padding=1, groups=4)
    fwd = c.get_total_flops()
    with FlopCounterMode(display=False, custom_mapping=mapping) as c:
        torch.nn.functional.conv2d(x, w, padding=1, groups=4).sum().backward()
    assert fwd == 2 * 64 * 128 * 16 * 9
    assert c.get_total_flops() == 3 * fwd


@pytest.mark.parametrize("name, forward_gflop", [("gssdpp-300", 40.91), ("gssdpp-512", 132.31)])
def test_model_flops(name, forward_gflop):
    m = config(name)
    fwd = work.model_flops(m, backward=False)
    both = work.model_flops(m, backward=True)
    assert fwd / 1e9 == pytest.approx(forward_gflop, abs=0.01)
    # the backward: every product twice (input and weight gradients), less
    # the first conv's input gradient, which nothing asks for
    assert 1.98 < (both - fwd) / fwd < 2.0
