"""The port's training ops against gssd_tpu on the CPU: matching, the
MultiBox loss with hard negative mining, the SGD optimizer and LR
schedule, and the gradients of the two kernel boundaries (their plain
versions inside the autograd Functions) against the JAX custom VJPs, run
in Pallas interpret mode as tests/test_flash_attn.py and
tests/test_deform_hat.py run them. Inputs are made from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssd_tpu.config import LossConfig as JaxLossConfig
from gssd_tpu.config import OptimConfig as JaxOptimConfig
from gssd_tpu.ops.losses import multibox_loss as jax_multibox_loss
from gssd_tpu.ops.matcher import match_batch as jax_match_batch
from gssd_tpu.ops.pallas.deform_hat import deform_conv2d_hat as jax_hat
from gssd_tpu.ops.pallas.flash_attn import flash_attention as jax_flash
from gssd_tpu.train.state import make_optimizer as jax_make_optimizer
from gssd_tpu.train.state import step_lr_schedule
from gssd_torch.config import LossConfig, OptimConfig
from gssd_torch.ops.anchors import make_anchors
from gssd_torch.config import V2
from gssd_torch.ops.kernels.deform_hat import deform_conv2d_hat
from gssd_torch.ops.kernels.flash_attn import flash_attention
from gssd_torch.ops.losses import hard_negatives, multibox_loss
from gssd_torch.ops.matcher import match, match_batch
from gssd_torch.train.optim import make_optimizer, step_lr
from gssd_torch.train.steps import update

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "reference_ops.npz")


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLD)


def _pad_gt(truths, max_gt=16):
    G = truths.shape[0]
    boxes = np.zeros((max_gt, 4), np.float32)
    boxes[:G] = truths
    labels = np.zeros(max_gt, np.int32)
    valid = np.zeros(max_gt, bool)
    valid[:G] = True
    return boxes, labels, valid


def _random_targets(rng, B=3, max_gt=6):
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.zeros((B, max_gt), np.int32)
    valid = np.zeros((B, max_gt), bool)
    for b in range(B):
        n = rng.integers(1, max_gt + 1)
        c = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.05, 0.4, (n, 2))
        boxes[b, :n] = np.concatenate([c - wh / 2, c + wh / 2], 1)
        valid[b, :n] = True
    # a duplicated gt: two gts claim the same best prior (last one wins)
    boxes[0, 1] = boxes[0, 0]
    valid[0, 1] = True
    return boxes, labels, valid


@pytest.mark.parametrize("case", ["rand3", "dup2", "mirror", "exact_prior"])
def test_match_goldens(gold, case):
    priors = torch.from_numpy(gold["priors"]).float()  # f32, as jnp.asarray makes it
    boxes, labels, valid = map(torch.from_numpy, _pad_gt(gold[f"match_{case}_truths"]))
    loc_t, conf_t = match(boxes, labels, valid, priors, 0.5, (0.1, 0.2))
    ref_conf = gold[f"match_{case}_conf_t"]
    np.testing.assert_array_equal(conf_t.numpy(), ref_conf)
    pos = ref_conf > 0
    # encode in f32: the goldens' own tolerance
    np.testing.assert_allclose(loc_t.numpy()[pos], gold[f"match_{case}_loc_t"][pos],
                               atol=2e-5, rtol=1e-4)


def test_match_batch_matches_jax(rng):
    priors = make_anchors(V2).copy()
    boxes, labels, valid = _random_targets(rng)
    want_loc, want_conf = jax_match_batch(jnp.asarray(boxes), jnp.asarray(labels),
                                          jnp.asarray(valid), jnp.asarray(priors), 0.5,
                                          (0.1, 0.2))
    got_loc, got_conf = match_batch(*map(torch.from_numpy, (boxes, labels, valid, priors)))
    np.testing.assert_array_equal(got_conf.numpy(), np.asarray(want_conf))
    # f32 encode, the same formula: rounding only
    np.testing.assert_allclose(got_loc.numpy(), np.asarray(want_loc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ratio", [1, 3])
def test_multibox_loss_goldens(gold, ratio):
    priors = torch.from_numpy(gold["priors"]).float()  # f32, as jnp.asarray makes it
    b0, l0, v0 = _pad_gt(gold["mbl_tgt0"][:, :4])
    b1, l1, v1 = _pad_gt(gold["mbl_tgt1"][:, :4])
    loss_l, loss_c, _ = multibox_loss(
        torch.from_numpy(gold["mbl_loc_pred"]), torch.from_numpy(gold["mbl_conf_pred"]),
        priors, torch.from_numpy(np.stack([b0, b1])), torch.from_numpy(np.stack([l0, l1])),
        torch.from_numpy(np.stack([v0, v1])), LossConfig(neg_pos_ratio=ratio))
    # the goldens' own tolerance (f32 sums over 8732 priors)
    np.testing.assert_allclose(float(loss_l), gold[f"mbl_r{ratio}_loss_l"], rtol=2e-4)
    np.testing.assert_allclose(float(loss_c), gold[f"mbl_r{ratio}_loss_c"], rtol=2e-4)


@pytest.mark.parametrize("tied", [False, True], ids=["random", "logit_ties"])
def test_multibox_loss_matches_jax(rng, tied):
    priors = make_anchors(V2).copy()
    B, P = 3, priors.shape[0]
    boxes, labels, valid = _random_targets(rng, B)
    loc = rng.normal(0, 1, (B, P, 4)).astype(np.float32)
    conf = rng.normal(0, 2, (B, P, 2)).astype(np.float32)
    if tied:
        # logits on a coarse grid: many negatives share one loss, so the
        # mined set depends on the order in which ties are kept
        conf = np.round(conf).astype(np.float32)
    want_l, want_c, want_aux = jax_multibox_loss(
        *map(jnp.asarray, (loc, conf, priors, boxes, labels, valid)), JaxLossConfig())
    got_l, got_c, got_aux = multibox_loss(
        *map(torch.from_numpy, (loc, conf, priors, boxes, labels, valid)), LossConfig())
    assert int(got_aux["num_pos"]) == int(want_aux["num_pos"])
    assert int(got_aux["num_neg"]) == int(want_aux["num_neg"])
    # f32 sums over B * P priors in another order
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=1e-5)

    # the mined set itself against the JAX formula on the same losses
    ce = rng.integers(0, 4, (B, 50)).astype(np.float32)  # heavy ties
    pos = rng.uniform(size=(B, 50)) < 0.1
    mining = jnp.where(jnp.asarray(pos), 0.0, jnp.asarray(ce))
    rank = jnp.argsort(jnp.argsort(-mining, axis=1), axis=1)
    want_neg = rank < jnp.clip(3 * jnp.sum(jnp.asarray(pos), axis=1), max=49)[:, None]
    got_neg = hard_negatives(torch.from_numpy(ce), torch.from_numpy(pos), 3)
    np.testing.assert_array_equal(got_neg.numpy(), np.asarray(want_neg))


def test_step_lr_matches_jax():
    for stepvalues in ((3, 5), (2, 9999999999999)):
        jcfg = JaxOptimConfig(lr=1e-2, gamma=0.1, stepvalues=stepvalues)
        cfg = OptimConfig(lr=1e-2, gamma=0.1, stepvalues=stepvalues)
        sched = step_lr_schedule(jcfg)
        for s in range(8):
            np.testing.assert_allclose(step_lr(cfg, s), float(sched(s)), rtol=1e-6)


class _Tree(torch.nn.Module):
    def __init__(self, leaves):
        super().__init__()
        for mod, sub in leaves.items():
            m = torch.nn.Module()
            for name, a in sub.items():
                m.register_parameter(name, torch.nn.Parameter(torch.from_numpy(a.copy())))
            self.add_module(mod, m)


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
def test_sgd_matches_optax(rng, clip):
    params = {"conv_1": {"weight": rng.normal(size=(4, 3)).astype(np.float32),
                         "bias": rng.normal(size=(4,)).astype(np.float32)},
              "dcn_0": {"weight": rng.normal(size=(3, 5)).astype(np.float32),
                        "bias": rng.normal(size=(5,)).astype(np.float32)}}
    kw = dict(lr=0.05, momentum=0.9, weight_decay=5e-4, gamma=0.1, stepvalues=(3,),
              clip=clip, modify_dcn_lr=True)
    tx = jax_make_optimizer(JaxOptimConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    model = _Tree(params)
    opt = make_optimizer(model, OptimConfig(**kw))
    assert [len(g["params"]) for g in opt.param_groups] == [2, 2]
    for step in range(6):  # through the LR boundary at step 3
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 2, a.shape).astype(np.float32), params)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        tgrads = []
        for name, p in model.named_parameters():
            mod, leaf = name.split(".")
            p.grad = torch.from_numpy(grads[mod][leaf].copy())
            tgrads.append(p.grad)
        norm, _ = update(opt, tgrads, OptimConfig(**kw), step)
        want_norm = np.sqrt(sum(np.sum(g ** 2) for s in grads.values() for g in s.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-5)
    for name, p in model.named_parameters():
        mod, leaf = name.split(".")
        # f32 updates in another association order
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[mod][leaf]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,N,M,dk,dv", [(2, 20, 20, 16, 32), (1, 20, 9, 16, 48)])
def test_flash_gradients_match_jax_vjp(rng, B, N, M, dk, dv):
    q = rng.normal(0, 1, (B, N, dk)).astype(np.float32)
    k = rng.normal(0, 1, (B, M, dk)).astype(np.float32)
    v = rng.normal(0, 1, (B, M, dv)).astype(np.float32)
    g = rng.normal(0, 1, (B, N, dv)).astype(np.float32)
    jin = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    out, vjp = jax.vjp(jax_flash, *jin)
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    tin = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    got = flash_attention(*tin)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(out, np.float32),
                               atol=1e-2 * np.abs(np.asarray(out, np.float32)).max())
    got.backward(torch.from_numpy(g).bfloat16())
    for name, t, w in zip("qkv", tin, want):
        a = np.asarray(w, np.float32)
        b = t.grad.float().numpy()
        assert t.grad.dtype == torch.bfloat16
        # same roundings (bf16 P and dO, f32 dS); the f32 sums run in
        # another order, so a final bf16 rounding may differ by one step
        np.testing.assert_allclose(b, a, atol=1e-2 * np.abs(a).max(), rtol=0,
                                   err_msg=f"d{name}")


def _hat_inputs(rng, B=1, H=6, W=7, C=8, G=2, K=9, Cout=8):
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    # offsets up to +-2.5 px: border taps sample outside the map; a third
    # are whole numbers, so samples also land on integer coordinates
    oy = rng.uniform(-2.5, 2.5, (B, H, W, G, K)).astype(np.float32)
    ox = rng.uniform(-2.5, 2.5, (B, H, W, G, K)).astype(np.float32)
    whole = rng.uniform(size=oy.shape) < 1 / 3
    oy[whole], ox[whole] = np.round(oy[whole]), np.round(ox[whole])
    m = rng.uniform(0, 1, (B, H, W, G, K)).astype(np.float32)
    w = (rng.normal(size=(K, C, Cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return x, oy, ox, m, w, b


def test_hat_gradients_match_jax_vjp(rng):
    args = _hat_inputs(rng)
    out, vjp = jax.vjp(jax_hat, *map(jnp.asarray, args))
    g = rng.normal(size=np.shape(out)).astype(np.float32)
    want = vjp(jnp.asarray(g))
    tin = [torch.from_numpy(a).requires_grad_() for a in args]
    got = deform_conv2d_hat(*tin)
    got.backward(torch.from_numpy(g))
    for name, t, w in zip(["x", "offset_y", "offset_x", "mask", "weight", "bias"], tin, want):
        a = np.asarray(w)
        b = t.grad.numpy()
        # the same bf16 roundings of g, dU, the corner weights and the
        # sample; f32 sums in another order, so a bf16-rounded dx / dW
        # entry may differ by one step (2^-8 relative)
        np.testing.assert_allclose(b, a, atol=1e-2 * np.abs(a).max(), rtol=0,
                                   err_msg=f"d{name}")
