"""Training of the port against ``wsovod_tpu`` on the CPU.

* The train ops: the matcher, the subsampler and the RPN losses with the
  JAX package's uniform draws handed in (torch cannot replay JAX's PRNG),
  pseudo-GT mining and relabelling, the object miner and the refinery
  losses, and the gated pool's backward (``roi_pool_gated_bwd_plain``)
  against the JAX package's own ``_pool_ad_bwd`` on tied, overhanging,
  degenerate and gate-0 ROIs.
* One train step of the tiny R18 config for ``FREEZE_AT`` 5 and 4: the
  losses, every trainable parameter's gradient (res5's through the pool
  backward at 4), and the parameters after two SGD updates (warmup, bias LR
  factor, backbone multiplier, weight decay), dropout off on both sides;
  clipping and ``ITER_SIZE`` accumulation on a toy model.
* The same for the tiny MRRP R18 config at ``FREEZE_AT`` 4: three branches,
  the three-row ROILoopPool, ContextLocNet's object miner, res5's gradient
  through the loop pool's backward; the loop pool saving nothing at
  ``FREEZE_AT`` 5, and all branches trained with a test branch index.
* The port's trainer for two iterations with a checkpoint round trip.

On the CPU the JAX model pools unfused: it gates the pooled tensor, the
port gates fc1's output (the fused design), equal up to float32 rounding.
Tolerances: losses rtol 1e-4; gradients rtol 1e-3 with atol 1e-4 of the
tensor's largest entry, at least 1e-8 (the miner's ``det`` bias has a zero
gradient: a softmax over proposals ignores a per-class constant, so both
sides hold float noise near 1e-12); parameters after the updates rtol 1e-5, atol 1e-7;
the ops exact where they are discrete (labels, masks, indices) and 1e-5
(float32 summation order) elsewhere.

Four test items on purpose: many small items queued behind the JAX
package's heavy tests have crashed XLA:CPU (ROADMAP.md, host facts).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_common import (
    MRRP_YAML, NUM_CLASSES, TINY_YAML, embeddings, jax_reference, make_batch, tiny_cfg,
)
from wsovod_tpu.models import mil_heads as jmil
from wsovod_tpu.models import mining as jmine
from wsovod_tpu.models.rpn import RPNAux as JaxRPNAux
from wsovod_tpu.models.rpn import WSOVODRPN_V2 as JaxRPN
from wsovod_tpu.ops.matcher import Matcher as JaxMatcher
from wsovod_tpu.ops.pallas.roi_pool_fused import _pool_ad_bwd
from wsovod_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from wsovod_tpu.ops.sampling import subsample_labels as jax_subsample
from wsovod_torch import get_cfg
from wsovod_torch.engine.train_loop import TrainStep
from wsovod_torch.engine.trainer import WSOVODTrainer
from wsovod_torch.models import build_model
from wsovod_torch.models import mil_heads as tmil
from wsovod_torch.models import mining as tmine
from wsovod_torch.models.rpn import RPNAux, WSOVODRPN_V2
from wsovod_torch.ops.matcher import Matcher
from wsovod_torch.ops.roi_pool import roi_pool_gated_bwd_plain, roi_pool_gated_plain
from wsovod_torch.ops.sampling import subsample_labels
from wsovod_torch.solver.build import build_optimizer
from wsovod_torch.utils.weight_import import state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _draws(key, n):
    """The JAX subsampler's uniform draws for one ``key``: (positives,
    negatives), as ``subsample_labels`` splits it."""
    kp, kn = jax.random.split(key)
    return np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,)))


def _batched_draws(key, b, n):
    """``[B, n]`` draws of a vmapped subsampler over ``split(key, b)``."""
    per = [_draws(k, n) for k in jax.random.split(key, b)]
    return _t(np.stack([p for p, _ in per])), _t(np.stack([q for _, q in per]))


class _Replay:
    """``uniforms`` that hands out pre-drawn arrays in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape, device):
        u = self.arrays.pop(0)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u.to(device)


# ---------------------------------------------------------------- (a) ops
def test_train_ops_match_jax():
    """Matcher, subsampler, mining, labelling, miner, refinery and RPN
    losses, and the pool backward, each against the JAX function."""
    _check_matcher_and_sampler()
    _check_mining_and_heads()
    _check_rpn_losses()
    _check_pool_backward()


def _check_matcher_and_sampler():
    rng = np.random.RandomState(0)
    iou = np.round(rng.rand(3, 5, 40), 1).astype(np.float32)  # rounded: ties
    gt_valid = rng.rand(3, 5) > 0.3
    gt_valid[:, 0] = True
    for thresholds, labels, low in (([0.2, 0.6], [0, -1, 1], True), ([0.5], [0, 1], False)):
        jm = jax.jit(JaxMatcher(thresholds, labels, allow_low_quality_matches=low).__call__)
        got_i, got_l = Matcher(thresholds, labels, low)(_t(iou), _t(gt_valid))
        for i in range(3):
            want_i, want_l = jm(jnp.asarray(iou[i]), jnp.asarray(gt_valid[i]))
            np.testing.assert_array_equal(got_i[i].numpy(), want_i)
            np.testing.assert_array_equal(got_l[i].numpy(), want_l)
    labels = rng.randint(-1, 2, (3, 300)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    u_pos, u_neg = _batched_draws(key, 3, 300)
    pos, neg = subsample_labels(_t(labels), 64, 0.25, u_pos, u_neg)
    sample = jax.jit(lambda lab, k: jax_subsample(lab, 64, 0.25, k))
    for i, k in enumerate(jax.random.split(key, 3)):
        want_p, want_n = sample(jnp.asarray(labels[i]), k)
        np.testing.assert_array_equal(pos[i].numpy(), want_p)
        np.testing.assert_array_equal(neg[i].numpy(), want_n)
    assert pos.sum() == 3 * 16 and (pos.sum(-1) + neg.sum(-1) == 64).all()


def _mining_inputs(rng, b=3, p=30, c=NUM_CLASSES):
    xy = rng.uniform(0, 80, (b, p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (b, p, 2))], -1).astype(np.float32)
    boxes[:, 0] = [10, 10, 12, 12]  # area 4 < 20: never mined
    valid = rng.rand(b, p) > 0.2
    scores = rng.rand(b, p, c).astype(np.float32)
    scores[:, 5:8] = scores[:, 5:6]  # tied rows: the lower index wins
    present = rng.rand(b, c) > 0.4
    present[0, 1] = True
    present[2] = False  # no class present: the fallback entry
    weights = rng.rand(b, c).astype(np.float32)
    return boxes, valid, scores, present, weights


def _check_mining_and_heads():
    rng = np.random.RandomState(1)
    boxes, valid, scores, present, weights = _mining_inputs(rng)
    b, p, c = scores.shape
    gt_classes = rng.randint(0, c, (b, 4)).astype(np.int32)
    gt_valid = rng.rand(b, 4) > 0.3
    want = jmine.get_image_level_gt(jnp.asarray(gt_classes[0]), jnp.asarray(gt_valid[0]), c)
    got = tmine.get_image_level_gt(_t(gt_classes), _t(gt_valid), c)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), w)

    jpgt = jax.jit(jax.vmap(lambda *a: jmine.pgt_top_k(*a, top_k=2)))(
        *map(jnp.asarray, (boxes, scores, valid, present, weights)))
    tpgt = tmine.pgt_top_k(_t(boxes), _t(scores), _t(valid), _t(present), _t(weights), top_k=2)
    for name in tmine.PseudoGT._fields:
        np.testing.assert_array_equal(getattr(tpgt, name).numpy(), getattr(jpgt, name), err_msg=name)
    assert tpgt.valid[2, 0] and not tpgt.valid[2, 1:].any()  # the fallback

    key = jax.random.PRNGKey(3)
    u_pos, u_neg = _batched_draws(key, b, p)
    jmatcher = JaxMatcher([0.5], [0, 1])
    for wsl in (True, False):
        if wsl:
            jl = jax.jit(jax.vmap(lambda pb, pv, pg, k: jmine.label_and_sample_wsl(
                pb, pv, pg, jmatcher, c, 8, 0.5, k)))(
                jnp.asarray(boxes), jnp.asarray(valid), jpgt, jax.random.split(key, b))
            tl = tmine.label_and_sample_wsl(_t(boxes), _t(valid), tpgt, Matcher([0.5], [0, 1]), c,
                                            8, 0.5, u_pos, u_neg)
        else:
            jl = jax.jit(jax.vmap(lambda pb, pv, pg: jmine.label_and_sample_plain(
                pb, pv, pg, jmatcher, c)))(jnp.asarray(boxes), jnp.asarray(valid), jpgt)
            tl = tmine.label_and_sample_plain(_t(boxes), _t(valid), tpgt, Matcher([0.5], [0, 1]), c)
        for name in tmine.LabeledProposals._fields:
            np.testing.assert_array_equal(getattr(tl, name).numpy(), getattr(jl, name),
                                          err_msg=f"{name} wsl={wsl}")
    labeled = tl

    # the object miner: forward, image-level scores and BCE
    x = rng.randn(b, p, 16).astype(np.float32)
    jm = jmil.ObjectMiningOutputLayers(num_classes=c)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0), x, valid)
    jscores = jax.jit(jm.apply)(jparams, x, valid)
    oh = (rng.rand(b, c) > 0.5).astype(np.float32)
    jloss = jax.jit(jm.losses)(jscores, jnp.asarray(oh))
    tm = tmil.ObjectMiningOutputLayers(16, c)
    tm.load_state_dict({f"{nm}.{k}": _t(np.asarray(v).T if k == "weight" else v)
                        for nm in ("cls", "det")
                        for k, v in (("weight", jparams["params"][nm]["kernel"]),
                                     ("bias", jparams["params"][nm]["bias"]))})
    tscores = tm(_t(x), _t(valid))
    np.testing.assert_allclose(tscores.detach().numpy(), jscores, **TOL)
    np.testing.assert_allclose(tm.predict_probs_img(tscores).detach().numpy(),
                               jm.predict_probs_img(jscores), **TOL)
    tloss = tm.losses(tscores, _t(oh))
    np.testing.assert_allclose(tloss["loss_cls_object_mining"].item(),
                               float(jloss["loss_cls_object_mining"]), rtol=1e-5)

    # the refinery losses on the labelled proposals, weighted and not
    scores_k = rng.randn(b, p, c + 1).astype(np.float32)
    deltas_k = (rng.randn(b, p, 4) * 0.1).astype(np.float32)
    for weighted, beta in ((True, 0.0), (False, 0.5)):
        jr = jmil.InstanceRefinementOutputLayers(num_classes=c, refine_k=1, refine_reg=True,
                                                 cross_entropy_weighted=weighted,
                                                 smooth_l1_beta=beta)
        want = jax.jit(jr.losses)(jnp.asarray(scores_k), jnp.asarray(deltas_k), jnp.asarray(boxes),
                                  *(jnp.asarray(getattr(labeled, f).numpy())
                                    for f in ("gt_classes", "gt_boxes", "gt_weights")),
                                  jnp.asarray(valid))
        tr = tmil.InstanceRefinementOutputLayers(16, refine_reg=True, weight_dim=8, refine_k=1,
                                                 cross_entropy_weighted=weighted,
                                                 smooth_l1_beta=beta)
        got = tr.losses(_t(scores_k), _t(deltas_k), _t(boxes), labeled.gt_classes,
                        labeled.gt_boxes, labeled.gt_weights, _t(valid), c)
        assert sorted(got) == sorted(want) == ["loss_box_reg_r1", "loss_cls_r1"]
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def _check_rpn_losses():
    rng = np.random.RandomState(2)
    b, r, g = 2, 200, 6
    xy = rng.uniform(0, 100, (r, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(10, 60, (r, 2))], -1).astype(np.float32)
    logits = rng.randn(b, r).astype(np.float32)
    deltas = (rng.randn(b, r, 4) * 0.2).astype(np.float32)
    gxy = rng.uniform(0, 100, (b, g, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(10, 60, (b, g, 2))], -1).astype(np.float32)
    gt_valid = rng.rand(b, g) > 0.3
    gt_valid[1] = False  # no pseudo GT: every anchor background
    key = jax.random.PRNGKey(11)
    kw = dict(batch_size_per_image=64, positive_fraction=0.5, iou_thresholds=(0.2, 0.6),
              iou_labels=(0, -1, 1), smooth_l1_beta=0.1)
    want = jax.jit(JaxRPN(**kw).losses)(JaxRPNAux(*map(jnp.asarray, (anchors, logits, deltas))),
                                        jnp.asarray(gt), jnp.asarray(gt_valid), key)
    u_pos, u_neg = _batched_draws(key, b, r)
    got = WSOVODRPN_V2(8, **kw).losses(RPNAux(_t(anchors), _t(logits), _t(deltas)), _t(gt),
                                       _t(gt_valid), _Replay([u_pos, u_neg]))
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def _check_pool_backward():
    """``roi_pool_gated_bwd_plain`` against ``_pool_ad_bwd`` with ``out``
    from the jnp ``roi_pool``: feature values on a coarse grid (many ties,
    a post-ReLU map), edge ROIs, gate-0 rows; both cotangents."""
    rng = np.random.RandomState(3)
    b, h, w, c, n, scale = 2, 9, 13, 12, 24, 0.125
    feat = (np.round(np.maximum(rng.randn(b, h, w, c), 0) * 2) / 2).astype(np.float32)
    img_w, img_h = w / scale, h / scale
    xy = rng.uniform(-20, img_w * 0.8, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, img_w * 0.7, (b, n, 2))], -1)
    rois[:, 0] = [img_w - 30, img_h - 20, img_w + 60, img_h + 50]  # overhangs
    rois[:, 1] = [50, 40, 20, 10]  # degenerate
    rois[:, 2] = [0, 0, img_w, img_h]  # the whole map: bins of zeros tie everywhere
    rois[:, 3] = [-400, -300, -200, -100]  # wholly outside: empty bins
    rois = rois.astype(np.float32)
    gate = ((rng.rand(b, n) + 1.0) * (rng.rand(b, n) > 0.2)).astype(np.float32)
    gate[:, 4] = 0.0
    c_base, c_take = 4, 8
    out = np.stack([np.asarray(jax_roi_pool(jnp.asarray(feat[i, ..., c_base:c_base + c_take]),
                                            jnp.asarray(rois[i]), 7, scale)) for i in range(b)])
    out = out * gate[:, :, None, None, None]
    g = rng.randn(b, n, 7, 7, c_take).astype(np.float32)
    hwnc = (0, 2, 3, 1, 4)  # the TPU kernel's [B, P, P, N, c] layout
    res = (jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(gate),
           jnp.asarray(out.transpose(hwnc)))
    bwd = jax.jit(lambda res, g: _pool_ad_bwd(c_base, c_take, 7, scale, False, 1.8, None, False,
                                              None, res, g))
    want_feat, _, want_gate = bwd(res, jnp.asarray(g.transpose(hwnc)))
    # the port's forward is the same pool: its output is the out above
    np.testing.assert_array_equal(
        roi_pool_gated_plain(_t(feat), _t(rois), _t(gate), c_base, c_take, 7, scale).numpy(), out)
    got_feat, got_gate = roi_pool_gated_bwd_plain(_t(feat), _t(rois), _t(gate), _t(out), _t(g),
                                                  c_base, c_take, 7, scale)
    np.testing.assert_allclose(got_feat.numpy(), want_feat, **TOL)
    np.testing.assert_allclose(got_gate.numpy(), want_gate, **TOL)
    assert (got_gate.numpy()[:, 4] == 0).all() and np.abs(want_feat).max() > 0
    assert not got_feat[..., :c_base].any() and not got_feat[..., c_base + c_take:].any()
    # only what is asked for
    assert roi_pool_gated_bwd_plain(_t(feat), _t(rois), _t(gate), None, _t(g), c_base, c_take,
                                    7, scale, need_gate=False)[1] is None


# ------------------------------------------------------------ (b) a step
def _train_cfg(cfg, freeze_at, yaml=TINY_YAML, test_branch_idx=None):
    """The tiny config (``tiny_cfg``) for training: train top-k as the test
    top-k, a short warmup from 0.5 so the two updates use different rates,
    the backbone multiplier off 1, one image per update."""
    cfg = tiny_cfg(cfg, yaml, test_branch_idx)
    cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 16
    cfg.SOLVER.MAX_ITER = 10
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.WARMUP_FACTOR = 0.5
    cfg.SOLVER.BACKBONE_MULTIPLIER = 0.5
    cfg.WSOVOD.ITER_SIZE = 1
    return cfg


class _NoDropout(flax.linen.Module):
    """``flax.linen.Dropout`` as the identity (this test only)."""

    rate: float = 0.0
    deterministic: bool = True

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _model_draws(model_rng, b, p, r):
    """The uniform draws of one JAX train forward, in the order the port
    asks for them: the ROI heads' proposal sampling (stage 0), then the
    RPN's anchor sampling (``meta_arch.py`` and ``roi_heads.py`` key
    splits)."""
    rng, _, rng_roi = jax.random.split(model_rng, 3)
    _, krng = jax.random.split(rng_roi)
    _, rng_rpn = jax.random.split(rng)
    return [*_batched_draws(krng, b, p), *_batched_draws(rng_rpn, b, r)]


def _grads_by_name(model):
    fc1 = model.roi_heads.box_head.fc1
    out = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            g = p.grad
            out[n] = (fc1.to_reference(g) if n == "roi_heads.box_head.fc1.weight" else g).numpy()
    return out


def _params_by_name(model):
    sd = model.state_dict()
    return {n: sd[n].numpy() for n, _ in model.named_parameters()}


def test_train_step_matches_jax(monkeypatch):
    """Losses, gradients and two SGD updates of the tiny R18 config, for
    ``FREEZE_AT`` 5 (heads only) and 4 (res5 trains through the pool
    backward). One compiled JAX program serves both: its backbone is not
    stopped, and at 5 its backbone gradients are simply not compared (the
    optimizer's frozen label zeroes their updates). Then gradient clipping
    and ``ITER_SIZE`` accumulation against optax."""
    from wsovod_tpu.config import get_cfg as jax_get_cfg
    from wsovod_tpu.models import build_model as jax_build_model
    from wsovod_tpu.solver.build import build_optimizer as jax_build_optimizer

    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jmodel = jax_build_model(_train_cfg(jax_get_cfg(), 4))
    params0 = jax.tree_util.tree_map(jnp.asarray, jax_reference()[1])
    emb = embeddings()
    batch = make_batch(2, gt=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model_rng = jax.random.PRNGKey(5)

    def loss_fn(p, it):
        losses = jmodel.apply(p, jbatch, train=True, iteration=it, rng=model_rng,
                              embeddings=jnp.asarray(emb))
        return sum(losses.values()), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, jlosses), jgrads = grad_fn(params0, jnp.asarray(3))
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(jgrads).items()}
    init = {k: v.numpy() for k, v in state_dict_from_jax(params0).items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    p = 16 + batch["sam_valid"].shape[1]
    r = 8 * 8 * 18  # res5 of a 64-px image at stride 8, 18 anchors

    for freeze_at in (5, 4):
        model = build_model(_train_cfg(get_cfg(), freeze_at), device="cpu", seed=None)
        model.load_state_dict(state_dict_from_jax(params0), strict=True)
        model.train()
        model.roi_heads.box_head.dropout = 0.0
        step = TrainStep(model, build_optimizer(_train_cfg(get_cfg(), freeze_at), model),
                         _train_cfg(get_cfg(), freeze_at))
        step.step = 3  # as after three earlier iterations: the RPN ramp is 0.3

        losses = model.forward_train(tbatch, _t(emb), iteration=step.step,
                                     uniforms=_Replay(_model_draws(model_rng, 2, p, r)))
        assert sorted(losses) == sorted(jlosses) == sorted(
            ["loss_cls_object_mining", "loss_cls_r0", "loss_box_reg_r0", "loss_rpn_cls",
             "loss_rpn_loc"])
        for k, v in jlosses.items():
            np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
        step.backward(losses)
        grads = _grads_by_name(model)
        res5 = {n for n in jgrads if n.startswith("backbone.res5.") and ".norm." not in n}
        assert {n for n in grads if n.startswith("backbone.")} == (res5 if freeze_at == 4 else set())
        for n, g in grads.items():
            atol = max(1e-4 * np.abs(jgrads[n]).max(), 1e-8)
            np.testing.assert_allclose(g, jgrads[n], rtol=1e-3, atol=atol,
                                       err_msg=f"grad {n}, FREEZE_AT {freeze_at}")
        step.update()

        # two updates on the JAX side, then the port's second
        jcfg = _train_cfg(jax_get_cfg(), freeze_at)
        tx = jax_build_optimizer(jcfg, params0["params"])

        @jax.jit
        def sgd(p, state, g):
            updates, state = tx.update(g, state, p)
            return optax.apply_updates(p, updates), state

        opt_state = jax.jit(tx.init)(params0["params"])
        params = params0
        for it in (3, 4):
            _, g = grad_fn(params, jnp.asarray(it))
            new, opt_state = sgd(params["params"], opt_state, g["params"])
            params = {"params": new}
        step.backward(model.forward_train(tbatch, _t(emb), iteration=step.step, uniforms=_Replay(
            _model_draws(model_rng, 2, p, r))))
        assert step.update() and (step.step, step.updates) == (5, 2)
        want = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
        for n, v in _params_by_name(model).items():
            np.testing.assert_allclose(v, want[n], rtol=1e-5, atol=1e-7,
                                       err_msg=f"param {n}, FREEZE_AT {freeze_at}")
            frozen = n.startswith("backbone.") and (freeze_at == 5 or ".res5." not in n)
            # the miner's det bias has a zero gradient and no decay: it stays
            stays = frozen or n == "roi_heads.object_miner.det.bias"
            assert (v == init[n]).all() == stays, n
    _check_clipping_and_accumulation()


def test_mrrp_train_step_matches_jax(monkeypatch):
    """The tiny MRRP R18 config at ``FREEZE_AT`` 4, as
    ``test_train_step_matches_jax``: the losses (the object miner's through
    ContextLocNet's ``det(frame) - det(ctx)``), every trainable gradient
    (res5's, shared by the three branches, through the loop pool's backward,
    ``roi_loop_pool_gated_bwd_plain`` here) and the parameters after two
    updates. The SAM rows' random branches are the JAX package's draws.

    A max pool's gradient goes to its argmax, and the two packages' convs
    round res5 differently (by about 1e-8 here), so a near-tied bin can
    route its cotangent to another pixel (on this input one channel of one
    pixel pair; the sums agree). res5's gradient is therefore compared in a
    second pass whose res5 output carries the JAX package's values on the
    port's own graph (``f - f.detach() + value``, exact); the other
    gradients, the losses and the updates come from the port's own forward.

    Then: at ``FREEZE_AT`` 5 the loop pool's Function records nothing to
    save, and with ``TEST_BRANCH_IDX 1`` training still runs all three
    branches (the losses are the same)."""
    from wsovod_tpu.config import get_cfg as jax_get_cfg
    from wsovod_tpu.models import build_model as jax_build_model
    from wsovod_tpu.solver.build import build_optimizer as jax_build_optimizer

    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jmodel = jax_build_model(_train_cfg(jax_get_cfg(), 4, MRRP_YAML))
    params0 = jax.tree_util.tree_map(jnp.asarray, jax_reference(MRRP_YAML, -1)[1])
    emb = embeddings()
    batch = make_batch(2, gt=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model_rng = jax.random.PRNGKey(5)

    def loss_fn(p, it):
        losses = jmodel.apply(p, jbatch, train=True, iteration=it, rng=model_rng,
                              embeddings=jnp.asarray(emb))
        return sum(losses.values()), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, jlosses), jgrads0 = grad_fn(params0, jnp.asarray(3))
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(jgrads0).items()}
    jax_res5 = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        p, x, method=lambda m, x: m.backbone(m._normalize(x), train=True)))(
            params0, jbatch["images"])["res5"])
    n_sam = batch["sam_valid"].shape[1]
    sam_branch = 1000 * np.asarray(jax.random.randint(jax.random.split(model_rng, 3)[1],
                                                      (2, n_sam), 0, 3))
    assert len(np.unique(sam_branch)) == 3
    tbatch = {k: _t(v) for k, v in batch.items()}
    p, r = 16 + n_sam, 3 * 8 * 8 * 6  # three anchor levels of 6 on an 8x8 res5

    def port_model(freeze_at, test_branch_idx=None):
        cfg = _train_cfg(get_cfg(), freeze_at, MRRP_YAML, test_branch_idx)
        model = build_model(cfg, device="cpu", seed=None)
        model.load_state_dict(state_dict_from_jax(params0), strict=True)
        model.train()
        model.roi_heads.box_head.dropout = 0.0
        proposals = model._proposals

        def with_jax_sam_branches(*args, **kwargs):
            props, aux = proposals(*args, **kwargs)
            level_ids = props.level_ids.clone()
            level_ids[:, -n_sam:] = _t(sam_branch)
            return props.replace(level_ids=level_ids), aux

        model._proposals = with_jax_sam_branches
        pooled = []
        model.roi_heads.pooler.register_forward_hook(lambda m, i, o: pooled.append(o))
        step = TrainStep(model, build_optimizer(cfg, model), cfg)
        step.step = 3
        return model, step, pooled

    draws = _model_draws(model_rng, 2, p, r)

    def forward(model, step):
        return model.forward_train(tbatch, _t(emb), iteration=step.step, uniforms=_Replay(draws))

    def check_grads(model, names, what):
        grads = _grads_by_name(model)
        assert {n for n in grads if n.startswith("backbone.")} == {
            n for n in jgrads if n.startswith("backbone.res5.") and ".norm." not in n}
        for n in names(grads):
            atol = max(1e-4 * np.abs(jgrads[n]).max(), 1e-8)
            np.testing.assert_allclose(grads[n], jgrads[n], rtol=1e-3, atol=atol,
                                       err_msg=f"grad {n}, {what}")

    # res5's gradient, on the JAX package's res5 values
    model, step, pooled = port_model(4)
    backbone = model.backbone.forward

    def jax_values(x, train=False):
        out = backbone(x, train=train)
        out["res5"] = out["res5"] - out["res5"].detach() + _t(jax_res5)
        return out

    model.backbone.forward = jax_values
    step.backward(forward(model, step))
    check_grads(model, lambda grads: grads, "res5 with the JAX values")

    model, step, pooled = port_model(4)
    losses = forward(model, step)
    assert sorted(losses) == sorted(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    # three rows per chunk through the Function, which kept no output (the
    # gate, the validity mask, needs no gradient)
    assert [tuple(o.shape[:2]) for o in pooled] == [(3, 2)]
    assert type(pooled[0].grad_fn).__name__ == "RoILoopPoolGatedFunctionBackward"
    assert pooled[0].grad_fn.saved_tensors[4] is None
    step.backward(losses)
    check_grads(model, lambda grads: [n for n in grads if not n.startswith("backbone.")],
                "the port's forward")
    step.update()

    jcfg = _train_cfg(jax_get_cfg(), 4, MRRP_YAML)
    tx = jax_build_optimizer(jcfg, params0["params"])

    @jax.jit
    def sgd(p, state, g):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    opt_state = jax.jit(tx.init)(params0["params"])
    params, g = params0, jgrads0
    for it in (3, 4):
        if it > 3:
            _, g = grad_fn(params, jnp.asarray(it))
        new, opt_state = sgd(params["params"], opt_state, g["params"])
        params = {"params": new}
    step.backward(forward(model, step))
    assert step.update() and (step.step, step.updates) == (5, 2)
    want = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    for n, v in _params_by_name(model).items():
        np.testing.assert_allclose(v, want[n], rtol=1e-5, atol=1e-7, err_msg=f"param {n}")

    frozen, frozen_step, pooled = port_model(5)
    forward(frozen, frozen_step)
    assert len(pooled) == 1 and pooled[0].shape[0] == 3 and pooled[0].grad_fn is None

    one, one_step, pooled = port_model(4, test_branch_idx=1)
    losses = forward(one, one_step)
    assert pooled[0].shape[:2] == (3, 2)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=f"{k}, branch 1")


def _check_clipping_and_accumulation():
    """``TrainStep.update`` against the JAX package's optax chain
    (``MultiSteps(chain(clip, sgd groups))``) on a toy linear model: the mean
    of two iterations' gradients, clipped by value or by global norm, one
    SGD update with momentum and decay. rtol 1e-6."""
    from wsovod_tpu.config import get_cfg as jax_get_cfg
    from wsovod_tpu.solver.build import build_optimizer as jax_build_optimizer

    rng = np.random.RandomState(4)
    for kind, value in (("value", 0.05), ("norm", 0.5)):
        cfgs = [get_cfg(), jax_get_cfg()]
        for c in cfgs:
            c.SOLVER.CLIP_GRADIENTS.ENABLED = True
            c.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = kind
            c.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = value
            c.SOLVER.WARMUP_ITERS = 0
            c.WSOVOD.ITER_SIZE = 2
        toy = torch.nn.Linear(3, 2)
        step = TrainStep(toy, build_optimizer(cfgs[0], toy), cfgs[0])
        params = {n: jnp.asarray(p.detach().numpy()) for n, p in toy.named_parameters()}
        tx = jax_build_optimizer(cfgs[1], params)
        state = tx.init(params)
        for i in range(2):
            loss = (toy(_t(rng.randn(4, 3).astype(np.float32))) ** 2).sum() * 3
            names, tensors = zip(*toy.named_parameters())
            grads = torch.autograd.grad(loss, tensors, retain_graph=True)
            step.backward({"loss": loss})
            assert step.update() == (i == 1)
            updates, state = tx.update({n: jnp.asarray(g.numpy()) for n, g in zip(names, grads)},
                                       state, params)
            params = optax.apply_updates(params, updates)
        for n, p in toy.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), params[n], rtol=1e-6, err_msg=(kind, n))


# ----------------------------------------------------------- (c) trainer
def _loader(seed=0):
    while True:
        yield make_batch(seed, gt=True)
        seed += 1


def test_trainer_checkpoint_round_trip(tmp_path):
    """Two iterations of ``WSOVODTrainer`` on the CPU (one update: the
    recipe's 4-worker batch on 2 workers is ``ITER_SIZE`` 2), the final
    checkpoint restores the parameters, the momentum, the counts and the
    generator bit for bit, and the resumed trainer's next iteration equals
    the original's; a checkpoint saved inside an accumulation carries the
    gradients; ``MODEL.WEIGHTS`` loads a saved state dict. A present SAM
    checkpoint and two training-only keys the port lacks are refused by
    name."""
    cfg = _train_cfg(get_cfg(), 5)
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.REFERENCE_WORLD_SIZE = 2
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.MODEL.WEIGHTS = ""
    assert cfg.WSOVOD.BBOX_REFINE.ENABLE  # the config asks for SAM; absent, it turns off
    emb = _t(embeddings())
    trainer = WSOVODTrainer(cfg, _loader(), embeddings=emb, device="cpu")
    assert trainer.cfg.WSOVOD.ITER_SIZE == 2 and not trainer.cfg.WSOVOD.BBOX_REFINE.ENABLE
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.train()
    assert (trainer.step.step, trainer.step.updates) == (2, 1)
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, before[n]) == (not p.requires_grad), n
    assert (tmp_path / "out" / "metrics.json").read_text().count("loss_rpn_loc") == 2

    resumed = WSOVODTrainer(cfg, _loader(2), embeddings=emb, resume=True, device="cpu")
    assert resumed.resumed and (resumed.step.step, resumed.step.updates) == (2, 1)
    for (n, p), q in zip(trainer.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n
        s, t = trainer.step.optimizer.state.get(p), resumed.step.optimizer.state.get(q)
        assert (s is None) == (t is None) and (s is None or torch.equal(s["momentum_buffer"],
                                                                        t["momentum_buffer"])), n
    assert torch.equal(trainer.generator.get_state(), resumed.generator.get_state())

    trainer.loader = _loader(2)
    m1, m2 = trainer.run_step(), resumed.run_step()  # a mini-step of the next update
    assert all(torch.equal(m1[k], m2[k]) for k in m1), (m1, m2)
    resumed.save("mid")
    again = WSOVODTrainer(cfg, _loader(3), embeddings=emb, resume=True, device="cpu")
    assert again.step.step == 3
    for p, q in zip(resumed.model.parameters(), again.model.parameters()):
        assert (p.grad is None and q.grad is None) or torch.equal(p.grad, q.grad)

    # MODEL.WEIGHTS: a torch.save'd state dict loads into a fresh trainer
    torch.save({"model": trainer.model.state_dict()}, tmp_path / "weights.pth")
    cfg.OUTPUT_DIR, cfg.MODEL.WEIGHTS = str(tmp_path / "fresh"), str(tmp_path / "weights.pth")
    fresh = WSOVODTrainer(cfg, _loader(), embeddings=emb, device="cpu")
    assert not fresh.resumed and fresh.step.step == 0
    for p, q in zip(trainer.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)

    cfg.WSOVOD.BBOX_REFINE.MODEL_CHECKPOINT = str(tmp_path / "sam.pth")
    (tmp_path / "sam.pth").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="BBOX_REFINE"):
        WSOVODTrainer(cfg, _loader(), embeddings=emb, device="cpu")
    cfg.WSOVOD.BBOX_REFINE.ENABLE = False
    for key, value in (("WSOVOD.INSTANCE_REFINEMENT.REFINE_MIST", True),
                       ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE", "giou")):
        bad = cfg.clone()
        node = bad
        *parents, leaf = key.split(".")
        for part in parents:
            node = getattr(node, part)
        setattr(node, leaf, value)
        with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
            WSOVODTrainer(bad, _loader(), embeddings=emb, device="cpu")
