"""The port's NMS, top-proposal selection, anchors and box ops against the
JAX package on the same seeded inputs. Keep masks and selected indices are
compared exactly; box arithmetic to 1e-6 (float32, same formulas). The JAX
side runs under ``jax.jit``: one compiled program per case, not one per
primitive."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wsovod_tpu.models.anchors import AnchorGenerator as JaxAnchorGenerator
from wsovod_tpu.models.poolers import assign_boxes_to_levels as jax_assign_levels
from wsovod_tpu.models.proposal_utils import find_top_rpn_proposals as jax_find_top
from wsovod_tpu.ops import nms as jnms
from wsovod_tpu.structures import boxes as jboxes
from wsovod_torch.models.anchors import AnchorGenerator
from wsovod_torch.models.poolers import assign_boxes_to_levels
from wsovod_torch.models.proposal_utils import find_top_rpn_proposals
from wsovod_torch.ops import nms as tnms
from wsovod_torch.structures import boxes as tboxes


def _boxes(rng, shape, extent=100.0):
    """Clustered boxes so that NMS has real overlaps to resolve."""
    lead = shape[:-1]
    cluster = rng.uniform(10, extent - 10, lead[:-1] + (6, 2))
    pick = rng.randint(0, 6, lead)[..., None].repeat(2, -1)
    centers = np.take_along_axis(cluster, pick, axis=-2) + rng.randn(*lead, 2) * 6
    wh = rng.uniform(4, 30, lead + (2,))
    return np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)


def _nms_inputs(seed, b=3, n=48):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (b, n, 4))
    scores = rng.rand(b, n).astype(np.float32)
    scores[:, 5] = scores[:, 6]  # a tie: stable order decides
    valid = rng.rand(b, n) > 0.15
    return boxes, scores, valid


def test_nms_matches_jax():
    """``nms_mask`` with and without ``stop_after``, ``nms_topk`` with and
    without class ids, and ``top_k``'s tie order."""
    boxes, scores, valid = _nms_inputs(0)
    for thresh in (0.3, 0.7):
        for stop_after in (None, 5, 12):
            ref = jax.jit(lambda b, s, v: jnms.nms_mask(b, s, thresh, valid=v, stop_after=stop_after))
            want = np.stack([np.asarray(ref(b, s, v)) for b, s, v in zip(boxes, scores, valid)])
            got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                                valid=torch.from_numpy(valid), stop_after=stop_after)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{thresh} {stop_after}")

    boxes, scores, valid = _nms_inputs(1)
    idxs = np.random.RandomState(2).randint(0, 3, scores.shape).astype(np.int32)
    k = 10
    for with_idxs in (False, True):
        ref = jax.jit(lambda b, s, v, c: jnms.nms_topk(b, s, 0.5, k, valid=v,
                                                       idxs=c if with_idxs else None))
        for i in range(boxes.shape[0]):
            ji, jv = ref(boxes[i], scores[i], valid[i], idxs[i])
            ti, tv = tnms.nms_topk(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]), 0.5, k,
                                   valid=torch.from_numpy(valid[i]),
                                   idxs=torch.from_numpy(idxs[i]) if with_idxs else None)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(ti.numpy()[tv.numpy()], np.asarray(ji)[np.asarray(jv)])

    x = np.array([[3.0, 1.0, 3.0, -np.inf, 2.0, 3.0, -np.inf]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tnms.top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_proposals_anchors_and_box_ops_match_jax():
    """``find_top_rpn_proposals`` (with a NaN logit, with and without a
    minimum size), the grid anchors, and the box ops; the FPN's five-level
    anchors and top-k, and the level assignment of its pooler."""
    rng = np.random.RandomState(3)
    b = 2
    levels = [_boxes(rng, (b, 150, 4), 120.0) - 10.0, _boxes(rng, (b, 60, 4), 120.0)]
    logits = [rng.randn(b, 150).astype(np.float32), rng.randn(b, 60).astype(np.float32)]
    logits[0][0, 3] = np.nan  # sorts last, as -inf
    sizes = np.array([[100, 110], [90, 120]], np.int32)
    for min_size in (0.0, 12.0):
        j = jax.jit(lambda lv, lg, sz: jax_find_top(lv, lg, sz, 0.7, 64, 24, min_size))(
            levels, logits, sizes)
        t = find_top_rpn_proposals([torch.from_numpy(x) for x in levels],
                                   [torch.from_numpy(x) for x in logits],
                                   torch.from_numpy(sizes), 0.7, 64, 24, min_size)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_array_equal(t.level_ids.numpy(), np.asarray(j.level_ids))
        np.testing.assert_array_equal(t.objectness_logits.numpy(), np.asarray(j.objectness_logits))
        np.testing.assert_allclose(t.proposal_boxes.numpy(), np.asarray(j.proposal_boxes), atol=1e-6)

    kw = dict(sizes=[(32, 64, 128, 256, 512, 768)], aspect_ratios=[(1.0, 2.0, 0.5)], strides=[8])
    want = JaxAnchorGenerator(**kw).grid_anchors([(5, 7)])[0]
    got = AnchorGenerator(**kw).grid_anchors([(5, 7)], "cpu")[0]
    np.testing.assert_array_equal(got.numpy(), want)
    _check_fpn_rpn_and_levels()

    rng = np.random.RandomState(4)
    a = _boxes(rng, (2, 30, 4), 80.0) - 5.0
    a[0, 3] = 0.0  # an all-zero padded row: zero area, IoU 0
    box_sizes = np.array([[50, 60], [70, 40]], np.int32)
    d = rng.randn(2, 30, 8).astype(np.float32)
    d_clamped = d.copy()
    d_clamped[..., 2::4] *= 40.0  # exp clamp at log(1000/16)
    w = (10.0, 10.0, 5.0, 5.0)
    cases = {
        "iou": (jax.jit(jax.vmap(lambda x: jboxes.pairwise_iou(x, x)))(a),
                tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(a))),
        "clip": (jax.jit(jax.vmap(lambda x, s: jboxes.clip_boxes(x, (s[0], s[1]))))(a, box_sizes),
                 tboxes.clip_boxes(torch.from_numpy(a), torch.from_numpy(box_sizes))),
        "nonempty": (jax.jit(lambda x: jboxes.nonempty_boxes(x, 10.0))(a),
                     tboxes.nonempty_boxes(torch.from_numpy(a), 10.0)),
    }
    for name, deltas in (("deltas", d), ("deltas_clamped", d_clamped)):
        cases[name] = (jax.jit(lambda d, a: jboxes.apply_deltas(d, a, weights=w))(deltas, a),
                       tboxes.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(a), weights=w))
    for name, (want, got) in cases.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5, err_msg=name)


def _check_fpn_rpn_and_levels():
    """The Swin FPN's RPN: anchors of one size per level on p2-p6
    (detectron2's ``Base-RCNN-FPN.yaml``), the per-level top-k and the
    level-aware NMS over five levels; then ``assign_boxes_to_levels`` (d2's
    canonical rule, 224 at level 4, p2-p5) on boxes whose side is exactly
    112, 224 and 448 and on random ones: level ids equal."""
    kw = dict(sizes=[(32,), (64,), (128,), (256,), (512,)], aspect_ratios=[(0.5, 1.0, 2.0)],
              strides=[4, 8, 16, 32, 64])
    grids = [(20, 28), (10, 14), (5, 7), (3, 4), (2, 2)]
    for want, got in zip(JaxAnchorGenerator(**kw).grid_anchors(grids),
                         AnchorGenerator(**kw).grid_anchors(grids, "cpu")):
        np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.RandomState(5)
    b = 2
    levels = [_boxes(rng, (b, h * w * 3, 4), 112.0) for h, w in grids]
    logits = [rng.randn(*x.shape[:2]).astype(np.float32) for x in levels]
    sizes = np.array([[80, 112], [76, 100]], np.int32)
    j = jax.jit(lambda lv, lg, sz: jax_find_top(lv, lg, sz, 0.7, 32, 48, 0.0))(levels, logits,
                                                                               sizes)
    t = find_top_rpn_proposals([torch.from_numpy(x) for x in levels],
                               [torch.from_numpy(x) for x in logits],
                               torch.from_numpy(sizes), 0.7, 32, 48, 0.0)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.level_ids.numpy(), np.asarray(j.level_ids))
    assert len(np.unique(np.asarray(j.level_ids)[np.asarray(j.valid)])) == 5
    np.testing.assert_array_equal(t.objectness_logits.numpy(), np.asarray(j.objectness_logits))
    np.testing.assert_allclose(t.proposal_boxes.numpy(), np.asarray(j.proposal_boxes), atol=1e-6)

    xy = rng.uniform(-50, 600, (3, 64, 2))
    wh = np.exp(rng.uniform(np.log(2.0), np.log(1200.0), (3, 64, 2)))
    boxes = np.concatenate([xy, xy + wh], -1)
    for k, side in enumerate((112.0, 224.0, 448.0, 111.99, 224.01, 447.9, 56.0, 896.0)):
        boxes[0, k] = [10.0, 20.0, 10.0 + side, 20.0 + side]  # square: sqrt(area) = side
    boxes[0, 8] = [10.0, 20.0, 122.0, 20.0 + 112.0]  # 112 x 112 from other corners
    boxes[0, 9] = [30.0, 30.0, 30.0, 90.0]  # zero area
    boxes[0, 10] = [50.0, 40.0, 20.0, 10.0]  # degenerate
    boxes[0, 11] = 0.0  # an invalid (zeroed) row
    boxes = boxes.astype(np.float32)
    rules = ((224.0, 2, 5), (56.0, 2, 5), (224.0, 3, 6))
    wants = jax.jit(lambda x: [jax_assign_levels(x, lo, hi, c) for c, lo, hi in rules])(boxes)
    for (canonical, lo, hi), want in zip(rules, wants):
        want = np.asarray(want)
        got = assign_boxes_to_levels(torch.from_numpy(boxes), lo, hi, canonical).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{canonical} {lo} {hi}")
        assert got.dtype == np.int32 and len(np.unique(got)) == hi - lo + 1
    # sides 112, 224, 448 open p3, p4, p5; just below stays one level down
    np.testing.assert_array_equal(
        assign_boxes_to_levels(torch.from_numpy(boxes[0, :8]), 2, 5).numpy(),
        [1, 2, 3, 0, 2, 2, 0, 3])
