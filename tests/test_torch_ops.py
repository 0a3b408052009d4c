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
from wsovod_tpu.models.proposal_utils import find_top_rpn_proposals as jax_find_top
from wsovod_tpu.ops import nms as jnms
from wsovod_tpu.structures import boxes as jboxes
from wsovod_torch.models.anchors import AnchorGenerator
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
    minimum size), the grid anchors, and the box ops."""
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
