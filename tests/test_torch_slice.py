"""The port's whole inference forward against ``wsovod_tpu``'s
``model.apply(..., train=False)`` on the tiny golden config (R18 DC5, 64-px
images, ``DAN_DIM [64, 64]``, ``WEIGHT_DIM 16``, float32), on the same
parameters and inputs. On the CPU the JAX model pools through the jnp
reference, so no Pallas interpret run is involved.

Tolerances: proposals, probabilities and boxes rtol 1e-4 with box atol 1e-3;
validity masks and classes exactly. The stage-wise test feeds the port's
heads the JAX backbone features, so a discrete top-k or NMS flip shows up at
the stage that made it instead of being loosened away; it also holds the ROI
heads with the ``ROIAlignV2`` pooler to the JAX package's.

The int8 inference (``TPU.DAN_FC1_QUANT`` and ``TPU.RPN_CONV_QUANT``
``"int8"``), inside ``test_slice_matches_jax``: against the JAX package's,
run with its pooler on the TPU path in interpret mode
(``torch_port_common.jax_int8_forward``), both on its default route (bf16
emission, fc1 quantizes) and on its ``WSOVOD_POOL_MAXABS`` route, which
give the same numbers. The whole forward: proposals (the int8 RPN conv) as
above; probabilities rtol 1e-4 and atol 1e-4, since torch's and XLA's
float32 backbone sums may move an activation across a rounding tie of the
int8 quantization, one step of 127; the ROI heads on the JAX features and
proposals, where fc1's int8 product is bit for bit, as the float slice.
Then the entry point over two batches."""

import numpy as np
import torch

from torch_port_common import (
    TINY_YAML, check_int8_model, embeddings, jax_int8_forward, jax_reference, jax_stages,
    make_batch, torch_model_from_jax,
)
from wsovod_torch.engine.evaluator import inference_on_dataset
from wsovod_torch.structures.instances import Instances

RTOL, BOX_ATOL = 1e-4, 1e-3


def _torch_forward(model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        return model(tb, embeddings=torch.from_numpy(embeddings()), return_proposals=True)


def _top5(det, i):
    v = np.asarray(det.valid[i])
    order = np.argsort(np.where(v, -np.asarray(det.scores[i]), np.inf), kind="stable")[:5]
    return order[v[order]]


def test_slice_matches_jax():
    """The forward on two inputs, then the entry point over two batches;
    then the int8 inference."""
    for seed in (0, 5):
        _check_forward(seed)
    _check_inference_on_dataset()
    _check_int8_slice()


def _check_int8_slice():
    """The tiny plain R18 with both int8 keys against the JAX package's int8
    inference; then ``inference_on_dataset`` over two batches, the first
    one's top detections the JAX package's."""
    tm = check_int8_model(TINY_YAML)
    jdet = jax_int8_forward(TINY_YAML)["default"][0]

    def loader():
        for seed in (0, 1):
            b = make_batch(seed)
            b["image_id"] = [f"{seed}_{i}" for i in range(2)]
            b["orig_size"] = b["image_sizes"]
            yield b

    got = inference_on_dataset(tm, loader(), _Recorder(), embeddings=torch.from_numpy(embeddings()))
    assert len(got) == 4 and all(len(s) and np.isfinite(s).all() for _, s, _ in got.values())
    for i in range(2):
        top = np.argsort(-jdet.scores[i][jdet.valid[i]], kind="stable")[:5]
        tb, ts, tc = got[f"0_{i}"]
        np.testing.assert_array_equal(tc[:5], jdet.classes[i][jdet.valid[i]][top])
        np.testing.assert_allclose(tb[:5], jdet.boxes[i][jdet.valid[i]][top], rtol=RTOL,
                                   atol=BOX_ATOL)


def _check_forward(seed):
    batch = make_batch(seed)
    jdet, jprobs, jboxes, jprops = jax_stages(seed)[3]
    tdet, tprobs, tboxes, tprops = _torch_forward(torch_model_from_jax(), batch)

    np.testing.assert_array_equal(tprops[2].numpy(), jprops[2])  # proposal validity
    np.testing.assert_allclose(tprops[0].numpy(), jprops[0], rtol=RTOL, atol=BOX_ATOL)
    np.testing.assert_allclose(tprops[1].numpy(), jprops[1], rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tboxes.numpy(), jboxes, rtol=RTOL, atol=BOX_ATOL)
    for i in range(batch["images"].shape[0]):
        top = _top5(jdet, i)
        assert len(top) == 5
        np.testing.assert_array_equal(tdet.valid[i].numpy()[top], True)
        np.testing.assert_array_equal(tdet.classes[i].numpy()[top], jdet.classes[i][top])
        np.testing.assert_allclose(tdet.scores[i].numpy()[top], jdet.scores[i][top], rtol=RTOL)
        np.testing.assert_allclose(tdet.boxes[i].numpy()[top], jdet.boxes[i][top],
                                   rtol=RTOL, atol=BOX_ATOL)


def test_slice_stagewise():
    """The RPN on the JAX backbone features, then the ROI heads on the JAX
    proposals and data-aware vector; then the ROI heads with the
    ``ROIAlignV2`` pooler (the config tree's default; ``POOLER_SAMPLING_RATIO``
    0, which both packages take as 2 samples per bin axis) against the JAX
    package's, which pools with the jnp ``roi_align`` on the CPU, and the
    entry point with it over two batches."""
    batch = make_batch(0)
    feats, rpn, daf, (det, probs, boxes, props) = jax_stages(0)
    tm = torch_model_from_jax()
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    sizes = torch.from_numpy(batch["image_sizes"])
    with torch.inference_mode():
        t = tm.proposal_generator(tfeats, sizes)
        np.testing.assert_array_equal(t.valid.numpy(), rpn.valid)
        np.testing.assert_allclose(t.objectness_logits.numpy(), rpn.objectness_logits,
                                   rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(t.proposal_boxes.numpy(), rpn.proposal_boxes,
                                   rtol=RTOL, atol=BOX_ATOL)
        tprops = Instances(torch.from_numpy(props[2]), proposal_boxes=torch.from_numpy(props[0]),
                           objectness_logits=torch.from_numpy(props[1]))
        tdet, tprobs, tboxes = tm.roi_heads.inference(
            tfeats, tprops, sizes, data_aware_features=torch.from_numpy(daf),
            embeddings=torch.from_numpy(embeddings()))
    np.testing.assert_allclose(tprobs.numpy(), probs, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tboxes.numpy(), boxes, rtol=RTOL, atol=BOX_ATOL)
    np.testing.assert_array_equal(tdet.valid.numpy(), det.valid)
    np.testing.assert_array_equal(tdet.classes.numpy()[det.valid], det.classes[det.valid])
    np.testing.assert_allclose(tdet.scores.numpy()[det.valid], det.scores[det.valid], rtol=RTOL)
    _check_align_heads(feats, daf, props)


def _check_align_heads(feats, daf, props):
    """The ROI heads with ``ROIAlignV2`` on the JAX package's features,
    proposals and data-aware vector (the pooler changes nothing before the
    ROI heads), against its ``roi_heads.inference``; then
    ``inference_on_dataset`` runs the align model over two batches."""
    import jax
    import jax.numpy as jnp

    from wsovod_tpu.structures.instances import Instances as JaxInstances

    batch = make_batch(0)
    jm, params = jax_reference(pooler="ROIAlignV2")

    def heads(m, f, boxes, logits, valid, sizes, d, e):
        p = JaxInstances(valid, proposal_boxes=boxes, objectness_logits=logits)
        return m.roi_heads.inference(f, p, sizes, data_aware_features=d, embeddings=e)

    args = (feats, *props, batch["image_sizes"], daf, embeddings())
    det, probs, boxes = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, *a: jm.apply(p, *a, method=heads))(params, *jax.tree_util.tree_map(jnp.asarray,
                                                                                  args)))
    tm = torch_model_from_jax(pooler="ROIAlignV2")
    assert (tm.roi_heads.pooler.pooler_type, tm.roi_heads.pooler.sampling_ratio) == ("ROIAlignV2", 2)
    tprops = Instances(torch.from_numpy(props[2]), proposal_boxes=torch.from_numpy(props[0]),
                       objectness_logits=torch.from_numpy(props[1]))
    with torch.inference_mode():
        tdet, tprobs, tboxes = tm.roi_heads.inference(
            {k: torch.from_numpy(v) for k, v in feats.items()}, tprops,
            torch.from_numpy(batch["image_sizes"]), data_aware_features=torch.from_numpy(daf),
            embeddings=torch.from_numpy(embeddings()))
    np.testing.assert_allclose(tprobs.numpy(), probs, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tboxes.numpy(), boxes, rtol=RTOL, atol=BOX_ATOL)
    np.testing.assert_array_equal(tdet.valid.numpy(), det.valid)
    np.testing.assert_array_equal(tdet.classes.numpy()[det.valid], det.classes[det.valid])
    np.testing.assert_allclose(tdet.scores.numpy()[det.valid], det.scores[det.valid], rtol=RTOL)

    def loader():
        for seed in (0, 1):
            b = make_batch(seed)
            b["image_id"] = [f"{seed}_{i}" for i in range(2)]
            b["orig_size"] = b["image_sizes"]
            yield b

    got = inference_on_dataset(tm, loader(), _Recorder(), embeddings=torch.from_numpy(embeddings()))
    assert len(got) == 4 and all(len(s) and np.isfinite(s).all() for _, s, _ in got.values())


class _Recorder:
    def __init__(self):
        self.rows = {}

    def process(self, image_id, boxes, scores, classes):
        self.rows[image_id] = (np.asarray(boxes), np.asarray(scores), np.asarray(classes))

    def evaluate(self):
        return dict(self.rows)


def _check_inference_on_dataset():
    """The entry point over two batches, against the JAX model's detections
    with the host-side rescale of ``wsovod_tpu.engine.evaluator`` (scale by
    original/input size, clip to the original image)."""
    orig = np.array([[128, 96], [64, 80]], np.int32)

    def loader():
        for seed in (0, 1):
            b = make_batch(seed)
            b["image_id"] = [f"{seed}_{i}" for i in range(2)]
            b["orig_size"] = orig
            yield b

    got = inference_on_dataset(torch_model_from_jax(), loader(), _Recorder(),
                               embeddings=torch.from_numpy(embeddings()))
    assert len(got) == 4
    for seed in (0, 1):
        det = jax_stages(seed)[3][0]
        size = make_batch(seed)["image_sizes"]
        for i in range(2):
            v = det.valid[i]
            sy, sx = orig[i] / size[i]
            jb = det.boxes[i][v] * np.array([sx, sy, sx, sy], np.float32)
            jb[:, 0::2] = np.clip(jb[:, 0::2], 0, orig[i][1])
            jb[:, 1::2] = np.clip(jb[:, 1::2], 0, orig[i][0])
            js, jc = det.scores[i][v], det.classes[i][v]
            tb, ts, tc = got[f"{seed}_{i}"]
            assert len(ts) == len(js)
            top = np.argsort(-js, kind="stable")[:5]
            np.testing.assert_array_equal(tc[top], jc[top])
            np.testing.assert_allclose(ts[top], js[top], rtol=RTOL)
            np.testing.assert_allclose(tb[top], jb[top], rtol=RTOL, atol=BOX_ATOL)
