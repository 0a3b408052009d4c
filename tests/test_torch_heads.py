"""The port's heads against the flax modules on the same parameters and
inputs: the DAN (chunked fc1) against the JAX ``DenseGeneral`` fc1, the
open-vocabulary classifier, the data-aware head, the refinement head with
``predict_probs_K`` / ``predict_boxes_K``, and ``fast_rcnn_inference``.
Tolerance 1e-5 in float32 (summation order only); detections' classes,
validity and proposal indices exactly. The JAX side runs under ``jax.jit``:
one compiled program per call, not one per primitive."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wsovod_tpu.models import class_heads as jch
from wsovod_tpu.models import mil_heads as jmil
from wsovod_tpu.models.box_head import DiscriminativeAdaptationNeck as JaxDAN
from wsovod_tpu.models.fast_rcnn_inference import fast_rcnn_inference_batched as jax_frcnn
from wsovod_torch.models import class_heads as tch
from wsovod_torch.models import mil_heads as tmil
from wsovod_torch.models.box_head import DiscriminativeAdaptationNeck
from wsovod_torch.models.fast_rcnn_inference import fast_rcnn_inference_batched
from wsovod_torch.utils.weight_import import fc1_weight_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _dense(p):
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def test_box_head_and_classifier_heads_match_flax():
    """The DAN with chunked fc1 (one chunk and four), the open-vocabulary
    classifier in its three modes, and the data-aware head."""
    _check_dan()
    for mode in ("embeddings", "embeddings_bg", "classifier"):
        _check_open_vocabulary_classifier(mode)
    _check_data_aware_head()


def _check_dan():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 7, 7, 64).astype(np.float32)
    jm = JaxDAN(fc_dims=(32, 24))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    xt = torch.from_numpy(x)
    for c_take in (64, 16):
        tm = DiscriminativeAdaptationNeck(64, 7, (32, 24), c_take=c_take)
        tm.load_state_dict({
            "fc1.weight": _t(fc1_weight_from_jax(params["fc1"]["kernel"])),
            "fc1.bias": _t(params["fc1"]["bias"]),
            **{f"fc2.{k}": v for k, v in _dense(params["fc2"]).items()},
        }, strict=True)
        with torch.inference_mode():
            got = tm(xt[..., c:c + c_take] for c in range(0, 64, c_take))
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"c_take {c_take}")
        # the state_dict keeps the reference [out, c*h*w] layout
        np.testing.assert_array_equal(tm.state_dict()["fc1.weight"].numpy(),
                                      fc1_weight_from_jax(params["fc1"]["kernel"]))


def _check_open_vocabulary_classifier(mode):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 32).astype(np.float32)
    emb = rng.randn(5, 16).astype(np.float32)
    override = rng.randn(7, 16).astype(np.float32)
    jm = jch.OpenVocabularyClassifier(num_classes=5, weight_dim=16, norm_temperature=50.0)
    bg = mode == "embeddings_bg"
    kw_j = dict(embeddings=jnp.asarray(emb))
    kw_t = dict(embeddings=_t(emb), append_background=bg)
    if mode == "classifier":
        kw_j["classifier"], kw_t["classifier"] = jnp.asarray(override), _t(override)
    init = jax.jit(lambda key, x, kw: jm.init(key, x, append_background=bg, **kw))
    apply = jax.jit(lambda p, x, kw: jm.apply(p, x, append_background=bg, **kw))
    params = init(jax.random.PRNGKey(1), x, kw_j)["params"]
    want = np.asarray(apply({"params": params}, x, kw_j))
    tm = tch.OpenVocabularyClassifier(32, 16, norm_temperature=50.0)
    sd = {f"projection.0.{k}": v for k, v in _dense(params["proj1"]).items()}
    sd.update({f"projection.2.{k}": v for k, v in _dense(params["proj2"]).items()})
    tm.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=mode)


def _check_data_aware_head():
    rng = np.random.RandomState(2)
    feat = rng.rand(2, 5, 6, 64).astype(np.float32)
    valid = np.zeros((2, 5, 6), bool)
    valid[0, :4, :5] = True
    valid[1] = True
    jm = jch.DataAwareFeaturesHead(prototype_num=5, features_dim=24)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), feat, valid)["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, feat, valid))
    tm = tch.DataAwareFeaturesHead(64, 5, 24)
    sd = {f"linear1.{k}": v for k, v in _dense(params["linear1"]).items()}
    sd.update({f"linear2.{k}": v for k, v in _dense(params["linear2"]).items()})
    sd["datasets_feat.weight"] = _t(params["datasets_feat"])
    tm.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(feat), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_refinery_and_fast_rcnn_inference_match_jax():
    """Two refinement heads with ``predict_probs_K`` / ``predict_boxes_K``,
    then ``fast_rcnn_inference`` at two score thresholds."""
    _check_refinery()
    for thresh in (1e-5, 0.02):
        _check_fast_rcnn_inference(thresh)


def _check_refinery():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 32).astype(np.float32)
    emb = rng.randn(5, 16).astype(np.float32)
    props = np.abs(rng.randn(2, 9, 4).astype(np.float32)) * 20
    props[..., 2:] += props[..., :2] + 5
    jms = [jmil.InstanceRefinementOutputLayers(num_classes=5, refine_k=k, refine_reg=True,
                                               weight_dim=16) for k in range(2)]
    tms = [tmil.InstanceRefinementOutputLayers(32, refine_reg=True, weight_dim=16) for _ in range(2)]
    s_j, d_j, s_t, d_t = [], [], [], []
    for k, (jm, tm) in enumerate(zip(jms, tms)):
        params = jax.jit(jm.init)(jax.random.PRNGKey(3 + k), x, embeddings=emb)["params"]
        s, d = jax.jit(jm.apply)({"params": params}, x, embeddings=emb)
        s_j.append(s)
        d_j.append(d)
        sd = {f"cls.projection.0.{k_}": v for k_, v in _dense(params["cls"]["proj1"]).items()}
        sd.update({f"cls.projection.2.{k_}": v for k_, v in _dense(params["cls"]["proj2"]).items()})
        sd.update({f"bbox_pred.{k_}": v for k_, v in _dense(params["bbox_pred"]).items()})
        tm.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            s2, d2 = tm(torch.from_numpy(x), embeddings=_t(emb))
        np.testing.assert_allclose(s2.numpy(), np.asarray(s), **TOL)
        np.testing.assert_allclose(d2.numpy(), np.asarray(d), **TOL)
        s_t.append(s2)
        d_t.append(d2)
    w = (10.0, 10.0, 5.0, 5.0)
    np.testing.assert_allclose(tmil.predict_probs_K(s_t).numpy(),
                               np.asarray(jax.jit(jmil.predict_probs_K)(s_j)), **TOL)
    np.testing.assert_allclose(tmil.predict_boxes_K(d_t, _t(props), w).numpy(),
                               np.asarray(jax.jit(lambda d, p: jmil.predict_boxes_K(d, p, w))(d_j, props)),
                               rtol=1e-5, atol=1e-4)


def _check_fast_rcnn_inference(thresh):
    rng = np.random.RandomState(4)
    b, p, c = 2, 60, 6
    xy = rng.uniform(-10, 80, (b, p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (b, p, 2))], -1).astype(np.float32)
    logits = rng.randn(b, p, c + 1) * 2
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    valid = rng.rand(b, p) > 0.2
    boxes[0, 7, 2] = np.inf  # non-finite rows never enter
    sizes = np.array([[90, 100], [70, 80]], np.int32)
    kw = dict(score_thresh=thresh, nms_thresh=0.3, topk_per_image=25, per_class_topk=16)
    j = jax.jit(lambda *a: jax_frcnn(*a, **kw))(boxes, probs, valid, sizes)
    t = fast_rcnn_inference_batched(_t(boxes), _t(probs), torch.from_numpy(valid),
                                    torch.from_numpy(sizes), **kw)
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), v)
    np.testing.assert_array_equal(t.classes.numpy()[v], np.asarray(j.classes)[v])
    np.testing.assert_array_equal(t.pred_inds.numpy()[v], np.asarray(j.pred_inds)[v])
    np.testing.assert_allclose(t.scores.numpy()[v], np.asarray(j.scores)[v], **TOL)
    np.testing.assert_allclose(t.boxes.numpy()[v], np.asarray(j.boxes)[v], **TOL)
