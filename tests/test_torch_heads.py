"""The port's heads against the flax modules on the same parameters and
inputs: the DAN (chunked fc1) against the JAX ``DenseGeneral`` fc1, the
open-vocabulary classifier, the data-aware head, the refinement head with
``predict_probs_K`` / ``predict_boxes_K``, and ``fast_rcnn_inference``.
Tolerance 1e-5 in float32 (summation order only); detections' classes,
validity and proposal indices exactly. The JAX side runs under ``jax.jit``:
one compiled program per call, not one per primitive (XLA also makes a
division by the constant 127 a multiplication by its float32 reciprocal,
which the port's int8 paths follow).

The int8 fc1 and RPN conv, inside ``test_box_head_and_classifier_heads_match_flax``:
``ChunkedLinear`` with ``quant="int8"`` against ``ChunkedDenseGeneral(quant=
"int8")`` on its three input forms (float chunks, ``(payload, maxabs)``
pairs, ``(int8 payload, scale)`` pairs), float32, rtol 1e-6 and atol 1e-7:
the scales and the int8 products (exact integer sums) are the same, and
the dequant and the sum over chunks follow the same order, but XLA:CPU
contracts the first chunk's ``* s_w`` and the following add into an FMA,
which the port does not, so the two differ by an ulp; a quantization step
would move a term by 1/127 of itself. (For int8 chunks alone the JAX module
returns bfloat16: there one bfloat16 step.) ``conv3x3_shifted_int8`` against the
JAX function, at dilation 1 and 2: without a bias bit for bit in float32
and bfloat16 (one int32 sum, then ``(acc * s_x) * s_k``), with one float32
rtol 1e-6 and atol 1e-7 (XLA:CPU makes ``* s_k + bias`` an FMA) and bfloat16
within one bfloat16 step; the RPN head's conv keeps its parameters and runs
in floating point in training; the int8 head on an FPN's five levels
against the JAX ``StandardRPNHead(conv_quant="int8")``, each level
quantized on its own, float32 at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wsovod_tpu.models import class_heads as jch
from wsovod_tpu.models import mil_heads as jmil
from wsovod_tpu.models.box_head import ChunkedDenseGeneral
from wsovod_tpu.models.box_head import DiscriminativeAdaptationNeck as JaxDAN
from wsovod_tpu.models.layers import conv3x3_shifted_int8 as jax_conv_int8
from wsovod_tpu.models.rpn import StandardRPNHead as JaxRPNHead
from wsovod_tpu.models.fast_rcnn_inference import fast_rcnn_inference_batched as jax_frcnn
from wsovod_torch.models import class_heads as tch
from wsovod_torch.models import mil_heads as tmil
from wsovod_torch.models.box_head import ChunkedLinear, DiscriminativeAdaptationNeck
from wsovod_torch.models.layers import conv3x3_shifted_int8
from wsovod_torch.models.rpn import StandardRPNHead
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
    _check_int8_fc1()
    _check_int8_rpn_conv()


def _check_int8_fc1():
    """``ChunkedLinear(quant="int8")`` against ``ChunkedDenseGeneral(quant=
    "int8")``, two 32-channel chunks, on the three input forms."""
    rng = np.random.RandomState(3)
    b, n, c, ct, f = 2, 21, 64, 32, 24
    x = rng.randn(b, n, 7, 7, c).astype(np.float32)
    x[0, 3] = 0.0  # a ROI pooling nothing: its maxabs is floored at 1e-8
    jm = ChunkedDenseGeneral(f, in_shape=(7, 7, c), quant="int8")
    chunks = [x[..., k:k + ct] for k in range(0, c, ct)]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), chunks)
    kernel = np.asarray(params["params"]["kernel"])
    lin = ChunkedLinear(c, 7, f, ct, quant="int8")
    lin.load_state_dict({"weight": _t(fc1_weight_from_jax(kernel)),
                         "bias": _t(params["params"]["bias"])})
    hwnc = [np.ascontiguousarray(ch.transpose(0, 2, 3, 1, 4)) for ch in chunks]
    maxabs = [np.abs(ch).max(axis=(2, 3, 4)) for ch in chunks]
    q8 = [rng.randint(-127, 128, ch.shape).astype(np.int8) for ch in chunks]
    scale = [rng.uniform(1e-3, 1e-2, (b, n)).astype(np.float32) for _ in chunks]
    forms = {
        "float": (chunks, "nhwc", [_t(ch) for ch in chunks]),
        "maxabs": (list(zip(hwnc, maxabs)), "hwnc",
                   [(_t(ch), _t(m)) for ch, m in zip(chunks, maxabs)]),
        "int8": (list(zip([q.transpose(0, 2, 3, 1, 4) for q in q8], scale)), "hwnc",
                 [(torch.from_numpy(q), _t(s)) for q, s in zip(q8, scale)]),
    }
    for name, (jchunks, layout, tchunks) in forms.items():
        jl = ChunkedDenseGeneral(f, in_shape=(7, 7, c), quant="int8", chunk_layout=layout)
        want = np.asarray(jax.jit(jl.apply)(params, jchunks).astype(jnp.float32))
        with torch.inference_mode():
            acc = None
            for k, ch in enumerate(tchunks):
                y = lin(ch, k, int8=True)
                acc = y if acc is None else acc + y
            got = acc + lin.bias.float()
        if name == "int8":  # int8 chunks alone: ChunkedDenseGeneral returns bfloat16
            got = got.bfloat16().float()
            tol = dict(rtol=2.0 ** -8, atol=0)
        else:
            tol = dict(rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.numpy(), want, **tol, err_msg=name)
    # quant "none", or int8 not asked for (training), is the floating-point product
    with torch.inference_mode():
        fp = lin(_t(chunks[0]), 0)
        assert not torch.equal(fp, lin(_t(chunks[0]), 0, int8=True))
        plain = ChunkedLinear(c, 7, f, ct)
        plain.load_state_dict(lin.state_dict())  # the same parameters
        assert torch.equal(fp, plain(_t(chunks[0]), 0, int8=True))


def _check_int8_rpn_conv():
    """``conv3x3_shifted_int8`` against the JAX function under ``jax.jit``,
    bit for bit; the RPN head's int8 conv at inference, its float conv in
    training, with the same parameters; then the int8 head on five levels
    against the JAX head."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 9, 16).astype(np.float32)
    kernel = (rng.randn(3, 3, 16, 24) * 0.1).astype(np.float32)
    bias = (rng.randn(24) * 0.1).astype(np.float32)
    weight = _t(kernel.transpose(3, 2, 0, 1))  # [F, C, 3, 3]
    conv = jax.jit(jax_conv_int8, static_argnames="dilation")
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for d in (1, 2):
            want = np.asarray(conv(jnp.asarray(x, jdt), jnp.asarray(kernel), None, dilation=d)
                              .astype(jnp.float32))
            got = conv3x3_shifted_int8(_t(x).to(dtype), weight, None, dilation=d)
            assert got.dtype == dtype and got.shape == (2, 6, 9, 24)
            np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"{dtype} {d}")
            want = np.asarray(conv(jnp.asarray(x, jdt), jnp.asarray(kernel), jnp.asarray(bias),
                                   dilation=d).astype(jnp.float32))
            got = conv3x3_shifted_int8(_t(x).to(dtype), weight, _t(bias), dilation=d).float()
            tol = (dict(rtol=1e-6, atol=1e-7) if dtype == torch.float32
                   else dict(rtol=2.0 ** -8, atol=0))
            np.testing.assert_allclose(got.numpy(), want, **tol, err_msg=f"{dtype} {d} bias")
    head = StandardRPNHead(16, 3, conv_quant="int8")  # its conv is 16 -> 16 channels
    assert sorted(head.conv.state_dict()) == ["bias", "weight"]
    kernel, bias = kernel[..., :16], bias[:16]
    with torch.no_grad():
        head.conv.weight.copy_(_t(kernel.transpose(3, 2, 0, 1)))
        head.conv.bias.copy_(_t(bias))
    want = jax.jit(jax_conv_int8)(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    with torch.inference_mode():
        t_int8 = head.conv.forward_nhwc(_t(x), int8=True)
        (lg_test,), _ = head([_t(x)])
        (lg_train,), _ = head([_t(x)], train=True)
        want_test = head.objectness_logits(torch.relu(t_int8).permute(0, 3, 1, 2))
        want_train = head.objectness_logits(torch.relu(head.conv(_t(x).permute(0, 3, 1, 2))))
    np.testing.assert_allclose(t_int8.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert torch.equal(lg_test, want_test.permute(0, 2, 3, 1))
    assert torch.equal(lg_train, want_train.permute(0, 2, 3, 1))
    assert not torch.equal(lg_test, lg_train)

    # the head on an FPN's five levels against the JAX StandardRPNHead with
    # its int8 conv: each level quantized on its own, the same parameters
    rng = np.random.RandomState(6)
    levels = [rng.randn(2, h, w, 16).astype(np.float32) * (1.0 + k)
              for k, (h, w) in enumerate(((10, 14), (5, 7), (3, 4), (2, 2), (1, 1)))]
    jhead = JaxRPNHead(num_anchors=3, conv_quant="int8")
    sd = head.state_dict()
    params = {"conv": {"kernel": kernel, "bias": bias}}
    for name in ("objectness_logits", "anchor_deltas"):
        params[name] = {"kernel": sd[f"{name}.weight"].numpy().transpose(2, 3, 1, 0),
                        "bias": sd[f"{name}.bias"].numpy()}
    want_lg, want_dl = jax.jit(lambda p, f: jhead.apply({"params": p}, f))(
        params, [jnp.asarray(f) for f in levels])
    with torch.inference_mode():
        got_lg, got_dl = head([_t(f) for f in levels])
    for k in range(len(levels)):
        np.testing.assert_allclose(got_lg[k].numpy(), np.asarray(want_lg[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"logits level {k}")
        np.testing.assert_allclose(got_dl[k].numpy(), np.asarray(want_dl[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"deltas level {k}")


def _check_dan():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 7, 7, 64).astype(np.float32)
    jm = JaxDAN(fc_dims=(32, 24))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    xt = torch.from_numpy(x)
    for c_take in (64, 16):
        tm = DiscriminativeAdaptationNeck(64, 7, (32, 24), c_take=c_take).eval()  # no dropout
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
