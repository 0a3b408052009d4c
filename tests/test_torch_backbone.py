"""The port's WSR ResNet and its layers, and its Swin Transformer and Swin
FPN, against the flax modules, on the same seeded parameters (random
frozen-BN statistics and LayerNorm scales included; moved across by
``backbone_state_dict_from_jax``) and inputs.
Tolerance rtol/atol 1e-4 in float32: XLA and oneDNN sum the convolutions
(and the attention's products) in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_common import random_params
from wsovod_tpu.models import layers as jlayers
from wsovod_tpu.models.backbones.resnet_wsl import WSRResNet as JaxWSRResNet
from wsovod_tpu.models.backbones.swin import SwinFPN as JaxSwinFPN
from wsovod_tpu.models.backbones.swin import SwinTransformer as JaxSwin
from wsovod_torch.models import layers as tlayers
from wsovod_torch.models.backbones.resnet_wsl import WSRResNet
from wsovod_torch.models.backbones.swin import SwinFPN, SwinTransformer
from wsovod_torch.utils.weight_import import backbone_state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def test_backbone_and_layers_match_flax():
    """R18 DC5 (the golden config's backbone), a narrow R50 DC5 and R18
    without dilation; ``max_pool_2x2`` at both strides; ``ConvNorm`` dilated,
    strided and 1x1; a tiny Swin alone and under its FPN."""
    for kw in (
        dict(depth=18),
        dict(depth=50, stem_out_channels=16, res2_out_channels=32, width_per_group=8),
        dict(depth=18, res5_dilation=1),  # res3 downsamples instead
    ):
        _check_wsr_resnet(kw)
    for stride in (1, 2):
        _check_max_pool_2x2_zero_pad(stride)
    for k, dilation, stride in ((3, 2, 1), (3, 1, 2), (1, 1, 1)):
        _check_convnorm(k, dilation, stride)
    _check_swin()


def _check_swin():
    """A tiny Swin (embed 24, depths ``[2, 2, 1, 1]``, 2 heads, window 4:
    every stage pads its windows, stages 2 and 3 run a shifted block) under
    a 32-channel FPN, on a 69x53 input (the patch embed pads it SAME,
    unevenly; the merges pad odd sides): p2-p6, and the Swin's own four
    stages (its bottom-up features, from the same JAX program); the strides
    and channels as the flax modules state them."""
    kw = dict(embed_dim=24, depths=(2, 2, 1, 1), num_heads=(2, 2, 2, 2), window_size=4)
    x = np.random.RandomState(3).uniform(-1, 1, (2, 69, 53, 3)).astype(np.float32)
    jm = JaxSwinFPN(bottom_up=JaxSwin(**kw), out_channels=32)
    params = random_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                          jnp.asarray(x))))["params"]
    # the bottom-up features captured in the same forward
    want_fpn, state = jax.jit(lambda p, v: jm.apply(
        {"params": p}, v, capture_intermediates=lambda mdl, _: isinstance(mdl, JaxSwin),
        mutable=["intermediates"]))(params, jnp.asarray(x))
    want_bu = state["intermediates"]["bottom_up"]["__call__"][0]
    tm = SwinFPN(SwinTransformer(**kw), out_channels=32)
    tm.load_state_dict(backbone_state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got_fpn, got_bu = tm(torch.from_numpy(x)), tm.bottom_up(torch.from_numpy(x))
    for name, t, j, got, want in (("swin_fpn", tm, jm, got_fpn, want_fpn),
                                  ("swin", tm.bottom_up, jm.bottom_up, got_bu, want_bu)):
        assert sorted(got) == sorted(want) and len(got) == (5 if name == "swin_fpn" else 4)
        assert t.output_strides() == j.output_strides(), name
        assert t.output_channels() == j.output_channels(), name
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].is_contiguous(), (name, k)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), **TOL, err_msg=f"{name} {k}")


def _check_wsr_resnet(kw):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 64, 48, 3)).astype(np.float32)
    jm = JaxWSRResNet(**kw)
    params = random_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    params = params["params"]
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))["res5"]

    tm = WSRResNet(**kw)
    tm.load_state_dict(backbone_state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))["res5"]
    assert got.shape == want.shape and got.is_contiguous()
    assert tm.output_strides() == jm.output_strides()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(kw))


def _check_max_pool_2x2_zero_pad(stride):
    """Stride 1 pads right/bottom with 0, not -inf: negative inputs show it."""
    x = np.random.RandomState(1).randn(2, 7, 9, 4).astype(np.float32) - 1.0
    want = np.asarray(jlayers.max_pool_2x2(jnp.asarray(x), stride))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = tlayers.max_pool_2x2(t, stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"stride {stride}")


def _check_convnorm(k, dilation, stride):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 11, 13, 8).astype(np.float32)
    jm = jlayers.ConvNorm(6, k, stride=stride, dilation=dilation)
    params = random_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(1), jnp.asarray(x))))
    params = params["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tlayers.ConvNorm(8, 6, k, stride=stride, dilation=dilation)
    sd = backbone_state_dict_from_jax({"stem": {f"conv{i}": params for i in (1, 2, 3)}})
    tm.load_state_dict({k_[len("stem.conv1."):]: v for k_, v in sd.items() if k_.startswith("stem.conv1.")})
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"{k} {dilation} {stride}")
