"""The port's WSR ResNet and its layers against the flax modules, on the same
seeded parameters (random frozen-BN statistics included; moved across by
``backbone_state_dict_from_jax``) and inputs.
Tolerance rtol/atol 1e-4 in float32: XLA and oneDNN sum the convolutions in
different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_common import random_params
from wsovod_tpu.models import layers as jlayers
from wsovod_tpu.models.backbones.resnet_wsl import WSRResNet as JaxWSRResNet
from wsovod_torch.models import layers as tlayers
from wsovod_torch.models.backbones.resnet_wsl import WSRResNet
from wsovod_torch.utils.weight_import import backbone_state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def test_backbone_and_layers_match_flax():
    """R18 DC5 (the golden config's backbone), a narrow R50 DC5 and R18
    without dilation; ``max_pool_2x2`` at both strides; ``ConvNorm`` dilated,
    strided and 1x1."""
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
