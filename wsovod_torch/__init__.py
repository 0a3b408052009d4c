"""WSOVOD on PyTorch and CUDA (NVIDIA H100).

The PyTorch port of ``wsovod_tpu``, which stays in the repository unchanged
as the reference. This slice is eval-only inference of the plain (non-MRRP)
WSR-ResNet DC5 detector: backbone -> ``WSOVODRPN_V2`` -> SAM-proposal fusion
-> data-aware head -> gated 7x7 ROIPool (a hand-written CUDA kernel) -> DAN
-> instance-refinement heads -> class-wise NMS.

Module names follow ``wsovod_tpu`` so every module has an obvious
counterpart. At module boundaries the JAX layouts are kept: features NHWC
``[B, H, W, C]``, padded static-shape ``Instances`` with a ``valid`` mask,
boxes XYXY in image coordinates.

The package imports ``torch`` and never ``jax`` or ``flax``; its one import
from ``wsovod_tpu`` is the pure-YAML ``wsovod_tpu.config``.
"""

from .config import check_supported, get_cfg

__all__ = ["get_cfg", "check_supported"]
