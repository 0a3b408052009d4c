"""WSOVOD on PyTorch and CUDA (NVIDIA H100).

The PyTorch port of ``wsovod_tpu``, which stays in the repository unchanged
as the reference. The port covers eval-only inference of the WSR-ResNet DC5
detector, plain and MRRP: backbone (with the multi-branch res5 stage under
MRRP) -> ``WSOVODRPN_V2`` -> SAM-proposal fusion -> data-aware head -> gated
7x7 ROIPool or branch-routed ROILoopPool (hand-written CUDA kernels) -> DAN
-> instance-refinement heads -> class-wise NMS.

Module names follow ``wsovod_tpu`` so every module has an obvious
counterpart. At module boundaries the JAX layouts are kept: features NHWC
``[B, H, W, C]``, padded static-shape ``Instances`` with a ``valid`` mask,
boxes XYXY in image coordinates.

The package imports ``torch`` and never ``jax``, ``flax`` or anything of
``wsovod_tpu``: it has its own copy of the YAML config system.
"""

from .config import check_supported, get_cfg

__all__ = ["get_cfg", "check_supported"]
