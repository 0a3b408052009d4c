"""Gated exact max RoIPool: the CUDA kernel's wrapper and its plain PyTorch
version (counterparts: ``wsovod_tpu/ops/roi_pool.py::roi_pool`` for the
semantics, ``wsovod_tpu/ops/pallas/roi_pool_fused.py::roi_pool_fused_batched``
(``loop_pool=False``) for the TPU kernel it replaces).

``roi_pool_gated(feat, rois, gate, c_base, c_take, output_size,
spatial_scale)`` returns, for every image ``b``,
``roi_pool(feat[b], rois[b], P, scale)[..., c_base:c_base+c_take] *
gate[b, :, None, None, None]`` as ``[B, N, P, P, c_take]`` in ``feat``'s
dtype, with the gate rounded to that dtype first (as the reference's
``pooled * gate.astype(pooled.dtype)``), so the kernel and the plain version
agree bit for bit in bfloat16 and float32.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30  # the reference's fill value for masked-out pixels

LAUNCHES = 0

_ENTRY = {torch.bfloat16: "wsovod_roi_pool_gated_bf16", torch.float32: "wsovod_roi_pool_gated_f32"}


def _kernel(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its ctypes signature (builds and
    loads the library at first use)."""
    from ..kernels import load

    fn = getattr(load("roi_pool_gated.cu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def round_region(rois: torch.Tensor, spatial_scale: float) -> torch.Tensor:
    """Rounded integer region ``(x1, y1, w, h)`` per ROI, int32 ``[..., 4]``.

    ``floor(x * scale + 0.5)`` (C ``round`` for the non-negative coordinates
    of this pipeline), taken as two separately rounded float32 ops like the
    reference; ``w, h = max(x2 - x1 + 1, 1)``."""
    r = torch.floor(rois.float() * spatial_scale + 0.5).to(torch.int32)
    x1, y1 = r[..., 0], r[..., 1]
    w = (r[..., 2] - x1 + 1).clamp(min=1)
    h = (r[..., 3] - y1 + 1).clamp(min=1)
    return torch.stack([x1, y1, w, h], dim=-1)


def _bin_edges(start: torch.Tensor, size: torch.Tensor, pooled: int, limit: int):
    """Integer bin edges ``[lo, hi)`` per bin: ``floor(p*size/P)`` and
    ``ceil((p+1)*size/P)`` plus ``start``, clipped to ``[0, limit]``.
    ``start``/``size`` ``[...]`` -> ``[..., P]``."""
    p = torch.arange(pooled, dtype=torch.int32, device=start.device)
    lo = torch.div(p * size[..., None], pooled, rounding_mode="floor") + start[..., None]
    hi = -torch.div(-(p + 1) * size[..., None], pooled, rounding_mode="floor") + start[..., None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_pool_gated_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    max_elems: int = 1 << 27,
) -> torch.Tensor:
    """The plain PyTorch version: the reference's separable masked max (max
    over each bin's columns, then over its rows), in ROI chunks sized so the
    ``[n, P, H, W, c]`` masked temporary stays under ``max_elems``."""
    b, h_lim, w_lim, _ = feat.shape
    n, p = rois.shape[1], output_size
    f = feat[..., c_base : c_base + c_take]
    reg = round_region(rois, spatial_scale)
    hlo, hhi = _bin_edges(reg[..., 1], reg[..., 3], p, h_lim)  # [B, N, P]
    wlo, whi = _bin_edges(reg[..., 0], reg[..., 2], p, w_lim)
    hidx = torch.arange(h_lim, device=feat.device)
    widx = torch.arange(w_lim, device=feat.device)
    neg = torch.tensor(NEG_INF, dtype=feat.dtype, device=feat.device)
    g = gate.to(feat.dtype)
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    out = torch.empty((b, n, p, p, c_take), dtype=feat.dtype, device=feat.device)
    for i in range(b):
        fi = f[i]
        for s in range(0, n, step):
            e = min(n, s + step)
            row_in = (hidx >= hlo[i, s:e, :, None]) & (hidx < hhi[i, s:e, :, None])  # [n, P, H]
            col_in = (widx >= wlo[i, s:e, :, None]) & (widx < whi[i, s:e, :, None])  # [n, P, W]
            colmax = torch.where(col_in[:, :, None, :, None], fi[None, None], neg).amax(dim=3)
            pooled = torch.where(row_in[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)
            pooled = torch.where(pooled <= neg, torch.zeros((), dtype=feat.dtype, device=feat.device), pooled)
            out[i, s:e] = pooled * g[i, s:e, None, None, None]
    return out


def _check(feat, rois, gate, c_base, c_take):
    if feat.dim() != 4:
        raise ValueError(f"feat must be [B, H, W, C], got {tuple(feat.shape)}")
    b, _, _, c = feat.shape
    if rois.shape != (b, rois.shape[1], 4):
        raise ValueError(f"rois must be [B, N, 4], got {tuple(rois.shape)}")
    if gate.shape != rois.shape[:2]:
        raise ValueError(f"gate must be [B, N], got {tuple(gate.shape)}")
    if not (0 <= c_base and c_take > 0 and c_base + c_take <= c):
        raise ValueError(f"channel chunk [{c_base}, {c_base + c_take}) outside C={c}")
    if not (rois.device == gate.device == feat.device):
        raise ValueError("feat, rois and gate must be on one device")


def roi_pool_gated(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
) -> torch.Tensor:
    """Gated pool of channels ``[c_base, c_base + c_take)``: ``feat [B, H, W,
    C]`` (NHWC, contiguous), ``rois [B, N, 4]`` XYXY image coordinates,
    ``gate [B, N]`` -> ``[B, N, P, P, c_take]``. The output keeps (ph, pw, c)
    innermost so fc1 reads a chunk as ``[B*N, P*P*c_take]`` with no copy."""
    global LAUNCHES
    _check(feat, rois, gate, c_base, c_take)
    if feat.device.type == "cpu":
        return roi_pool_gated_plain(feat, rois, gate, c_base, c_take, output_size, spatial_scale)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_pool_gated runs on CPU or CUDA tensors, not {feat.device}")
    if feat.dtype not in _ENTRY:
        raise TypeError(f"roi_pool_gated kernel takes bfloat16 or float32, not {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be a contiguous, 16-byte aligned NHWC tensor")
    b, h, w, c = feat.shape
    if c % 2 or c_base % 2 or c_take % 2:
        raise ValueError("C, c_base and c_take must be even (two channels per thread)")
    n = rois.shape[1]
    region = round_region(rois, spatial_scale).contiguous()
    g = gate.to(feat.dtype).contiguous()
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=feat.dtype, device=feat.device)
    neg_floor = float(torch.tensor(NEG_INF, dtype=feat.dtype))
    fn = _kernel(feat.dtype)
    # region and g are freed when this returns, while the kernel may still
    # run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), region.data_ptr(), g.data_ptr(), out.data_ptr(),
                b, h, w, c, n, int(c_base), int(c_take), int(output_size), neg_floor, stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool_gated kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
