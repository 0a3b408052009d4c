"""Gated exact max RoIPool and gated, branch-routed ROILoopPool: the CUDA
kernels' wrappers and their plain PyTorch versions (counterparts:
``wsovod_tpu/ops/roi_pool.py::roi_pool`` and ``::roi_loop_pool`` for the
semantics, ``wsovod_tpu/ops/pallas/roi_pool_fused.py::roi_pool_fused_batched``
with ``loop_pool=False``, and with ``loop_pool=True`` and ``src_tbl``, for the
TPU kernels they replace).

``roi_pool_gated(feat, rois, gate, c_base, c_take, output_size,
spatial_scale, src)`` returns, for every image ``b`` and ROI ``n``,
``roi_pool(feat[src[b, n]], rois[b], P, scale)[n, ..., c_base:c_base+c_take]
* gate[b, n]`` as ``[B, N, P, P, c_take]`` in ``feat``'s dtype, with the
gate rounded to that dtype first (as the reference's ``pooled *
gate.astype(pooled.dtype)``), so the kernel and the plain version agree bit
for bit in bfloat16 and float32. Without ``src`` ROI ``n`` of image ``b``
reads ``feat[b]``; with it, MRRP's plain ROIPool reads its branch's copy
``branch * B + b`` of the branch-major concat (the counterpart of
``roi_pool_fused_batched`` with ``loop_pool=False`` and ``src_tbl``,
reached from ``roi_pool_fused_branched_ad``, ``roi_pool_fused.py:2198``).

``roi_loop_pool_gated(feat, rois, gate, src, c_base, c_take, rows,
output_size, spatial_scale, context_ratio)`` returns, for every image ``b``
and ROI ``n``, ``roi_loop_pool(feat[src[b, n]], rois[b], P, scale,
ratio)[r, n, ..., c_base:c_base+c_take] * gate[b, n]`` for ``r < rows`` as
``[rows, B, N, P, P, c_take]``: row 0 the ROI, row 1 the frame, row 2 the
context, each a max that starts at 0. ``src`` picks the feature copy each ROI
reads (MRRP: ``branch * B + b`` of the branch-major concat), so the ROIs
need no sorting by branch. The same rounding of the gate holds.

``RoIPoolGatedFunction`` makes ``roi_pool_gated`` differentiable (the
counterpart of ``roi_pool_fused_ad``, ``roi_pool_fused.py:2109``, and with
``src`` of ``roi_pool_fused_branched_ad`` with ``loop_pool=False``): its
backward is ``roi_pool_gated_bwd``, a third kernel, whose feature cotangent
``[S, H, W, c]`` splits each bin's cotangent equally among the pixels of
the ROI's copy that tie its max, as ``jnp.max``'s VJP does at both stages of
the reference's separable max, and whose gate cotangent is ``sum(g * out) /
gate`` where ``|gate| > 1e-8``.

``RoILoopPoolGatedFunction`` does the same for ``roi_loop_pool_gated`` (the
counterpart of ``roi_pool_fused_branched_ad``, ``:2198``, and of
``roi_pool_fused_ad`` with ``loop_pool=True``): its backward is
``roi_loop_pool_gated_bwd``, a fourth kernel, with JAX's tie rules for the
ROI row's ``maximum(M, 0)`` and the frame's and context's ``maximum(m1,
m2)``, both of which halve a cotangent at a tie, and the gate cotangent
summed over the rows too.

``roi_pool_levels`` and ``roi_loop_pool_levels`` are the level-routed
modes of the two forward kernels (kernel 2.5: the counterparts of
``wsovod_tpu/ops/pallas/roi_pool_kernel.py``'s ``roi_pool_pallas`` and
``roi_loop_pool_pallas``, which the JAX package's multi-level pooler runs
on every FPN level for every ROI before it keeps each ROI's level): each
ROI carries its level index and is pooled on that level only, from a table
of the levels' maps; gated as the unfused ROI heads gate the pooled
tensor (the gate rounded to the features' dtype, one multiply). They have
no backward: the JAX package gives its per-image pools no VJP.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES``, ``LOOP_LAUNCHES``, ``BWD_LAUNCHES`` and
``LOOP_BWD_LAUNCHES`` count the four kernels' launches; the emission modes
and the level-routed modes (``LEVEL_LAUNCHES``, ``LOOP_LEVEL_LAUNCHES``)
have counts of their own.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # the reference's fill value for masked-out pixels

LAUNCHES = 0
LOOP_LAUNCHES = 0
BWD_LAUNCHES = 0
LOOP_BWD_LAUNCHES = 0
MAXABS_LAUNCHES = 0
INT8_LAUNCHES = 0
TILE8_LAUNCHES = 0
LOOP_MAXABS_LAUNCHES = 0
LEVEL_LAUNCHES = 0
LOOP_LEVEL_LAUNCHES = 0
LOOP_INT8_LAUNCHES = 0

_DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _kernel(source: str, entry: str, dtype: torch.dtype, argtypes):
    """The C entry point ``<entry>_<dtype>`` of ``csrc/<source>``, with its
    ctypes signature (builds and loads the library at first use)."""
    from ..kernels import load

    fn = getattr(load(source), f"{entry}_{_DTYPE_SUFFIX[dtype]}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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


def _roi_groups(src: Optional[torch.Tensor], i: int, n: int, step: int):
    """``(copy, sel)`` for image ``i``'s ``n`` ROIs in groups of at most
    ``step``: without ``src`` copy ``i`` and slices of the ROIs in order;
    with ``src [B, N]`` each copy that image ``i``'s ROIs read and the
    indices of those ROIs."""
    if src is None:
        for lo in range(0, n, step):
            yield i, slice(lo, min(n, lo + step))
        return
    for s in torch.unique(src[i]).tolist():
        idx = torch.nonzero(src[i] == s).squeeze(1)
        for lo in range(0, idx.numel(), step):
            yield s, idx[lo : lo + step]


def roi_pool_gated_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    max_elems: int = 1 << 27,
    src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version: the reference's separable masked max (max
    over each bin's columns, then over its rows), in ROI chunks sized so the
    ``[n, P, H, W, c]`` masked temporary stays under ``max_elems``; ROI
    ``n`` of image ``b`` pools from ``feat[src[b, n]]`` (``feat[b]``
    without ``src``), as ``wsovod_tpu/models/poolers.py:808-840`` pools
    every copy and keeps each ROI's."""
    _, h_lim, w_lim, _ = feat.shape
    b, n = rois.shape[:2]
    p = output_size
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
        for s, sel in _roi_groups(src, i, n, step):
            row_in = (hidx >= hlo[i, sel, :, None]) & (hidx < hhi[i, sel, :, None])  # [n, P, H]
            col_in = (widx >= wlo[i, sel, :, None]) & (widx < whi[i, sel, :, None])  # [n, P, W]
            colmax = torch.where(col_in[:, :, None, :, None], f[s][None, None], neg).amax(dim=3)
            pooled = torch.where(row_in[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)
            pooled = torch.where(pooled <= neg, torch.zeros((), dtype=feat.dtype, device=feat.device), pooled)
            out[i, sel] = pooled * g[i, sel, None, None, None]
    return out


def _check_src(feat, src, b, n):
    """``src [B, N]``, integer, on ``feat``'s device; on the CPU its range
    ``[0, S)`` is checked here (on the card by ``_src32``)."""
    if src.shape != (b, n):
        raise ValueError(f"src must be [B, N] = {(b, n)}, got {tuple(src.shape)}")
    if src.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"src must be an integer tensor, not {src.dtype}")
    if src.device != feat.device:
        raise ValueError("feat and src must be on one device")
    if feat.device.type == "cpu" and src.numel() and not (
            0 <= int(src.min()) and int(src.max()) < feat.shape[0]):
        raise ValueError(f"src must lie in [0, {feat.shape[0]})")


def _check(feat, rois, gate, c_base, c_take, src=None):
    if feat.dim() != 4:
        raise ValueError(f"feat must be [S, H, W, C], got {tuple(feat.shape)}")
    b, n = rois.shape[:2]
    c = feat.shape[3]
    if rois.shape != (b, n, 4) or (src is None and b != feat.shape[0]):
        raise ValueError(f"rois must be [B, N, 4] with B = {feat.shape[0]} feature copies "
                         f"unless src is given, got {tuple(rois.shape)}")
    if gate.shape != (b, n):
        raise ValueError(f"gate must be [B, N], got {tuple(gate.shape)}")
    if not (0 <= c_base and c_take > 0 and c_base + c_take <= c):
        raise ValueError(f"channel chunk [{c_base}, {c_base + c_take}) outside C={c}")
    if not (rois.device == gate.device == feat.device):
        raise ValueError("feat, rois and gate must be on one device")
    if src is not None:
        _check_src(feat, src, b, n)


def roi_pool_gated(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gated pool of channels ``[c_base, c_base + c_take)``: ``feat [S, H,
    W, C]`` (NHWC, contiguous), ``rois [B, N, 4]`` XYXY image coordinates,
    ``gate [B, N]`` -> ``[B, N, P, P, c_take]``. ROI ``n`` of image ``b``
    reads copy ``src[b, n]`` (integer ``[B, N]`` in ``[0, S)``; MRRP:
    ``branch * B + b`` of the branch-major concat), or copy ``b`` without
    ``src`` (then S = B). The output keeps (ph, pw, c) innermost so fc1
    reads a chunk as ``[B*N, P*P*c_take]`` with no copy. On the card
    ``src``'s range is checked by a device-side assert."""
    global LAUNCHES
    _check(feat, rois, gate, c_base, c_take, src)
    if feat.device.type == "cpu":
        return roi_pool_gated_plain(feat, rois, gate, c_base, c_take, output_size, spatial_scale,
                                    src=src)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_pool_gated runs on CPU or CUDA tensors, not {feat.device}")
    if feat.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"roi_pool_gated kernel takes bfloat16 or float32, not {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be a contiguous, 16-byte aligned NHWC tensor")
    s_copies, h, w, c = feat.shape
    if c % 2 or c_base % 2 or c_take % 2:
        raise ValueError("C, c_base and c_take must be even (two channels per thread)")
    b, n = rois.shape[:2]
    region = round_region(rois, spatial_scale).contiguous()
    src32 = None if src is None else _src32(src, s_copies)
    g = gate.to(feat.dtype).contiguous()
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=feat.dtype, device=feat.device)
    neg_floor = float(torch.tensor(NEG_INF, dtype=feat.dtype))
    fn = _kernel("roi_pool_gated.cu", "wsovod_roi_pool_gated", feat.dtype,
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    # region, src32 and g are freed when this returns, while the kernel may
    # still run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), region.data_ptr(), _ptr(src32), g.data_ptr(), out.data_ptr(),
                b, h, w, c, n, int(c_base), int(c_take), int(output_size), neg_floor, stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool_gated kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def roi_pool_gated_bwd_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    out: Optional[torch.Tensor],
    g: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    need_feat: bool = True,
    need_gate: bool = True,
    max_elems: int = 1 << 27,
    src: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain PyTorch version of ``_pool_ad_bwd`` and, with ``src``, of
    ``_pool_branched_bwd`` with ``loop_pool=False``
    (``wsovod_tpu/ops/pallas/roi_pool_fused.py:2146,2240``): ``(g_feat [S,
    H, W, C] in feat's dtype, zero outside the chunk and on copies no ROI
    reads, g_gate [B, N] in gate's dtype)``, each ``None`` where not wanted.

    ``g_gate`` follows the reference's formula: ``sum(g * out)`` over the
    ROI's bins and channels in float32, divided by the gate where ``|gate|
    > 1e-8``, else 0. ``g_feat`` is autograd through the plain forward's
    separable masked max (``amax`` splits a cotangent equally among tied
    entries, as ``jnp.max``'s VJP) on each ROI's copy in float32, times the
    gate rounded to feat's dtype as the forward used it, summed in float32
    over ROI chunks sized by ``max_elems`` and rounded once to feat's
    dtype."""
    g_gate = _gate_cotangent(g, out, gate, (2, 3, 4)) if need_gate else None
    if not need_feat:
        return None, g_gate
    _, h_lim, w_lim, _ = feat.shape
    b, n = rois.shape[:2]
    p = output_size
    reg = round_region(rois, spatial_scale)
    hlo, hhi = _bin_edges(reg[..., 1], reg[..., 3], p, h_lim)
    wlo, whi = _bin_edges(reg[..., 0], reg[..., 2], p, w_lim)
    hidx = torch.arange(h_lim, device=feat.device)
    widx = torch.arange(w_lim, device=feat.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=feat.device)
    gd = gate.to(feat.dtype).float()
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    acc = torch.zeros(feat.shape[:3] + (c_take,), dtype=torch.float32, device=feat.device)
    fs, last = None, None
    for i in range(b):
        for s, sel in _roi_groups(src, i, n, step):
            if s != last:
                fs, last = feat[s, ..., c_base : c_base + c_take].float(), s
            row_in = (hidx >= hlo[i, sel, :, None]) & (hidx < hhi[i, sel, :, None])
            col_in = (widx >= wlo[i, sel, :, None]) & (widx < whi[i, sel, :, None])
            leaf = fs.detach().requires_grad_(True)
            with torch.enable_grad():
                pooled = _masked_max(leaf, row_in, col_in, neg)
                pooled = torch.where(pooled <= neg, torch.zeros_like(pooled), pooled)
                (grad,) = torch.autograd.grad(pooled * gd[i, sel, None, None, None], leaf,
                                              g[i, sel].float())
            acc[s] += grad
    g_feat = torch.zeros_like(feat)
    g_feat[..., c_base : c_base + c_take] = acc.to(feat.dtype)
    return g_feat, g_gate


def roi_pool_gated_bwd(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    out: Optional[torch.Tensor],
    g: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    need_feat: bool = True,
    need_gate: bool = True,
    src: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of ``roi_pool_gated`` at cotangent ``g [B, N, P, P,
    c_take]``: ``(g_feat [S, H, W, C], g_gate [B, N])`` as
    ``roi_pool_gated_bwd_plain``; ``out`` (the forward's output) is read
    only for ``g_gate``. On the card the feature cotangent is summed with
    float32 atomics over every copy, so it equals the plain version to float
    tolerance, not bit for bit."""
    global BWD_LAUNCHES
    _check(feat, rois, gate, c_base, c_take, src)
    b, n = rois.shape[:2]
    shape = (b, n, output_size, output_size, c_take)
    if tuple(g.shape) != shape or (need_gate and (out is None or tuple(out.shape) != shape)):
        raise ValueError(f"g (and out for the gate cotangent) must be {shape}, got "
                         f"{tuple(g.shape)}, {None if out is None else tuple(out.shape)}")
    if feat.device.type == "cpu":
        return roi_pool_gated_bwd_plain(feat, rois, gate, out, g, c_base, c_take, output_size,
                                        spatial_scale, need_feat, need_gate, src=src)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_pool_gated_bwd runs on CPU or CUDA tensors, not {feat.device}")
    if feat.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"roi_pool_gated_bwd kernel takes bfloat16 or float32, not {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be a contiguous, 16-byte aligned NHWC tensor")
    s_copies, h, w, c = feat.shape
    if c % 2 or c_base % 2 or c_take % 2:
        raise ValueError("C, c_base and c_take must be even (two channels per thread)")
    region = round_region(rois, spatial_scale).contiguous()
    src32 = None if src is None else _src32(src, s_copies)
    gate_dt = gate.to(feat.dtype).contiguous()
    gate_f32 = gate.float().contiguous()
    g = g.to(feat.dtype).contiguous()
    out = out.to(feat.dtype).contiguous() if need_gate else None
    scratch = (torch.zeros((s_copies, h, w, c_take), dtype=torch.float32, device=feat.device)
               if need_feat else None)
    g_gate = torch.empty((b, n), dtype=torch.float32, device=feat.device) if need_gate else None
    neg_floor = float(torch.tensor(NEG_INF, dtype=feat.dtype))
    fn = _kernel("roi_pool_gated_bwd.cu", "wsovod_roi_pool_gated_bwd", feat.dtype,
                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    # the temporaries are freed when this returns, while the kernel may still
    # run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), region.data_ptr(), _ptr(src32), gate_dt.data_ptr(),
                gate_f32.data_ptr(), g.data_ptr(), _ptr(out), _ptr(scratch), _ptr(g_gate), b, h, w,
                c, n, int(c_base), int(c_take), int(output_size), neg_floor, stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool_gated_bwd kernel launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    g_feat = None
    if need_feat:
        g_feat = torch.zeros_like(feat)
        g_feat[..., c_base : c_base + c_take] = scratch.to(feat.dtype)
    return g_feat, (g_gate.to(gate.dtype) if need_gate else None)


class RoIPoolGatedFunction(torch.autograd.Function):
    """``roi_pool_gated`` under autograd (``roi_pool_fused_ad``, and with
    ``src`` ``roi_pool_fused_branched_ad`` with ``loop_pool=False``): the
    forward launches the pool kernel, the backward ``roi_pool_gated_bwd``.
    It saves nothing when neither ``feat`` nor ``gate`` needs a gradient (a
    frozen backbone and a validity gate, every shipped config), and the
    forward's output only when the gate needs one."""

    @staticmethod
    def forward(ctx, feat, rois, gate, c_base, c_take, output_size, spatial_scale, src=None):
        out = roi_pool_gated(feat, rois, gate, c_base, c_take, output_size, spatial_scale, src)
        need_feat, need_gate = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        if need_feat or need_gate:
            ctx.save_for_backward(feat, rois, gate, src, out if need_gate else None)
            ctx.args = (c_base, c_take, output_size, spatial_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, rois, gate, src, out = ctx.saved_tensors
        g_feat, g_gate = roi_pool_gated_bwd(feat, rois, gate, out, g, *ctx.args,
                                            need_feat=ctx.needs_input_grad[0],
                                            need_gate=ctx.needs_input_grad[2], src=src)
        return g_feat, None, g_gate, None, None, None, None, None


def _masked_max(f: torch.Tensor, row_in: torch.Tensor, col_in: torch.Tensor,
                neg: torch.Tensor) -> torch.Tensor:
    """max of ``f [H, W, c]`` over ``{(h, w): row_in & col_in}`` per (ROI,
    bin): ``row_in [n, P, H]``, ``col_in [n, P, W]`` -> ``[n, P, P, c]``
    (``neg`` where the set is empty); the reference's separable max."""
    colmax = torch.where(col_in[:, :, None, :, None], f[None, None], neg).amax(dim=3)
    return torch.where(row_in[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)


def loop_geometry(rois: torch.Tensor, spatial_scale, h_lim, w_lim,
                  context_ratio: float) -> torch.Tensor:
    """The ROILoopPool's integer geometry per ROI, int32 ``[..., 16]``:

    * ``[0:4]`` the ROI's rounded region ``(x1, y1, w, h)`` (``round_region``);
    * ``[4:8]`` the same of the outer box (the ROI grown by
      ``context_ratio``, clipped to the image);
    * ``[8:12]`` the frame's hole ``floor(x * scale + 0.5)`` of the inner box
      (the ROI shrunk by ``context_ratio``, clipped), ``(x1, y1, x2, y2)``;
    * ``[12:16]`` the context's hole, the same of the unclipped ROI.

    A hole removes the pixels ``x1 < w < x2 and y1 < h < y2`` from its row's
    bins. Float32 throughout, one rounding per op, as
    ``wsovod_tpu/ops/roi_pool.py::roi_loop_pool``; the division by the ratio
    divides by a tensor, so that CPU and CUDA round it alike (a division by a
    Python number may become a multiplication by its reciprocal on CUDA).

    ``spatial_scale``, ``h_lim`` and ``w_lim`` may also be float32 tensors
    ``[...]`` of each ROI's own (its FPN level's): ``w_lim / scale`` is an
    integer times a power of two either way, so exact."""
    r = rois.float()
    x1, y1, x2, y2 = r.unbind(-1)
    rw, rh = x2 - x1, y2 - y1
    ratio = torch.full_like(rw, context_ratio)
    in_dw, in_dh = (rw - rw / ratio) / 2, (rh - rh / ratio) / 2
    out_dw, out_dh = (rw * ratio - rw) / 2, (rh * ratio - rh) / 2
    img_w, img_h = w_lim / spatial_scale, h_lim / spatial_scale

    def clip(v, lim):  # jnp.clip(v, 0, lim)
        return torch.minimum(v.clamp(min=0.0), lim) if torch.is_tensor(lim) else v.clamp(0.0, lim)

    def clipped(bx1, by1, bx2, by2):
        return torch.stack([clip(bx1, img_w), clip(by1, img_h), clip(bx2, img_w),
                            clip(by2, img_h)], dim=-1)

    inner = clipped(x1 + in_dw, y1 + in_dh, x2 - in_dw, y2 - in_dh)
    outer = clipped(x1 - out_dw, y1 - out_dh, x2 + out_dw, y2 + out_dh)
    scale = spatial_scale[..., None] if torch.is_tensor(spatial_scale) else spatial_scale

    def ints(box):
        return torch.floor(box * scale + 0.5).to(torch.int32)

    return torch.cat([round_region(r, scale), round_region(outer, scale), ints(inner), ints(r)],
                     dim=-1)


def _loop_rows(fs: torch.Tensor, m: torch.Tensor, rows: int, p: int) -> list:
    """The first ``rows`` ROILoopPool rows of ``fs [H, W, c]`` for ROIs of
    geometry ``m [k, 16]`` (``loop_geometry``), ungated, each ``[k, P, P,
    c]``, in the reference's form (``wsovod_tpu/ops/roi_pool.py:115-209``):
    the ROI ``maximum(where(M <= NEG_INF, 0, M), 0)``, the frame and the
    context ``maximum(maximum(m1, m2), 0)``, ``m1`` and ``m2`` the separable
    maxes with the hole's columns and its rows taken out. Differentiable:
    ``amax`` splits a cotangent equally among ties and ``torch.maximum``
    halves it at a tie, as ``jnp.max`` and ``jnp.maximum`` do."""
    h_lim, w_lim = fs.shape[0], fs.shape[1]
    hidx = torch.arange(h_lim, device=fs.device)
    widx = torch.arange(w_lim, device=fs.device)
    neg = torch.tensor(NEG_INF, dtype=fs.dtype, device=fs.device)
    zero = torch.zeros((), dtype=fs.dtype, device=fs.device)

    def bins(region):  # (x1, y1, w, h) [k, 4] -> row_in [k, P, H], col_in [k, P, W]
        hlo, hhi = _bin_edges(region[:, 1], region[:, 3], p, h_lim)
        wlo, whi = _bin_edges(region[:, 0], region[:, 2], p, w_lim)
        return ((hidx >= hlo[..., None]) & (hidx < hhi[..., None]),
                (widx >= wlo[..., None]) & (widx < whi[..., None]))

    def hollow(row_in, col_in, hole):  # bin pixels outside the hole's strict interior
        col_ok = (widx <= hole[:, 0, None]) | (widx >= hole[:, 2, None])  # [k, W]
        row_ok = (hidx <= hole[:, 1, None]) | (hidx >= hole[:, 3, None])  # [k, H]
        m1 = _masked_max(fs, row_in, col_in & col_ok[:, None], neg)
        m2 = _masked_max(fs, row_in & row_ok[:, None], col_in, neg)
        return torch.maximum(torch.maximum(m1, m2), zero)

    row_roi, col_roi = bins(m[:, 0:4])
    pr = _masked_max(fs, row_roi, col_roi, neg)
    pooled = [torch.maximum(torch.where(pr <= neg, zero, pr), zero)]
    if rows > 1:
        pooled.append(hollow(row_roi, col_roi, m[:, 8:12]))
    if rows > 2:
        pooled.append(hollow(*bins(m[:, 4:8]), m[:, 12:16]))
    return pooled


def roi_loop_pool_gated_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    src: torch.Tensor,
    c_base: int,
    c_take: int,
    rows: int = 3,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    context_ratio: float = 1.8,
    max_elems: int = 1 << 27,
) -> torch.Tensor:
    """The plain PyTorch version: per image and feature copy, the
    reference's separable masked maxes (``_loop_rows``), in ROI chunks sized
    so the ``[n, P, H, W, c]`` temporary stays under ``max_elems``. Only the
    requested rows are computed."""
    _, h_lim, w_lim, _ = feat.shape
    b, n = rois.shape[:2]
    p = output_size
    f = feat[..., c_base : c_base + c_take]
    geo = loop_geometry(rois, spatial_scale, h_lim, w_lim, context_ratio)
    g = gate.to(feat.dtype)
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    out = torch.empty((rows, b, n, p, p, c_take), dtype=feat.dtype, device=feat.device)
    for i in range(b):
        for s, sel in _roi_groups(src, i, n, step):
            pooled = _loop_rows(f[s], geo[i, sel], rows, p)
            gi = g[i, sel, None, None, None]
            for r, pr in enumerate(pooled):
                out[r, i, sel] = pr * gi
    return out


def _check_loop(feat, rois, gate, src, c_base, c_take, rows):
    if feat.dim() != 4:
        raise ValueError(f"feat must be [S, H, W, C], got {tuple(feat.shape)}")
    b, n = rois.shape[:2]
    if rois.shape != (b, n, 4) or gate.shape != (b, n):
        raise ValueError(f"rois [B, N, 4] and gate [B, N]: got {tuple(rois.shape)}, "
                         f"{tuple(gate.shape)}")
    if not (0 <= c_base and c_take > 0 and c_base + c_take <= feat.shape[3]):
        raise ValueError(f"channel chunk [{c_base}, {c_base + c_take}) outside C={feat.shape[3]}")
    if rows not in (1, 2, 3):
        raise ValueError(f"rows must be 1, 2 or 3, not {rows}")
    if not (rois.device == gate.device == feat.device):
        raise ValueError("feat, rois and gate must be on one device")
    _check_src(feat, src, b, n)
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the loop pool runs on CPU or CUDA tensors, not {feat.device}")


def _check_kernel_args(feat, c_base, c_take, what):
    if feat.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"{what} kernel takes bfloat16 or float32, not {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be a contiguous, 16-byte aligned NHWC tensor")
    if feat.shape[3] % 2 or c_base % 2 or c_take % 2:
        raise ValueError("C, c_base and c_take must be even (two channels per thread)")


def _src32(src: torch.Tensor, copies: int) -> torch.Tensor:
    """``src`` as contiguous int32, its range checked on the card by a
    device-side assert, which needs no synchronisation."""
    src32 = src.to(torch.int32).contiguous()
    torch._assert_async(((src32 >= 0) & (src32 < copies)).all())
    return src32


def roi_loop_pool_gated(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    src: torch.Tensor,
    c_base: int,
    c_take: int,
    rows: int = 3,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    context_ratio: float = 1.8,
) -> torch.Tensor:
    """Gated ROILoopPool of channels ``[c_base, c_base + c_take)``: ``feat
    [S, H, W, C]`` (NHWC, contiguous; S feature copies), ``rois [B, N, 4]``
    XYXY image coordinates, ``gate [B, N]``, ``src [B, N]`` integer copy
    index in ``[0, S)`` -> ``[rows, B, N, P, P, c_take]``; row 0 is a ``[B*N,
    P*P*c_take]`` fc1 operand with no copy. On the card ``src``'s range is
    checked by a device-side assert, which needs no synchronisation."""
    global LOOP_LAUNCHES
    _check_loop(feat, rois, gate, src, c_base, c_take, rows)
    if feat.device.type == "cpu":
        return roi_loop_pool_gated_plain(feat, rois, gate, src, c_base, c_take, rows,
                                         output_size, spatial_scale, context_ratio)
    _check_kernel_args(feat, c_base, c_take, "roi_loop_pool_gated")
    b, n = rois.shape[:2]
    _, h, w, c = feat.shape
    geo = loop_geometry(rois, spatial_scale, h, w, context_ratio).contiguous()
    src32 = _src32(src, feat.shape[0])
    g = gate.to(feat.dtype).contiguous()
    out = torch.empty((rows, b, n, output_size, output_size, c_take), dtype=feat.dtype,
                      device=feat.device)
    fn = _kernel("roi_loop_pool_gated.cu", "wsovod_roi_loop_pool_gated", feat.dtype,
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    # geo, src32 and g are freed when this returns, while the kernel may
    # still run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), geo.data_ptr(), src32.data_ptr(), g.data_ptr(), out.data_ptr(),
                b, h, w, c, n, int(c_base), int(c_take), int(output_size), int(rows), stream)
    if rc != 0:
        raise RuntimeError(f"roi_loop_pool_gated kernel launch failed: cudaError {rc}")
    LOOP_LAUNCHES += 1
    return out


def _gate_cotangent(g: torch.Tensor, out: torch.Tensor, gate: torch.Tensor,
                    dims: Tuple[int, ...]) -> torch.Tensor:
    """``sum(g * out) / gate`` over ``dims`` in float32 where ``|gate| >
    1e-8``, else 0, in gate's dtype (the reference's gate VJP)."""
    s = (g.float() * out.float()).sum(dim=dims)
    big = gate.abs() > 1e-8
    return torch.where(big, s / torch.where(big, gate, torch.ones_like(gate)),
                       torch.zeros_like(s)).to(gate.dtype)


def roi_loop_pool_gated_bwd_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    src: torch.Tensor,
    out: Optional[torch.Tensor],
    g: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    context_ratio: float = 1.8,
    need_feat: bool = True,
    need_gate: bool = True,
    max_elems: int = 1 << 27,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain PyTorch version of the ROILoopPool's backward, the
    ``loop_pool=True`` branch of ``_pool_branched_bwd`` and ``_pool_ad_bwd``
    (``wsovod_tpu/ops/pallas/roi_pool_fused.py:2240,2146``), at cotangent
    ``g [rows, B, N, P, P, c_take]``: ``(g_feat [S, H, W, C] in feat's
    dtype, zero outside the chunk and on copies no ROI reads, g_gate [B, N]
    in gate's dtype)``, each ``None`` where not wanted.

    ``g_gate`` sums ``g * out`` over the rows, bins and channels (``out``
    is the forward's output). ``g_feat`` is autograd through ``_loop_rows``
    in float32, times the gate rounded to feat's dtype as the forward used
    it, per image and feature copy in ROI chunks sized by ``max_elems``,
    summed in float32 and rounded once to feat's dtype."""
    rows = g.shape[0]
    g_gate = _gate_cotangent(g, out, gate, (0, 3, 4, 5)) if need_gate else None
    if not need_feat:
        return None, g_gate
    _, h_lim, w_lim, _ = feat.shape
    b, n = rois.shape[:2]
    p = output_size
    geo = loop_geometry(rois, spatial_scale, h_lim, w_lim, context_ratio)
    gd = gate.to(feat.dtype).float()
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    acc = torch.zeros(feat.shape[:3] + (c_take,), dtype=torch.float32, device=feat.device)
    fs, last = None, None
    for i in range(b):
        for s, sel in _roi_groups(src, i, n, step):
            if s != last:
                fs, last = feat[s, ..., c_base : c_base + c_take].float(), s
            leaf = fs.detach().requires_grad_(True)
            with torch.enable_grad():
                pooled = torch.stack(_loop_rows(leaf, geo[i, sel], rows, p))
                (grad,) = torch.autograd.grad(pooled * gd[i, sel, None, None, None], leaf,
                                              g[:, i, sel].float())
            acc[s] += grad
    g_feat = torch.zeros_like(feat)
    g_feat[..., c_base : c_base + c_take] = acc.to(feat.dtype)
    return g_feat, g_gate


def loop_bwd_order(geo: torch.Tensor, gate: torch.Tensor, src: torch.Tensor, h_lim: int,
                   w_lim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The order in which ``roi_loop_pool_gated_bwd``'s kernel walks the
    ROIs: ``(order, n_live)``, ``order`` int32 ``[B * N]`` a permutation of
    the flat ROI indices ``b * N + n`` that lists first, once each, the
    ``n_live`` (int32 ``[1]``) ROIs of nonzero ``gate [B, N]`` (in the
    feature dtype, as the forward used it), by feature copy ``src [B, N]``
    and then by the top-left ``(y1, x1)`` of the ROI's region (``geo``'s
    ``[0:4]``, clipped to the map), row-major, ties in index order; the ROIs
    of gate 0 follow and get no work. Blocks that run together then read
    and scatter into one copy's neighbourhood of the L2."""
    live = (gate != 0).flatten()
    y1 = geo[..., 1].clamp(0, h_lim - 1).flatten().long()
    x1 = geo[..., 0].clamp(0, w_lim - 1).flatten().long()
    key = (src.flatten().long() * h_lim + y1) * w_lim + x1
    key = torch.where(live, key, torch.full_like(key, torch.iinfo(torch.int64).max))
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    return order, live.sum(dtype=torch.int32).reshape(1)


def roi_loop_pool_gated_bwd(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    src: torch.Tensor,
    out: Optional[torch.Tensor],
    g: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    context_ratio: float = 1.8,
    need_feat: bool = True,
    need_gate: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of ``roi_loop_pool_gated`` at cotangent ``g [rows, B, N, P,
    P, c_take]``: ``(g_feat, g_gate)`` as ``roi_loop_pool_gated_bwd_plain``;
    ``out`` (the forward's output) is read only for ``g_gate``. On the card
    the feature cotangent is summed with float32 atomics, so it equals the
    plain version to float tolerance, not bit for bit; its kernel walks the
    ROIs in ``loop_bwd_order``."""
    global LOOP_BWD_LAUNCHES
    if g.dim() != 6:
        raise ValueError(f"g must be [rows, B, N, P, P, c_take], got {tuple(g.shape)}")
    rows = g.shape[0]
    _check_loop(feat, rois, gate, src, c_base, c_take, rows)
    b, n = rois.shape[:2]
    shape = (rows, b, n, output_size, output_size, c_take)
    if tuple(g.shape) != shape or (need_gate and (out is None or tuple(out.shape) != shape)):
        raise ValueError(f"g (and out for the gate cotangent) must be {shape}, got "
                         f"{tuple(g.shape)}, {None if out is None else tuple(out.shape)}")
    if feat.device.type == "cpu":
        return roi_loop_pool_gated_bwd_plain(feat, rois, gate, src, out, g, c_base, c_take,
                                             output_size, spatial_scale, context_ratio, need_feat,
                                             need_gate)
    _check_kernel_args(feat, c_base, c_take, "roi_loop_pool_gated_bwd")
    s_copies, h, w, c = feat.shape
    geo = loop_geometry(rois, spatial_scale, h, w, context_ratio).contiguous()
    src32 = _src32(src, s_copies)
    gate_dt = gate.to(feat.dtype).contiguous()
    gate_f32 = gate.float().contiguous()
    g = g.to(feat.dtype).contiguous()
    out = out.to(feat.dtype).contiguous() if need_gate else None
    scratch, order, n_live = None, None, None
    if need_feat:
        scratch = torch.zeros((s_copies, h, w, c_take), dtype=torch.float32, device=feat.device)
        order, n_live = loop_bwd_order(geo, gate_dt, src32, h, w)
    g_gate = torch.empty((b, n), dtype=torch.float32, device=feat.device) if need_gate else None
    neg_floor = float(torch.tensor(NEG_INF, dtype=feat.dtype))
    fn = _kernel("roi_loop_pool_gated_bwd.cu", "wsovod_roi_loop_pool_gated_bwd", feat.dtype,
                 [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    # the temporaries are freed when this returns, while the kernel may still
    # run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), geo.data_ptr(), src32.data_ptr(), _ptr(order), _ptr(n_live),
                gate_dt.data_ptr(), gate_f32.data_ptr(), g.data_ptr(), _ptr(out), _ptr(scratch),
                _ptr(g_gate), b, h, w, c, n, int(c_base), int(c_take), int(output_size),
                int(rows), neg_floor, stream)
    if rc != 0:
        raise RuntimeError(f"roi_loop_pool_gated_bwd kernel launch failed: cudaError {rc}")
    LOOP_BWD_LAUNCHES += 1
    g_feat = None
    if need_feat:
        g_feat = torch.zeros_like(feat)
        g_feat[..., c_base : c_base + c_take] = scratch.to(feat.dtype)
    return g_feat, (g_gate.to(gate.dtype) if need_gate else None)


class RoILoopPoolGatedFunction(torch.autograd.Function):
    """``roi_loop_pool_gated`` under autograd (``roi_pool_fused_branched_ad``
    and ``roi_pool_fused_ad`` with ``loop_pool=True``): the forward launches
    the loop kernel, the backward ``roi_loop_pool_gated_bwd``. It saves
    nothing when neither ``feat`` nor ``gate`` needs a gradient (a frozen
    backbone and a validity gate, every shipped config), and the forward's
    output only when the gate needs one."""

    @staticmethod
    def forward(ctx, feat, rois, gate, src, c_base, c_take, rows, output_size, spatial_scale,
                context_ratio):
        out = roi_loop_pool_gated(feat, rois, gate, src, c_base, c_take, rows, output_size,
                                  spatial_scale, context_ratio)
        need_feat, need_gate = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        if need_feat or need_gate:
            ctx.save_for_backward(feat, rois, gate, src, out if need_gate else None)
            ctx.args = (c_base, c_take, output_size, spatial_scale, context_ratio)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, rois, gate, src, out = ctx.saved_tensors
        g_feat, g_gate = roi_loop_pool_gated_bwd(feat, rois, gate, src, out, g, *ctx.args,
                                                 need_feat=ctx.needs_input_grad[0],
                                                 need_gate=ctx.needs_input_grad[2])
        return g_feat, None, g_gate, None, None, None, None, None, None, None


# ---------------------------------------------------------------- emissions
# The pools' other emission modes (roi_pool_fused_batched's quant="maxabs",
# "int8" and "tile8"; kernels/csrc/roi_pool_common.cuh): what the int8 fc1
# reads. The pooler runs only maxabs (at inference with
# TPU.DAN_FC1_QUANT = "int8"); int8 and tile8 are reached by no pooler path,
# in the JAX package only through an environment toggle or its tests.

INV127 = 1.0 / 127.0  # applied as a float32 multiply, as XLA compiles `/ 127.0`


def quant_scale(gate: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The scale an int8 emission writes: ``(gate * m) * (1 / 127)`` in
    float32 (``gate`` broadcast against the tile maxima ``m``)."""
    inv127 = torch.tensor(INV127, dtype=torch.float32, device=m.device)
    return gate.float() * m * inv127


def quantize_tiles(v: torch.Tensor, c_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 emission of pre-gate values ``v [..., P, P, c]``: per
    ``c_tile`` channels ``m = max |v|`` over the tile's bins and channels,
    the payload ``round(v * (127 / m))`` (half to even; 0 where ``m <=
    1e-20``) as int8 ``[..., P, P, c]``, and ``m [..., c / c_tile]``
    float32. ``127 / m`` is a true division (torch's scalar ``/`` tensor is
    a reciprocal times the scalar)."""
    *lead, p, _, c = v.shape
    t = v.float().reshape(*lead, p, p, c // c_tile, c_tile)
    m = t.abs().amax(dim=(-4, -3, -1))
    inv = torch.where(m > 1e-20, torch.full_like(m, 127.0) / m, torch.zeros_like(m))
    q = torch.round(t * inv[..., None, None, :, None]).to(torch.int8)
    return q.reshape(v.shape), m


def quantize_per_image(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tile8's per-image quantization of a feature chunk ``f [B, H, W, c]``
    (``roi_pool_fused.py:1677-1691``): ``s = max(max |f| / 127, 1e-20)`` per
    image and ``clip(round(f / s), -127, 127)`` as int8; returns ``(q, s
    [B])``."""
    f32 = f.float()
    s = f32.abs().amax(dim=(1, 2, 3)) * torch.tensor(INV127, dtype=torch.float32,
                                                     device=f.device)
    s = s.clamp(min=1e-20)
    return torch.round(f32 / s[:, None, None, None]).clamp(-127, 127).to(torch.int8), s


def _check_c_tile(c_take: int, c_tile: int):
    if c_tile <= 0 or c_tile % 2 or c_take % c_tile:
        raise ValueError(f"c_tile {c_tile} must be even and divide c_take {c_take}")


def roi_pool_gated_maxabs_plain(feat, rois, gate, c_base, c_take, output_size=7,
                                spatial_scale=1.0, src=None):
    """``(roi_pool_gated_plain(...), its max |payload| per ROI [B, N]
    float32)``."""
    out = roi_pool_gated_plain(feat, rois, gate, c_base, c_take, output_size, spatial_scale,
                               src=src)
    return out, out.float().abs().amax(dim=(2, 3, 4))


def roi_pool_gated_int8_plain(feat, rois, gate, c_base, c_take, c_tile, output_size=7,
                              spatial_scale=1.0, src=None):
    """``(int8 payload [B, N, P, P, c_take], scales [B, c_take / c_tile, N]
    float32)``: ``quantize_tiles`` of the ungated pool, the float32 gate
    folded into the scales."""
    ones = torch.ones_like(gate, dtype=torch.float32)
    v = roi_pool_gated_plain(feat, rois, ones, c_base, c_take, output_size, spatial_scale,
                             src=src)
    q, m = quantize_tiles(v, c_tile)
    return q, quant_scale(gate[..., None], m).permute(0, 2, 1).contiguous()


def roi_pool_gated_tile8_plain(feat, rois, gate, c_base, c_take, output_size=7,
                               spatial_scale=1.0):
    """``(int8 payload [B, N, P, P, c_take], scale [B, N] float32)``: the
    max pool of the chunk quantized per image (``quantize_per_image``), its
    empty bins 0, and ``gate * s``."""
    q, s = quantize_per_image(feat[..., c_base : c_base + c_take])
    ones = torch.ones_like(gate, dtype=torch.float32)
    out = roi_pool_gated_plain(q.float(), rois, ones, 0, c_take, output_size, spatial_scale)
    return out.to(torch.int8), gate.float() * s[:, None]


def _launch(source, entry, dtype, pointers, ints, floats=(), what="pool", levels=None):
    """Launch ``entry`` (the full C name, without a dtype suffix when
    ``dtype`` is None) of ``csrc/<source>`` on the current stream with
    ``pointers`` (tensors or None), int and float arguments; with
    ``levels`` (a level-routed mode's maps) the per-level table comes
    first: host arrays of their base pointers, heights and widths, and
    their count. Raises on a launch error."""
    from ..kernels import load

    fn = getattr(load(source), entry if dtype is None else f"{entry}_{_DTYPE_SUFFIX[dtype]}")
    table = []
    if levels is not None:
        n = len(levels)
        table = [(ctypes.c_void_p * n)(*[f.data_ptr() for f in levels]),
                 (ctypes.c_int * n)(*[f.shape[1] for f in levels]),
                 (ctypes.c_int * n)(*[f.shape[2] for f in levels]), n]
    head = [ctypes.c_void_p] * 3 + [ctypes.c_int] if table else []
    fn.argtypes = (head + [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = next(t.device for t in pointers if t is not None)
    # temporaries are freed when the caller returns, while the kernel may
    # still run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*table, *[_ptr(t) for t in pointers], *[int(i) for i in ints],
                *[float(f) for f in floats], stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _pool_kernel_inputs(feat, rois, gate, c_base, c_take, src, spatial_scale, what):
    """The checks and device inputs shared by the ROIPool emissions on the
    card: ``(region, src32)``."""
    if feat.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {feat.device}")
    _check_kernel_args(feat, c_base, c_take, what)
    region = round_region(rois, spatial_scale).contiguous()
    return region, (None if src is None else _src32(src, feat.shape[0]))


def roi_pool_gated_maxabs(feat, rois, gate, c_base, c_take, output_size=7, spatial_scale=1.0,
                          src=None):
    """``roi_pool_gated``'s payload and its max |payload| per (ROI, chunk),
    ``[B, N]`` float32 (``quant="maxabs"``, reduced over the chunk in the
    block): the int8 fc1's activation maxabs without a second read of the
    chunk. The payload is ``roi_pool_gated``'s bit for bit."""
    global MAXABS_LAUNCHES
    _check(feat, rois, gate, c_base, c_take, src)
    if feat.device.type == "cpu":
        return roi_pool_gated_maxabs_plain(feat, rois, gate, c_base, c_take, output_size,
                                           spatial_scale, src)
    region, src32 = _pool_kernel_inputs(feat, rois, gate, c_base, c_take, src, spatial_scale,
                                        "roi_pool_gated_maxabs")
    s_copies, h, w, c = feat.shape
    b, n = rois.shape[:2]
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=feat.dtype,
                      device=feat.device)
    maxabs = torch.empty((b, n), dtype=torch.float32, device=feat.device)
    _launch("roi_pool_gated.cu", "wsovod_roi_pool_gated_maxabs", feat.dtype,
            [feat, region, src32, gate.to(feat.dtype).contiguous(), out, maxabs],
            [b, h, w, c, n, c_base, c_take, output_size],
            [float(torch.tensor(NEG_INF, dtype=feat.dtype))], "roi_pool_gated_maxabs")
    MAXABS_LAUNCHES += 1
    return out, maxabs


def roi_pool_gated_int8(feat, rois, gate, c_base, c_take, c_tile, output_size=7,
                        spatial_scale=1.0, src=None):
    """The int8 emission (``quant="int8"``): ``(payload int8 [B, N, P, P,
    c_take], scales [B, c_take / c_tile, N] float32)``, per (ROI,
    ``c_tile``) the pre-gate maxabs ``m``, ``round(v * (127 / m))`` and the
    scale ``gate * m / 127`` (``roi_pool_gated_int8_plain``)."""
    global INT8_LAUNCHES
    _check(feat, rois, gate, c_base, c_take, src)
    _check_c_tile(c_take, c_tile)
    if feat.device.type == "cpu":
        return roi_pool_gated_int8_plain(feat, rois, gate, c_base, c_take, c_tile, output_size,
                                         spatial_scale, src)
    region, src32 = _pool_kernel_inputs(feat, rois, gate, c_base, c_take, src, spatial_scale,
                                        "roi_pool_gated_int8")
    s_copies, h, w, c = feat.shape
    b, n = rois.shape[:2]
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=torch.int8,
                      device=feat.device)
    scales = torch.empty((b, c_take // c_tile, n), dtype=torch.float32, device=feat.device)
    _launch("roi_pool_gated.cu", "wsovod_roi_pool_gated_int8", feat.dtype,
            [feat, region, src32, gate.float().contiguous(), out, scales],
            [b, h, w, c, n, c_base, c_take, c_tile, output_size],
            [float(torch.tensor(NEG_INF, dtype=feat.dtype))], "roi_pool_gated_int8")
    INT8_LAUNCHES += 1
    return out, scales


def roi_pool_gated_tile8(feat, rois, gate, c_base, c_take, output_size=7, spatial_scale=1.0):
    """tile8 (``quant="tile8"``, the plain ROIPool without ``src``): the
    chunk quantized per image in torch (``quantize_per_image``), then the
    kernel's max pool over the int8 chunk; ``(payload int8 [B, N, P, P,
    c_take], scale [B, N] = gate * s float32)``. Its precision is per
    (image, chunk), coarser than the int8 emission's."""
    global TILE8_LAUNCHES
    _check(feat, rois, gate, c_base, c_take)
    if feat.device.type == "cpu":
        return roi_pool_gated_tile8_plain(feat, rois, gate, c_base, c_take, output_size,
                                          spatial_scale)
    region, _ = _pool_kernel_inputs(feat, rois, gate, c_base, c_take, None, spatial_scale,
                                    "roi_pool_gated_tile8")
    q, s = quantize_per_image(feat[..., c_base : c_base + c_take])
    q = q.contiguous()
    _, h, w, _ = q.shape
    b, n = rois.shape[:2]
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=torch.int8,
                      device=feat.device)
    _launch("roi_pool_gated.cu", "wsovod_roi_pool_gated_tile8", None, [q, region, out],
            [b, h, w, c_take, n, 0, c_take, output_size], (), "roi_pool_gated_tile8")
    TILE8_LAUNCHES += 1
    return out, gate.float() * s[:, None]


def roi_loop_pool_gated_maxabs_plain(feat, rois, gate, src, c_base, c_take, rows=3,
                                     output_size=7, spatial_scale=1.0, context_ratio=1.8):
    """``(roi_loop_pool_gated_plain(...), max |payload| per row and ROI
    [rows, B, N] float32)``."""
    out = roi_loop_pool_gated_plain(feat, rois, gate, src, c_base, c_take, rows, output_size,
                                    spatial_scale, context_ratio)
    return out, out.float().abs().amax(dim=(3, 4, 5))


def roi_loop_pool_gated_int8_plain(feat, rois, gate, src, c_base, c_take, c_tile, rows=3,
                                   output_size=7, spatial_scale=1.0, context_ratio=1.8):
    """``(int8 payload [rows, B, N, P, P, c_take], scales [rows, B, c_take /
    c_tile, N] float32)``, per row as ``roi_pool_gated_int8_plain``."""
    ones = torch.ones_like(gate, dtype=torch.float32)
    v = roi_loop_pool_gated_plain(feat, rois, ones, src, c_base, c_take, rows, output_size,
                                  spatial_scale, context_ratio)
    q, m = quantize_tiles(v, c_tile)
    return q, quant_scale(gate[..., None], m).permute(0, 1, 3, 2).contiguous()


def _loop_kernel_inputs(feat, rois, gate, src, c_base, c_take, spatial_scale, context_ratio,
                        what):
    _check_kernel_args(feat, c_base, c_take, what)
    _, h, w, _ = feat.shape
    geo = loop_geometry(rois, spatial_scale, h, w, context_ratio).contiguous()
    return geo, _src32(src, feat.shape[0])


def roi_loop_pool_gated_maxabs(feat, rois, gate, src, c_base, c_take, rows=3, output_size=7,
                               spatial_scale=1.0, context_ratio=1.8):
    """``roi_loop_pool_gated``'s payload and its max |payload| per row and
    (ROI, chunk), ``[rows, B, N]`` float32 (``quant="maxabs"``)."""
    global LOOP_MAXABS_LAUNCHES
    _check_loop(feat, rois, gate, src, c_base, c_take, rows)
    if feat.device.type == "cpu":
        return roi_loop_pool_gated_maxabs_plain(feat, rois, gate, src, c_base, c_take, rows,
                                                output_size, spatial_scale, context_ratio)
    geo, src32 = _loop_kernel_inputs(feat, rois, gate, src, c_base, c_take, spatial_scale,
                                     context_ratio, "roi_loop_pool_gated_maxabs")
    _, h, w, c = feat.shape
    b, n = rois.shape[:2]
    out = torch.empty((rows, b, n, output_size, output_size, c_take), dtype=feat.dtype,
                      device=feat.device)
    maxabs = torch.empty((rows, b, n), dtype=torch.float32, device=feat.device)
    _launch("roi_loop_pool_gated.cu", "wsovod_roi_loop_pool_gated_maxabs", feat.dtype,
            [feat, geo, src32, gate.to(feat.dtype).contiguous(), out, maxabs],
            [b, h, w, c, n, c_base, c_take, output_size, rows], (), "roi_loop_pool_gated_maxabs")
    LOOP_MAXABS_LAUNCHES += 1
    return out, maxabs


def roi_loop_pool_gated_int8(feat, rois, gate, src, c_base, c_take, c_tile, rows=3,
                             output_size=7, spatial_scale=1.0, context_ratio=1.8):
    """The loop pool's int8 emission: ``(payload int8 [rows, B, N, P, P,
    c_take], scales [rows, B, c_take / c_tile, N] float32)``, per row as
    ``roi_pool_gated_int8``."""
    global LOOP_INT8_LAUNCHES
    _check_loop(feat, rois, gate, src, c_base, c_take, rows)
    _check_c_tile(c_take, c_tile)
    if feat.device.type == "cpu":
        return roi_loop_pool_gated_int8_plain(feat, rois, gate, src, c_base, c_take, c_tile, rows,
                                              output_size, spatial_scale, context_ratio)
    geo, src32 = _loop_kernel_inputs(feat, rois, gate, src, c_base, c_take, spatial_scale,
                                     context_ratio, "roi_loop_pool_gated_int8")
    _, h, w, c = feat.shape
    b, n = rois.shape[:2]
    out = torch.empty((rows, b, n, output_size, output_size, c_take), dtype=torch.int8,
                      device=feat.device)
    scales = torch.empty((rows, b, c_take // c_tile, n), dtype=torch.float32, device=feat.device)
    _launch("roi_loop_pool_gated.cu", "wsovod_roi_loop_pool_gated_int8", feat.dtype,
            [feat, geo, src32, gate.float().contiguous(), out, scales],
            [b, h, w, c, n, c_base, c_take, c_tile, output_size, rows], (),
            "roi_loop_pool_gated_int8")
    LOOP_INT8_LAUNCHES += 1
    return out, scales


# ------------------------------------------------------------------------
# Kernel 2.5: the level-routed pools of the multi-level (FPN) pooler.


def _per_roi(values, level: torch.Tensor) -> torch.Tensor:
    """Each ROI's entry of the per-level ``values``, float32 ``[B, N]``."""
    return torch.tensor([float(v) for v in values], dtype=torch.float32,
                        device=level.device)[level.long()]


def level_scales(level: torch.Tensor, scales) -> torch.Tensor:
    """Each ROI's level scale, float32 ``[B, N, 1]``, for ``round_region``."""
    return _per_roi(scales, level)[..., None]


def level_loop_geometry(rois: torch.Tensor, level: torch.Tensor, scales, sizes,
                        context_ratio: float) -> torch.Tensor:
    """``loop_geometry`` of each ROI on its own level, int32 ``[B, N, 16]``:
    its level's scale, and its frame and context boxes clipped to
    ``w_lim / scale`` and ``h_lim / scale`` of that level's map (``sizes``:
    ``(h_lim, w_lim)`` per level; an FPN's coarse levels are padded, so these
    bounds differ between levels), in one pass over per-ROI tensors."""
    return loop_geometry(rois, _per_roi(scales, level), _per_roi([h for h, _ in sizes], level),
                         _per_roi([w for _, w in sizes], level), context_ratio)


def _level_groups(level: torch.Tensor, i: int, lvl: int, step: int):
    """Indices of image ``i``'s ROIs on level ``lvl``, in groups of at most
    ``step``."""
    idx = torch.nonzero(level[i] == lvl).squeeze(1)
    for lo in range(0, idx.numel(), step):
        yield idx[lo : lo + step]


def _check_levels(feats, rois, gate, level, scales, c_base, c_take, what):
    """``feats``: per level ``[B, H_l, W_l, C]`` of one dtype and device;
    ``rois [B, N, 4]``, ``gate`` and ``level [B, N]`` (integer in ``[0,
    L)``: on the CPU checked here, on the card by a device-side assert);
    one scale per level. The pools have no backward (the JAX package gives
    its per-image pools no VJP)."""
    feats = list(feats)
    if not feats or len(feats) != len(scales):
        raise ValueError(f"{what}: one scale per level, got {len(feats)} levels and "
                         f"{len(scales)} scales")
    b, n = rois.shape[:2]
    c = feats[0].shape[-1]
    for f in feats:
        if f.dim() != 4 or f.shape[0] != b or f.shape[3] != c:
            raise ValueError(f"{what}: every level must be [B={b}, H, W, C={c}], got "
                             f"{tuple(f.shape)}")
        if f.dtype != feats[0].dtype or f.device != feats[0].device:
            raise ValueError(f"{what}: the levels differ in dtype or device")
    if rois.shape != (b, n, 4) or gate.shape != (b, n) or level.shape != (b, n):
        raise ValueError(f"{what}: rois [B, N, 4], gate and level [B, N]: got "
                         f"{tuple(rois.shape)}, {tuple(gate.shape)}, {tuple(level.shape)}")
    if level.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: level must be an integer tensor, not {level.dtype}")
    if not (rois.device == gate.device == level.device == feats[0].device):
        raise ValueError(f"{what}: feats, rois, gate and level must be on one device")
    if not (0 <= c_base and c_take > 0 and c_base + c_take <= c):
        raise ValueError(f"{what}: channel chunk [{c_base}, {c_base + c_take}) outside C={c}")
    if feats[0].device.type == "cpu" and level.numel() and not (
            0 <= int(level.min()) and int(level.max()) < len(feats)):
        raise ValueError(f"{what}: level must lie in [0, {len(feats)})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in feats + [gate]):
        raise NotImplementedError(f"{what} has no backward: its TPU kernel has no VJP")
    return feats


def roi_pool_levels_plain(feats, rois, gate, level, c_base, c_take, output_size=7,
                          scales=(0.25,), max_elems: int = 1 << 27) -> torch.Tensor:
    """The plain PyTorch version of ``roi_pool_levels``: per level and
    image, the reference's separable masked max of the ROIs on that level
    (``wsovod_tpu/ops/roi_pool.py::roi_pool`` with the level's scale), in
    groups sized so the ``[n, P, H, W, c]`` temporary stays under
    ``max_elems``; each ROI is pooled on its own level only."""
    b, n = rois.shape[:2]
    p = output_size
    dtype, dev = feats[0].dtype, feats[0].device
    neg = torch.tensor(NEG_INF, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    g = gate.to(dtype)
    out = torch.zeros((b, n, p, p, c_take), dtype=dtype, device=dev)
    for lvl, (feat, s) in enumerate(zip(feats, scales)):
        _, h_lim, w_lim, _ = feat.shape
        f = feat[..., c_base : c_base + c_take]
        reg = round_region(rois, float(s))
        hlo, hhi = _bin_edges(reg[..., 1], reg[..., 3], p, h_lim)
        wlo, whi = _bin_edges(reg[..., 0], reg[..., 2], p, w_lim)
        hidx = torch.arange(h_lim, device=dev)
        widx = torch.arange(w_lim, device=dev)
        step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
        for i in range(b):
            for sel in _level_groups(level, i, lvl, step):
                row_in = (hidx >= hlo[i, sel, :, None]) & (hidx < hhi[i, sel, :, None])
                col_in = (widx >= wlo[i, sel, :, None]) & (widx < whi[i, sel, :, None])
                pooled = _masked_max(f[i], row_in, col_in, neg)
                out[i, sel] = torch.where(pooled <= neg, zero, pooled) * g[i, sel, None, None, None]
    return out


def roi_pool_levels(feats, rois, gate, level, c_base, c_take, output_size=7,
                    scales=(0.25,)) -> torch.Tensor:
    """Gated ROIPool of channels ``[c_base, c_base + c_take)`` over an FPN's
    levels, each ROI on its own level (kernel 2.5, the counterpart of
    ``roi_pool_pallas`` on every level and the select of
    ``wsovod_tpu/models/poolers.py:852-873``): ``feats`` per level ``[B,
    H_l, W_l, C]`` (NHWC, contiguous), ``rois [B, N, 4]`` XYXY image
    coordinates, ``gate [B, N]``, ``level [B, N]`` the ROI's level index, one
    scale per level -> ``[B, N, P, P, c_take]`` in the levels' dtype: ROI
    ``n`` of image ``b`` gives ``roi_pool(feats[level[b, n]][b], rois[b],
    P, scales[level[b, n]])[n, ..., c_base:c_base+c_take] * gate[b, n]``,
    the gate rounded to the features' dtype first. The integer regions are
    made here in torch with each ROI's own scale. No backward."""
    global LEVEL_LAUNCHES
    feats = _check_levels(feats, rois, gate, level, scales, c_base, c_take, "roi_pool_levels")
    if feats[0].device.type == "cpu":
        return roi_pool_levels_plain(feats, rois, gate, level, c_base, c_take, output_size,
                                     scales)
    if feats[0].device.type != "cuda":
        raise ValueError(f"roi_pool_levels runs on CPU or CUDA tensors, not {feats[0].device}")
    for f in feats:
        _check_kernel_args(f, c_base, c_take, "roi_pool_levels")
    b, n = rois.shape[:2]
    region = round_region(rois, level_scales(level, scales)).contiguous()
    level32 = _src32(level, len(feats))
    g = gate.to(feats[0].dtype).contiguous()
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=feats[0].dtype,
                      device=feats[0].device)
    neg_floor = float(torch.tensor(NEG_INF, dtype=feats[0].dtype))
    _launch("roi_pool_gated.cu", "wsovod_roi_pool_levels", feats[0].dtype,
            (region, level32, g, out), (b, feats[0].shape[3], n, c_base, c_take, output_size),
            (neg_floor,), "roi_pool_levels", levels=feats)
    LEVEL_LAUNCHES += 1
    return out


def roi_loop_pool_levels_plain(feats, rois, gate, level, c_base, c_take, rows=1, output_size=7,
                               scales=(0.25,), context_ratio=1.8,
                               max_elems: int = 1 << 27) -> torch.Tensor:
    """The plain PyTorch version of ``roi_loop_pool_levels``: per level and
    image, the reference's separable masked maxes (``_loop_rows``) of the
    ROIs on that level with that level's geometry, in groups sized so the
    ``[n, P, H, W, c]`` temporary stays under ``max_elems``."""
    b, n = rois.shape[:2]
    p = output_size
    dtype, dev = feats[0].dtype, feats[0].device
    g = gate.to(dtype)
    out = torch.zeros((rows, b, n, p, p, c_take), dtype=dtype, device=dev)
    for lvl, (feat, s) in enumerate(zip(feats, scales)):
        _, h_lim, w_lim, _ = feat.shape
        f = feat[..., c_base : c_base + c_take]
        geo = loop_geometry(rois, float(s), h_lim, w_lim, context_ratio)
        step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
        for i in range(b):
            for sel in _level_groups(level, i, lvl, step):
                gi = g[i, sel, None, None, None]
                for r, pr in enumerate(_loop_rows(f[i], geo[i, sel], rows, p)):
                    out[r, i, sel] = pr * gi
    return out


def roi_loop_pool_levels(feats, rois, gate, level, c_base, c_take, rows=1, output_size=7,
                         scales=(0.25,), context_ratio=1.8) -> torch.Tensor:
    """Gated ROILoopPool of channels ``[c_base, c_base + c_take)`` over an
    FPN's levels, each ROI on its own level (kernel 2.5, the counterpart of
    ``roi_loop_pool_pallas`` on every level and the select of
    ``wsovod_tpu/models/poolers.py:852-873``): arguments as
    ``roi_pool_levels``, ``rows`` 1 to 3 -> ``[rows, B, N, P, P, c_take]``:
    row 0 the ROI, row 1 the frame, row 2 the context of
    ``roi_loop_pool(feats[level[b, n]][b], rois[b], P, scales[level[b, n]],
    ratio)``, each a max that starts at 0, times the gate. The geometry is
    made here in torch with each ROI's own level (``level_loop_geometry``).
    No backward."""
    global LOOP_LEVEL_LAUNCHES
    feats = _check_levels(feats, rois, gate, level, scales, c_base, c_take,
                          "roi_loop_pool_levels")
    if rows not in (1, 2, 3):
        raise ValueError(f"rows must be 1, 2 or 3, not {rows}")
    if feats[0].device.type == "cpu":
        return roi_loop_pool_levels_plain(feats, rois, gate, level, c_base, c_take, rows,
                                          output_size, scales, context_ratio)
    if feats[0].device.type != "cuda":
        raise ValueError(f"roi_loop_pool_levels runs on CPU or CUDA tensors, not "
                         f"{feats[0].device}")
    for f in feats:
        _check_kernel_args(f, c_base, c_take, "roi_loop_pool_levels")
    b, n = rois.shape[:2]
    geo = level_loop_geometry(rois, level, scales, [f.shape[1:3] for f in feats],
                              context_ratio).contiguous()
    level32 = _src32(level, len(feats))
    g = gate.to(feats[0].dtype).contiguous()
    out = torch.empty((rows, b, n, output_size, output_size, c_take), dtype=feats[0].dtype,
                      device=feats[0].device)
    _launch("roi_loop_pool_gated.cu", "wsovod_roi_loop_pool_levels", feats[0].dtype,
            (geo, level32, g, out), (b, feats[0].shape[3], n, c_base, c_take, output_size, rows),
            what="roi_loop_pool_levels", levels=feats)
    LOOP_LEVEL_LAUNCHES += 1
    return out
