"""Gated exact max RoIPool and gated, branch-routed ROILoopPool: the CUDA
kernels' wrappers and their plain PyTorch versions (counterparts:
``wsovod_tpu/ops/roi_pool.py::roi_pool`` and ``::roi_loop_pool`` for the
semantics, ``wsovod_tpu/ops/pallas/roi_pool_fused.py::roi_pool_fused_batched``
with ``loop_pool=False``, and with ``loop_pool=True`` and ``src_tbl``, for the
TPU kernels they replace).

``roi_pool_gated(feat, rois, gate, c_base, c_take, output_size,
spatial_scale)`` returns, for every image ``b``,
``roi_pool(feat[b], rois[b], P, scale)[..., c_base:c_base+c_take] *
gate[b, :, None, None, None]`` as ``[B, N, P, P, c_take]`` in ``feat``'s
dtype, with the gate rounded to that dtype first (as the reference's
``pooled * gate.astype(pooled.dtype)``), so the kernel and the plain version
agree bit for bit in bfloat16 and float32.

``roi_loop_pool_gated(feat, rois, gate, src, c_base, c_take, rows,
output_size, spatial_scale, context_ratio)`` returns, for every image ``b``
and ROI ``n``, ``roi_loop_pool(feat[src[b, n]], rois[b], P, scale,
ratio)[r, n, ..., c_base:c_base+c_take] * gate[b, n]`` for ``r < rows`` as
``[rows, B, N, P, P, c_take]``: row 0 the ROI, row 1 the frame, row 2 the
context, each a max that starts at 0. ``src`` picks the feature copy each ROI
reads (MRRP: ``branch * B + b`` of the branch-major concat), so the ROIs
need no sorting by branch. The same rounding of the gate holds.

``RoIPoolGatedFunction`` makes ``roi_pool_gated`` differentiable (the
counterpart of ``roi_pool_fused_ad``, ``roi_pool_fused.py:2109``): its
backward is ``roi_pool_gated_bwd``, a third kernel, whose feature cotangent
splits each bin's cotangent equally among the pixels that tie its max, as
``jnp.max``'s VJP does at both stages of the reference's separable max, and
whose gate cotangent is ``sum(g * out) / gate`` where ``|gate| > 1e-8``.

``RoILoopPoolGatedFunction`` does the same for ``roi_loop_pool_gated`` (the
counterpart of ``roi_pool_fused_branched_ad``, ``:2198``, and of
``roi_pool_fused_ad`` with ``loop_pool=True``): its backward is
``roi_loop_pool_gated_bwd``, a fourth kernel, with JAX's tie rules for the
ROI row's ``maximum(M, 0)`` and the frame's and context's ``maximum(m1,
m2)``, both of which halve a cotangent at a tie, and the gate cotangent
summed over the rows too.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES``, ``LOOP_LAUNCHES``, ``BWD_LAUNCHES`` and
``LOOP_BWD_LAUNCHES`` count the four kernels' launches.
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

_DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _kernel(source: str, entry: str, dtype: torch.dtype, argtypes):
    """The C entry point ``<entry>_<dtype>`` of ``csrc/<source>``, with its
    ctypes signature (builds and loads the library at first use)."""
    from ..kernels import load

    fn = getattr(load(source), f"{entry}_{_DTYPE_SUFFIX[dtype]}")
    fn.argtypes = argtypes
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
    if feat.dtype not in _DTYPE_SUFFIX:
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
    fn = _kernel("roi_pool_gated.cu", "wsovod_roi_pool_gated", feat.dtype,
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
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
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain PyTorch version of ``_pool_ad_bwd``
    (``wsovod_tpu/ops/pallas/roi_pool_fused.py:2146``): ``(g_feat [B, H, W,
    C] in feat's dtype, zero outside the chunk, g_gate [B, N] in gate's
    dtype)``, each ``None`` where not wanted.

    ``g_gate`` follows the reference's formula: ``sum(g * out)`` over the
    ROI's bins and channels in float32, divided by the gate where ``|gate|
    > 1e-8``, else 0. ``g_feat`` is autograd through the plain forward's
    separable masked max (``amax`` splits a cotangent equally among tied
    entries, as ``jnp.max``'s VJP) in float32, times the gate rounded to
    feat's dtype as the forward used it, summed in float32 over ROI chunks
    sized by ``max_elems`` and rounded once to feat's dtype."""
    g_gate = _gate_cotangent(g, out, gate, (2, 3, 4)) if need_gate else None
    if not need_feat:
        return None, g_gate
    b, h_lim, w_lim, _ = feat.shape
    n, p = rois.shape[1], output_size
    reg = round_region(rois, spatial_scale)
    hlo, hhi = _bin_edges(reg[..., 1], reg[..., 3], p, h_lim)
    wlo, whi = _bin_edges(reg[..., 0], reg[..., 2], p, w_lim)
    hidx = torch.arange(h_lim, device=feat.device)
    widx = torch.arange(w_lim, device=feat.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=feat.device)
    gd = gate.to(feat.dtype).float()
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    acc = torch.zeros((b, h_lim, w_lim, c_take), dtype=torch.float32, device=feat.device)
    for i in range(b):
        fi = feat[i, ..., c_base : c_base + c_take].float()
        for s in range(0, n, step):
            e = min(n, s + step)
            row_in = (hidx >= hlo[i, s:e, :, None]) & (hidx < hhi[i, s:e, :, None])
            col_in = (widx >= wlo[i, s:e, :, None]) & (widx < whi[i, s:e, :, None])
            leaf = fi.detach().requires_grad_(True)
            with torch.enable_grad():
                pooled = _masked_max(leaf, row_in, col_in, neg)
                pooled = torch.where(pooled <= neg, torch.zeros_like(pooled), pooled)
                (grad,) = torch.autograd.grad(pooled * gd[i, s:e, None, None, None], leaf,
                                              g[i, s:e].float())
            acc[i] += grad
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
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of ``roi_pool_gated`` at cotangent ``g [B, N, P, P,
    c_take]``: ``(g_feat, g_gate)`` as ``roi_pool_gated_bwd_plain``; ``out``
    (the forward's output) is read only for ``g_gate``. On the card the
    feature cotangent is summed with float32 atomics, so it equals the plain
    version to float tolerance, not bit for bit."""
    global BWD_LAUNCHES
    _check(feat, rois, gate, c_base, c_take)
    b, n = rois.shape[:2]
    shape = (b, n, output_size, output_size, c_take)
    if tuple(g.shape) != shape or (need_gate and (out is None or tuple(out.shape) != shape)):
        raise ValueError(f"g (and out for the gate cotangent) must be {shape}, got "
                         f"{tuple(g.shape)}, {None if out is None else tuple(out.shape)}")
    if feat.device.type == "cpu":
        return roi_pool_gated_bwd_plain(feat, rois, gate, out, g, c_base, c_take, output_size,
                                        spatial_scale, need_feat, need_gate)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_pool_gated_bwd runs on CPU or CUDA tensors, not {feat.device}")
    if feat.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"roi_pool_gated_bwd kernel takes bfloat16 or float32, not {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be a contiguous, 16-byte aligned NHWC tensor")
    _, h, w, c = feat.shape
    if c % 2 or c_base % 2 or c_take % 2:
        raise ValueError("C, c_base and c_take must be even (two channels per thread)")
    region = round_region(rois, spatial_scale).contiguous()
    gate_dt = gate.to(feat.dtype).contiguous()
    gate_f32 = gate.float().contiguous()
    g = g.to(feat.dtype).contiguous()
    out = out.to(feat.dtype).contiguous() if need_gate else None
    scratch = (torch.zeros((b, h, w, c_take), dtype=torch.float32, device=feat.device)
               if need_feat else None)
    g_gate = torch.empty((b, n), dtype=torch.float32, device=feat.device) if need_gate else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    neg_floor = float(torch.tensor(NEG_INF, dtype=feat.dtype))
    fn = _kernel("roi_pool_gated_bwd.cu", "wsovod_roi_pool_gated_bwd", feat.dtype,
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    # the temporaries are freed when this returns, while the kernel may still
    # run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), region.data_ptr(), gate_dt.data_ptr(), gate_f32.data_ptr(),
                g.data_ptr(), ptr(out), ptr(scratch), ptr(g_gate), b, h, w, c, n, int(c_base),
                int(c_take), int(output_size), neg_floor, stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool_gated_bwd kernel launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    g_feat = None
    if need_feat:
        g_feat = torch.zeros_like(feat)
        g_feat[..., c_base : c_base + c_take] = scratch.to(feat.dtype)
    return g_feat, (g_gate.to(gate.dtype) if need_gate else None)


class RoIPoolGatedFunction(torch.autograd.Function):
    """``roi_pool_gated`` under autograd (``roi_pool_fused_ad``): the forward
    launches the pool kernel, the backward ``roi_pool_gated_bwd``. It saves
    nothing when neither ``feat`` nor ``gate`` needs a gradient (a frozen
    backbone and a validity gate, every shipped config), and the forward's
    output only when the gate needs one."""

    @staticmethod
    def forward(ctx, feat, rois, gate, c_base, c_take, output_size, spatial_scale):
        out = roi_pool_gated(feat, rois, gate, c_base, c_take, output_size, spatial_scale)
        need_feat, need_gate = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        if need_feat or need_gate:
            ctx.save_for_backward(feat, rois, gate, out if need_gate else None)
            ctx.args = (c_base, c_take, output_size, spatial_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, rois, gate, out = ctx.saved_tensors
        g_feat, g_gate = roi_pool_gated_bwd(feat, rois, gate, out, g, *ctx.args,
                                            need_feat=ctx.needs_input_grad[0],
                                            need_gate=ctx.needs_input_grad[2])
        return g_feat, None, g_gate, None, None, None, None


def _masked_max(f: torch.Tensor, row_in: torch.Tensor, col_in: torch.Tensor,
                neg: torch.Tensor) -> torch.Tensor:
    """max of ``f [H, W, c]`` over ``{(h, w): row_in & col_in}`` per (ROI,
    bin): ``row_in [n, P, H]``, ``col_in [n, P, W]`` -> ``[n, P, P, c]``
    (``neg`` where the set is empty); the reference's separable max."""
    colmax = torch.where(col_in[:, :, None, :, None], f[None, None], neg).amax(dim=3)
    return torch.where(row_in[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)


def loop_geometry(rois: torch.Tensor, spatial_scale: float, h_lim: int, w_lim: int,
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
    Python number may become a multiplication by its reciprocal on CUDA)."""
    r = rois.float()
    x1, y1, x2, y2 = r.unbind(-1)
    rw, rh = x2 - x1, y2 - y1
    ratio = torch.full_like(rw, context_ratio)
    in_dw, in_dh = (rw - rw / ratio) / 2, (rh - rh / ratio) / 2
    out_dw, out_dh = (rw * ratio - rw) / 2, (rh * ratio - rh) / 2
    img_w, img_h = w_lim / spatial_scale, h_lim / spatial_scale

    def clipped(bx1, by1, bx2, by2):
        return torch.stack([bx1.clamp(0.0, img_w), by1.clamp(0.0, img_h),
                            bx2.clamp(0.0, img_w), by2.clamp(0.0, img_h)], dim=-1)

    inner = clipped(x1 + in_dw, y1 + in_dh, x2 - in_dw, y2 - in_dh)
    outer = clipped(x1 - out_dw, y1 - out_dh, x2 + out_dw, y2 + out_dh)

    def ints(box):
        return torch.floor(box * spatial_scale + 0.5).to(torch.int32)

    return torch.cat([round_region(r, spatial_scale), round_region(outer, spatial_scale),
                      ints(inner), ints(r)], dim=-1)


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
        for s in torch.unique(src[i]).tolist():
            idx = torch.nonzero(src[i] == s).squeeze(1)
            for lo in range(0, idx.numel(), step):
                sel = idx[lo : lo + step]
                pooled = _loop_rows(f[s], geo[i, sel], rows, p)
                gi = g[i, sel, None, None, None]
                for r, pr in enumerate(pooled):
                    out[r, i, sel] = pr * gi
    return out


def _check_loop(feat, rois, gate, src, c_base, c_take, rows):
    if feat.dim() != 4:
        raise ValueError(f"feat must be [S, H, W, C], got {tuple(feat.shape)}")
    b, n = rois.shape[:2]
    if rois.shape != (b, n, 4) or gate.shape != (b, n) or src.shape != (b, n):
        raise ValueError(f"rois [B, N, 4], gate and src [B, N]: got {tuple(rois.shape)}, "
                         f"{tuple(gate.shape)}, {tuple(src.shape)}")
    if src.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"src must be an integer tensor, not {src.dtype}")
    if not (0 <= c_base and c_take > 0 and c_base + c_take <= feat.shape[3]):
        raise ValueError(f"channel chunk [{c_base}, {c_base + c_take}) outside C={feat.shape[3]}")
    if rows not in (1, 2, 3):
        raise ValueError(f"rows must be 1, 2 or 3, not {rows}")
    if not (rois.device == gate.device == src.device == feat.device):
        raise ValueError("feat, rois, gate and src must be on one device")
    if feat.device.type == "cpu":
        if src.numel() and not (0 <= int(src.min()) and int(src.max()) < feat.shape[0]):
            raise ValueError(f"src must lie in [0, {feat.shape[0]})")
    elif feat.device.type != "cuda":
        raise ValueError(f"the loop pool runs on CPU or CUDA tensors, not {feat.device}")


def _check_loop_kernel_args(feat, c_base, c_take, what):
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
    _check_loop_kernel_args(feat, c_base, c_take, "roi_loop_pool_gated")
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
    b = rois.shape[0]
    p = output_size
    geo = loop_geometry(rois, spatial_scale, h_lim, w_lim, context_ratio)
    gd = gate.to(feat.dtype).float()
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    acc = torch.zeros(feat.shape[:3] + (c_take,), dtype=torch.float32, device=feat.device)
    for i in range(b):
        for s in torch.unique(src[i]).tolist():
            idx = torch.nonzero(src[i] == s).squeeze(1)
            fs = feat[s, ..., c_base : c_base + c_take].float()
            for lo in range(0, idx.numel(), step):
                sel = idx[lo : lo + step]
                leaf = fs.detach().requires_grad_(True)
                with torch.enable_grad():
                    pooled = torch.stack(_loop_rows(leaf, geo[i, sel], rows, p))
                    (grad,) = torch.autograd.grad(pooled * gd[i, sel, None, None, None], leaf,
                                                  g[:, i, sel].float())
                acc[s] += grad
    g_feat = torch.zeros_like(feat)
    g_feat[..., c_base : c_base + c_take] = acc.to(feat.dtype)
    return g_feat, g_gate


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
    plain version to float tolerance, not bit for bit."""
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
    _check_loop_kernel_args(feat, c_base, c_take, "roi_loop_pool_gated_bwd")
    s_copies, h, w, c = feat.shape
    geo = loop_geometry(rois, spatial_scale, h, w, context_ratio).contiguous()
    src32 = _src32(src, s_copies)
    gate_dt = gate.to(feat.dtype).contiguous()
    gate_f32 = gate.float().contiguous()
    g = g.to(feat.dtype).contiguous()
    out = out.to(feat.dtype).contiguous() if need_gate else None
    scratch = (torch.zeros((s_copies, h, w, c_take), dtype=torch.float32, device=feat.device)
               if need_feat else None)
    g_gate = torch.empty((b, n), dtype=torch.float32, device=feat.device) if need_gate else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    neg_floor = float(torch.tensor(NEG_INF, dtype=feat.dtype))
    fn = _kernel("roi_loop_pool_gated_bwd.cu", "wsovod_roi_loop_pool_gated_bwd", feat.dtype,
                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    # the temporaries are freed when this returns, while the kernel may still
    # run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), geo.data_ptr(), src32.data_ptr(), gate_dt.data_ptr(),
                gate_f32.data_ptr(), g.data_ptr(), ptr(out), ptr(scratch), ptr(g_gate), b, h, w, c,
                n, int(c_base), int(c_take), int(output_size), int(rows), neg_floor, stream)
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
