// Shared by roi_align_gated.cu and roi_align_gated_bwd.cu: the two-channel
// loads and stores, and the per-ROI sample metadata each block builds in
// shared memory before it gathers or scatters.
//
// The metadata of one ROI is, per axis (y, then x) and per sample k = p * s +
// sub (K = P * s samples), the lo and hi corner index and weight, the
// sample's range test folded into the weights:
//
//   sidx[(axis * K + k) * 2 + corner]   int, within the map
//   swt [(axis * K + k) * 2 + corner]   float, zero for an out-of-range sample
//
// It follows wsovod_tpu/ops/roi_pool.py::roi_align in float32 with one
// rounding per operation, in the order XLA compiles the reference (the
// division by the constant P is a multiplication by its float32 reciprocal):
// the __f*_rn intrinsics keep nvcc from contracting a multiply and an add,
// which would move a sample by an ulp, enough to cross a pixel edge or the
// range test. With a window (TPU.ROI_ALIGN_KERNEL = "pallas_approx",
// wsovod_tpu/ops/pallas/roi_align_kernel.py:89-99, 161-177, 31-44) the ROI
// reads a win_y x win_x window whose origin is floor(y1), and floor(x1)
// aligned down to 8, clipped to the map; a ROI longer than a window that
// stops short of the map's edge has its sample grid resampled into it by
// min(1, span / extent), and the corner indices are clamped to the window.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace roi_align {

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static float2 load(const V* p) { return __bfloat1622float2(*p); }
  __device__ static void store(V* p, float a, float b) { *p = __floats2bfloat162_rn(a, b); }
};

template <>
struct Pair<float> {
  using V = float2;
  __device__ static float2 load(const V* p) { return *p; }
  __device__ static void store(V* p, float a, float b) { *p = make_float2(a, b); }
};

// Fills sidx and swt (4 K entries each) for the ROI roi[0..3] (x1, y1, x2,
// y2 in image coordinates) on an H x W map; window 0 means exact. The caller
// synchronises the block before reading them.
__device__ inline void build_meta(const float* __restrict__ roi, float scale, int aligned,
                                  int window, int H, int W, int P, int s, int* sidx, float* swt) {
  const int K = P * s;
  const float off = aligned ? 0.5f : 0.0f;
  for (int i = threadIdx.x; i < 2 * K; i += blockDim.x) {
    const int axis = i / K;  // 0: y, 1: x
    const int k = i - axis * K;
    const float lo1 = __fsub_rn(__fmul_rn(roi[axis ? 0 : 1], scale), off);
    const float hi1 = __fsub_rn(__fmul_rn(roi[axis ? 2 : 3], scale), off);
    const int limit = axis ? W : H;
    float extent = __fsub_rn(hi1, lo1);
    if (!aligned) extent = fmaxf(extent, 1.0f);
    const float bin = __fmul_rn(extent, __frcp_rn((float)P));
    const int p = k / s;
    const float sub = __fdiv_rn(__fadd_rn((float)(k - p * s), 0.5f), (float)s);
    const float grid = __fadd_rn((float)p, sub);
    float c = __fadd_rn(lo1, __fmul_rn(grid, bin));
    int origin = 0, size = 0;
    if (window > 0) {
      const int win = min(window, min(H, max(W - 8, 8)));
      size = axis ? win + 8 : min(win + 8, H);
      const int span_len = axis ? (W + 7) / 8 * 8 : H;
      origin = min(max((int)floorf(lo1), 0), max(span_len - size, 0));
      if (axis) origin = origin / 8 * 8;
      // a window that reaches the map's edge is not resampled (f = 1)
      const float f = origin + size >= limit
                          ? 1.0f
                          : fminf(1.0f, __fdiv_rn(__fsub_rn((float)(origin + size - 2), lo1),
                                                  fmaxf(__fsub_rn(hi1, lo1), 1e-6f)));
      c = __fadd_rn(lo1, __fmul_rn(__fsub_rn(c, lo1), f));
    }
    const bool ok = c >= -1.0f && c <= (float)limit;
    const float cc = fminf(fmaxf(c, 0.0f), (float)(limit - 1));
    const float lo = floorf(cc);
    const float hi = fminf(lo + 1.0f, (float)(limit - 1));
    const float w_hi = __fsub_rn(cc, lo);
    int ilo = (int)lo, ihi = (int)hi;
    if (window > 0) {
      ilo = origin + min(max(ilo - origin, 0), size - 1);
      ihi = origin + min(max(ihi - origin, 0), size - 1);
    }
    sidx[2 * i] = ilo;
    sidx[2 * i + 1] = ihi;
    swt[2 * i] = ok ? __fsub_rn(1.0f, w_hi) : 0.0f;
    swt[2 * i + 1] = ok ? w_hi : 0.0f;
  }
}

}  // namespace roi_align
