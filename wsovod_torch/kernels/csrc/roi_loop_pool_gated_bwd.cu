// Backward of the gated, branch-routed ROILoopPool over one channel chunk,
// for Hopper (sm_90a).
//
// Replaces the loop_pool=True branch of the backward of the TPU kernel's
// differentiable wrappers in wsovod_tpu/ops/pallas/roi_pool_fused.py:
// _pool_branched_bwd (roi_pool_fused_branched_ad, MRRP: feature copy
// branch * B + image) and _pool_ad_bwd (roi_pool_fused_ad, one copy per
// image). Both are the VJP of the reference wsovod_tpu/ops/roi_pool.py::
// roi_loop_pool times the gate. Given the forward's
//
//   out[r, b, n, ph, pw, c] = roi_loop_pool(feat[src[b, n]], rois[b])[r, n, ph, pw, c_base + c]
//                             * gate[b, n]                                 (r < rows)
//
// and its cotangent g of the same shape, it computes
//
//   g_gate[b, n] = sum_{r, ph, pw, c} g * out / gate   where |gate| > 1e-8, else 0
//   g_feat       = the VJP of the pool times the gate at g, with JAX's tie rules.
//
// For one (ROI, row, bin, channel) with t = g * gate:
// * Row 0 (the ROI): out = maximum(where(M <= -1e30, 0, M), 0), M the bin's
//   separable max (over each row's columns, then over the rows). An empty
//   bin sends nothing; otherwise w = t * (1 if M > 0, 1/2 if M == 0, 0 if
//   M < 0), split equally among the rows R whose column max equals M, and
//   within each such row equally among its columns equal to M (jnp.max's
//   VJP at both stages): each receives w / |R| / |C_h|.
// * Rows 1 (frame) and 2 (context): out = maximum(maximum(m1, m2), 0),
//   m1 the separable max over the bin's rows x its columns outside the
//   hole's column interior, m2 over the bin's rows outside the hole's row
//   interior x its columns (a pixel lies in the hole iff x1 < w < x2 and
//   y1 < h < y2). w = t * (1, 1/2 or 0 as max(m1, m2) is >, == or < 0);
//   set 1 receives w * (1, 1/2 or 0 as m1 is >, == or < m2), set 2 the
//   same with m1 and m2 swapped (jnp.maximum's VJP), each split by the rule
//   of row 0 within its own set. A pixel in both sets receives both shares;
//   m1 == m2 is common (an empty hole, or a max in a corner outside it).
//   The frame's bins are the ROI's and its hole the inner box; the
//   context's bins are the outer box's and its hole the ROI.
// Post-ReLU maps hold many exact zeros, so ties are the rule.
//
// All geometry arrives as integers (geo[b, n] = 4 x int4 from the wrapper's
// loop_geometry, one rounding per op in torch), so no contraction of a
// multiply and an add into an FMA can move a .5 boundary. Overlapping bins,
// rows and ROIs add onto one pixel, so the feature cotangent is accumulated
// with float32 atomics into a zeroed float32 scratch [S, H, W, c_take] that
// the wrapper casts to the feature dtype: the result equals the plain
// version to float tolerance, not bit for bit (the order of the adds varies).
//
// Design (first, simple version, the walk of roi_pool_gated_bwd.cu): one
// block per (ROI, image), each thread owns two adjacent channels. The ROI
// row and the frame share the ROI's bins, so each of those bins is walked
// once for its three sets (the whole bin, the frame's two), and each bin of
// the outer box once for the context's two: one read of the bin finds every
// set's max and tied rows, then each row is read twice (tied columns per
// set, then the adds), and a pixel that is the max of several sets gets one
// float32 atomic carrying their summed shares. g_gate is a block reduction of g * out over the ROI's rows, bins and
// channels. What bounds it: the bytes of the cotangent (rows * B * N * 49 *
// c_take elements) and the float32 scratch, against a max and a tie test
// per visited pixel and channel of every set; the bin reads hit L2 mostly,
// and tied zero bins still take an atomic per pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static float2 load(const V* p) { return __bfloat1622float2(*p); }
  __device__ static float scalar(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};

template <>
struct Pair<float> {
  using V = float2;
  __device__ static float2 load(const V* p) { return *p; }
  __device__ static float scalar(const float* p) { return *p; }
};

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// jnp.maximum's VJP share of the larger operand: 1, 1/2 at a tie, 0
__device__ __forceinline__ float share(float x, float other) {
  return x > other ? 1.0f : (x == other ? 0.5f : 0.0f);
}

// a new row maximum x (a feature value) against the set's max m and its
// count of tied rows r
__device__ __forceinline__ void take_row(float x, float& m, int& r) {
  if (x > m) {
    m = x;
    r = 1;
  } else if (x == m) {
    ++r;
  }
}

// One bin [hlo, hhi) x [wlo, whi) of a region and the open interior (hx1,
// hx2) x (hy1, hy2) of its hole. Set 0 is the whole bin (the ROI row); set 1
// its rows x its columns outside the hole's column interior, set 2 its rows
// outside the hole's row interior x its columns (the frame's or the
// context's two sets). An empty interior (hx2 <= hx1 + 1) takes nothing out.
struct Bin {
  int hlo, hhi, wlo, whi, hx1, hx2, hy1, hy2;
  __device__ bool col_in_set1(int w) const { return w <= hx1 || w >= hx2; }
  __device__ bool row_in_set2(int h) const { return h <= hy1 || h >= hy2; }
};

// The backward of one bin for one channel pair: set 0 with cotangent share
// w0 (kRoi), sets 1 and 2 with wh (kHollow). One walk finds each set's max
// and its tied rows; a second walk counts each row's tied columns per set
// and adds each pixel's summed share with one float32 atomic, so a pixel
// that is the max of several sets receives one add.
template <typename T, bool kRoi, bool kHollow>
__device__ __forceinline__ void bin_backward(const typename Pair<T>::V* fc, float* sb,
                                             size_t row_pairs, int pix_pairs, int W, int c_take,
                                             int cp, const Bin& bn, float2 w0, float2 wh,
                                             float neg_floor) {
  float m0[2] = {-INFINITY, -INFINITY}, m1[2] = {-INFINITY, -INFINITY},
        m2[2] = {-INFINITY, -INFINITY};
  int r0[2] = {0, 0}, r1[2] = {0, 0}, r2[2] = {0, 0};
  bool set1_cols = false;  // set 1 has a column
  for (int w = bn.wlo; w < bn.whi; ++w) set1_cols |= bn.col_in_set1(w);
  for (int h = bn.hlo; h < bn.hhi; ++h) {
    const typename Pair<T>::V* row = fc + h * row_pairs;
    float all0 = -INFINITY, all1 = -INFINITY, c10 = -INFINITY, c11 = -INFINITY;
    for (int w = bn.wlo; w < bn.whi; ++w) {
      const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
      all0 = v.x > all0 ? v.x : all0;
      all1 = v.y > all1 ? v.y : all1;
      if (kHollow && bn.col_in_set1(w)) {
        c10 = v.x > c10 ? v.x : c10;
        c11 = v.y > c11 ? v.y : c11;
      }
    }
    if (kRoi) {
      take_row(all0, m0[0], r0[0]);
      take_row(all1, m0[1], r0[1]);
    }
    if (kHollow) {
      if (set1_cols) {
        take_row(c10, m1[0], r1[0]);
        take_row(c11, m1[1], r1[1]);
      }
      if (bn.row_in_set2(h)) {
        take_row(all0, m2[0], r2[0]);
        take_row(all1, m2[1], r2[1]);
      }
    }
  }
  // each set's share of the cotangent, divided by its tied rows
  const float w0k[2] = {w0.x, w0.y}, whk[2] = {wh.x, wh.y};
  float t0[2] = {0.0f, 0.0f}, t1[2] = {0.0f, 0.0f}, t2[2] = {0.0f, 0.0f};
  for (int k = 0; k < 2; ++k) {
    if (kRoi && r0[k] && m0[k] > neg_floor) t0[k] = w0k[k] * share(m0[k], 0.0f) / (float)r0[k];
    if (kHollow) {
      const float wk = whk[k] * share(fmaxf(m1[k], m2[k]), 0.0f);
      if (r1[k]) t1[k] = wk * share(m1[k], m2[k]) / (float)r1[k];
      if (r2[k]) t2[k] = wk * share(m2[k], m1[k]) / (float)r2[k];
    }
  }
  if (t0[0] == 0.0f && t0[1] == 0.0f && t1[0] == 0.0f && t1[1] == 0.0f && t2[0] == 0.0f &&
      t2[1] == 0.0f)
    return;
  for (int h = bn.hlo; h < bn.hhi; ++h) {
    const typename Pair<T>::V* row = fc + h * row_pairs;
    const bool in2 = kHollow && bn.row_in_set2(h);
    int k0[2] = {0, 0}, k1[2] = {0, 0}, k2[2] = {0, 0};
    for (int w = bn.wlo; w < bn.whi; ++w) {
      const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
      const bool in1 = kHollow && bn.col_in_set1(w);
      k0[0] += kRoi && v.x == m0[0];
      k0[1] += kRoi && v.y == m0[1];
      k1[0] += in1 && v.x == m1[0];
      k1[1] += in1 && v.y == m1[1];
      k2[0] += in2 && v.x == m2[0];
      k2[1] += in2 && v.y == m2[1];
    }
    float a0[2], a1[2], a2[2];
    bool any = false;
    for (int k = 0; k < 2; ++k) {
      a0[k] = k0[k] ? t0[k] / (float)k0[k] : 0.0f;
      a1[k] = k1[k] ? t1[k] / (float)k1[k] : 0.0f;
      a2[k] = k2[k] ? t2[k] / (float)k2[k] : 0.0f;
      any |= a0[k] != 0.0f || a1[k] != 0.0f || a2[k] != 0.0f;
    }
    if (!any) continue;  // h is no set's tied row
    float* srow = sb + (size_t)h * W * c_take + 2 * cp;
    for (int w = bn.wlo; w < bn.whi; ++w) {
      const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
      const bool in1 = kHollow && bn.col_in_set1(w);
      const float s0 = (v.x == m0[0] ? a0[0] : 0.0f) + (in1 && v.x == m1[0] ? a1[0] : 0.0f) +
                       (in2 && v.x == m2[0] ? a2[0] : 0.0f);
      const float s1 = (v.y == m0[1] ? a0[1] : 0.0f) + (in1 && v.y == m1[1] ? a1[1] : 0.0f) +
                       (in2 && v.y == m2[1] ? a2[1] : 0.0f);
      if (s0 != 0.0f) atomicAdd(srow + (size_t)w * c_take, s0);
      if (s1 != 0.0f) atomicAdd(srow + (size_t)w * c_take + 1, s1);
    }
  }
}

template <typename T>
__global__ void roi_loop_pool_gated_bwd_kernel(
    const T* __restrict__ feat, const int4* __restrict__ geo, const int* __restrict__ src,
    const T* __restrict__ gate_dt, const float* __restrict__ gate_f32, const T* __restrict__ g,
    const T* __restrict__ out, float* __restrict__ scratch, float* __restrict__ g_gate, int B,
    int H, int W, int C, int N, int c_base, int c_take, int P, int rows, float neg_floor) {
  using V = typename Pair<T>::V;
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * N + n;
  const int pairs = c_take / 2;
  const size_t roi_elems = (size_t)P * P * c_take;
  const size_t out_row = (size_t)B * N * roi_elems;  // one row r of g and out, in elements

  if (g_gate != nullptr) {  // sum of g * out over the ROI's rows, bins and channels
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const V* gr = reinterpret_cast<const V*>(g + r * out_row + roi * roi_elems);
      const V* orow = reinterpret_cast<const V*>(out + r * out_row + roi * roi_elems);
      for (int i = threadIdx.x; i < P * P * pairs; i += blockDim.x) {
        const float2 gv = Pair<T>::load(gr + i);
        const float2 ov = Pair<T>::load(orow + i);
        acc += gv.x * ov.x + gv.y * ov.y;
      }
    }
    __shared__ float part[32];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int i = 0; i < (int)((blockDim.x + 31) >> 5); ++i) s += part[i];
      const float gt = gate_f32[roi];
      g_gate[roi] = fabsf(gt) > 1e-8f ? s / gt : 0.0f;
    }
  }
  if (scratch == nullptr) return;

  const float gate = Pair<T>::scalar(gate_dt + roi);
  if (gate == 0.0f) return;  // every cotangent of this ROI is multiplied by 0
  // regions (x1, y1, w, h), w and h >= 1; holes (x1, y1, x2, y2)
  const int4 roi_region = geo[roi * 4 + 0];
  const int4 outer_region = geo[roi * 4 + 1];
  const int4 inner_hole = geo[roi * 4 + 2];
  const int4 roi_hole = geo[roi * 4 + 3];
  const int s = src[roi];
  const T* fb = feat + (size_t)s * H * W * C + c_base;
  float* sb = scratch + (size_t)s * H * W * c_take;
  const size_t row_pairs = (size_t)W * C / 2;  // one image row, in channel pairs
  const int pix_pairs = C / 2;
  const float2 zero = make_float2(0.0f, 0.0f);

  for (int cp = threadIdx.x; cp < pairs; cp += blockDim.x) {
    const V* fc = reinterpret_cast<const V*>(fb) + cp;
    // the ROI's bins: row 0 and, with rows >= 2, the frame's sets (hole:
    // the inner box); then, with rows == 3, the outer box's bins for the
    // context's sets (hole: the ROI)
    for (int grid = 0; grid < (rows == 3 ? 2 : 1); ++grid) {
      const int4 reg = grid == 0 ? roi_region : outer_region;
      const int4 hole = grid == 0 ? inner_hole : roi_hole;
      const V* g0 = reinterpret_cast<const V*>(g + roi * roi_elems) + cp;
      const V* gh = reinterpret_cast<const V*>(g + (grid + 1) * out_row + roi * roi_elems) + cp;
      for (int ph = 0; ph < P; ++ph) {
        const int hlo = clip((ph * reg.w) / P + reg.y, H);
        const int hhi = clip(((ph + 1) * reg.w + P - 1) / P + reg.y, H);
        for (int pw = 0; pw < P; ++pw) {
          const int wlo = clip((pw * reg.z) / P + reg.x, W);
          const int whi = clip(((pw + 1) * reg.z + P - 1) / P + reg.x, W);
          if (hhi <= hlo || whi <= wlo) continue;  // empty bin: no gradient
          const Bin bn = {hlo, hhi, wlo, whi, hole.x, hole.z, hole.y, hole.w};
          const size_t bin = (size_t)(ph * P + pw) * pairs;
          const float2 gh_v = (grid == 1 || rows >= 2) ? Pair<T>::load(gh + bin) : zero;
          const float2 wh = make_float2(gh_v.x * gate, gh_v.y * gate);
          const float2 g0_v = grid == 0 ? Pair<T>::load(g0 + bin) : zero;
          const float2 w0 = make_float2(g0_v.x * gate, g0_v.y * gate);
          if (w0.x == 0.0f && w0.y == 0.0f && wh.x == 0.0f && wh.y == 0.0f) continue;
          if (grid == 1) {
            bin_backward<T, false, true>(fc, sb, row_pairs, pix_pairs, W, c_take, cp, bn, zero, wh,
                                         neg_floor);
            continue;
          }
          if (rows >= 2)
            bin_backward<T, true, true>(fc, sb, row_pairs, pix_pairs, W, c_take, cp, bn, w0, wh,
                                        neg_floor);
          else
            bin_backward<T, true, false>(fc, sb, row_pairs, pix_pairs, W, c_take, cp, bn, w0, zero,
                                         neg_floor);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const void* geo, const void* src, const void* gate_dt,
           const void* gate_f32, const void* g, const void* out, void* scratch, void* g_gate,
           int B, int H, int W, int C, int N, int c_base, int c_take, int P, int rows,
           float neg_floor, void* stream) {
  if (B == 0 || N == 0 || c_take == 0 || rows == 0) return 0;
  const int pairs = c_take / 2;
  int threads = pairs < 256 ? pairs : 256;
  threads = (threads + 31) / 32 * 32;  // whole warps for the g_gate reduction
  const dim3 grid(N, B);
  roi_loop_pool_gated_bwd_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int4*>(geo), static_cast<const int*>(src),
      static_cast<const T*>(gate_dt), static_cast<const float*>(gate_f32),
      static_cast<const T*>(g), static_cast<const T*>(out), static_cast<float*>(scratch),
      static_cast<float*>(g_gate), B, H, W, C, N, c_base, c_take, P, rows, neg_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers: feat [S, H,
// W, C]; geo int32 [B, N, 16] (loop_geometry); src int32 [B, N] in [0, S);
// gate_dt [B, N] in the feature dtype (as the forward used it) and gate_f32
// [B, N] float32; g and out [rows, B, N, P, P, c_take]. `out` and `g_gate`
// [B, N] float32 are both null or both set (the gate cotangent); `scratch`
// float32 [S, H, W, c_take], zeroed, is null when the feature cotangent is
// not wanted. c_base, c_take and C must be even, rows 1 to 3. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wsovod_roi_loop_pool_gated_bwd_bf16(
    const void* feat, const void* geo, const void* src, const void* gate_dt, const void* gate_f32,
    const void* g, const void* out, void* scratch, void* g_gate, int B, int H, int W, int C, int N,
    int c_base, int c_take, int P, int rows, float neg_floor, void* stream) {
  return launch<__nv_bfloat16>(feat, geo, src, gate_dt, gate_f32, g, out, scratch, g_gate, B, H,
                               W, C, N, c_base, c_take, P, rows, neg_floor, stream);
}

extern "C" int wsovod_roi_loop_pool_gated_bwd_f32(
    const void* feat, const void* geo, const void* src, const void* gate_dt, const void* gate_f32,
    const void* g, const void* out, void* scratch, void* g_gate, int B, int H, int W, int C, int N,
    int c_base, int c_take, int P, int rows, float neg_floor, void* stream) {
  return launch<float>(feat, geo, src, gate_dt, gate_f32, g, out, scratch, g_gate, B, H, W, C, N,
                       c_base, c_take, P, rows, neg_floor, stream);
}
