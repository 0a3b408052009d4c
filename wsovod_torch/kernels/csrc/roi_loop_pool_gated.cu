// Gated, branch-routed ROILoopPool over one channel chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel wsovod_tpu/ops/pallas/roi_pool_fused.py
// roi_pool_fused_batched (loop_pool=True, with src_tbl), which the MRRP
// pooler reaches through roi_pool_fused_branched_ad. It computes, for every
// image b, ROI n and requested row r < rows,
//
//   out[r, b, n, ph, pw, c] = roi_loop_pool(feat[src[b, n]], rois[b], P, scale, ratio)
//                               [r, n, ph, pw, c_base + c] * gate[b, n]
//
// with the semantics of wsovod_tpu/ops/roi_pool.py::roi_loop_pool (the
// reference's ROILoopPool_cuda.cu): row 0 the ROI's bins, row 1 (frame) the
// ROI's bins minus the strict interior of the inner box, row 2 (context) the
// outer box's bins minus the strict interior of the unclipped ROI; every max
// starts at 0, so an empty bin writes 0. src[b, n] picks the feature copy the
// ROI reads: under MRRP, branch * B + b of the branch-major concat, so no
// sorting of ROIs by branch is needed. The gate arrives in the feature dtype
// and the product is rounded once, as the reference's `pooled * gate`.
//
// All geometry arrives as integers (geo[b, n] = 4 x int4, made by the wrapper
// in torch with one rounding per op): the ROI's and the outer box's rounded
// regions (x1, y1, w, h) and the two holes (x1, y1, x2, y2), a pixel (h, w)
// lying in a hole iff x1 < w < x2 and y1 < h < y2. The kernel does integer
// bin arithmetic only, so no contraction of a multiply and an add into an
// FMA can move a .5 boundary.
//
// Layout: feat is NHWC [S, H, W, C]; out is [rows, B, N, P, P, c_take], so
// row 0 is the DAN's fc1 operand [B*N, P*P*c_take] with no relayout.
//
// Design (first, simple version, the same walk as roi_pool_gated.cu): one
// block per (ROI, image); each thread owns two adjacent channels (4-byte
// bf16x2 or 8-byte float2 loads, so a warp reads 128 or 256 contiguous
// bytes) and walks every bin of every requested row. On a row of a bin that
// crosses its hole, the walk takes the columns left of the hole and those
// right of it (the two spans may overlap when the hole is empty: max does not
// mind). What bounds it: bytes read, as for roi_pool_gated (about 1,000
// feature pixels per ROI and row, mostly from the 50 MB L2, since one copy's
// 512-channel chunk is 86 x 132 x 512 x 2 B = 11.6 MB); rows 1 and 2 add the
// frame's and the outer box's pixels. Row-max reuse across bins and rows is
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static float2 load(const V* p) { return __bfloat1622float2(*p); }
  __device__ static void store(V* p, float a, float b) { *p = __floats2bfloat162_rn(a, b); }
  __device__ static float scalar(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};

template <>
struct Pair<float> {
  using V = float2;
  __device__ static float2 load(const V* p) { return *p; }
  __device__ static void store(V* p, float a, float b) { *p = make_float2(a, b); }
  __device__ static float scalar(const float* p) { return *p; }
};

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

template <typename T>
__global__ void roi_loop_pool_gated_kernel(const T* __restrict__ feat, const int4* __restrict__ geo,
                                           const int* __restrict__ src, const T* __restrict__ gate,
                                           T* __restrict__ out, int B, int H, int W, int C, int N,
                                           int c_base, int c_take, int P, int rows) {
  using V = typename Pair<T>::V;
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * N + n;
  // regions (x1, y1, w, h), w and h >= 1; holes (x1, y1, x2, y2)
  const int4 roi_region = geo[roi * 4 + 0];
  const int4 outer_region = geo[roi * 4 + 1];
  const int4 inner_hole = geo[roi * 4 + 2];
  const int4 roi_hole = geo[roi * 4 + 3];
  const float g = Pair<T>::scalar(gate + roi);
  const T* fb = feat + (size_t)src[roi] * H * W * C + c_base;
  const int pairs = c_take / 2;
  const size_t row_pairs = (size_t)W * C / 2;  // one image row, in channel pairs
  const int pix_pairs = C / 2;
  const size_t out_row = (size_t)B * N * P * P * c_take;  // one output row r, in elements

  for (int r = 0; r < rows; ++r) {
    const int4 reg = r == 2 ? outer_region : roi_region;
    // row 0 has no hole: y1 = y2 = 0 leaves no row strictly inside
    const int4 hole = r == 0 ? make_int4(0, 0, 0, 0) : (r == 1 ? inner_hole : roi_hole);
    V* ob = reinterpret_cast<V*>(out + r * out_row + roi * P * P * c_take);
    for (int cp = threadIdx.x; cp < pairs; cp += blockDim.x) {
      const V* fc = reinterpret_cast<const V*>(fb) + cp;
      for (int ph = 0; ph < P; ++ph) {
        const int hlo = clip((ph * reg.w) / P + reg.y, H);
        const int hhi = clip(((ph + 1) * reg.w + P - 1) / P + reg.y, H);
        for (int pw = 0; pw < P; ++pw) {
          const int wlo = clip((pw * reg.z) / P + reg.x, W);
          const int whi = clip(((pw + 1) * reg.z + P - 1) / P + reg.x, W);
          float m0 = 0.0f, m1 = 0.0f;
          for (int h = hlo; h < hhi; ++h) {
            const V* row = fc + h * row_pairs;
            // columns [wlo, left_end) and [right_start, whi): all of the bin's
            // columns, or those outside the hole on a row that crosses it
            int left_end = whi, right_start = whi;
            if (h > hole.y && h < hole.w) {
              left_end = imin(whi, hole.x + 1);
              right_start = imax(wlo, hole.z);
            }
#pragma unroll 4
            for (int w = wlo; w < left_end; ++w) {
              const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
              m0 = v.x > m0 ? v.x : m0;
              m1 = v.y > m1 ? v.y : m1;
            }
#pragma unroll 4
            for (int w = right_start; w < whi; ++w) {
              const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
              m0 = v.x > m0 ? v.x : m0;
              m1 = v.y > m1 ? v.y : m1;
            }
          }
          Pair<T>::store(ob + (size_t)(ph * P + pw) * pairs + cp, m0 * g, m1 * g);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const void* geo, const void* src, const void* gate, void* out, int B,
           int H, int W, int C, int N, int c_base, int c_take, int P, int rows, void* stream) {
  if (B == 0 || N == 0 || c_take == 0 || rows == 0) return 0;
  const int pairs = c_take / 2;
  const int threads = pairs < 256 ? pairs : 256;
  const dim3 grid(N, B);
  roi_loop_pool_gated_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int4*>(geo), static_cast<const int*>(src),
      static_cast<const T*>(gate), static_cast<T*>(out), B, H, W, C, N, c_base, c_take, P, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `geo` is
// int32 [B, N, 16], `src` int32 [B, N] with values in [0, S), `gate` [B, N]
// in the feature dtype, `out` [rows, B, N, P, P, c_take]. c_base, c_take and
// C must be even, rows 1 to 3. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int wsovod_roi_loop_pool_gated_bf16(const void* feat, const void* geo, const void* src,
                                               const void* gate, void* out, int B, int H, int W,
                                               int C, int N, int c_base, int c_take, int P,
                                               int rows, void* stream) {
  return launch<__nv_bfloat16>(feat, geo, src, gate, out, B, H, W, C, N, c_base, c_take, P, rows,
                               stream);
}

extern "C" int wsovod_roi_loop_pool_gated_f32(const void* feat, const void* geo, const void* src,
                                              const void* gate, void* out, int B, int H, int W,
                                              int C, int N, int c_base, int c_take, int P,
                                              int rows, void* stream) {
  return launch<float>(feat, geo, src, gate, out, B, H, W, C, N, c_base, c_take, P, rows, stream);
}
