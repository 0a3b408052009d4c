// Gated, branch-routed ROILoopPool over one channel chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel wsovod_tpu/ops/pallas/roi_pool_fused.py
// roi_pool_fused_batched (loop_pool=True, with src_tbl), which the MRRP
// pooler reaches through roi_pool_fused_branched_ad, in its emission modes
// quant="none", "maxabs" and "int8" (roi_pool_common.cuh; per row: stat
// [rows, B, N] maxabs, or [rows, B, n_ct, N] int8 scales); and, in its
// level-routed mode, the per-image wsovod_tpu/ops/pallas/roi_pool_kernel.py
// roi_loop_pool_pallas, which the JAX pooler runs on every FPN level for
// every ROI: here each ROI is pooled on its own level only, from a
// per-level table of maps (roi_pool_common.cuh), its frame and context
// boxes clipped to that level's map. It computes, for every
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
// kInt8 keeps a row's c_tile of pooled values in shared memory until the
// tile's max |v| is known, as roi_pool_gated.cu does.
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

#include "roi_pool_common.cuh"

namespace {

using roi_pool::clip;
using roi_pool::Pair;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

template <typename T, int MODE, bool LEVELS>
__global__ void roi_loop_pool_gated_kernel(const T* __restrict__ feat, const int4* __restrict__ geo,
                                           const int* __restrict__ src,
                                           const void* __restrict__ gate, void* __restrict__ out,
                                           float* __restrict__ stat, int B, int H, int W, int C,
                                           int N, int c_base, int c_take, int c_tile, int P,
                                           int rows,
                                           const __grid_constant__ roi_pool::Levels levels,
                                           const int* __restrict__ level) {
  using V = typename Pair<T>::V;
  extern __shared__ float2 stash[];  // kInt8: [P * P][c_tile / 2] pre-gate values
  __shared__ float red[32];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * N + n;
  // regions (x1, y1, w, h), w and h >= 1; holes (x1, y1, x2, y2)
  const int4 roi_region = geo[roi * 4 + 0];
  const int4 outer_region = geo[roi * 4 + 1];
  const int4 inner_hole = geo[roi * 4 + 2];
  const int4 roi_hole = geo[roi * 4 + 3];
  int copy;
  if constexpr (LEVELS) {  // image b of the ROI's level
    const int l = level[roi];
    feat = static_cast<const T*>(levels.feat[l]);
    H = levels.h[l];
    W = levels.w[l];
    copy = b;
  } else {
    copy = src[roi];
  }
  const T* fb = feat + (size_t)copy * H * W * C + c_base;
  const int pairs = c_take / 2;
  const size_t row_pairs = (size_t)W * C / 2;  // one image row, in channel pairs
  const int pix_pairs = C / 2;
  const size_t out_row = (size_t)B * N * P * P * pairs;  // one output row r, in channel pairs
  const size_t out_pairs = roi * P * P * pairs;  // this ROI's output in a row, in channel pairs

  for (int r = 0; r < rows; ++r) {
    const int4 reg = r == 2 ? outer_region : roi_region;
    // row 0 has no hole: y1 = y2 = 0 leaves no row strictly inside
    const int4 hole = r == 0 ? make_int4(0, 0, 0, 0) : (r == 1 ? inner_hole : roi_hole);

    // row r's max of bin (ph, pw) for channel pair cp, starting at 0
    auto pool = [&](int cp, int ph, int pw) -> float2 {
      const V* fc = reinterpret_cast<const V*>(fb) + cp;
      const int hlo = clip((ph * reg.w) / P + reg.y, H);
      const int hhi = clip(((ph + 1) * reg.w + P - 1) / P + reg.y, H);
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
      return make_float2(m0, m1);
    };

    if constexpr (MODE == roi_pool::kInt8) {
      const float g = static_cast<const float*>(gate)[roi];
      char2* ob = static_cast<char2*>(out) + r * out_row + out_pairs;
      const int tile_pairs = c_tile / 2;
      const int n_ct = c_take / c_tile;
      for (int t = 0; t < n_ct; ++t) {
        float amax = 0.0f;
        for (int j = threadIdx.x; j < tile_pairs; j += blockDim.x) {
          for (int bin = 0; bin < P * P; ++bin) {
            const float2 v = pool(t * tile_pairs + j, bin / P, bin % P);
            stash[bin * tile_pairs + j] = v;
            amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
          }
        }
        const float m = roi_pool::block_max(amax, red);  // also orders the stash's writes
        const float inv = roi_pool::quant_inv(m);
        for (int j = threadIdx.x; j < tile_pairs; j += blockDim.x) {
          for (int bin = 0; bin < P * P; ++bin) {
            ob[(size_t)bin * pairs + t * tile_pairs + j] =
                roi_pool::quantize(stash[bin * tile_pairs + j], inv);
          }
        }
        if (threadIdx.x == 0)
          stat[(((size_t)r * B + b) * n_ct + t) * N + n] = roi_pool::quant_scale(g, m);
        __syncthreads();  // the next tile rewrites the stash
      }
    } else {
      const float g = Pair<T>::scalar(static_cast<const T*>(gate) + roi);
      V* ob = static_cast<V*>(out) + r * out_row + out_pairs;
      float amax = 0.0f;
      for (int cp = threadIdx.x; cp < pairs; cp += blockDim.x) {
        for (int bin = 0; bin < P * P; ++bin) {
          const float2 v = pool(cp, bin / P, bin % P);
          const float o0 = v.x * g, o1 = v.y * g;
          Pair<T>::store(ob + (size_t)bin * pairs + cp, o0, o1);
          if constexpr (MODE == roi_pool::kMaxabs) amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
        }
      }
      if constexpr (MODE == roi_pool::kMaxabs) {
        amax = roi_pool::block_max(amax, red);
        if (threadIdx.x == 0) stat[(size_t)r * B * N + roi] = roi_pool::payload_maxabs<T>(amax, g);
      }
    }
  }
}

template <typename T, int MODE, bool LEVELS = false>
int launch(const void* feat, const void* geo, const void* src, const void* gate, void* out,
           float* stat, int B, int H, int W, int C, int N, int c_base, int c_take, int c_tile,
           int P, int rows, void* stream, const roi_pool::Levels& levels = {},
           const int* level = nullptr) {
  if (B == 0 || N == 0 || c_take == 0 || rows == 0) return 0;
  auto kernel = roi_loop_pool_gated_kernel<T, MODE, LEVELS>;
  size_t shmem = 0;
  int threads = roi_pool::block_threads(c_take / 2);
  if (MODE == roi_pool::kInt8) {
    shmem = (size_t)P * P * c_tile / 2 * sizeof(float2);
    threads = roi_pool::block_threads(c_tile / 2);
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(N, B);
  kernel<<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int4*>(geo), static_cast<const int*>(src),
      gate, out, stat, B, H, W, C, N, c_base, c_take, c_tile, P, rows, levels, level);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_levels(const void* const* feats, const int* hs, const int* ws, int L, const void* geo,
                  const void* level, const void* gate, void* out, int B, int C, int N, int c_base,
                  int c_take, int P, int rows, void* stream) {
  roi_pool::Levels levels;
  if (!roi_pool::make_levels(levels, feats, hs, ws, L)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, roi_pool::kNone, true>(feats[0], geo, nullptr, gate, out, nullptr, B, hs[0],
                                          ws[0], C, N, c_base, c_take, c_take, P, rows, stream,
                                          levels, static_cast<const int*>(level));
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `geo` is
// int32 [B, N, 16], `src` int32 [B, N] with values in [0, S), `out` [rows,
// B, N, P, P, c_take]. c_base, c_take and C must be even, rows 1 to 3. Each
// returns the cudaError_t of the launch (0 on success).
//
// quant="none": `gate` [B, N] in the feature dtype, `out` in the feature dtype.
extern "C" int wsovod_roi_loop_pool_gated_bf16(const void* feat, const void* geo, const void* src,
                                               const void* gate, void* out, int B, int H, int W,
                                               int C, int N, int c_base, int c_take, int P,
                                               int rows, void* stream) {
  return launch<__nv_bfloat16, roi_pool::kNone>(feat, geo, src, gate, out, nullptr, B, H, W, C, N,
                                                c_base, c_take, c_take, P, rows, stream);
}

extern "C" int wsovod_roi_loop_pool_gated_f32(const void* feat, const void* geo, const void* src,
                                              const void* gate, void* out, int B, int H, int W,
                                              int C, int N, int c_base, int c_take, int P,
                                              int rows, void* stream) {
  return launch<float, roi_pool::kNone>(feat, geo, src, gate, out, nullptr, B, H, W, C, N, c_base,
                                        c_take, c_take, P, rows, stream);
}

// quant="maxabs": as "none", plus `maxabs` float32 [rows, B, N].
extern "C" int wsovod_roi_loop_pool_gated_maxabs_bf16(const void* feat, const void* geo,
                                                      const void* src, const void* gate,
                                                      void* out, void* maxabs, int B, int H,
                                                      int W, int C, int N, int c_base,
                                                      int c_take, int P, int rows, void* stream) {
  return launch<__nv_bfloat16, roi_pool::kMaxabs>(feat, geo, src, gate, out,
                                                  static_cast<float*>(maxabs), B, H, W, C, N,
                                                  c_base, c_take, c_take, P, rows, stream);
}

extern "C" int wsovod_roi_loop_pool_gated_maxabs_f32(const void* feat, const void* geo,
                                                     const void* src, const void* gate, void* out,
                                                     void* maxabs, int B, int H, int W, int C,
                                                     int N, int c_base, int c_take, int P,
                                                     int rows, void* stream) {
  return launch<float, roi_pool::kMaxabs>(feat, geo, src, gate, out, static_cast<float*>(maxabs),
                                          B, H, W, C, N, c_base, c_take, c_take, P, rows, stream);
}

// quant="int8": `gate` float32 [B, N]; `out` int8; `scales` float32 [rows,
// B, c_take / c_tile, N]; c_tile even and dividing c_take.
extern "C" int wsovod_roi_loop_pool_gated_int8_bf16(const void* feat, const void* geo,
                                                    const void* src, const void* gate, void* out,
                                                    void* scales, int B, int H, int W, int C,
                                                    int N, int c_base, int c_take, int c_tile,
                                                    int P, int rows, void* stream) {
  return launch<__nv_bfloat16, roi_pool::kInt8>(feat, geo, src, gate, out,
                                                static_cast<float*>(scales), B, H, W, C, N,
                                                c_base, c_take, c_tile, P, rows, stream);
}

extern "C" int wsovod_roi_loop_pool_gated_int8_f32(const void* feat, const void* geo,
                                                   const void* src, const void* gate, void* out,
                                                   void* scales, int B, int H, int W, int C,
                                                   int N, int c_base, int c_take, int c_tile,
                                                   int P, int rows, void* stream) {
  return launch<float, roi_pool::kInt8>(feat, geo, src, gate, out, static_cast<float*>(scales), B,
                                        H, W, C, N, c_base, c_take, c_tile, P, rows, stream);
}

// The level-routed mode (kernel 2.5), quant="none": `feats` a host array of
// L device pointers, level l's maps [B, hs[l], ws[l], C] in the feature
// dtype (hs, ws host arrays, L <= 8); `geo` int32 [B, N, 16] made with each
// ROI's own level (its scale, and its frame and context boxes clipped to
// that level's map); `level` int32 [B, N], each entry in [0, L): ROI n of
// image b reads feats[level[b, n]][b]. `gate` and `out` as in quant="none".
extern "C" int wsovod_roi_loop_pool_levels_bf16(const void* const* feats, const int* hs,
                                                const int* ws, int L, const void* geo,
                                                const void* level, const void* gate, void* out,
                                                int B, int C, int N, int c_base, int c_take, int P,
                                                int rows, void* stream) {
  return launch_levels<__nv_bfloat16>(feats, hs, ws, L, geo, level, gate, out, B, C, N, c_base,
                                      c_take, P, rows, stream);
}

extern "C" int wsovod_roi_loop_pool_levels_f32(const void* const* feats, const int* hs,
                                               const int* ws, int L, const void* geo,
                                               const void* level, const void* gate, void* out,
                                               int B, int C, int N, int c_base, int c_take, int P,
                                               int rows, void* stream) {
  return launch_levels<float>(feats, hs, ws, L, geo, level, gate, out, B, C, N, c_base, c_take, P,
                              rows, stream);
}
