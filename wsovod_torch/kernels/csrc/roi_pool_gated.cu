// Gated exact max RoIPool over one channel chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel wsovod_tpu/ops/pallas/roi_pool_fused.py
// roi_pool_fused_batched (loop_pool=False), the ROI pooler of the slice's
// main path, with or without its per-ROI source table (src_tbl, as
// roi_pool_fused_branched_ad reaches it for MRRP with the plain ROIPool), in
// each of its emission modes (quant="none", "maxabs", "int8", "tile8";
// roi_pool_common.cuh).
// It computes, for every image b and ROI n,
//
//   out[b, n, ph, pw, c] = roi_pool(feat[s], rois[b], P, scale)[n, ph, pw, c_base + c]
//                          * gate[b, n],   s = src ? src[b, n] : b
//
// with the semantics of wsovod_tpu/ops/roi_pool.py::roi_pool (torchvision's
// exact max RoIPool): the rounded integer region (x1, y1, w, h) arrives
// precomputed by the wrapper (floor(x * scale + 0.5) as a separately rounded
// multiply and add, which an FMA here would not reproduce at .5 boundaries);
// bin edges are integer floor/ceil divisions clipped to [0, H] and [0, W];
// the max starts at -inf; an empty bin, or a max at or below the reference's
// -1e30 fill value, writes 0. The gate arrives in the feature dtype and the
// product is rounded once, as the reference's `pooled * gate.astype(dtype)`.
//
// Layout: feat is NHWC [S, H, W, C], S feature copies (S = B without src; the
// MRRP branch-major concat, S = n_br * B, where src[b, n] = branch * B + b);
// out is [B, N, P, P, c_take], so the DAN's fc1 contracts a chunk as a plain
// [B*N, P*P*c_take] x [P*P*c_take, F] product with no relayout. Each ROI
// reads its own copy through src, so nothing is sorted by branch.
//
// The emission modes (roi_pool_common.cuh) change only the epilogue: kMaxabs
// also reduces max |payload| over the block and writes it per ROI (stat [B,
// N]); kInt8 writes an int8 payload and per-(ROI, c_tile) scales (stat [B,
// n_ct, N]) from the float32 gate; kTile8 walks int8 features (the chunk
// quantized per image by the wrapper, no src) and writes their bin maxima,
// ungated. kInt8 must know a tile's max |v| before it can quantize any of
// it: the block keeps the tile's pooled values in shared memory (P * P *
// c_tile floats, 100 KB at c_tile 512) rather than pooling twice, since the
// walk over the ROI's pixels is what the kernel's time goes to.
//
// Design (first, simple version): one block per (ROI, image); each thread owns
// two adjacent channels (one 4-byte bf16x2 or 8-byte float2 load per pixel, so
// a warp reads 128 or 256 contiguous bytes) and walks every bin's rows and
// columns. What bounds it: bytes read, about sum over ROIs of the ROI's
// feature-pixel area x c_take x 2 B per chunk -- tens of GB per image at the
// 5024-ROI mix, most of it from the 50 MB L2, since one image's res5 chunk is
// 86 x 132 x 512 x 2 B = 11.6 MB. Reusing row maxima across bins, TMA tiles
// and persistent blocks are left for later work.

#include "roi_pool_common.cuh"

namespace {

using roi_pool::clip;
using roi_pool::Pair;

template <typename T, int MODE>
__global__ void roi_pool_gated_kernel(const T* __restrict__ feat, const int4* __restrict__ region,
                                      const int* __restrict__ src, const void* __restrict__ gate,
                                      void* __restrict__ out, float* __restrict__ stat, int H,
                                      int W, int C, int N, int c_base, int c_take, int c_tile,
                                      int P, float neg_floor) {
  using V = typename Pair<T>::V;
  extern __shared__ float2 stash[];  // kInt8: [P * P][c_tile / 2] pre-gate values
  __shared__ float red[32];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * N + n;
  const int4 r = region[roi];  // (x1, y1, w, h), w and h >= 1
  const int copy = src != nullptr ? src[roi] : b;  // the feature copy
  const T* fb = feat + (size_t)copy * H * W * C + c_base;
  const int pairs = c_take / 2;
  const size_t row_pairs = (size_t)W * C / 2;  // one image row, in channel pairs
  const int pix_pairs = C / 2;
  const size_t out_pairs = roi * P * P * pairs;  // this ROI's output, in channel pairs

  // the pre-gate max of bin (ph, pw) for channel pair cp; 0 for an empty bin
  auto pool = [&](int cp, int ph, int pw) -> float2 {
    const V* fc = reinterpret_cast<const V*>(fb) + cp;
    const int hlo = clip((ph * r.w) / P + r.y, H);
    const int hhi = clip(((ph + 1) * r.w + P - 1) / P + r.y, H);
    const int wlo = clip((pw * r.z) / P + r.x, W);
    const int whi = clip(((pw + 1) * r.z + P - 1) / P + r.x, W);
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int h = hlo; h < hhi; ++h) {
      const V* row = fc + h * row_pairs;
#pragma unroll 4
      for (int w = wlo; w < whi; ++w) {
        const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
        m0 = v.x > m0 ? v.x : m0;
        m1 = v.y > m1 ? v.y : m1;
      }
    }
    const bool empty = (hhi <= hlo) || (whi <= wlo);
    return make_float2((empty || m0 <= neg_floor) ? 0.0f : m0,
                       (empty || m1 <= neg_floor) ? 0.0f : m1);
  };

  if constexpr (MODE == roi_pool::kInt8) {
    const float g = static_cast<const float*>(gate)[roi];
    char2* ob = static_cast<char2*>(out) + out_pairs;
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
      if (threadIdx.x == 0) stat[((size_t)b * n_ct + t) * N + n] = roi_pool::quant_scale(g, m);
      __syncthreads();  // the next tile rewrites the stash
    }
  } else {
    float g = 1.0f;
    if constexpr (MODE != roi_pool::kTile8) g = Pair<T>::scalar(static_cast<const T*>(gate) + roi);
    V* ob = static_cast<V*>(out) + out_pairs;
    float amax = 0.0f;
    for (int cp = threadIdx.x; cp < pairs; cp += blockDim.x) {
      for (int bin = 0; bin < P * P; ++bin) {
        const float2 v = pool(cp, bin / P, bin % P);
        if constexpr (MODE == roi_pool::kTile8) {
          Pair<T>::store(ob + (size_t)bin * pairs + cp, v.x, v.y);
        } else {
          const float o0 = v.x * g, o1 = v.y * g;
          Pair<T>::store(ob + (size_t)bin * pairs + cp, o0, o1);
          if constexpr (MODE == roi_pool::kMaxabs) amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
        }
      }
    }
    if constexpr (MODE == roi_pool::kMaxabs) {
      amax = roi_pool::block_max(amax, red);
      if (threadIdx.x == 0) stat[roi] = roi_pool::payload_maxabs<T>(amax, g);
    }
  }
}

template <typename T, int MODE>
int launch(const void* feat, const void* region, const void* src, const void* gate, void* out,
           float* stat, int B, int H, int W, int C, int N, int c_base, int c_take, int c_tile,
           int P, float neg_floor, void* stream) {
  if (B == 0 || N == 0 || c_take == 0) return 0;
  auto kernel = roi_pool_gated_kernel<T, MODE>;
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
      static_cast<const T*>(feat), static_cast<const int4*>(region), static_cast<const int*>(src),
      gate, out, stat, H, W, C, N, c_base, c_take, c_tile, P, neg_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `region` is
// int32 [B, N, 4]; `src` int32 [B, N], each entry in [0, S), or null (ROI n
// of image b reads copy b); `out` is [B, N, P, P, c_take]. c_base, c_take and
// C must be even. Each returns the cudaError_t of the launch (0 on success).
//
// quant="none": `gate` [B, N] in the feature dtype, `out` in the feature dtype.
extern "C" int wsovod_roi_pool_gated_bf16(const void* feat, const void* region, const void* src,
                                          const void* gate, void* out, int B, int H, int W, int C,
                                          int N, int c_base, int c_take, int P, float neg_floor,
                                          void* stream) {
  return launch<__nv_bfloat16, roi_pool::kNone>(feat, region, src, gate, out, nullptr, B, H, W, C,
                                                N, c_base, c_take, c_take, P, neg_floor, stream);
}

extern "C" int wsovod_roi_pool_gated_f32(const void* feat, const void* region, const void* src,
                                         const void* gate, void* out, int B, int H, int W, int C,
                                         int N, int c_base, int c_take, int P, float neg_floor,
                                         void* stream) {
  return launch<float, roi_pool::kNone>(feat, region, src, gate, out, nullptr, B, H, W, C, N,
                                        c_base, c_take, c_take, P, neg_floor, stream);
}

// quant="maxabs": as "none", plus `maxabs` float32 [B, N].
extern "C" int wsovod_roi_pool_gated_maxabs_bf16(const void* feat, const void* region,
                                                 const void* src, const void* gate, void* out,
                                                 void* maxabs, int B, int H, int W, int C, int N,
                                                 int c_base, int c_take, int P, float neg_floor,
                                                 void* stream) {
  return launch<__nv_bfloat16, roi_pool::kMaxabs>(feat, region, src, gate, out,
                                                  static_cast<float*>(maxabs), B, H, W, C, N,
                                                  c_base, c_take, c_take, P, neg_floor, stream);
}

extern "C" int wsovod_roi_pool_gated_maxabs_f32(const void* feat, const void* region,
                                                const void* src, const void* gate, void* out,
                                                void* maxabs, int B, int H, int W, int C, int N,
                                                int c_base, int c_take, int P, float neg_floor,
                                                void* stream) {
  return launch<float, roi_pool::kMaxabs>(feat, region, src, gate, out,
                                          static_cast<float*>(maxabs), B, H, W, C, N, c_base,
                                          c_take, c_take, P, neg_floor, stream);
}

// quant="int8": `gate` float32 [B, N]; `out` int8; `scales` float32 [B,
// c_take / c_tile, N]; c_tile even and dividing c_take.
extern "C" int wsovod_roi_pool_gated_int8_bf16(const void* feat, const void* region,
                                               const void* src, const void* gate, void* out,
                                               void* scales, int B, int H, int W, int C, int N,
                                               int c_base, int c_take, int c_tile, int P,
                                               float neg_floor, void* stream) {
  return launch<__nv_bfloat16, roi_pool::kInt8>(feat, region, src, gate, out,
                                                static_cast<float*>(scales), B, H, W, C, N,
                                                c_base, c_take, c_tile, P, neg_floor, stream);
}

extern "C" int wsovod_roi_pool_gated_int8_f32(const void* feat, const void* region,
                                              const void* src, const void* gate, void* out,
                                              void* scales, int B, int H, int W, int C, int N,
                                              int c_base, int c_take, int c_tile, int P,
                                              float neg_floor, void* stream) {
  return launch<float, roi_pool::kInt8>(feat, region, src, gate, out, static_cast<float*>(scales),
                                        B, H, W, C, N, c_base, c_take, c_tile, P, neg_floor,
                                        stream);
}

// quant="tile8": `feat` int8 [B, H, W, C] (no src, no gate), `out` int8.
extern "C" int wsovod_roi_pool_gated_tile8(const void* feat, const void* region, void* out, int B,
                                           int H, int W, int C, int N, int c_base, int c_take,
                                           int P, void* stream) {
  return launch<int8_t, roi_pool::kTile8>(feat, region, nullptr, nullptr, out, nullptr, B, H, W,
                                          C, N, c_base, c_take, c_take, P, -INFINITY, stream);
}
