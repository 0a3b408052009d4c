// Gated exact max RoIPool over one channel chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel wsovod_tpu/ops/pallas/roi_pool_fused.py
// roi_pool_fused_batched (loop_pool=False, quant="none"), the ROI pooler of
// the slice's main path. It computes, for every image b and ROI n,
//
//   out[b, n, ph, pw, c] = roi_pool(feat[b], rois[b], P, scale)[n, ph, pw, c_base + c]
//                          * gate[b, n]
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
// Layout: feat is NHWC [B, H, W, C]; out is [B, N, P, P, c_take], so the DAN's
// fc1 contracts a chunk as a plain [B*N, P*P*c_take] x [P*P*c_take, F] product
// with no relayout.
//
// Design (first, simple version): one block per (ROI, image); each thread owns
// two adjacent channels (one 4-byte bf16x2 or 8-byte float2 load per pixel, so
// a warp reads 128 or 256 contiguous bytes) and walks every bin's rows and
// columns. What bounds it: bytes read, about sum over ROIs of the ROI's
// feature-pixel area x c_take x 2 B per chunk -- tens of GB per image at the
// 5024-ROI mix, most of it from the 50 MB L2, since one image's res5 chunk is
// 86 x 132 x 512 x 2 B = 11.6 MB. Reusing row maxima across bins, TMA tiles
// and persistent blocks are left for later work.

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

template <typename T>
__global__ void roi_pool_gated_kernel(const T* __restrict__ feat, const int4* __restrict__ region,
                                      const T* __restrict__ gate, T* __restrict__ out, int H, int W,
                                      int C, int N, int c_base, int c_take, int P, float neg_floor) {
  using V = typename Pair<T>::V;
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int4 r = region[(size_t)b * N + n];  // (x1, y1, w, h), w and h >= 1
  const float g = Pair<T>::scalar(gate + (size_t)b * N + n);
  const T* fb = feat + (size_t)b * H * W * C + c_base;
  V* ob = reinterpret_cast<V*>(out + ((size_t)b * N + n) * P * P * c_take);
  const int pairs = c_take / 2;
  const size_t row_pairs = (size_t)W * C / 2;  // one image row, in channel pairs
  const int pix_pairs = C / 2;

  for (int cp = threadIdx.x; cp < pairs; cp += blockDim.x) {
    const V* fc = reinterpret_cast<const V*>(fb) + cp;
    for (int ph = 0; ph < P; ++ph) {
      const int hlo = clip((ph * r.w) / P + r.y, H);
      const int hhi = clip(((ph + 1) * r.w + P - 1) / P + r.y, H);
      for (int pw = 0; pw < P; ++pw) {
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
        const float o0 = (empty || m0 <= neg_floor) ? 0.0f : m0;
        const float o1 = (empty || m1 <= neg_floor) ? 0.0f : m1;
        Pair<T>::store(ob + (size_t)(ph * P + pw) * pairs + cp, o0 * g, o1 * g);
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const void* region, const void* gate, void* out, int B, int H, int W,
           int C, int N, int c_base, int c_take, int P, float neg_floor, void* stream) {
  if (B == 0 || N == 0 || c_take == 0) return 0;
  const int pairs = c_take / 2;
  const int threads = pairs < 256 ? pairs : 256;
  const dim3 grid(N, B);
  roi_pool_gated_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int4*>(region), static_cast<const T*>(gate),
      static_cast<T*>(out), H, W, C, N, c_base, c_take, P, neg_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `region` is
// int32 [B, N, 4], `gate` is [B, N] in the feature dtype, `out` is
// [B, N, P, P, c_take]. c_base, c_take and C must be even. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wsovod_roi_pool_gated_bf16(const void* feat, const void* region, const void* gate,
                                          void* out, int B, int H, int W, int C, int N, int c_base,
                                          int c_take, int P, float neg_floor, void* stream) {
  return launch<__nv_bfloat16>(feat, region, gate, out, B, H, W, C, N, c_base, c_take, P,
                               neg_floor, stream);
}

extern "C" int wsovod_roi_pool_gated_f32(const void* feat, const void* region, const void* gate,
                                         void* out, int B, int H, int W, int C, int N, int c_base,
                                         int c_take, int P, float neg_floor, void* stream) {
  return launch<float>(feat, region, gate, out, B, H, W, C, N, c_base, c_take, P, neg_floor,
                       stream);
}
