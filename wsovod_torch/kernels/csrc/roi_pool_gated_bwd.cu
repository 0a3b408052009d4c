// Backward of the gated exact max RoIPool over one channel chunk, for Hopper
// (sm_90a).
//
// Replaces the backward of the TPU kernel's differentiable wrappers,
// wsovod_tpu/ops/pallas/roi_pool_fused.py roi_pool_fused_ad (_pool_ad_bwd)
// and, with a per-ROI source copy, roi_pool_fused_branched_ad
// (_pool_branched_bwd, loop_pool=False: MRRP with the plain ROIPool), whose
// forward is roi_pool_fused_batched (loop_pool=False). Given the forward's
// out[b, n, ph, pw, c] = roi_pool(feat[s], rois[b])[n, ph, pw, c_base + c] *
// gate[b, n], s = src ? src[b, n] : b, and its cotangent g of the same shape,
// it computes
//
//   g_gate[b, n] = sum_{ph, pw, c} g * out / gate   where |gate| > 1e-8, else 0
//   g_feat       = the VJP of roi_pool(feat) * gate at g, with JAX's tie rule.
//
// The reference max is separable (wsovod_tpu/ops/roi_pool.py): first over a
// bin's columns for every row, then over the bin's rows, and jnp.max's VJP
// splits a cotangent equally among the entries that tie the max, at each
// stage. For one (ROI, bin, channel) with max m and cotangent t = g * gate:
//   R   = the bin's rows whose column max equals m,
//   C_h = the bin's columns of row h equal to m,
// and each pixel (h, w) with h in R and w in C_h receives t / |R| / |C_h|.
// An empty bin, or one whose max is at or below the reference's -1e30 fill
// value, sends nothing. Post-ReLU feature maps hold many exact zeros, so ties
// are the common case: a single-argmax backward would be wrong.
//
// Overlapping bins and ROIs add onto one pixel, so the feature cotangent is
// accumulated with float32 atomics into a zeroed float32 scratch [S, H, W,
// c_take] over every feature copy (S = B without src, n_br * B for the MRRP
// branch concat), which the wrapper casts to the feature dtype: the result
// equals the plain version to float tolerance, not bit for bit (the order of
// the adds varies from run to run). Each ROI adds into its own copy's
// scratch, so nothing is sorted by branch.
//
// Design (first, simple version, as the forward kernel): one block per (ROI,
// image); each thread owns two adjacent channels. Per bin it reads the bin
// once for the max and the tie count over rows, then each row of R twice
// (column ties, then the adds). g_gate is a block reduction of g * out over
// the ROI's bins and channels. What bounds it: the bytes of the cotangent
// (B * N * 49 * c_take elements) and the f32 scratch, plus the bin reads,
// most from L2 as in the forward; the atomics of tied bins are the open
// question (PERF.md).

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

template <typename T>
__global__ void roi_pool_gated_bwd_kernel(const T* __restrict__ feat, const int4* __restrict__ region,
                                          const int* __restrict__ src,
                                          const T* __restrict__ gate_dt,
                                          const float* __restrict__ gate_f32,
                                          const T* __restrict__ g, const T* __restrict__ out,
                                          float* __restrict__ scratch, float* __restrict__ g_gate,
                                          int H, int W, int C, int N, int c_base, int c_take, int P,
                                          float neg_floor) {
  using V = typename Pair<T>::V;
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * N + n;
  const int pairs = c_take / 2;
  const V* gr = reinterpret_cast<const V*>(g + roi * P * P * c_take);

  if (g_gate != nullptr) {  // sum of g * out over the ROI's bins and channels
    const V* orow = reinterpret_cast<const V*>(out + roi * P * P * c_take);
    float acc = 0.0f;
    for (int i = threadIdx.x; i < P * P * pairs; i += blockDim.x) {
      const float2 gv = Pair<T>::load(gr + i);
      const float2 ov = Pair<T>::load(orow + i);
      acc += gv.x * ov.x + gv.y * ov.y;
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

  const int4 r = region[roi];  // (x1, y1, w, h), w and h >= 1
  const float gate = Pair<T>::scalar(gate_dt + roi);
  if (gate == 0.0f) return;  // every cotangent of this ROI is multiplied by 0
  const int copy = src != nullptr ? src[roi] : b;  // the feature copy
  const T* fb = feat + (size_t)copy * H * W * C + c_base;
  float* sb = scratch + (size_t)copy * H * W * c_take;
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
        if (hhi <= hlo || whi <= wlo) continue;  // empty bin: no gradient
        // the max m and |R|, the count of rows whose column max ties it
        float m0 = -INFINITY, m1 = -INFINITY;
        int r0 = 0, r1 = 0;
        for (int h = hlo; h < hhi; ++h) {
          const V* row = fc + h * row_pairs;
          float x0 = -INFINITY, x1 = -INFINITY;
          for (int w = wlo; w < whi; ++w) {
            const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
            x0 = v.x > x0 ? v.x : x0;
            x1 = v.y > x1 ? v.y : x1;
          }
          if (x0 > m0) { m0 = x0; r0 = 1; } else if (x0 == m0) { ++r0; }
          if (x1 > m1) { m1 = x1; r1 = 1; } else if (x1 == m1) { ++r1; }
        }
        const float2 gv = Pair<T>::load(gr + (size_t)(ph * P + pw) * pairs + cp);
        // as the reference's VJP: (g * gate) / |R|, then / |C_h| per row
        const float t0 = (m0 <= neg_floor || r0 == 0) ? 0.0f : gv.x * gate / (float)r0;
        const float t1 = (m1 <= neg_floor || r1 == 0) ? 0.0f : gv.y * gate / (float)r1;
        if (t0 == 0.0f && t1 == 0.0f) continue;
        for (int h = hlo; h < hhi; ++h) {
          const V* row = fc + h * row_pairs;
          int k0 = 0, k1 = 0;
          for (int w = wlo; w < whi; ++w) {
            const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
            k0 += v.x == m0;
            k1 += v.y == m1;
          }
          if (k0 == 0 && k1 == 0) continue;  // h not in R
          const float a0 = k0 ? t0 / (float)k0 : 0.0f;
          const float a1 = k1 ? t1 / (float)k1 : 0.0f;
          float* srow = sb + (size_t)h * W * c_take + 2 * cp;
          for (int w = wlo; w < whi; ++w) {
            const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
            if (v.x == m0 && a0 != 0.0f) atomicAdd(srow + (size_t)w * c_take, a0);
            if (v.y == m1 && a1 != 0.0f) atomicAdd(srow + (size_t)w * c_take + 1, a1);
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const void* region, const void* src, const void* gate_dt,
           const void* gate_f32, const void* g, const void* out, void* scratch, void* g_gate, int B,
           int H, int W, int C, int N, int c_base, int c_take, int P, float neg_floor,
           void* stream) {
  if (B == 0 || N == 0 || c_take == 0) return 0;
  const int pairs = c_take / 2;
  int threads = pairs < 256 ? pairs : 256;
  threads = (threads + 31) / 32 * 32;  // whole warps for the g_gate reduction
  const dim3 grid(N, B);
  roi_pool_gated_bwd_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int4*>(region), static_cast<const int*>(src),
      static_cast<const T*>(gate_dt), static_cast<const float*>(gate_f32),
      static_cast<const T*>(g), static_cast<const T*>(out), static_cast<float*>(scratch),
      static_cast<float*>(g_gate), H, W, C, N, c_base, c_take, P, neg_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers: feat [S, H,
// W, C]; region int32 [B, N, 4]; src int32 [B, N] in [0, S), or null (ROI n of
// image b reads copy b, S = B); gate_dt [B, N] in the feature dtype (as the
// forward used it) and gate_f32 [B, N] float32; g and out [B, N, P, P,
// c_take]. `out` and `g_gate` [B, N] float32 are both null or both set (the
// gate cotangent); `scratch` float32 [S, H, W, c_take], zeroed, is null when
// the feature cotangent is not wanted. c_base, c_take and C must be even.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int wsovod_roi_pool_gated_bwd_bf16(const void* feat, const void* region,
                                              const void* src, const void* gate_dt,
                                              const void* gate_f32, const void* g, const void* out,
                                              void* scratch, void* g_gate, int B, int H, int W,
                                              int C, int N, int c_base, int c_take, int P,
                                              float neg_floor, void* stream) {
  return launch<__nv_bfloat16>(feat, region, src, gate_dt, gate_f32, g, out, scratch, g_gate, B,
                               H, W, C, N, c_base, c_take, P, neg_floor, stream);
}

extern "C" int wsovod_roi_pool_gated_bwd_f32(const void* feat, const void* region,
                                             const void* src, const void* gate_dt,
                                             const void* gate_f32, const void* g, const void* out,
                                             void* scratch, void* g_gate, int B, int H, int W,
                                             int C, int N, int c_base, int c_take, int P,
                                             float neg_floor, void* stream) {
  return launch<float>(feat, region, src, gate_dt, gate_f32, g, out, scratch, g_gate, B, H, W, C,
                       N, c_base, c_take, P, neg_floor, stream);
}
