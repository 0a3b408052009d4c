// Backward of the gated, branch-routed ROIAlign over one channel chunk, for
// Hopper (sm_90a).
//
// Replaces the backward of the TPU kernels' differentiable wrappers:
// wsovod_tpu/ops/pallas/roi_align_fused.py roi_align_fused_ad (_fused_ad_bwd,
// the linear transpose of the gather-path ROIAlign times the gate) and, with
// a per-ROI source copy, wsovod_tpu/ops/pallas/roi_align_kernel.py
// roi_align_pallas_exact_ad (_ra_exact_bwd, the gather path's VJP per branch
// copy, through the MRRP pooler's branch select). Given the forward's
//
//   out[b, n, ph, pw, c] = gate[b, n] / s^2 * sum_{samples, corners} wy * wx * feat[copy, y, x, c]
//
// (roi_align_gated.cu; copy = src ? src[b, n] : b) and its cotangent g of the
// same shape, it computes
//
//   g_gate[b, n]           = sum_{ph, pw, c} g * out / gate   where |gate| > 1e-8, else 0
//   g_feat[copy, y, x, c] += wy * wx * (g[b, n, ph, pw, c] * gate[b, n] / s^2)
//
// the second for each of every in-range sample's four corners (the weights
// of an out-of-range sample are zero and it adds nothing). The operation is
// linear in feat, so the feature is not read. Overlapping samples, bins and
// ROIs add onto one pixel, so the feature cotangent is accumulated with
// float32 atomics into a zeroed float32 scratch [S, H, W, c_take] over every
// feature copy, which the wrapper casts to the feature dtype: the result
// equals the plain version to float tolerance, not bit for bit (the order of
// the adds varies from run to run). Each ROI adds into its own copy's
// scratch, so nothing is sorted by branch. Each block builds its ROI's sample
// metadata as the forward does (roi_align_common.cuh).
//
// Design (first, simple version, as the forward): one block per (ROI,
// image), the ROI's metadata built in shared memory, each thread owns two
// adjacent channels and adds both with one 8-byte float2 atomic (sm_90) per
// corner of nonzero weight. g_gate is a block reduction of g * out over the ROI's
// bins and channels. What bounds it: the float32 atomics, 4 s^2 per bin and
// channel pair (about 2 G float2 atomics per 512-channel chunk at B = 4,
// 5024 ROIs per image, s = 2), against the bytes of the cotangent and the
// scratch.

#include "roi_align_common.cuh"

namespace {

using roi_align::Pair;

template <typename T>
__global__ void roi_align_gated_bwd_kernel(const float* __restrict__ rois,
                                           const int* __restrict__ src,
                                           const float* __restrict__ gate,
                                           const T* __restrict__ g, const T* __restrict__ out,
                                           float* __restrict__ scratch, float* __restrict__ g_gate,
                                           int H, int W, int N, int c_take, int P, int s,
                                           int aligned, float scale) {
  using V = typename Pair<T>::V;
  extern __shared__ unsigned char smem[];
  const int K = P * s;
  int* sidx = reinterpret_cast<int*>(smem);
  float* swt = reinterpret_cast<float*>(smem) + 4 * K;
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * N + n;
  const int pairs = c_take / 2;
  const V* gr = reinterpret_cast<const V*>(g + roi * P * P * c_take);
  const float gt = gate[roi];

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
      float sum = 0.0f;
      for (int i = 0; i < (int)((blockDim.x + 31) >> 5); ++i) sum += part[i];
      g_gate[roi] = fabsf(gt) > 1e-8f ? sum / gt : 0.0f;
    }
  }
  if (scratch == nullptr || gt == 0.0f) return;  // a gate of 0 sends nothing to the feature

  roi_align::build_meta(rois + roi * 4, scale, aligned, 0, H, W, P, s, sidx, swt);
  __syncthreads();
  const int copy = src != nullptr ? src[roi] : b;
  float* sb = scratch + (size_t)copy * H * W * c_take;
  const float gain = __fmul_rn(gt, 1.0f / (float)(s * s));
  const int* yi = sidx;
  const int* xi = sidx + 2 * K;
  const float* yw = swt;
  const float* xw = swt + 2 * K;

  for (int cp = threadIdx.x; cp < pairs; cp += blockDim.x) {
    for (int ph = 0; ph < P; ++ph) {
      for (int pw = 0; pw < P; ++pw) {
        const float2 gv = Pair<T>::load(gr + (size_t)(ph * P + pw) * pairs + cp);
        const float t0 = gv.x * gain, t1 = gv.y * gain;
        if (t0 == 0.0f && t1 == 0.0f) continue;
        for (int sy = 0; sy < s; ++sy) {
          const int ky = 2 * (ph * s + sy);
          for (int sx = 0; sx < s; ++sx) {
            const int kx = 2 * (pw * s + sx);
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const size_t row = (size_t)yi[ky + a] * W;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float w = __fmul_rn(yw[ky + a], xw[kx + e]);
                if (w == 0.0f) continue;
                float2* dst = reinterpret_cast<float2*>(sb + (row + xi[kx + e]) * c_take + 2 * cp);
                atomicAdd(dst, make_float2(w * t0, w * t1));
              }
            }
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* rois, const void* src, const void* gate, const void* g, const void* out,
           void* scratch, void* g_gate, int B, int H, int W, int N, int c_take, int P, int s,
           int aligned, float scale, void* stream) {
  if (B == 0 || N == 0 || c_take == 0) return 0;
  const int pairs = c_take / 2;
  int threads = pairs < 256 ? pairs : 256;
  threads = (threads + 31) / 32 * 32;  // whole warps for the g_gate reduction
  const size_t shmem = (size_t)4 * P * s * (sizeof(int) + sizeof(float));
  const dim3 grid(N, B);
  roi_align_gated_bwd_kernel<T><<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rois), static_cast<const int*>(src),
      static_cast<const float*>(gate), static_cast<const T*>(g), static_cast<const T*>(out),
      static_cast<float*>(scratch), static_cast<float*>(g_gate), H, W, N, c_take, P, s, aligned,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers: rois
// float32 [B, N, 4], `aligned` and `scale` as roi_align_gated.cu; src int32
// [B, N] in [0, S), or null (ROI n of image b reads copy b, S = B); gate
// float32 [B, N]; g and out [B, N, P, P, c_take] in the feature dtype. `out`
// and `g_gate` [B, N] float32 are both null or both set (the gate
// cotangent); `scratch` float32 [S, H, W, c_take], zeroed, is null when the
// feature cotangent is not wanted. c_take must be even. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wsovod_roi_align_gated_bwd_bf16(const void* rois, const void* src, const void* gate,
                                               const void* g, const void* out, void* scratch,
                                               void* g_gate, int B, int H, int W, int N,
                                               int c_take, int P, int s, int aligned, float scale,
                                               void* stream) {
  return launch<__nv_bfloat16>(rois, src, gate, g, out, scratch, g_gate, B, H, W, N, c_take, P, s,
                               aligned, scale, stream);
}

extern "C" int wsovod_roi_align_gated_bwd_f32(const void* rois, const void* src, const void* gate,
                                              const void* g, const void* out, void* scratch,
                                              void* g_gate, int B, int H, int W, int N, int c_take,
                                              int P, int s, int aligned, float scale,
                                              void* stream) {
  return launch<float>(rois, src, gate, g, out, scratch, g_gate, B, H, W, N, c_take, P, s, aligned,
                       scale, stream);
}
