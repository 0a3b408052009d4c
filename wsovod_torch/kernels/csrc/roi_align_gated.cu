// Gated, branch-routed ROIAlign over one channel chunk, for Hopper (sm_90a).
//
// Replaces three TPU kernels, which compute the same function on different
// schedules (and, with an int8 payload, roi_align_fused_batched's
// quant="int8" emission, below):
// * wsovod_tpu/ops/pallas/roi_align_fused.py roi_align_fused_batched: exact
//   ROIAlignV2 of every ROI of every image, gate folded in (the plain
//   single-level ROIAlignV2 pooler);
// * wsovod_tpu/ops/pallas/roi_align_kernel.py roi_align_pallas_ab (through
//   roi_align_pallas_exact): the same, per image and ungated; the JAX
//   package pools every MRRP branch copy with it and keeps each ROI's
//   branch, which a per-ROI source copy does here in one pass;
// * the same file's roi_align_pallas (TPU.ROI_ALIGN_KERNEL = "pallas_approx"):
//   its window resamples and clamps the sample grid, which changes only the
//   sample metadata each block builds, not the gather.
//
// For every image b and ROI n it computes
//
//   out[b, n, ph, pw, c] = gate[b, n] * (1 / s^2) * sum_{sy, sx < s} sum_{corners}
//                          wy * wx * feat[copy, y, x, c_base + c],   copy = src ? src[b, n] : b
//
// with wsovod_tpu/ops/roi_pool.py::roi_align's semantics. Each block first
// builds its ROI's sample metadata in shared memory (roi_align_common.cuh:
// per sample row k = ph * s + sy its two corner rows and weights, zero where
// the sample is out of range, the same per sample column; with a window,
// 2.8's resample-and-clamp). Then the weights of a sample's four corners are
// products wy * wx, its value their blend in the reference's corner order,
// the s * s samples of a bin summed in float32, multiplied by the float32 1 /
// s^2 (as XLA compiles the reference's division by s * s) and by the float32
// gate; the output is rounded once to the feature dtype. The JAX gather path
// in bfloat16 rounds at every step instead; the TPU kernels, as here, sum in
// float32.
//
// Layout: feat is NHWC [S, H, W, C] (S copies: B, or the MRRP branch-major
// concat n_br * B); out is [B, N, P, P, c_take], the layout the DAN's
// chunked fc1 reads as [B*N, P*P*c_take] with no relayout. Nothing is sorted
// by branch.
//
// quant="int8" (roi_align_fused.py:192-205; roi_pool_common.cuh's kInt8):
// per (ROI, c_tile) m = max |acc| of the raw float32 sums acc (before 1 / s^2
// and the gate), the int8 payload rint(acc * (127 / m)), and the scale ((gate
// * (1 / s^2)) * m) * (1 / 127). The block keeps the tile's sums in shared
// memory until m is known. Its sums are taken with __fmul_rn / __fadd_rn in
// the plain version's order (the four corner terms of a sample, then the
// samples in order), so no FMA moves an acc by an ulp across a rounding tie:
// the payload equals the plain version's bit for bit.
//
// Design (first, simple version): one block per (ROI, image); 2 K threads
// (K = P * s) build the ROI's metadata, then each thread owns two adjacent
// channels (one 4-byte bf16x2 or 8-byte float2 load per corner, so a warp
// reads 128 or 256 contiguous bytes of one feature pixel). What bounds it:
// bytes read, 4 s^2 corner pixels per bin and channel (about 0.8 MB per ROI
// per 512-channel bf16 chunk at s = 2), most from the 50 MB L2 since one
// image's chunk is 11.6 MB at res5; the output write is the only traffic
// device memory must carry. TPU size buckets, one-hot matrices and DMA
// windows have no role here; 2.8's window survives only as arithmetic.

#include "roi_align_common.cuh"
#include "roi_pool_common.cuh"

namespace {

using roi_align::Pair;

template <typename T, bool INT8>
__global__ void roi_align_gated_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                                       const int* __restrict__ src,
                                       const float* __restrict__ gate, void* __restrict__ out,
                                       float* __restrict__ scales, int H, int W, int C, int N,
                                       int c_base, int c_take, int c_tile, int P, int s,
                                       int aligned, int window, float scale) {
  using V = typename Pair<T>::V;
  extern __shared__ unsigned char smem[];
  __shared__ float red[32];
  const int K = P * s;
  // [2 axes][K][lo, hi]: corner indices, then their weights; with INT8 then
  // the tile's raw sums [P * P][c_tile / 2]
  int* sidx = reinterpret_cast<int*>(smem);
  float* swt = reinterpret_cast<float*>(smem) + 4 * K;
  float2* stash = reinterpret_cast<float2*>(swt + 4 * K);
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * N + n;
  roi_align::build_meta(rois + roi * 4, scale, aligned, window, H, W, P, s, sidx, swt);
  __syncthreads();
  const float g = gate[roi];
  const int copy = src != nullptr ? src[roi] : b;
  const V* fb = reinterpret_cast<const V*>(feat + (size_t)copy * H * W * C + c_base);
  const int pairs = c_take / 2;
  const int pix_pairs = C / 2;
  const float inv = 1.0f / (float)(s * s);  // the reference's 1 / s^2, rounded to float32
  const int* yi = sidx;
  const int* xi = sidx + 2 * K;
  const float* yw = swt;
  const float* xw = swt + 2 * K;

  // the raw sum of bin (ph, pw) over its s * s samples for channel pair cp
  auto sample_sum = [&](int cp, int ph, int pw) -> float2 {
    const V* fc = fb + cp;
    float a0 = 0.0f, a1 = 0.0f;
    for (int sy = 0; sy < s; ++sy) {
      const int ky = 2 * (ph * s + sy);
      for (int sx = 0; sx < s; ++sx) {
        const int kx = 2 * (pw * s + sx);
        float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const size_t row = (size_t)yi[ky + a] * W;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w = __fmul_rn(yw[ky + a], xw[kx + e]);
            const float2 f = Pair<T>::load(fc + (row + xi[kx + e]) * pix_pairs);
            if constexpr (INT8) {
              v0 = __fadd_rn(v0, __fmul_rn(f.x, w));
              v1 = __fadd_rn(v1, __fmul_rn(f.y, w));
            } else {
              v0 += f.x * w;
              v1 += f.y * w;
            }
          }
        }
        if constexpr (INT8) {
          a0 = __fadd_rn(a0, v0);
          a1 = __fadd_rn(a1, v1);
        } else {
          a0 += v0;
          a1 += v1;
        }
      }
    }
    return make_float2(a0, a1);
  };

  if constexpr (INT8) {
    char2* ob = static_cast<char2*>(out) + roi * P * P * pairs;
    const int tile_pairs = c_tile / 2;
    const int n_ct = c_take / c_tile;
    const float scale_out = __fmul_rn(g, inv);
    for (int t = 0; t < n_ct; ++t) {
      float amax = 0.0f;
      for (int j = threadIdx.x; j < tile_pairs; j += blockDim.x) {
        for (int bin = 0; bin < P * P; ++bin) {
          const float2 v = sample_sum(t * tile_pairs + j, bin / P, bin % P);
          stash[bin * tile_pairs + j] = v;
          amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
        }
      }
      const float m = roi_pool::block_max(amax, red);  // also orders the stash's writes
      const float qinv = roi_pool::quant_inv(m);
      for (int j = threadIdx.x; j < tile_pairs; j += blockDim.x) {
        for (int bin = 0; bin < P * P; ++bin) {
          ob[(size_t)bin * pairs + t * tile_pairs + j] =
              roi_pool::quantize(stash[bin * tile_pairs + j], qinv);
        }
      }
      if (threadIdx.x == 0)
        scales[((size_t)b * n_ct + t) * N + n] = roi_pool::quant_scale(scale_out, m);
      __syncthreads();  // the next tile rewrites the stash
    }
  } else {
    V* ob = static_cast<V*>(out) + roi * P * P * pairs;
    for (int cp = threadIdx.x; cp < pairs; cp += blockDim.x) {
      for (int ph = 0; ph < P; ++ph) {
        for (int pw = 0; pw < P; ++pw) {
          const float2 a = sample_sum(cp, ph, pw);
          Pair<T>::store(ob + (size_t)(ph * P + pw) * pairs + cp,
                         __fmul_rn(__fmul_rn(a.x, inv), g), __fmul_rn(__fmul_rn(a.y, inv), g));
        }
      }
    }
  }
}

template <typename T, bool INT8>
int launch(const void* feat, const void* rois, const void* src, const void* gate, void* out,
           void* scales, int B, int H, int W, int C, int N, int c_base, int c_take, int c_tile,
           int P, int s, int aligned, int window, float scale, void* stream) {
  if (B == 0 || N == 0 || c_take == 0) return 0;
  auto kernel = roi_align_gated_kernel<T, INT8>;
  const int pairs = c_take / 2;
  int threads = pairs < 256 ? pairs : 256;
  size_t shmem = (size_t)4 * P * s * (sizeof(int) + sizeof(float));
  if (INT8) {
    threads = roi_pool::block_threads(c_tile / 2);
    shmem += (size_t)P * P * c_tile / 2 * sizeof(float2);
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(N, B);
  kernel<<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois), static_cast<const int*>(src),
      static_cast<const float*>(gate), out, static_cast<float*>(scales), H, W, C, N, c_base,
      c_take, c_tile, P, s, aligned, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers: feat [S, H,
// W, C]; rois float32 [B, N, 4] (x1, y1, x2, y2 in image coordinates, scaled
// by `scale`); src int32 [B, N] in [0, S), or null (ROI n of image b reads
// copy b); gate float32 [B, N]; out [B, N, P, P, c_take]. `aligned` nonzero
// takes the 0.5 offset (ROIAlignV2); `window` > 0 is 2.8's window size, 0
// the exact align. c_base, c_take and C must be even. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wsovod_roi_align_gated_bf16(const void* feat, const void* rois, const void* src,
                                           const void* gate, void* out, int B, int H, int W, int C,
                                           int N, int c_base, int c_take, int P, int s,
                                           int aligned, int window, float scale, void* stream) {
  return launch<__nv_bfloat16, false>(feat, rois, src, gate, out, nullptr, B, H, W, C, N, c_base,
                                      c_take, c_take, P, s, aligned, window, scale, stream);
}

extern "C" int wsovod_roi_align_gated_f32(const void* feat, const void* rois, const void* src,
                                          const void* gate, void* out, int B, int H, int W, int C,
                                          int N, int c_base, int c_take, int P, int s, int aligned,
                                          int window, float scale, void* stream) {
  return launch<float, false>(feat, rois, src, gate, out, nullptr, B, H, W, C, N, c_base, c_take,
                              c_take, P, s, aligned, window, scale, stream);
}

// quant="int8": as above with `out` int8 and `scales` float32 [B, c_take /
// c_tile, N]; c_tile even and dividing c_take.
extern "C" int wsovod_roi_align_gated_int8_bf16(const void* feat, const void* rois,
                                                const void* src, const void* gate, void* out,
                                                void* scales, int B, int H, int W, int C, int N,
                                                int c_base, int c_take, int c_tile, int P, int s,
                                                int aligned, int window, float scale,
                                                void* stream) {
  return launch<__nv_bfloat16, true>(feat, rois, src, gate, out, scales, B, H, W, C, N, c_base,
                                     c_take, c_tile, P, s, aligned, window, scale, stream);
}

extern "C" int wsovod_roi_align_gated_int8_f32(const void* feat, const void* rois,
                                               const void* src, const void* gate, void* out,
                                               void* scales, int B, int H, int W, int C, int N,
                                               int c_base, int c_take, int c_tile, int P, int s,
                                               int aligned, int window, float scale,
                                               void* stream) {
  return launch<float, true>(feat, rois, src, gate, out, scales, B, H, W, C, N, c_base, c_take,
                             c_tile, P, s, aligned, window, scale, stream);
}
