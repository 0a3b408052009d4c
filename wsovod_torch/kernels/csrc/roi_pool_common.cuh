// Shared by roi_pool_gated.cu, roi_loop_pool_gated.cu and roi_align_gated.cu:
// the emission modes of the forward pool kernels and the pieces they share.
//
// A pool kernel computes, per ROI and channel, a pooled value v (pre-gate)
// and emits one of (wsovod_tpu/ops/pallas/roi_pool_fused.py::_write_out,
// roi_align_fused.py:192-205):
//
//   kNone    v * gate, rounded to the feature dtype;
//   kMaxabs  the same payload, and per (ROI, chunk) the max of |payload| over
//            its bins and channels (float32), which the int8 fc1 turns into
//            its activation scale without reading the chunk twice (taken
//            from the block's max |v|: payload_maxabs);
//   kInt8    per (ROI, c_tile) m = max |v| over the tile's bins and channels,
//            the payload rint(v * (127 / m)) as int8 (0 where m <= 1e-20),
//            and the scale (gate * m) * (1 / 127): the gate folds into the
//            scale, the payload is gate-free;
//   kTile8   int8 features in, their bin max out as int8 (the chunk was
//            quantized per image beforehand; the scale is the caller's).
//
// The rounding of the int8 modes is the reference's, one IEEE operation at a
// time: 127 / m a correctly rounded division, v * inv a rounded multiply,
// rintf half to even (jnp.round); the __f*_rn intrinsics keep nvcc from
// contracting anything into an FMA.
//
// The block reduction of a max: every thread of the block calls block_max
// with its partial (>= 0); it returns the block's max to every thread. The
// block's size must be a multiple of 32 (full-warp shuffles).
//
// The level-routed mode (kernel 2.5, the pooler of an FPN's several
// levels): each ROI carries the index of its FPN level, and the kernel
// reads that level's map through a small table of per-level base pointers
// and sizes passed by value (Levels). The levels stay separate tensors:
// nothing is concatenated or copied. A ROI of image b on level l reads
// feat[l][b], an [H_l, W_l, C] map.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace roi_pool {

enum Mode { kNone = 0, kMaxabs = 1, kInt8 = 2, kTile8 = 3 };

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static float2 load(const V* p) { return __bfloat1622float2(*p); }
  __device__ static void store(V* p, float a, float b) { *p = __floats2bfloat162_rn(a, b); }
  __device__ static float scalar(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  // the value a store of x writes, read back as float
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

template <>
struct Pair<float> {
  using V = float2;
  __device__ static float2 load(const V* p) { return *p; }
  __device__ static void store(V* p, float a, float b) { *p = make_float2(a, b); }
  __device__ static float scalar(const float* p) { return *p; }
  __device__ static float round(float x) { return x; }
};

template <>
struct Pair<int8_t> {
  using V = char2;
  __device__ static float2 load(const V* p) {
    const char2 v = *p;
    return make_float2((float)v.x, (float)v.y);
  }
  // a and b are integers in [-127, 127] (maxima of int8 values, or 0)
  __device__ static void store(V* p, float a, float b) {
    *p = make_char2((signed char)a, (signed char)b);
  }
};

constexpr int kMaxLevels = 8;

// Per-level maps [B, h[l], w[l], C] of one dtype, passed by value as a kernel
// parameter (__grid_constant__: read from parameter space, never copied).
struct Levels {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// The table of `n` levels from host arrays; false if n is out of range.
inline bool make_levels(Levels& lv, const void* const* feat, const int* h, const int* w, int n) {
  if (n < 1 || n > kMaxLevels) return false;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.feat[l] = l < n ? feat[l] : nullptr;
    lv.h[l] = l < n ? h[l] : 0;
    lv.w[l] = l < n ? w[l] : 0;
  }
  return true;
}

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// Max of v over the block, returned to every thread; `red` is 32 floats of
// shared memory, free again when this returns.
__device__ inline float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  return v;
}

// kMaxabs: max |payload| from the pre-gate max |v| of the block: the float32
// product and the rounding to T are monotone and odd, so max |round(fl(v *
// g))| = round(fl(max |v| * |g|)) exactly, and the walk tracks only max |v|.
template <typename T>
__device__ __forceinline__ float payload_maxabs(float vmax, float g) {
  return Pair<T>::round(vmax * fabsf(g));
}

// The int8 quantization of one (ROI, c_tile): 127 / m, 0 where m <= 1e-20.
__device__ __forceinline__ float quant_inv(float m) {
  return m > 1e-20f ? __fdiv_rn(127.0f, m) : 0.0f;
}

__device__ __forceinline__ char2 quantize(float2 v, float inv) {
  return make_char2((signed char)rintf(__fmul_rn(v.x, inv)),
                    (signed char)rintf(__fmul_rn(v.y, inv)));
}

// The emitted scale of an int8 tile, (gate * m) * (1 / 127) in float32.
__device__ __forceinline__ float quant_scale(float gate, float m) {
  return __fmul_rn(__fmul_rn(gate, m), 1.0f / 127.0f);
}

// Threads of a launch over `pairs` channel pairs: a multiple of 32, at most
// 256.
inline int block_threads(int pairs) {
  const int t = (pairs + 31) / 32 * 32;
  return t < 256 ? t : 256;
}

}  // namespace roi_pool
