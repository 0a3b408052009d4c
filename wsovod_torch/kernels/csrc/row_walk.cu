// Row walk of ROI bins over one map resident in L2, bfloat16 or int8 widened
// to bfloat16 on load, for Hopper (sm_90a): a microbenchmark of the pool
// kernels' load path, on no model path.
//
// Replaces the TPU kernel scripts/bench_i8walk.py build(dtype, win) (its
// pallas_call, :80), which asks what a stage-A row walk costs from bfloat16
// tiles against int8 tiles widened to bfloat16, over the full row or a 48- or
// 96-wide window. It computes, for ROI q in [0, n_roi) and bin ph in [0,
// bins), k = q * bins + ph (on the TPU q = i * RB + r for grid step i and ROI
// r of the step),
//
//   bin(k)[x, c] = max(bf16(-3e38), max over t < rows of bf16(feat[hlo[k] + t, x0[k] + x, c]))
//
// for x < wd and every channel c, where wd is the window (x0[k] in [0, W -
// wd]) or, with `full`, the whole row (wd = W, x0 unread); and returns out[ph]
// = bin((n_roi - 1) * bins + ph), since on the TPU every bin overwrites its
// slot of the one output block that all grid steps share.
//
// Where the map lives: the TPU kernel copies the whole [H, W, C] map into
// VMEM once and walks it there. At the script's shapes (86 x 136 x 512) the
// map is 12 MB in bfloat16 and 6 MB in int8: too large for a block's 227 KB
// of shared memory, well inside the H100's 50 MB L2. So this kernel walks
// the map from global memory, where it stays in L2 once the first call has
// read it (the measured calls are warm).
//
// Design (first, simple version): one block per ROI (5024 at the script's
// shapes), its bins in turn. A bin's row feat[h, x0:x0+wd, :] is one
// contiguous span of wd * C elements. Each thread owns 16-byte vectors of the
// span (8 bfloat16, or 16 int8 widened to two vectors of 8 bfloat16 as they
// are loaded, exactly: every int8 is a bfloat16) and keeps their running max
// in registers over the rows with __hmax2.
//
// Every bin is stored. The result holds only the last ROI's bins; a kernel
// that stored only those would let nvcc sink every other block's loads into a
// branch that never runs. So every block stores its bins unconditionally, as
// the TPU kernel stores every bin into its VMEM output block: the last ROI's
// into out, every other ROI's into one of n_slots scratch copies of the
// output after it (their contents are unspecified). No other block writes
// out, so the result is deterministic. A bin's store is 1/rows of its reads
// in bfloat16 (2/rows from int8), into slots that stay in L2.
//
// What bounds it: the compares, n_roi * bins * rows * wd * C: at the
// script's shapes 7.35 G over the full row (0.110 ms at 67 TFLOP/s of
// float32 operations) and 2.59 G over 48 columns (0.039 ms); the map's bytes
// read once are fewer (12 MB, 0.004 ms at 3.35 TB/s). What it meets in
// practice is the L2's read rate for the walked bytes, compares x the
// element size (14.7 GB over bfloat16 full rows, 7.3 GB over int8).

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t hmax2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

__device__ __forceinline__ uint4 hmax8(uint4 a, uint4 b) {
  return make_uint4(hmax2(a.x, b.x), hmax2(a.y, b.y), hmax2(a.z, b.z), hmax2(a.w, b.w));
}

// int8 lanes 2j and 2j + 1 of `w` (little-endian) as a bfloat16 pair, exactly
__device__ __forceinline__ uint32_t widen2(uint32_t w, int j) {
  const float lo = static_cast<float>(static_cast<int8_t>(w >> (16 * j)));
  const float hi = static_cast<float>(static_cast<int8_t>(w >> (16 * j + 8)));
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Walk(T): the 16-byte input vector type's output (one or two bfloat16
// vectors of 8) and how a loaded vector folds into the running max
template <typename T>
struct Walk;

template <>
struct Walk<__nv_bfloat16> {
  static constexpr int kOut = 1;  // output vectors per input vector
  __device__ static void fold(uint4 (&acc)[1], uint4 v) { acc[0] = hmax8(acc[0], v); }
};

template <>
struct Walk<int8_t> {
  static constexpr int kOut = 2;
  __device__ static void fold(uint4 (&acc)[2], uint4 v) {
    acc[0] = hmax8(acc[0], make_uint4(widen2(v.x, 0), widen2(v.x, 1), widen2(v.y, 0),
                                      widen2(v.y, 1)));
    acc[1] = hmax8(acc[1], make_uint4(widen2(v.z, 0), widen2(v.z, 1), widen2(v.w, 0),
                                      widen2(v.w, 1)));
  }
};

// grid (n_roi); feat [H, W, C] as 16-byte vectors of T; hlo, x0 int32
// [n_roi * bins]; out [1 + n_slots, bins, wd, C] bfloat16 as 16-byte vectors
template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_walk_kernel(const uint4* __restrict__ feat, const int* __restrict__ hlo,
                    const int* __restrict__ x0, uint4* __restrict__ out, int H, int W, int C,
                    int rows, int bins, int wd, int full, int n_roi, int n_slots) {
  constexpr int kPer = 16 / sizeof(T);  // input elements per vector
  constexpr int kOut = Walk<T>::kOut;
  const int q = blockIdx.x;
  const int c_vecs = C / kPer;
  const size_t row_vecs = (size_t)W * c_vecs;  // one map row, input vectors
  const int span = wd * c_vecs;                // one bin row, input vectors
  const __nv_bfloat162 neg2 = __bfloat162bfloat162(__float2bfloat16_rn(-3e38f));
  const uint32_t neg = *reinterpret_cast<const uint32_t*>(&neg2);
  const int slot = q == n_roi - 1 ? 0 : 1 + q % n_slots;
  for (int ph = 0; ph < bins; ++ph) {
    const int k = q * bins + ph;
    const int h = hlo[k];
    const int x = full ? 0 : x0[k];
    assert(h >= 0 && h <= H - rows && x >= 0 && x <= W - wd);
    const uint4* src = feat + h * row_vecs + (size_t)x * c_vecs;
    uint4* dst = out + ((size_t)slot * bins + ph) * span * kOut;
    for (int v = threadIdx.x; v < span; v += kThreads) {
      uint4 acc[kOut];
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[j] = make_uint4(neg, neg, neg, neg);
      const uint4* p = src + v;
#pragma unroll 3
      for (int t = 0; t < rows; ++t) Walk<T>::fold(acc, __ldg(p + t * row_vecs));
#pragma unroll
      for (int j = 0; j < kOut; ++j) dst[v * kOut + j] = acc[j];
    }
  }
}

template <typename T>
int launch(const void* feat, const void* hlo, const void* x0, void* out, int H, int W, int C,
           int rows, int bins, int wd, int full, int n_roi, int n_slots, void* stream) {
  if (n_roi == 0 || bins == 0) return 0;
  row_walk_kernel<T><<<n_roi, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(feat), static_cast<const int*>(hlo), static_cast<const int*>(x0),
      static_cast<uint4*>(out), H, W, C, rows, bins, wd, full, n_roi, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers: `feat` a
// contiguous [H, W, C] map, 16-byte aligned, with C * sizeof(T) a multiple of
// 16; `hlo` and `x0` int32 [n_roi * bins], each hlo in [0, H - rows] and,
// unless `full`, each x0 in [0, W - wd] (a device-side assert checks both);
// `out` bfloat16 [1 + n_slots, bins, wd, C] (copies 1.. are scratch, n_slots
// >= 1), wd = W with `full`. Each returns the cudaError_t of the launch (0 on
// success).
extern "C" int wsovod_row_walk_bf16(const void* feat, const void* hlo, const void* x0, void* out,
                                    int H, int W, int C, int rows, int bins, int wd, int full,
                                    int n_roi, int n_slots, void* stream) {
  return launch<__nv_bfloat16>(feat, hlo, x0, out, H, W, C, rows, bins, wd, full, n_roi, n_slots,
                               stream);
}

extern "C" int wsovod_row_walk_i8(const void* feat, const void* hlo, const void* x0, void* out,
                                  int H, int W, int C, int rows, int bins, int wd, int full,
                                  int n_roi, int n_slots, void* stream) {
  return launch<int8_t>(feat, hlo, x0, out, H, W, C, rows, bins, wd, full, n_roi, n_slots, stream);
}
