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
// What bounds it: the bytes of the three-row cotangent and of the feature
// chunks read once, the float32 scratch written once (about 3.6 GB at the
// MRRP training shape, [12, 100, 152, 2048] bf16 with 5024 ROIs per image,
// 1.07 ms on an H100), against a max and a tie test per visited pixel and
// channel of every set (91 G operations, 1.36 ms). The first version (one
// block of 256 threads per ROI in ROI order; one walk of each bin for the
// sets' maxima, a second over every row to count tied columns, a third
// over the tied rows adding each lane's share with an atomic per pixel)
// took 744 ms there on an H100, 136 of them in the walks: its 1.1 G
// float32 atomics cost the rest. Not by their number (a map with dead
// areas, 8.9 G atomics, took the same time) nor by hot addresses (H100
// takes 63 G scattered atomics/s onto 256 addresses, 88 G/s into 4-32 MB)
// but by where they sat: in the third walk's loop, beside its loads, where
// nvcc issues no load past an atomic early and each pixel waits for its
// load. Taking them out of every loop that loads is what moved the time.
//
// Design, by those findings (each measured on an H100 at that shape):
// * Atomics in lock step, none in a loop that loads: after the walk, the
//   warp reads again each row of the bin that lies within some lane's tied
//   rows, marks each set's columns equal to its max, and then visits every
//   column, each lane adding its two channels' shares at that pixel with
//   one float2 atomic, shares of several sets on one pixel summed first; a
//   warp's atomics at a pixel fall in one 256-byte run of the scratch. Each
//   lane adding at its own pixels instead (its tied columns one by one)
//   took 2.9 s. Bins wider than 32 columns (a row's mask) count each row's
//   tied columns, then add while reading it again.
// * One walk of each bin for the sets' maxima and tied rows, then a second
//   read of the rows from a set's first tied row to its last: with a unique
//   max, one row. Not used: keeping the tied columns of the first two tied
//   rows as masks, so that most sets need no second read, nor adding an
//   even share without reading where a set ties over its whole area (a
//   dead area at 0). Both cost registers and spills, and the kernel runs
//   faster without them: 80.4 ms against 104.0 on a random post-ReLU map
//   and 77.0 against 91.9 on one with dead areas (switched off but left in
//   the source: 88.2 and 85.3; the masks alone off: 90.9 and 81.4; the
//   even shares alone off: 98.0 and 93.8). The atomics are the same 1.04 G
//   float2 a call on the random map (4.78 G on the other) in every form.
// * Occupancy: the walk waits on loads, and the registers decide how many
//   warps hide that. Each grid of bins is a kernel of its own (the ROI's
//   with its one or three sets, the outer box's with two), held to 80
//   registers for three blocks of 256 threads an SM (in the form with
//   masks: 103 ms against 183 with both grids in one kernel at 128
//   registers and two blocks; without them 72-80 registers and no spills
//   either way, 80.4 ms against 80.9 without the bound of three blocks).
//   The context's walk skips the pixels inside its hole, in neither set.
// * ROI order, for the L2: the wrapper sorts the ROIs by feature copy and
//   by the top-left of their region, those of gate 0 last and past n_live,
//   where no block works; blocks in flight then share one copy's
//   neighbourhood in the L2 (in the form with masks: 103 ms against 115
//   in the ROIs' own order).
// * The gate cotangent is a second, small kernel (one block per ROI).
// Not used either: a difference buffer for the dead areas' shares (the
// dead-area map, 4.8 G float2 atomics a call against 1.0 G, takes less
// time than the random one), combining shares in shared memory, and
// narrower channel slices per block, so that the scatter of the copies in
// flight fits the L2 (128 channels: no faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlicePairs = 256;  // channel pairs per block of the feature cotangent

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

// The max of one channel over a set's rows walked so far, as jnp.max's VJP
// splits it: its value, its tied rows, and the first tied row and the last
// (packed two to an int: registers bound the walk). A constructor, not
// default member initializers: with `float m = -INFINITY;` nvcc 12.8
// (-O3, sm_90a) starts the maxima of sets 1 and 2 in both hollow kernels
// at 0.0 (SASS `CS2R Rn, SRZ` where this form loads 0xff800000), and a set
// of negative pixels then takes 0 as its max (the card test fails).
struct SetMax {
  float m;
  int n, fl;  // tied rows; first | last << 16
  __device__ SetMax() : m(-INFINITY), n(0), fl(0) {}
  __device__ bool spans(int h) const { return h >= (fl & 0xffff) && h <= (fl >> 16); }
  __device__ void take(float r, int h) {
    if (r > m) {
      m = r;
      n = 1;
      fl = h | h << 16;
    } else if (r == m) {
      ++n;
      fl = (fl & 0xffff) | h << 16;
    }
  }
};

// One bin [hlo, hhi) x [wlo, whi) of a region and the open interior (hx1,
// hx2) x (hy1, hy2) of its hole. Set 0 is the whole bin (the ROI row); set 1
// its rows x its columns outside the hole's column interior, set 2 its rows
// outside the hole's row interior x its columns (the frame's or the
// context's two sets). An empty interior (hx2 <= hx1 + 1) takes nothing out.
struct Bin {
  int hlo, hhi, wlo, whi, hx1, hx2, hy1, hy2;
  __device__ bool col_in_set1(int w) const { return w <= hx1 || w >= hx2; }
  __device__ bool row_in_set2(int h) const { return h <= hy1 || h >= hy2; }
  __device__ int set1_cols() const {
    return (whi - wlo) - max(0, min(whi, hx2) - max(wlo, hx1 + 1));
  }
};

// Adds channel pair (a, b) at one pixel of the float32 scratch.
__device__ __forceinline__ void add_pair(float* px, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(px), make_float2(a, b));
}

// The backward of one bin for one channel pair: set 0 with cotangent share
// w0 (kRoi), sets 1 and 2 with wh (kHollow). fc and sb point at the
// thread's channel pair of the copy's features and scratch; `lanes` the
// warp's lanes that work, all of which call it for the bin.
template <typename T, bool kRoi, bool kHollow>
__device__ __forceinline__ void bin_backward(const typename Pair<T>::V* fc, float* sb,
                                             size_t row_pairs, int pix_pairs, int W, int c_take,
                                             const Bin& bn, float2 w0, float2 wh, float neg_floor,
                                             unsigned lanes) {
  using V = typename Pair<T>::V;
  constexpr int kSets = 3;
  const int bw = bn.whi - bn.wlo;
  const int cols1 = kHollow ? bn.set1_cols() : 0;

  // the walk: each set's max and tied rows, per channel. Set 1 takes the
  // row's max when it holds every column; without the ROI row, a row
  // outside set 2 is walked only on set 1's columns (left and right of the
  // hole; the two spans may overlap when the hole is empty, which the max
  // does not mind), and not at all when set 1 has none.
  const bool all1 = cols1 == bw;
  const int left_end = min(bn.whi, bn.hx1 + 1), right_start = max(bn.wlo, bn.hx2);
  SetMax st[kSets][2];
  for (int h = bn.hlo; h < bn.hhi; ++h) {
    const V* row = fc + h * row_pairs;
    const bool in2 = kHollow && bn.row_in_set2(h);
    float all[2] = {-INFINITY, -INFINITY}, in1[2] = {-INFINITY, -INFINITY};
    if (kRoi || in2) {
#pragma unroll 4
      for (int w = bn.wlo; w < bn.whi; ++w) {
        const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
        all[0] = fmaxf(all[0], v.x);
        all[1] = fmaxf(all[1], v.y);
        if (kHollow && !all1 && bn.col_in_set1(w)) {
          in1[0] = fmaxf(in1[0], v.x);
          in1[1] = fmaxf(in1[1], v.y);
        }
      }
    } else {
      if (cols1 == 0) continue;  // no pixel of this row is in a set
#pragma unroll 4
      for (int w = bn.wlo; w < left_end; ++w) {
        const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
        in1[0] = fmaxf(in1[0], v.x);
        in1[1] = fmaxf(in1[1], v.y);
      }
#pragma unroll 4
      for (int w = right_start; w < bn.whi; ++w) {
        const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
        in1[0] = fmaxf(in1[0], v.x);
        in1[1] = fmaxf(in1[1], v.y);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (kRoi) st[0][k].take(all[k], h);
      if (kHollow) {
        if (cols1 > 0) st[1][k].take(all1 && (kRoi || in2) ? all[k] : in1[k], h);
        if (in2) st[2][k].take(all[k], h);
      }
    }
  }

  // each set's share of the cotangent, divided by its tied rows
  const float w0k[2] = {w0.x, w0.y}, whk[2] = {wh.x, wh.y};
  float t[kSets][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (kRoi && st[0][k].n && st[0][k].m > neg_floor)
      t[0][k] = w0k[k] * share(st[0][k].m, 0.0f) / (float)st[0][k].n;
    if (kHollow) {
      const float wk = whk[k] * share(fmaxf(st[1][k].m, st[2][k].m), 0.0f);
      if (st[1][k].n) t[1][k] = wk * share(st[1][k].m, st[2][k].m) / (float)st[1][k].n;
      if (st[2][k].n) t[2][k] = wk * share(st[2][k].m, st[1][k].m) / (float)st[2][k].n;
    }
  }

  // The adds, in lock step: the warp reads again each row of the bin that
  // lies between some lane's first and last tied row of a set with a share,
  // marks each set's columns equal to its max, and then visits every column,
  // each lane adding its two channels' shares at that pixel with one float2
  // atomic, so that the warp's atomics at a pixel fall in one 256-byte run
  // of the scratch, and no atomic sits in a loop that loads (nvcc issues no
  // load past an atomic early, and each load's latency would add up). A row
  // outside a set's tied rows holds no pixel equal to its max.
  for (int h = bn.hlo; h < bn.hhi; ++h) {
    const bool in2 = kHollow && bn.row_in_set2(h);
    bool read = false;
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
#pragma unroll
      for (int k = 0; k < 2; ++k) read |= t[s][k] != 0.0f && st[s][k].spans(h);
    }
    if (!__any_sync(lanes, read)) continue;
    const V* row = fc + h * row_pairs;
    float* srow = sb + ((size_t)h * W + bn.wlo) * c_take;
    if (bw > 32) {  // wider than a mask: count the tied columns, then add while reading
      int c[kSets][2] = {{0, 0}, {0, 0}, {0, 0}};
      for (int w = bn.wlo; w < bn.whi; ++w) {
        const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
        const float vk[2] = {v.x, v.y};
        const bool in1 = kHollow && bn.col_in_set1(w);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          c[0][k] += vk[k] == st[0][k].m;
          c[1][k] += in1 && vk[k] == st[1][k].m;
          c[2][k] += in2 && vk[k] == st[2][k].m;
        }
      }
      float a[kSets][2];
#pragma unroll
      for (int s = 0; s < kSets; ++s) {
#pragma unroll
        for (int k = 0; k < 2; ++k) a[s][k] = c[s][k] ? t[s][k] / (float)c[s][k] : 0.0f;
      }
      for (int w = bn.wlo; w < bn.whi; ++w) {
        const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
        const bool in1 = kHollow && bn.col_in_set1(w);
        const float x = (v.x == st[0][0].m ? a[0][0] : 0.0f) +
                        (in1 && v.x == st[1][0].m ? a[1][0] : 0.0f) +
                        (in2 && v.x == st[2][0].m ? a[2][0] : 0.0f);
        const float y = (v.y == st[0][1].m ? a[0][1] : 0.0f) +
                        (in1 && v.y == st[1][1].m ? a[1][1] : 0.0f) +
                        (in2 && v.y == st[2][1].m ? a[2][1] : 0.0f);
        if (x != 0.0f || y != 0.0f) add_pair(srow + (size_t)(w - bn.wlo) * c_take, x, y);
      }
      continue;
    }
    // each set's tied columns on this row, and the share of each
    unsigned rm[kSets][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
    unsigned bit = 1u;
#pragma unroll 4
    for (int w = bn.wlo; w < bn.whi; ++w, bit <<= 1) {
      const float2 v = Pair<T>::load(row + (size_t)w * pix_pairs);
      const float vk[2] = {v.x, v.y};
      const bool in1 = kHollow && bn.col_in_set1(w);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (vk[k] == st[0][k].m) rm[0][k] |= bit;
        if (in1 && vk[k] == st[1][k].m) rm[1][k] |= bit;
        if (in2 && vk[k] == st[2][k].m) rm[2][k] |= bit;
      }
    }
    float sh[kSets][2];
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
#pragma unroll
      for (int k = 0; k < 2; ++k) sh[s][k] = rm[s][k] ? t[s][k] / (float)__popc(rm[s][k]) : 0.0f;
    }
    for (int j = 0; j < bw; ++j) {
      float x = 0.0f, y = 0.0f;
#pragma unroll
      for (int s = 0; s < kSets; ++s) {
        x += (rm[s][0] >> j) & 1u ? sh[s][0] : 0.0f;
        y += (rm[s][1] >> j) & 1u ? sh[s][1] : 0.0f;
      }
      if (x != 0.0f || y != 0.0f) add_pair(srow + (size_t)j * c_take, x, y);
    }
  }
}

// The feature cotangent of one grid of bins: block (i, slice) walks the
// bins of ROI order[i] for channel pairs [slice * kSlicePairs, (slice + 1)
// * kSlicePairs), one pair per thread; blocks past the n_live ROIs of
// nonzero gate do nothing. Grid 0 is the ROI's bins, for row 0 (kRoi) and,
// with rows >= 2, the frame's sets (kHollow; hole: the inner box); grid 1
// the outer box's bins for the context's sets (hole: the ROI). g0 and gh
// are the cotangent rows of set 0 and of the hollow sets. Each grid is a
// kernel of its own, so that each gets the registers its sets need.
template <typename T, bool kRoi, bool kHollow>
__global__ void __launch_bounds__(kSlicePairs, 3) roi_loop_pool_gated_bwd_kernel(
    const T* __restrict__ feat, const int4* __restrict__ geo, const int* __restrict__ src,
    const int* __restrict__ order, const int* __restrict__ n_live, const T* __restrict__ gate_dt,
    const T* __restrict__ g0, const T* __restrict__ gh, float* __restrict__ scratch, int H, int W,
    int C, int c_base, int c_take, int P, int grid, float neg_floor) {
  using V = typename Pair<T>::V;
  if ((int)blockIdx.x >= *n_live) return;
  const int pairs = c_take / 2;
  const int cp = blockIdx.y * kSlicePairs + threadIdx.x;
  const unsigned lanes = __ballot_sync(0xffffffffu, cp < pairs);  // the warp's working lanes
  if (cp >= pairs) return;
  const size_t roi = (size_t)order[blockIdx.x];
  const size_t roi_pairs = (size_t)P * P * pairs;
  const float gate = Pair<T>::scalar(gate_dt + roi);
  // region (x1, y1, w, h), w and h >= 1; hole (x1, y1, x2, y2)
  const int4 reg = geo[roi * 4 + grid];
  const int4 hole = geo[roi * 4 + 2 + grid];
  const int s = src[roi];
  const V* fc = reinterpret_cast<const V*>(feat + (size_t)s * H * W * C + c_base) + cp;
  float* sb = scratch + (size_t)s * H * W * c_take + 2 * cp;
  const size_t row_pairs = (size_t)W * C / 2;  // one image row, in channel pairs
  const int pix_pairs = C / 2;
  const V* g0r = kRoi ? reinterpret_cast<const V*>(g0) + roi * roi_pairs + cp : nullptr;
  const V* ghr = kHollow ? reinterpret_cast<const V*>(gh) + roi * roi_pairs + cp : nullptr;
  const float2 zero = make_float2(0.0f, 0.0f);
  for (int ph = 0; ph < P; ++ph) {
    const int hlo = clip((ph * reg.w) / P + reg.y, H);
    const int hhi = clip(((ph + 1) * reg.w + P - 1) / P + reg.y, H);
    for (int pw = 0; pw < P; ++pw) {
      const int wlo = clip((pw * reg.z) / P + reg.x, W);
      const int whi = clip(((pw + 1) * reg.z + P - 1) / P + reg.x, W);
      if (hhi <= hlo || whi <= wlo) continue;  // empty bin: no gradient
      const Bin bn = {hlo, hhi, wlo, whi, hole.x, hole.z, hole.y, hole.w};
      const size_t bin = (size_t)(ph * P + pw) * pairs;
      const float2 g0_v = kRoi ? Pair<T>::load(g0r + bin) : zero;
      const float2 gh_v = kHollow ? Pair<T>::load(ghr + bin) : zero;
      const float2 w0 = make_float2(g0_v.x * gate, g0_v.y * gate);
      const float2 wh = make_float2(gh_v.x * gate, gh_v.y * gate);
      // the warp skips a bin only when all its lanes do: the adds go in lock step
      if (!__any_sync(lanes, w0.x != 0.0f || w0.y != 0.0f || wh.x != 0.0f || wh.y != 0.0f))
        continue;
      bin_backward<T, kRoi, kHollow>(fc, sb, row_pairs, pix_pairs, W, c_take, bn, w0, wh,
                                     neg_floor, lanes);
    }
  }
}

// The gate cotangent: one block per ROI sums g * out over its rows, bins and
// channels.
template <typename T>
__global__ void roi_loop_pool_gate_bwd_kernel(const float* __restrict__ gate_f32,
                                              const T* __restrict__ g, const T* __restrict__ out,
                                              float* __restrict__ g_gate, int B, int N, int c_take,
                                              int P, int rows) {
  using V = typename Pair<T>::V;
  const size_t roi = (size_t)blockIdx.y * N + blockIdx.x;
  const int pairs = c_take / 2;
  const size_t roi_elems = (size_t)P * P * c_take;
  const size_t out_row = (size_t)B * N * roi_elems;
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

template <typename T>
int launch(const void* feat, const void* geo, const void* src, const void* order,
           const void* n_live, const void* gate_dt, const void* gate_f32, const void* g,
           const void* out, void* scratch, void* g_gate, int B, int H, int W, int C, int N,
           int c_base, int c_take, int P, int rows, float neg_floor, void* stream) {
  if (B == 0 || N == 0 || c_take == 0 || rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = c_take / 2;
  if (g_gate != nullptr) {
    int threads = pairs < 256 ? pairs : 256;
    threads = (threads + 31) / 32 * 32;  // whole warps for the reduction
    roi_loop_pool_gate_bwd_kernel<T><<<dim3(N, B), threads, 0, st>>>(
        static_cast<const float*>(gate_f32), static_cast<const T*>(g),
        static_cast<const T*>(out), static_cast<float*>(g_gate), B, N, c_take, P, rows);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (scratch != nullptr) {
    const dim3 blocks(B * N, (pairs + kSlicePairs - 1) / kSlicePairs);
    const size_t out_row = (size_t)B * N * P * P * c_take;  // one row r of g, in elements
    const T* gt = static_cast<const T*>(g);
    const T* ft = static_cast<const T*>(feat);
    const int4* gm = static_cast<const int4*>(geo);
    const int* sr = static_cast<const int*>(src);
    const int* od = static_cast<const int*>(order);
    const int* nl = static_cast<const int*>(n_live);
    const T* gd = static_cast<const T*>(gate_dt);
    float* sc = static_cast<float*>(scratch);
    if (rows == 1)
      roi_loop_pool_gated_bwd_kernel<T, true, false><<<blocks, kSlicePairs, 0, st>>>(
          ft, gm, sr, od, nl, gd, gt, nullptr, sc, H, W, C, c_base, c_take, P, 0, neg_floor);
    else
      roi_loop_pool_gated_bwd_kernel<T, true, true><<<blocks, kSlicePairs, 0, st>>>(
          ft, gm, sr, od, nl, gd, gt, gt + out_row, sc, H, W, C, c_base, c_take, P, 0, neg_floor);
    if (rows == 3) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      roi_loop_pool_gated_bwd_kernel<T, false, true><<<blocks, kSlicePairs, 0, st>>>(
          ft, gm, sr, od, nl, gd, nullptr, gt + 2 * out_row, sc, H, W, C, c_base, c_take, P, 1,
          neg_floor);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers: feat [S, H,
// W, C]; geo int32 [B, N, 16] (loop_geometry); src int32 [B, N] in [0, S);
// order int32 [B * N], a permutation of the flat ROI indices b * N + n
// whose first n_live[0] (int32 [1]) are the ROIs of nonzero gate
// (loop_bwd_order); gate_dt [B, N] in the feature dtype (as the forward used
// it) and gate_f32 [B, N] float32; g and out [rows, B, N, P, P, c_take].
// `out` and `g_gate` [B, N] float32 are both null or both set (the gate
// cotangent); `scratch` float32 [S, H, W, c_take], zeroed, is null when the
// feature cotangent is not wanted (and then `order` and `n_live` may be
// null). c_base, c_take and C must be even, rows 1 to 3. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int wsovod_roi_loop_pool_gated_bwd_bf16(
    const void* feat, const void* geo, const void* src, const void* order, const void* n_live,
    const void* gate_dt, const void* gate_f32, const void* g, const void* out, void* scratch,
    void* g_gate, int B, int H, int W, int C, int N, int c_base, int c_take, int P, int rows,
    float neg_floor, void* stream) {
  return launch<__nv_bfloat16>(feat, geo, src, order, n_live, gate_dt, gate_f32, g, out, scratch,
                               g_gate, B, H, W, C, N, c_base, c_take, P, rows, neg_floor, stream);
}

extern "C" int wsovod_roi_loop_pool_gated_bwd_f32(
    const void* feat, const void* geo, const void* src, const void* order, const void* n_live,
    const void* gate_dt, const void* gate_f32, const void* g, const void* out, void* scratch,
    void* g_gate, int B, int H, int W, int C, int N, int c_base, int c_take, int P, int rows,
    float neg_floor, void* stream) {
  return launch<float>(feat, geo, src, order, n_live, gate_dt, gate_f32, g, out, scratch, g_gate,
                       B, H, W, C, N, c_base, c_take, P, rows, neg_floor, stream);
}
