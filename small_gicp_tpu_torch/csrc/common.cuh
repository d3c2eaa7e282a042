// Shared device helpers of the port's hand-written kernels.
#pragma once

#include <cuda_runtime.h>

namespace sgt {

// "No neighbour yet" distance; finite so that comparisons never see inf.
constexpr float kBig = 3.0e38f;

// Squared distance in the rounding order of the plain PyTorch versions:
// ((dx*dx) + (dy*dy)) + (dz*dz) with every operation rounded on its own
// (no fused multiply-add), so kernel and plain version pick the same
// neighbours bit for bit.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz,
                                         float& dx, float& dy, float& dz) {
  dx = __fsub_rn(ax, bx);
  dy = __fsub_rn(ay, by);
  dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// R·p + t in the plain versions' order: ((r0·x + r1·y) + r2·z) + t.
__device__ __forceinline__ float affine_row(const float* r, float t, float x,
                                            float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)),
                   t);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// (d², index) order of the searches: ascending distance, ties to the lower
// index.
__device__ __forceinline__ bool lex_before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// One thread's sorted list of its k nearest candidates so far: d[s] is the
// squared distance of slot s, ascending, and p0[s] (p1[s], p2[s]) its NPAY
// 32-bit payload words (the neighbour's offsets for the moments kernel, its
// row index for the searches). KMAX bounds the length at compile time and
// k ≤ KMAX is the length in use; every loop is unrolled over KMAX with
// constant slot indices, so a short list lives in registers. `kth` is
// d[k-1], the distance a candidate has to beat, and `kth0` the first
// payload word of that slot.
template <int KMAX, int NPAY>
struct TopK {
  static_assert(NPAY >= 1 && NPAY <= 3, "one to three payload words");
  float d[KMAX];
  unsigned p0[KMAX];
  unsigned p1[NPAY > 1 ? KMAX : 1];
  unsigned p2[NPAY > 2 ? KMAX : 1];
  float kth;
  unsigned kth0;

  __device__ __forceinline__ void set(int s, float d2, unsigned v0, unsigned v1,
                                      unsigned v2) {
    d[s] = d2;
    p0[s] = v0;
    if constexpr (NPAY > 1) p1[s] = v1;
    if constexpr (NPAY > 2) p2[s] = v2;
  }

  __device__ __forceinline__ void shift_down(int s) {  // slot s-1 → slot s
    d[s] = d[s - 1];
    p0[s] = p0[s - 1];
    if constexpr (NPAY > 1) p1[s] = p1[s - 1];
    if constexpr (NPAY > 2) p2[s] = p2[s - 1];
  }

  // Empty list: every slot at kBig with payload `fill`.
  __device__ __forceinline__ void clear(unsigned fill) {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) set(s, kBig, fill, fill, fill);
    kth = kBig;
    kth0 = fill;
  }

  __device__ __forceinline__ void refresh_kth(int k) {
#pragma unroll
    for (int s = 0; s < KMAX; ++s)
      if (s == k - 1) {
        kth = d[s];
        kth0 = p0[s];
      }
  }

  // Insert after every entry ≤ d2, shifting the larger ones down: among
  // equal distances the earlier arrival stays ahead. The caller has
  // checked d2 < kth.
  __device__ __forceinline__ void insert(int k, float d2, unsigned v0,
                                         unsigned v1 = 0u, unsigned v2 = 0u) {
#pragma unroll
    for (int s = KMAX - 1; s > 0; --s) {
      if (s < k) {
        if (d[s - 1] > d2)
          shift_down(s);
        else if (d[s] > d2)
          set(s, d2, v0, v1, v2);
      }
    }
    if (d[0] > d2) set(0, d2, v0, v1, v2);
    refresh_kth(k);
  }

  // Insert (d2, idx) in (d², index) order, p0 holding the index, so the
  // list does not depend on the order of arrival. The caller has checked
  // lex_before(d2, idx, kth, kth0).
  __device__ __forceinline__ void insert_lex(int k, float d2, int idx) {
    static_assert(NPAY == 1, "the lexicographic list carries the index only");
#pragma unroll
    for (int s = KMAX - 1; s > 0; --s) {
      if (s < k) {
        if (lex_before(d2, idx, d[s - 1], (int)p0[s - 1]))
          shift_down(s);
        else if (lex_before(d2, idx, d[s], (int)p0[s]))
          set(s, d2, (unsigned)idx, 0u, 0u);
      }
    }
    if (lex_before(d2, idx, d[0], (int)p0[0])) set(0, d2, (unsigned)idx, 0u, 0u);
    refresh_kth(k);
  }
};

// kth smallest d² from (qx, qy, qz) over rows lo, lo + step, ... below hi
// of a table of 16-byte rows (kBig if these are fewer than k rows): an
// upper bound on the query's kth neighbour distance over any set of rows
// that contains them.
template <int KMAX>
__device__ float kth_bound(const float4* __restrict__ pts, int lo, int hi, int step,
                           int k, float qx, float qy, float qz) {
  float sd[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) sd[s] = kBig;
  float kth = kBig;
  for (int j = lo; j < hi; j += step) {
    const float4 p = pts[j];
    float dx, dy, dz;
    const float d2 = sq_dist(p.x, p.y, p.z, qx, qy, qz, dx, dy, dz);
    if (d2 < kth) {
#pragma unroll
      for (int s = KMAX - 1; s > 0; --s)
        if (s < k) sd[s] = sd[s - 1] > d2 ? sd[s - 1] : fminf(sd[s], d2);
      sd[0] = fminf(sd[0], d2);
#pragma unroll
      for (int s = 0; s < KMAX; ++s)
        if (s == k - 1) kth = sd[s];
    }
  }
  return kth;
}

}  // namespace sgt
