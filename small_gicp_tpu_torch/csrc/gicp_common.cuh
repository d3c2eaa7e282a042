// What the fused linearize kernels share (K1 of gicp_listed.cu and
// gicp_fused.cu, K6 of gicp_swept.cu, K7 of gicp_fleet.cu): the factor and
// robust-kernel switches, the per-point finalize that follows the
// correspondence search, and the chunked box walk of K1 (both forms) and K6.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace sgt {

constexpr int kLinThreads = 64;
constexpr int kLinTile = 512;
constexpr int kLinRed = 29;  // 21 unique H | b 6 | e | inliers
constexpr int kLinOut = 44;  // H 36 | b 6 | e | inliers

enum Factor { kGicp = 0, kPlaneIcp = 1, kIcp = 2 };
enum Robust { kNone = 0, kHuber = 1, kCauchy = 2 };

// w(√e) with e the unweighted per-point error, clamped at 0
// (factors.robust_weight): Huber min(1, c/√e), Cauchy c/(c+e).
template <int ROBUST>
__device__ __forceinline__ float robust_weight(float e, float c) {
  const float e0 = fmaxf(e, 0.f);
  if (ROBUST == kHuber) {
    const float x = sqrtf(e0);
    return x < c ? 1.f : c / fmaxf(x, 1e-30f);
  }
  if (ROBUST == kCauchy) return c / (c + e0);
  return 1.f;
}

// Packed index of H[lo][hi], lo ≤ hi, in the 21-entry upper triangle.
__host__ __device__ constexpr int tri(int lo, int hi) {
  return lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
}

// After the search: thread i of a block of kLinThreads holds source row
// `qrow` (null beyond the table) with point p, its transformed point q and
// its winner `best` (a row of ttab, or -1) at squared distance best_d. Forms
// the per-point weight W, the rejector mask, the robust weight, J and the 29
// unique sums, writes the frozen row corr_row = [μ 3 | W 9 | mask | d² | 0 0]
// (null beyond the table) and the block's 44 sums to `partials`. Called by
// every thread of the block. ZERO_UNMATCHED: a row without an accepted
// correspondence holds zeros and d² = kBig.
template <int FACTOR, int ROBUST, bool ZERO_UNMATCHED>
__device__ __forceinline__ void linearize_finalize(
    const float* __restrict__ ttab, const float* __restrict__ qrow, bool active,
    int best, float best_d, const float (&r)[9], float qx, float qy, float qz,
    float px, float py, float pz, float max_d2, float robust_c,
    float* __restrict__ corr_row, float* __restrict__ partials,
    float (*red)[kLinRed]) {
  float mux = 0.f, muy = 0.f, muz = 0.f;
  float pay[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) pay[k] = 0.f;
  if (best >= 0) {
    const float* row = ttab + (size_t)best * 16;
    mux = row[0];
    muy = row[1];
    muz = row[2];
#pragma unroll
    for (int k = 0; k < 9; ++k) pay[k] = row[4 + k];
  }
  const bool mask = active && best_d <= max_d2 && best_d < 0.5f * kBig;
  if (ZERO_UNMATCHED && !mask) {
    mux = muy = muz = 0.f;
    best_d = kBig;
  }

  // Per-point weight W.
  float w[9];
  if (FACTOR == kGicp) {
    float cs[9];
    if (qrow) {
#pragma unroll
      for (int k = 0; k < 9; ++k) cs[k] = qrow[4 + k];
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) cs[k] = 0.f;
    }
    float a[9];  // A = R C_s
#pragma unroll
    for (int row = 0; row < 3; ++row)
#pragma unroll
      for (int col = 0; col < 3; ++col)
        a[row * 3 + col] = r[row * 3 + 0] * cs[0 * 3 + col] +
                           r[row * 3 + 1] * cs[1 * 3 + col] +
                           r[row * 3 + 2] * cs[2 * 3 + col];
    float mm[9];  // M = C_t + A Rᵀ
#pragma unroll
    for (int row = 0; row < 3; ++row)
#pragma unroll
      for (int col = 0; col < 3; ++col)
        mm[row * 3 + col] = pay[row * 3 + col] + a[row * 3 + 0] * r[col * 3 + 0] +
                            a[row * 3 + 1] * r[col * 3 + 1] +
                            a[row * 3 + 2] * r[col * 3 + 2];
    const float co00 = mm[4] * mm[8] - mm[5] * mm[7];
    const float co01 = mm[2] * mm[7] - mm[1] * mm[8];
    const float co02 = mm[1] * mm[5] - mm[2] * mm[4];
    const float co10 = mm[5] * mm[6] - mm[3] * mm[8];
    const float co11 = mm[0] * mm[8] - mm[2] * mm[6];
    const float co12 = mm[2] * mm[3] - mm[0] * mm[5];
    const float co20 = mm[3] * mm[7] - mm[4] * mm[6];
    const float co21 = mm[1] * mm[6] - mm[0] * mm[7];
    const float co22 = mm[0] * mm[4] - mm[1] * mm[3];
    const float det = mm[0] * co00 + mm[1] * co10 + mm[2] * co20;
    const float inv_det = fabsf(det) < 1e-30f ? 0.f : 1.f / det;
    w[0] = co00 * inv_det;
    w[1] = co01 * inv_det;
    w[2] = co02 * inv_det;
    w[3] = co10 * inv_det;
    w[4] = co11 * inv_det;
    w[5] = co12 * inv_det;
    w[6] = co20 * inv_det;
    w[7] = co21 * inv_det;
    w[8] = co22 * inv_det;
  } else if (FACTOR == kPlaneIcp) {
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = 0.f;
    w[0] = pay[0] * pay[0];
    w[4] = pay[1] * pay[1];
    w[8] = pay[2] * pay[2];
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = 0.f;
    w[0] = w[4] = w[8] = 1.f;
  }

  if (ZERO_UNMATCHED && !mask) {
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = 0.f;
  }

  float v[kLinRed];
#pragma unroll
  for (int c = 0; c < kLinRed; ++c) v[c] = 0.f;
  if (mask) {
    const float rx = mux - qx, ry = muy - qy, rz = muz - qz;
    const float wr[3] = {w[0] * rx + w[1] * ry + w[2] * rz,
                         w[3] * rx + w[4] * ry + w[5] * rz,
                         w[6] * rx + w[7] * ry + w[8] * rz};
    const float e_i = 0.5f * (rx * wr[0] + ry * wr[1] + rz * wr[2]);
    const float wm = robust_weight<ROBUST>(e_i, robust_c);

    // J = [R·skew(p) | −R]
    float J[3][6];
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      const float* rr = r + row * 3;
      J[row][0] = rr[1] * pz - rr[2] * py;
      J[row][1] = rr[2] * px - rr[0] * pz;
      J[row][2] = rr[0] * py - rr[1] * px;
      J[row][3] = -rr[0];
      J[row][4] = -rr[1];
      J[row][5] = -rr[2];
    }
    float WJ[3][6];
#pragma unroll
    for (int row = 0; row < 3; ++row)
#pragma unroll
      for (int col = 0; col < 6; ++col)
        WJ[row][col] = w[row * 3 + 0] * J[0][col] + w[row * 3 + 1] * J[1][col] +
                       w[row * 3 + 2] * J[2][col];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b)
        v[tri(a, b)] = (J[0][a] * WJ[0][b] + J[1][a] * WJ[1][b] + J[2][a] * WJ[2][b]) * wm;
      v[21 + a] = (J[0][a] * wr[0] + J[1][a] * wr[1] + J[2][a] * wr[2]) * wm;
    }
    v[27] = e_i * wm;
    v[28] = 1.f;  // the inlier count stays unweighted
  }

  if (corr_row) {
    float4* out = reinterpret_cast<float4*>(corr_row);
    out[0] = make_float4(mux, muy, muz, w[0]);
    out[1] = make_float4(w[1], w[2], w[3], w[4]);
    out[2] = make_float4(w[5], w[6], w[7], w[8]);
    out[3] = make_float4(mask ? 1.f : 0.f, best_d, 0.f, 0.f);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kLinRed; ++c) {
    const float s = warp_sum(v[c]);
    if (lane == 0) red[warp][c] = s;
  }
  __syncthreads();
  if (threadIdx.x < kLinOut) {
    const int o = threadIdx.x;
    int c;
    if (o < 36) {
      const int a = o / 6, b = o % 6;
      c = a <= b ? tri(a, b) : tri(b, a);
    } else {
      c = 21 + (o - 36);
    }
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kLinThreads / 32; ++wi) s += red[wi][c];
    partials[o] = s;
  }
}

// ------------------------------------------------------------------------
// The chunked box walk of K6 and K1: `chunks` blocks a source block on the
// grid's second dimension, merged in the launch.

static_assert(kLinThreads == kPrunedThreads, "block_max reduces a linearize block");

// A row's winner as the 64-bit key of the merge: d²'s bits (d² ≥ +0, and
// -0 + 0 = +0, so they order as the floats) over the original row.
__device__ __forceinline__ unsigned long long swept_key(float d2, int row) {
  return ((unsigned long long)__float_as_uint(__fadd_rn(d2, 0.f)) << 32) |
         (unsigned)row;
}

// The score form's key: the score can be negative, so its bits are made
// orderable first.
__device__ __forceinline__ unsigned long long score_key(float s, int row) {
  return ((unsigned long long)orderable(__fadd_rn(s, 0.f)) << 32) | (unsigned)row;
}

// Start the copy of the ‖t‖² of sorted tile tt into dst: tnorm holds one
// float a sorted row, padded to whole tiles, so a tile is 64 16-byte copies.
__device__ __forceinline__ void stage_norms(float* dst, const float* tnorm, int tt) {
  static_assert(kBoxRows == 4 * kLinThreads, "one 16-byte copy a thread");
  __pipeline_memcpy_async(dst + 4 * threadIdx.x, tnorm + (size_t)tt * kBoxRows +
                          4 * threadIdx.x, 16);
}

// The score form of nearest_in_tile: the row of the cnt staged rows of
// sorted tile t (‖t‖² in norms) with the smallest score ‖t‖² − 2 t·q, in
// (score, original row) order, folded into (best_s, best). The score is
// formed with the rounded operations of the first form's instance
// (gicp_fused.cu) and of the plain version, so all three rank alike. Every
// row is a candidate: the rejector takes the winner's exact d² afterwards.
// A warp skips the rows if the tile's box lies farther than max_d2 from each
// of its points: no row there is accepted.
__device__ __forceinline__ void score_in_tile(const float4* tile, const float* norms,
                                              int cnt, const float* __restrict__ tbox,
                                              int t, bool active, float qx, float qy,
                                              float qz, float max_d2, float& best_s,
                                              int& best) {
  const bool wanted =
      active && !(box_gap2(tbox + (size_t)t * 8, qx, qy, qz, qx, qy, qz) > max_d2);
  if (!__any_sync(0xffffffffu, wanted) || !wanted) return;
  for (int j = 0; j < cnt; ++j) {
    const float4 tp = tile[j];
    const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, tp.x), __fmul_rn(qy, tp.y)),
                                __fmul_rn(qz, tp.z));
    const float s = __fsub_rn(norms[j], __fmul_rn(2.f, dot));
    const int idx = __float_as_int(tp.w);  // original target row
    if (lex_before(s, idx, best_s, best)) {
      best_s = s;
      best = idx;
    }
  }
}

// Called by every thread of a block after the block's results are in
// device memory: counts the block at *ticket and returns true in the one
// that arrives as the `expected`-th.
__device__ __forceinline__ bool last_arrival(unsigned* ticket, unsigned expected) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == expected - 1;
  __syncthreads();
  return last;
}

// The chunked walk of K6 and K1, called by every thread of a block: chunk
// blockIdx.y of the gridDim.y chunks of source block blockIdx.x, whose
// thread at sorted position i (active: a valid row; block_active: the block
// holds one) carries the transformed point q. The chunk reduces the box of
// the block's valid points, culls the boxes of the sorted target (rows x y
// z | original index, the first m valid) against it at max_d2 in passes of
// kCullPass, and scans every gridDim.y-th live tile through the cp.async
// ring; candidates need d² ≤ max_d2 and win in (d², original index) order.
// SCORE (K1's score form): the tiles' ‖t‖² (tnorm, in sorted order) ride
// in the ring beside them, every row of a tile within max_d2 of the point is
// a candidate and candidates win in (score, original index) order. With
// more than one chunk each posts its rows' winners as keys [n] (~0 between
// launches) and returns false, except the last of the source block (ticket
// tickets[blockIdx.x], 0 between launches), which reads and resets the keys
// and its ticket. (best_v, best): the row's winner over the target and its
// d² (SCORE: its score), (kBig, kNoIndex) without one.
template <bool SCORE = false>
__device__ __forceinline__ bool chunked_nearest(const float* __restrict__ tsorted,
                                                const float* __restrict__ tbox, int m,
                                                bool block_active, bool active, int i,
                                                float qx, float qy, float qz,
                                                float max_d2,
                                                unsigned long long* __restrict__ keys,
                                                unsigned* __restrict__ tickets,
                                                float& best_v, int& best,
                                                const float* __restrict__ tnorm = nullptr) {
  __shared__ __align__(16) float4 tile[2][kBoxRows];
  __shared__ __align__(16) float norms[SCORE ? 2 : 1][SCORE ? kBoxRows : 4];
  __shared__ int live[kCullPass];
  __shared__ int counts[kCullWords];
  __shared__ float sw[kLinThreads / 32];
  best_v = kBig;
  best = kNoIndex;
  if (block_active) {
    float lo[3], hi[3];  // the box of the block's transformed valid points
    block_box(active, qx, qy, qz, sw, lo, hi);
    const float4* t4 = reinterpret_cast<const float4*>(tsorted);
    const int ntiles = (m + kBoxRows - 1) / kBoxRows;
    const int chunks = gridDim.y, s = blockIdx.y;
    int before = 0;  // the block's live tiles in earlier passes
    for (int first = 0; first < ntiles; first += kCullPass) {
      const int nlive = cull_boxes(tbox, first, min(ntiles, first + kCullPass), lo, hi,
                                   max_d2, live, nullptr, counts);
      // This chunk's tiles: live[j] with (before + j) % chunks == s. Its tile
      // c goes to ring slot c & 1, one commit group per tile.
      const int j0 = ((s - before) % chunks + chunks) % chunks;
      const int mine = j0 < nlive ? (nlive - j0 + chunks - 1) / chunks : 0;
      if (mine > 0) {
        stage_tile(tile[0], t4, live[j0], m);
        if constexpr (SCORE) stage_norms(norms[0], tnorm, live[j0]);
      }
      __pipeline_commit();
      for (int c = 0; c < mine; ++c) {
        if (c + 1 < mine) {
          const int nt = live[j0 + (c + 1) * chunks];
          stage_tile(tile[(c + 1) & 1], t4, nt, m);
          if constexpr (SCORE) stage_norms(norms[(c + 1) & 1], tnorm, nt);
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);  // this thread's copies of tile c landed
        __syncthreads();           // and every other thread's
        const int tt = live[j0 + c * chunks];
        const int cnt = min(kBoxRows, m - tt * kBoxRows);
        if constexpr (SCORE)
          score_in_tile(tile[c & 1], norms[c & 1], cnt, tbox, tt, active, qx, qy, qz,
                        max_d2, best_v, best);
        else
          nearest_in_tile(tile[c & 1], cnt, tbox, tt, active, qx, qy, qz, max_d2, best_v,
                          best);
        __syncthreads();  // slot c & 1 is read; tile c + 2 may land there
      }
      before += nlive;
    }
  }

  if (gridDim.y > 1 && block_active) {
    // Post the chunk's winners, the smallest key kept: ties to the lower
    // row, in any order of the chunks.
    if (active && best != kNoIndex)
      atomicMin(keys + i, SCORE ? score_key(best_v, best) : swept_key(best_v, best));
    if (!last_arrival(tickets + blockIdx.x, gridDim.y)) return false;
    best_v = kBig;
    best = kNoIndex;
    if (active) {
      const unsigned long long key = __ldcg(keys + i);
      keys[i] = ~0ull;
      if (key != ~0ull) {
        const unsigned hi = (unsigned)(key >> 32);
        best_v = SCORE ? from_orderable(hi) : __uint_as_float(hi);
        best = (int)(key & 0xffffffffu);
      }
    }
    if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
  }
  return true;
}

}  // namespace sgt
