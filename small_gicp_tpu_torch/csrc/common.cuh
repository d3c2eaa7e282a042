// Shared device helpers of the port's hand-written kernels.
#pragma once

#include <cuda_pipeline.h>
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

// Float bits whose unsigned order is the floats' order (no NaN), and back:
// the high word of the 64-bit merge keys of ranks that can be negative (K9's
// and K1's score forms). Add +0 first, so that -0 keys as +0.
__device__ __forceinline__ unsigned orderable(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// One thread's sorted list of its k nearest candidates so far, kept in
// plain arrays that the kernel declares: d[s] is the squared distance of
// slot s, ascending, and p0[s] (p1[s], p2[s]) its 32-bit payload words (the
// neighbour's offsets for the moments kernel, its row index for the
// searches). KMAX bounds the length at compile time and k ≤ KMAX is the
// length in use; every loop is unrolled over KMAX with constant slot
// indices, so a short list lives in registers. (Gathered into one struct the
// arrays are placed in local memory as a whole: ptxas gave the 16-slot
// moments kernel a 264-byte stack frame and 167 registers against none and
// 105 for these functions over separate arrays.) The kernel keeps `kth` =
// d[k-1], the distance a candidate has to beat, and where ties are broken by
// index `kth0` = p0[k-1], both refreshed by topk_slot after an insertion.

template <int KMAX, typename T>
__device__ __forceinline__ void topk_fill(T (&a)[KMAX], T v) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s) a[s] = v;
}

// a[s] for a run-time slot s, by constant indices.
template <int KMAX, typename T>
__device__ __forceinline__ T topk_slot(const T (&a)[KMAX], int s) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < KMAX; ++j)
    if (j == s) v = a[j];
  return v;
}

// Insert after every entry ≤ d2, shifting the larger ones down: among equal
// distances the earlier arrival stays ahead. The caller has checked
// d2 < d[k-1].
template <int KMAX>
__device__ __forceinline__ void topk_insert(float (&d)[KMAX], unsigned (&p0)[KMAX],
                                            int k, float d2, unsigned v0) {
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (s < k) {
      if (d[s - 1] > d2) {
        d[s] = d[s - 1];
        p0[s] = p0[s - 1];
      } else if (d[s] > d2) {
        d[s] = d2;
        p0[s] = v0;
      }
    }
  }
  if (d[0] > d2) {
    d[0] = d2;
    p0[0] = v0;
  }
}

// The same with three payload words.
template <int KMAX>
__device__ __forceinline__ void topk_insert3(float (&d)[KMAX], unsigned (&p0)[KMAX],
                                             unsigned (&p1)[KMAX],
                                             unsigned (&p2)[KMAX], int k, float d2,
                                             unsigned v0, unsigned v1, unsigned v2) {
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (s < k) {
      if (d[s - 1] > d2) {
        d[s] = d[s - 1];
        p0[s] = p0[s - 1];
        p1[s] = p1[s - 1];
        p2[s] = p2[s - 1];
      } else if (d[s] > d2) {
        d[s] = d2;
        p0[s] = v0;
        p1[s] = v1;
        p2[s] = v2;
      }
    }
  }
  if (d[0] > d2) {
    d[0] = d2;
    p0[0] = v0;
    p1[0] = v1;
    p2[0] = v2;
  }
}

// Insert (d2, idx) in (d², index) order, p0 holding the index, so the list
// does not depend on the order of arrival. The caller has checked
// lex_before(d2, idx, d[k-1], p0[k-1]).
template <int KMAX>
__device__ __forceinline__ void topk_insert_lex(float (&d)[KMAX],
                                                unsigned (&p0)[KMAX], int k,
                                                float d2, int idx) {
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (s < k) {
      if (lex_before(d2, idx, d[s - 1], (int)p0[s - 1])) {
        d[s] = d[s - 1];
        p0[s] = p0[s - 1];
      } else if (lex_before(d2, idx, d[s], (int)p0[s])) {
        d[s] = d2;
        p0[s] = (unsigned)idx;
      }
    }
  }
  if (lex_before(d2, idx, d[0], (int)p0[0])) {
    d[0] = d2;
    p0[0] = (unsigned)idx;
  }
}

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

// ------------------------------------------------------------------------
// Box-pruned search over a Morton-sorted table (K12, K4, K6): rows
// (x y z | original index as int32 bits), kBoxRows sorted rows per box
// (lo 3, 0, hi 3, 0 over the valid rows), blocks of kPrunedThreads queries.

constexpr int kBoxRows = 256;
constexpr int kPrunedThreads = 64;
constexpr int kNoIndex = 0x7fffffff;

// Maximum of v over a block of kPrunedThreads; sw holds one float per warp.
__device__ __forceinline__ float block_max(float v, float* sw) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // earlier readers of sw are done
  if ((threadIdx.x & 31) == 0) sw[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = sw[0];
#pragma unroll
  for (int w = 1; w < kPrunedThreads / 32; ++w) r = fmaxf(r, sw[w]);
  return r;
}

// The box of the block's `active` points: lo[3], hi[3]. A block without an
// active point gets the inverted box (kBig, -kBig), which lies infinitely
// far from every other box.
__device__ __forceinline__ void block_box(bool active, float x, float y, float z,
                                          float* sw, float (&lo)[3], float (&hi)[3]) {
  lo[0] = -block_max(active ? -x : -kBig, sw);
  lo[1] = -block_max(active ? -y : -kBig, sw);
  lo[2] = -block_max(active ? -z : -kBig, sw);
  hi[0] = block_max(active ? x : -kBig, sw);
  hi[1] = block_max(active ? y : -kBig, sw);
  hi[2] = block_max(active ? z : -kBig, sw);
}

// gap² between the box b (lo 3, 0, hi 3, 0) and the box [lo, hi] (a point if
// lo = hi), in the operation order of sq_dist and without fused
// multiply-add, so that it never exceeds the d² of a pair of points inside
// the two boxes: subtraction, squaring and the sums are monotone under
// round-to-nearest.
__device__ __forceinline__ float box_gap2(const float* __restrict__ b, float lox,
                                          float loy, float loz, float hix, float hiy,
                                          float hiz) {
  const float gx = fmaxf(0.f, fmaxf(__fsub_rn(b[0], hix), __fsub_rn(lox, b[4])));
  const float gy = fmaxf(0.f, fmaxf(__fsub_rn(b[1], hiy), __fsub_rn(loy, b[5])));
  const float gz = fmaxf(0.f, fmaxf(__fsub_rn(b[2], hiz), __fsub_rn(loz, b[6])));
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// Stage sorted tile t and offer its rows to the queries of the block that
// can still use them, lists in (d², original index) order. Called by all
// threads of the block or by none. A warp none of whose queries can use the
// tile (its box lies farther from each than that query's kth distance, or
// than its `reach` where BOUNDED) skips the rows. Where BOUNDED, a row needs
// d² ≤ reach, an upper bound of the query's kth distance that the caller
// knows beforehand.
template <int KMAX, bool BOUNDED>
__device__ __forceinline__ void scan_tile(const float4* __restrict__ t4,
                                          const float* __restrict__ tbox, int m,
                                          int t, float4* tile, bool active, float qx,
                                          float qy, float qz, int k, float reach,
                                          float (&d)[KMAX], unsigned (&p0)[KMAX],
                                          float& kth, unsigned& kth0) {
  const int base = t * kBoxRows;
  const int cnt = min(kBoxRows, m - base);
  __syncthreads();
  for (int j = threadIdx.x; j < cnt; j += kPrunedThreads) tile[j] = t4[base + j];
  __syncthreads();
  const float limit = BOUNDED ? fminf(kth, reach) : kth;
  const bool wanted =
      active && !(box_gap2(tbox + (size_t)t * 8, qx, qy, qz, qx, qy, qz) > limit);
  if (!__any_sync(0xffffffffu, wanted)) return;
  if (!wanted) return;
  for (int j = 0; j < cnt; ++j) {
    const float4 p = tile[j];
    float dx, dy, dz;
    const float d2 = sq_dist(qx, qy, qz, p.x, p.y, p.z, dx, dy, dz);
    const int idx = __float_as_int(p.w);  // original row index
    if (BOUNDED && d2 > reach) continue;
    if (d2 < kBig && lex_before(d2, idx, kth, (int)kth0)) {
      topk_insert_lex<KMAX>(d, p0, k, d2, idx);
      kth = topk_slot<KMAX>(d, k - 1);
      kth0 = topk_slot<KMAX>(p0, k - 1);
    }
  }
}

// ------------------------------------------------------------------------
// The parallel cull and the copy ring of the box walks (K4, K6, K7).

// Boxes a cull pass tests at most: the length of a block's shared list. A
// thread tests kCullPerThread of them, all loads in flight together; the
// counts of a pass are one int per (round, warp).
constexpr int kCullPass = 256;
constexpr int kCullPerThread = kCullPass / kPrunedThreads;
constexpr int kCullWords = kCullPass / 32;
static_assert(kCullPass % kPrunedThreads == 0, "a pass is whole rounds of the block");

// Test boxes [first, end) of tbox, end - first ≤ kCullPass, against the box
// [lo, hi] at `bound`: thread tid tests boxes first + tid, first + tid + 64,
// … and keeps a box where !(gap² > bound) (a NaN gap keeps it). The kept
// box indices go to live[0, count) in ascending order by ballot and popc,
// their gap² beside them in live_gap where that is not null. Returns count,
// the same in every thread. Called by all threads of a block of
// kPrunedThreads; counts holds kCullWords ints.
__device__ __forceinline__ int cull_boxes(const float* __restrict__ tbox, int first,
                                          int end, const float (&lo)[3],
                                          const float (&hi)[3], float bound, int* live,
                                          float* live_gap, int* counts) {
  constexpr int kWarpsPerBlock = kPrunedThreads / 32;
  const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool keep[kCullPerThread];
  float gap2[kCullPerThread];
  unsigned ballot[kCullPerThread];
#pragma unroll
  for (int r = 0; r < kCullPerThread; ++r) {
    const int tt = first + r * kPrunedThreads + threadIdx.x;
    gap2[r] = 0.f;
    keep[r] = false;
    if (tt < end) {
      gap2[r] = box_gap2(tbox + (size_t)tt * 8, lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]);
      keep[r] = !(gap2[r] > bound);
    }
  }
#pragma unroll
  for (int r = 0; r < kCullPerThread; ++r) {
    ballot[r] = __ballot_sync(0xffffffffu, keep[r]);
    if (lid == 0) counts[r * kWarpsPerBlock + warp] = __popc(ballot[r]);
  }
  __syncthreads();
  // Box first + r·64 + tid is (round r, warp, lane) in ascending order.
  int nlive = 0;
#pragma unroll
  for (int c = 0; c < kCullWords; ++c) nlive += counts[c];
#pragma unroll
  for (int r = 0; r < kCullPerThread; ++r) {
    if (keep[r]) {
      int at = __popc(ballot[r] & ((1u << lid) - 1u));
      for (int c = 0; c < r * kWarpsPerBlock + warp; ++c) at += counts[c];
      live[at] = first + r * kPrunedThreads + threadIdx.x;
      if (live_gap) live_gap[at] = gap2[r];
    }
  }
  __syncthreads();  // `live` complete; counts free for the next pass
  return nlive;
}

// Start the copy of sorted tile tt (its rows below m) into dst: 16-byte
// cp.async copies by the kPrunedThreads threads of a block (one tile is at
// most 4 KB and contiguous: 4 copies a thread, no barrier object to set
// up). The caller commits a group per tile and waits with wait_prior(1), so
// that tile k + 1 is copied while tile k is scanned.
__device__ __forceinline__ void stage_tile(float4* dst, const float4* t4, int tt,
                                           int m) {
  const int base = tt * kBoxRows;
  const int cnt = min(kBoxRows, m - base);
  for (int j = threadIdx.x; j < cnt; j += kPrunedThreads)
    __pipeline_memcpy_async(dst + j, t4 + base + j, sizeof(float4));
}

// The nearest of the cnt staged rows of sorted tile t to the point q with
// d² ≤ max_d2, in (d², original row) order, folded into (best_d, best). A
// warp skips the rows if the tile's box lies farther from each of its
// points than that point's best so far, or than max_d2 (K6, K7).
__device__ __forceinline__ void nearest_in_tile(const float4* tile, int cnt,
                                                const float* __restrict__ tbox, int t,
                                                bool active, float qx, float qy,
                                                float qz, float max_d2, float& best_d,
                                                int& best) {
  const bool wanted =
      active && !(box_gap2(tbox + (size_t)t * 8, qx, qy, qz, qx, qy, qz) >
                  fminf(best_d, max_d2));
  if (!__any_sync(0xffffffffu, wanted) || !wanted) return;
  float limit = fminf(best_d, max_d2);  // a winner has d² ≤ limit
  for (int j = 0; j < cnt; ++j) {
    const float4 tp = tile[j];
    float dx, dy, dz;
    const float d2 = sq_dist(qx, qy, qz, tp.x, tp.y, tp.z, dx, dy, dz);
    if (d2 <= limit) {
      const int idx = __float_as_int(tp.w);  // original target row
      if (d2 <= max_d2 && lex_before(d2, idx, best_d, best)) {
        best_d = d2;
        best = idx;
        limit = fminf(best_d, max_d2);
      }
    }
  }
}

// Write a list to row `row` of [rows, k] outputs; empty slots get index 0.
template <int KMAX>
__device__ __forceinline__ void store_list(const float (&d)[KMAX],
                                           const unsigned (&p0)[KMAX], int k,
                                           float* __restrict__ out_d,
                                           int* __restrict__ out_i, size_t row) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      out_d[row * k + s] = d[s];
      out_i[row * k + s] = d[s] < kBig ? (int)p0[s] : 0;
    }
  }
}

// ------------------------------------------------------------------------
// The box walk in cull passes over a Morton-sorted table (K3, K4, K5, K12).
// TEAM threads serve one query, kPrunedThreads / TEAM queries a block; each
// query's list is seeded with its reach, the kth smallest d² over a window
// of sorted rows, which bounds its true kth distance from above.

// Passes start at the anchor box and work outwards (kOutward; else in
// ascending order).
constexpr int kOutward = 1;
constexpr int kWalkWarps = kPrunedThreads / 32;

// Offer the cnt staged rows of sorted tile t to the block's seeded lists,
// in (d², original index) order: team member `member` of TEAM takes rows
// member, member + TEAM, …; a warp skips the tile if its box lies beyond
// each of its queries' kth.
template <int KMAX, int TEAM>
__device__ __forceinline__ void offer_seeded(const float4* tile, int cnt,
                                             const float* __restrict__ tbox, int t,
                                             int member, bool active, float qx,
                                             float qy, float qz, int k,
                                             float (&d)[KMAX], unsigned (&p0)[KMAX],
                                             float& kth, unsigned& kth0) {
  const bool wanted =
      active && !(box_gap2(tbox + (size_t)t * 8, qx, qy, qz, qx, qy, qz) > kth);
  if (!__any_sync(0xffffffffu, wanted) || !wanted) return;
  for (int j = member; j < cnt; j += TEAM) {
    const float4 p = tile[j];
    float dx, dy, dz;
    const float d2 = sq_dist(qx, qy, qz, p.x, p.y, p.z, dx, dy, dz);
    const int idx = __float_as_int(p.w);  // original row index
    if (lex_before(d2, idx, kth, (int)kth0)) {
      topk_insert_lex<KMAX>(d, p0, k, d2, idx);
      kth = topk_slot<KMAX>(d, k - 1);
      kth0 = topk_slot<KMAX>(p0, k - 1);
    }
  }
}

// The ring, the pass's list and its gaps: at least 16 blocks on an SM.
static_assert(2 * kBoxRows * 16 + kCullPass * 9 + 64 <= 232448 / 16,
              "the walk's shared memory keeps fewer than 16 blocks on an SM");

// The passes of a block with at least one active query (the same for all
// its threads): thread tid holds a query with point q (active: a real
// query), whose bound is `reach`; `own` is the block's anchor box, where
// the passes start. A pass culls its kCullPass boxes in parallel against
// the current R (cull_boxes, gap² kept beside each index) and streams the
// live tiles through the two-stage cp.async ring; a live tile whose gap²
// exceeds R, which has tightened since the cull, is not staged. Each staged
// tile goes to offer(tile, rows, tile index), called by all threads. R
// starts at the largest reach and tightens after each pass to the largest
// kth() over the block (each thread's kth() ≤ its reach bounds its query's
// kth distance). The next pass takes the adjacent kCullPass boxes above
// and below in turn.
template <int TEAM, class Offer, class Kth>
__device__ __forceinline__ void walk_passes(const float4* __restrict__ t4, int m,
                                            const float* __restrict__ tbox, int own,
                                            bool active, float qx, float qy, float qz,
                                            float reach, Offer&& offer, Kth&& kth) {
  __shared__ __align__(16) float4 tile[2][kBoxRows];
  __shared__ int live[kCullPass];
  __shared__ float live_gap[kCullPass];
  __shared__ int counts[kCullWords];
  __shared__ float sw[kWalkWarps];

  float lo[3], hi[3];  // the block's query box
  block_box(active, qx, qy, qz, sw, lo, hi);
  float bound = block_max(active ? reach : 0.f, sw);

  const int ntiles = (m + kBoxRows - 1) / kBoxRows;
  constexpr int P = kCullPass;
  // The first pass: P boxes around the anchor (or the first P).
  int below = kOutward ? max(0, min(own - P / 2, ntiles - P)) : 0;
  int above = min(ntiles, below + P);
  int first = below, end = above;
  bool up = true;
  for (;;) {
    const int nlive = cull_boxes(tbox, first, end, lo, hi, bound, live, live_gap, counts);
    // Live tile j goes to ring slot `slot`, one commit group per tile; the
    // next one is the first after it whose gap² is still within R.
    int j = 0;
    while (j < nlive && live_gap[j] > bound) ++j;
    if (j < nlive) stage_tile(tile[0], t4, live[j], m);
    __pipeline_commit();
    int slot = 0;
    while (j < nlive) {
      int next = j + 1;
      while (next < nlive && live_gap[next] > bound) ++next;
      if (next < nlive) stage_tile(tile[slot ^ 1], t4, live[next], m);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of tile j landed
      __syncthreads();           // and every other thread's
      const int tt = live[j];
      offer(tile[slot], min(kBoxRows, m - tt * kBoxRows), tt);
      __syncthreads();  // the slot is read; tile `next + 1` may land there
      j = next;
      slot ^= 1;
    }
    bound = block_max(active ? kth() : 0.f, sw);
    if (above < ntiles && (up || below == 0)) {
      first = above;
      end = above = min(ntiles, above + P);
    } else if (below > 0) {
      end = below;
      first = below = max(0, below - P);
    } else {
      break;
    }
    up = !up;
  }
}

// The walk (walk_passes) with each thread's list (d, p0) in registers:
// the query's reach is the kth smallest d² over the sorted rows wlo, wlo +
// wstep, … below whi (≤ m); on return the list holds the k first of the
// thread's rows within that reach in (d², original index) order, empty slots
// (reach', kNoIndex) with reach' = min(reach, the float below kBig), so that
// one (d², index) compare against the list's end also tests d² ≤ reach and
// d² < kBig (unseed turns them back). The lists are in (d², original index)
// order whatever the order of the tiles. Called by all threads.
template <int KMAX, int TEAM>
__device__ __forceinline__ void walk_sorted(const float4* __restrict__ t4, int m,
                                            const float* __restrict__ tbox, int k,
                                            int wlo, int whi, int wstep, int own,
                                            bool active, float qx, float qy, float qz,
                                            float (&d)[KMAX], unsigned (&p0)[KMAX],
                                            float& kth, unsigned& kth0) {
  const int member = TEAM == 1 ? 0 : (int)threadIdx.x % TEAM;
  float reach = kBig;
  if (active) reach = kth_bound<KMAX>(t4, wlo, whi, wstep, k, qx, qy, qz);
  kth = fminf(reach, nextafterf(kBig, 0.f));
  topk_fill<KMAX>(d, kth);
  walk_passes<TEAM>(
      t4, m, tbox, own, active, qx, qy, qz, reach,
      [&](const float4* tile, int cnt, int tt) {
        offer_seeded<KMAX, TEAM>(tile, cnt, tbox, tt, member, active, qx, qy, qz, k, d,
                                 p0, kth, kth0);
      },
      [&] { return kth; });
}

// Empty slots of a walked list back to (kBig, kNoIndex).
template <int KMAX>
__device__ __forceinline__ void unseed(float (&d)[KMAX], const unsigned (&p0)[KMAX]) {
#pragma unroll
  for (int s = 0; s < KMAX; ++s)
    if (p0[s] == (unsigned)kNoIndex) d[s] = kBig;
}

// One round of the merge of a team's walked lists (aligned groups of TEAM
// threads of a warp): (wd, wi) = the smallest head over the team in (d²,
// original index) order, and the thread that held it advances `head`. k
// rounds give the query's list in slot order. Row indices are unique within
// a team (each row went to one member). Called by every thread of the warp.
template <int KMAX, int TEAM>
__device__ __forceinline__ void team_list_pop(const float (&d)[KMAX],
                                              const unsigned (&p0)[KMAX], int k,
                                              int& head, float& wd, int& wi) {
  const unsigned hi = head < k ? topk_slot<KMAX>(p0, head) : (unsigned)kNoIndex;
  wd = head < k ? topk_slot<KMAX>(d, head) : kBig;
  wi = (int)hi;
#pragma unroll
  for (int off = 1; off < TEAM; off <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, wd, off);
    const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
    if (lex_before(od, oi, wd, wi)) {
      wd = od;
      wi = oi;
    }
  }
  if (wi != kNoIndex && (int)hi == wi) ++head;
}

// ------------------------------------------------------------------------
// Lane lists (K11, K5): every lane keeps a private sorted list of (d², row)
// in shared memory, ld / li [k][32] with one bank per lane; k rounds of an
// arg-min on (d², row) over a team of lanes merge the team's lists. K11's
// lanes see their rows in index order (lane_list_push); K5's see the sorted
// tiles out of index order and insert in (d², row) order
// (lane_list_push_lex). The first forms insert with lane_list_insert.

__device__ __forceinline__ void lane_list_clear(float* ld, int* li, int lane, int k) {
  for (int s = 0; s < k; ++s) {
    ld[s * 32 + lane] = kBig;
    li[s * 32 + lane] = kNoIndex;
  }
}

// Insertion sort in the lane's column: entries ≤ d2 stay ahead. The caller
// has checked d2 < kth, the lane's d[k-1], which is refreshed here.
__device__ __forceinline__ void lane_list_insert(float* ld, int* li, int lane, int k,
                                                 float d2, int idx, float& kth) {
  int s = k - 1;
  while (s > 0 && ld[(s - 1) * 32 + lane] > d2) {
    ld[s * 32 + lane] = ld[(s - 1) * 32 + lane];
    li[s * 32 + lane] = li[(s - 1) * 32 + lane];
    --s;
  }
  ld[s * 32 + lane] = d2;
  li[s * 32 + lane] = idx;
  kth = ld[(k - 1) * 32 + lane];
}

// The new kernels' lists keep a fill count n ≤ k in a register: the slots
// from n on hold what the caller filled them with (kBig / kNoIndex, or a
// seed), so an insertion shifts only over the real entries behind it, and
// the list's last entry is read back only once it is full. The caller has
// checked that (d2, idx) goes in: below the fill value while n < k, below
// the last entry after.
__device__ __forceinline__ void lane_list_push(float* ld, int* li, int lane, int k,
                                               int& n, float d2, int idx) {
  int s = n < k ? n : k - 1;
  while (s > 0 && ld[(s - 1) * 32 + lane] > d2) {
    ld[s * 32 + lane] = ld[(s - 1) * 32 + lane];
    li[s * 32 + lane] = li[(s - 1) * 32 + lane];
    --s;
  }
  ld[s * 32 + lane] = d2;
  li[s * 32 + lane] = idx;
  if (n < k) ++n;
}

// The same in (d², row) order, whatever the order of arrival.
__device__ __forceinline__ void lane_list_push_lex(float* ld, int* li, int lane, int k,
                                                   int& n, float d2, int idx) {
  int s = n < k ? n : k - 1;
  while (s > 0 && lex_before(d2, idx, ld[(s - 1) * 32 + lane], li[(s - 1) * 32 + lane])) {
    ld[s * 32 + lane] = ld[(s - 1) * 32 + lane];
    li[s * 32 + lane] = li[(s - 1) * 32 + lane];
    --s;
  }
  ld[s * 32 + lane] = d2;
  li[s * 32 + lane] = idx;
  if (n < k) ++n;
}

// The m-th smallest (1 ≤ m ≤ 32) of the 32 values v of a warp, to every
// lane: each lane ranks its value by (v, lane) against all 32.
__device__ __forceinline__ float warp_mth_smallest(float v, int m) {
  const int lane = threadIdx.x & 31;
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float o = __shfl_sync(0xffffffffu, v, j);
    rank += (o < v || (o == v && j < lane)) ? 1 : 0;
  }
  const unsigned at = __ballot_sync(0xffffffffu, rank == m - 1);
  return __shfl_sync(0xffffffffu, v, __ffs(at) - 1);
}

// The smallest head over the TEAM lanes of a team (aligned groups of TEAM
// lanes of a warp) in (d², row) order, to every lane of the team; the lane
// that held it advances its head. Exhausted: (kBig, kNoIndex). Called by
// every lane of the warp.
template <int TEAM = 32>
__device__ __forceinline__ void lane_lists_pop(const float* ld, const int* li,
                                               int lane, int k, int& head, float& bd,
                                               int& bi) {
  const int hi = head < k ? li[head * 32 + lane] : kNoIndex;
  bd = head < k ? ld[head * 32 + lane] : kBig;
  bi = hi;
#pragma unroll
  for (int off = TEAM / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (lex_before(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
  // Row indices are unique, so exactly one lane holds a real winner.
  if (bi != kNoIndex && hi == bi) ++head;
}

}  // namespace sgt

// The box geometry that the Python prologue and plain versions repeat
// (ops/morton_boxes.py): out[0..2] = sorted rows per box, queries per block,
// boxes per cull pass. Every library built on this header exports it.
extern "C" int sgt_box_geometry(int* out) {
  out[0] = sgt::kBoxRows;
  out[1] = sgt::kPrunedThreads;
  out[2] = sgt::kCullPass;
  return 0;
}
