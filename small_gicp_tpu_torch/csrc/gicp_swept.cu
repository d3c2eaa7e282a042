// Fused GICP correspondence search + linearize for map-scale targets (K6),
// hand-written for Hopper (sm_90a).
//
// Replaces small_gicp_tpu/ops/gicp_fused_pallas.py `_fused_kernel` (the
// grid-swept search with in-kernel box pruning that gicp_linearize_tables
// takes for targets too large for the listed kernel) + `_fused_finalize`:
// K1's outputs — per-block sums [H | b | e | inliers] and frozen rows
// corr = [μ 3 | W 9 | mask | d² | 0 0] in original source order — over a
// target of millions of rows, of which a scan can only match the few within
// the rejector radius.
//
// What bounds it: the pairs that box pruning cannot avoid on the data
// (operations): for every block of source rows, the target rows of the tiles
// within max_dist of the block. The prologue (gicp_prepare) sorts the target
// by Morton code into compact rows (x y z | original index), boxes every 256
// sorted rows, and sorts the source rows likewise (a permutation only: the
// tables stay in original order). A source block is 64 consecutive sorted
// source rows; a scan against a map has a few hundred, too few to fill the
// card one block each, so each gets `chunks` blocks on the grid's second
// dimension (the wrapper's plan, from the valid source blocks and the SM
// count). Every chunk transforms the block's rows, reduces the box of the
// valid ones and culls the target's boxes in passes of kCullPass, in
// parallel (common.cuh's cull_boxes: gap² > max_d2 culls, a NaN gap keeps
// the tile, the live tiles compacted in ascending order), and scans every
// chunks-th live tile of the block starting at its own index — the live
// tiles of a scan block are a few short runs in Morton order, so chunks
// interleave rather than take contiguous ranges — streamed through a
// two-stage cp.async ring. Within a staged tile a warp skips the rows if the
// tile's box is farther from each of its points than that point's best d²
// so far, or than max_d2. Candidates need d² ≤ max_d2 and win in (d²,
// original index) order, so that the winner is K1's on every row K1
// accepts; the gap² between boxes never exceeds the d² of a pair inside
// them (common.cuh), so no acceptable row is skipped.
//
// The chunks merge in the launch: each posts its rows' winners as a 64-bit
// key (d²'s bits over the original row) by atomicMin into a per-row word,
// so the smaller d² wins and a tie goes to the lower row in any block
// order. The last chunk of a source block (a ticket) reads and resets its
// 64 keys and its ticket, gathers the winner's payload from the table in
// original order, and runs K1's finalize, which writes corr and the
// block's partial sums exactly as the one-block-per-source-block first
// form did. One chunk skips the keys. A row without an accepted
// correspondence (rejected, padding, empty target) holds zeros and
// d² = 3e38: its nearest row may lie in a tile that was never scanned.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "gicp_common.cuh"

namespace {

using namespace sgt;

static_assert(kLinThreads == kPrunedThreads, "block_max reduces a linearize block");

// ttab [M,16] and qtab [N,16] in original order (K1's tables); tsorted [M,4]:
// Morton-sorted target rows x y z | original index, the first *tnum valid;
// tbox [ceil(M / 256), 8]; sperm [N]: sorted position → source row, valid rows
// first; pose [12]; corr [N,16] in original order; partials [blocks, 44].
// The first form: one source block per block, the target's boxes
// tested one after another, each live tile staged synchronously. Kept as the
// yardstick of the kernel below (entry sgt_gicp_linearize_swept_v1); on no
// path.
template <int FACTOR, int ROBUST>
__global__ void __launch_bounds__(kLinThreads)
gicp_linearize_swept_kernel_v1(const float* __restrict__ ttab,
                            const float* __restrict__ tsorted,
                            const float* __restrict__ tbox,
                            const int* __restrict__ tnum, int mcap,
                            const float* __restrict__ qtab,
                            const int* __restrict__ sperm,
                            const int* __restrict__ qnum, int n,
                            const float* __restrict__ pose, float max_d2,
                            float robust_c, float* __restrict__ corr,
                            float* __restrict__ partials) {
  __shared__ float4 tile[kBoxRows];
  __shared__ float sw[kLinThreads / 32];
  __shared__ float red[kLinThreads / 32][kLinRed];

  const int i = blockIdx.x * kLinThreads + threadIdx.x;  // sorted position
  partials += (size_t)blockIdx.x * kLinOut;
  const int m = min(*tnum, mcap);
  const int nv = min(n, *qnum);
  const bool active = i < nv;
  const bool block_active = blockIdx.x * kLinThreads < nv;  // uniform
  const int row = i < n ? sperm[i] : 0;
  const float* qrow = i < n ? qtab + (size_t)row * 16 : nullptr;

  float r[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];

  float px = 0.f, py = 0.f, pz = 0.f;
  if (qrow) {
    const float4 p4 = *reinterpret_cast<const float4*>(qrow);
    px = p4.x;
    py = p4.y;
    pz = p4.z;
  }
  const float qx = affine_row(r + 0, t[0], px, py, pz);
  const float qy = affine_row(r + 3, t[1], px, py, pz);
  const float qz = affine_row(r + 6, t[2], px, py, pz);

  float best_d = kBig;
  int best = kNoIndex;
  if (block_active) {
    float lo[3], hi[3];  // the box of the block's transformed valid points
    block_box(active, qx, qy, qz, sw, lo, hi);
    const float4* t4 = reinterpret_cast<const float4*>(tsorted);
    const int ntiles = (m + kBoxRows - 1) / kBoxRows;
    for (int tt = 0; tt < ntiles; ++tt) {
      const float* box = tbox + (size_t)tt * 8;
      // The same for every thread of the block.
      if (box_gap2(box, lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]) > max_d2) continue;
      const int base = tt * kBoxRows;
      const int cnt = min(kBoxRows, m - base);
      __syncthreads();
      for (int j = threadIdx.x; j < cnt; j += kLinThreads) tile[j] = t4[base + j];
      __syncthreads();
      const bool wanted = active && !(box_gap2(box, qx, qy, qz, qx, qy, qz) >
                                      fminf(best_d, max_d2));
      if (!__any_sync(0xffffffffu, wanted)) continue;
      if (!wanted) continue;
      for (int j = 0; j < cnt; ++j) {
        const float4 tp = tile[j];
        float dx, dy, dz;
        const float d2 = sq_dist(qx, qy, qz, tp.x, tp.y, tp.z, dx, dy, dz);
        const int idx = __float_as_int(tp.w);  // original target row
        if (d2 <= max_d2 && lex_before(d2, idx, best_d, best)) {
          best_d = d2;
          best = idx;
        }
      }
    }
  }

  linearize_finalize<FACTOR, ROBUST, true>(
      ttab, qrow, active, best == kNoIndex ? -1 : best, best_d, r, qx, qy, qz, px, py,
      pz, max_d2, robust_c, i < n ? corr + (size_t)row * 16 : nullptr, partials, red);
}

// A row's winner as the 64-bit key of the merge: d²'s bits (d² ≥ +0, and
// -0 + 0 = +0, so they order as the floats) over the original row.
__device__ __forceinline__ unsigned long long swept_key(float d2, int row) {
  return ((unsigned long long)__float_as_uint(__fadd_rn(d2, 0.f)) << 32) |
         (unsigned)row;
}

// Called by every thread after its chunk posted its winners: true in the
// block of source block blockIdx.x that finished last among its chunks.
__device__ __forceinline__ bool last_chunk(unsigned* tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  return last;
}

// The launch of sgt_gicp_linearize_swept: chunk blockIdx.y of source block
// blockIdx.x. Arguments as the first form's, and keys [n] (~0 between
// launches) and tickets [blocks] (0 between launches).
template <int FACTOR, int ROBUST>
__global__ void __launch_bounds__(kLinThreads)
gicp_linearize_swept_kernel(const float* __restrict__ ttab,
                            const float* __restrict__ tsorted,
                            const float* __restrict__ tbox,
                            const int* __restrict__ tnum, int mcap,
                            const float* __restrict__ qtab,
                            const int* __restrict__ sperm,
                            const int* __restrict__ qnum, int n,
                            const float* __restrict__ pose, float max_d2,
                            float robust_c, float* __restrict__ corr,
                            float* __restrict__ partials,
                            unsigned long long* __restrict__ keys,
                            unsigned* __restrict__ tickets) {
  __shared__ __align__(16) float4 tile[2][kBoxRows];
  __shared__ int live[kCullPass];
  __shared__ int counts[kCullWords];
  __shared__ float sw[kLinThreads / 32];
  __shared__ float red[kLinThreads / 32][kLinRed];

  const int i = blockIdx.x * kLinThreads + threadIdx.x;  // sorted position
  partials += (size_t)blockIdx.x * kLinOut;
  const int m = min(*tnum, mcap);
  const int nv = min(n, *qnum);
  const bool active = i < nv;
  const bool block_active = blockIdx.x * kLinThreads < nv;  // uniform
  // Chunk 0 of a source block without a valid row writes its zero rows.
  if (!block_active && blockIdx.y > 0) return;
  const int row = i < n ? sperm[i] : 0;
  const float* qrow = i < n ? qtab + (size_t)row * 16 : nullptr;

  float r[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];

  float px = 0.f, py = 0.f, pz = 0.f;
  if (qrow) {
    const float4 p4 = *reinterpret_cast<const float4*>(qrow);
    px = p4.x;
    py = p4.y;
    pz = p4.z;
  }
  const float qx = affine_row(r + 0, t[0], px, py, pz);
  const float qy = affine_row(r + 3, t[1], px, py, pz);
  const float qz = affine_row(r + 6, t[2], px, py, pz);

  float best_d = kBig;
  int best = kNoIndex;
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
      if (mine > 0) stage_tile(tile[0], t4, live[j0], m);
      __pipeline_commit();
      for (int c = 0; c < mine; ++c) {
        if (c + 1 < mine) stage_tile(tile[(c + 1) & 1], t4, live[j0 + (c + 1) * chunks], m);
        __pipeline_commit();
        __pipeline_wait_prior(1);  // this thread's copies of tile c landed
        __syncthreads();           // and every other thread's
        const int tt = live[j0 + c * chunks];
        nearest_in_tile(tile[c & 1], min(kBoxRows, m - tt * kBoxRows), tbox, tt, active,
                        qx, qy, qz, max_d2, best_d, best);
        __syncthreads();  // slot c & 1 is read; tile c + 2 may land there
      }
      before += nlive;
    }
  }

  if (gridDim.y > 1 && block_active) {
    // Post the chunk's winners, the smallest key kept: ties to the lower
    // row, in any order of the chunks.
    if (active && best != kNoIndex) atomicMin(keys + i, swept_key(best_d, best));
    if (!last_chunk(tickets)) return;
    best_d = kBig;
    best = kNoIndex;
    if (active) {
      const unsigned long long key = __ldcg(keys + i);
      keys[i] = ~0ull;
      if (key != ~0ull) {
        best_d = __uint_as_float((unsigned)(key >> 32));
        best = (int)(key & 0xffffffffu);
      }
    }
    if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
  }

  linearize_finalize<FACTOR, ROBUST, true>(
      ttab, qrow, active, best == kNoIndex ? -1 : best, best_d, r, qx, qy, qz, px, py,
      pz, max_d2, robust_c, i < n ? corr + (size_t)row * 16 : nullptr, partials, red);
}

template <int F, int RB>
void launch_swept(dim3 grid, cudaStream_t stream, const float* ttab,
                  const float* tsorted, const float* tbox, const int* tnum, int mcap,
                  const float* qtab, const int* sperm, const int* qnum, int n,
                  const float* pose, float max_d2, float robust_c, float* corr,
                  float* partials, unsigned long long* keys, unsigned* tickets) {
  if (keys)
    gicp_linearize_swept_kernel<F, RB><<<grid, kLinThreads, 0, stream>>>(
        ttab, tsorted, tbox, tnum, mcap, qtab, sperm, qnum, n, pose, max_d2, robust_c,
        corr, partials, keys, tickets);
  else
    gicp_linearize_swept_kernel_v1<F, RB><<<grid.x, kLinThreads, 0, stream>>>(
        ttab, tsorted, tbox, tnum, mcap, qtab, sperm, qnum, n, pose, max_d2, robust_c,
        corr, partials);
}

using SweptLaunch = void (*)(dim3, cudaStream_t, const float*, const float*,
                             const float*, const int*, int, const float*, const int*,
                             const int*, int, const float*, float, float, float*,
                             float*, unsigned long long*, unsigned*);

const SweptLaunch kSwept[3][3] = {
    {launch_swept<kGicp, kNone>, launch_swept<kGicp, kHuber>,
     launch_swept<kGicp, kCauchy>},
    {launch_swept<kPlaneIcp, kNone>, launch_swept<kPlaneIcp, kHuber>,
     launch_swept<kPlaneIcp, kCauchy>},
    {launch_swept<kIcp, kNone>, launch_swept<kIcp, kHuber>,
     launch_swept<kIcp, kCauchy>},
};

}  // namespace

extern "C" {

// K6: one pair, one pose, `chunks` chunk blocks per source block (1 to
// 65,535); partials [ceil(n / 64), 44]; keys [n] int64, ~0 between
// launches; tickets [ceil(n / 64)] int32, 0 between launches (each launch
// leaves them so). Returns cudaGetLastError() after the launch.
int sgt_gicp_linearize_swept(const float* ttab, const float* tsorted,
                             const float* tbox, const int* tnum, int mcap,
                             const float* qtab, const int* sperm, const int* qnum,
                             int n, const float* pose, float max_d2, float robust_c,
                             int factor, int robust, int chunks, float* corr,
                             float* partials, unsigned long long* keys,
                             unsigned* tickets, void* stream) {
  if (factor < 0 || factor > 2 || robust < 0 || robust > 2 || n <= 0 || mcap < 0 ||
      chunks < 1 || chunks > 65535 || !keys || !tickets)
    return (int)cudaErrorInvalidValue;
  kSwept[factor][robust](dim3((n + kLinThreads - 1) / kLinThreads, chunks),
                         (cudaStream_t)stream, ttab, tsorted, tbox, tnum, mcap, qtab,
                         sperm, qnum, n, pose, max_d2, robust_c, corr, partials, keys,
                         tickets);
  return (int)cudaGetLastError();
}

// K6's first form: one block per source block, no chunks, keys or tickets.
int sgt_gicp_linearize_swept_v1(const float* ttab, const float* tsorted,
                                const float* tbox, const int* tnum, int mcap,
                                const float* qtab, const int* sperm, const int* qnum,
                                int n, const float* pose, float max_d2, float robust_c,
                                int factor, int robust, float* corr, float* partials,
                                void* stream) {
  if (factor < 0 || factor > 2 || robust < 0 || robust > 2 || n <= 0 || mcap < 0)
    return (int)cudaErrorInvalidValue;
  kSwept[factor][robust](dim3((n + kLinThreads - 1) / kLinThreads), (cudaStream_t)stream,
                         ttab, tsorted, tbox, tnum, mcap, qtab, sperm, qnum, n, pose,
                         max_d2, robust_c, corr, partials, nullptr, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
