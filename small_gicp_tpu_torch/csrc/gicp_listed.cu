// Fused GICP correspondence search + linearize of the listed route (K1 and
// its score form), hand-written for Hopper (sm_90a).
//
// Replaces small_gicp_tpu/ops/gicp_fused_pallas.py `_fused_kernel_listed`
// (its XLA-side lists of the live target tiles of each source block, built
// at :836-866) + `_fused_finalize`: exact 1-NN of T·p among the valid
// target rows within the rejector radius, then the per-point weight W, the
// rejector mask d² ≤ max_d2, the optional Huber/Cauchy weight w(√e),
// J = [R·skew(p) | −R], the sums [H 36 | b 6 | e | inliers] in float64 and
// the frozen rows corr = [μ 3 | W 9 | mask | d² | 0 0] in original source
// order — over a scan-sized target.
//
// What bounds it: the pairs that box pruning cannot avoid on the data
// (operations, ~9 a pair): for every block of source rows, the target rows
// of the tiles within max_dist of the block, a few per cent of Q·M for a
// scan against the next. The tables (gicp_prepare) carry the target sorted
// by Morton code into compact rows (x y z | original index), a box for
// every 256 sorted rows, and the source's Morton order (a permutation: the
// tables stay in original order); a KdTree over the target keeps that sort
// from the covariance stage. The walk is K6's (gicp_common.cuh's
// chunked_nearest; the Pallas listed and swept kernels share one walk too):
// a source block is 64
// consecutive sorted source rows, and each has `chunks` blocks on the
// grid's second dimension (the wrapper's plan from the valid source rows,
// read once per tables, and the SM count), so that a scan's ~340 source
// blocks fill the card. Every chunk transforms the block's rows, reduces
// the box of the valid ones, culls the target's boxes in passes of
// kCullPass in parallel (common.cuh's cull_boxes: gap² > max_d2 culls, a NaN
// gap keeps the tile, so a radius of inf walks every tile), and scans every
// chunks-th live tile through a two-stage cp.async ring; within a staged
// tile a warp skips the rows if the tile's box is farther from each of its
// points than that point's best d² so far, or than max_d2. Candidates need
// d² ≤ max_d2 and win in (d², original index) order, so the winner is the
// first form's on every row the first form accepts. The chunks post their
// winners as 64-bit keys (d²'s bits over the original row) by atomicMin;
// the last chunk of a source block (a ticket) reads and resets its keys,
// gathers the winner's payload from the table in original order and runs
// the shared finalize (gicp_common.cuh), which writes corr and the block's
// float32 partial sums. The last source block to finish (a second ticket)
// sums the valid blocks' partials in block order in float64 — no float
// atomics, and no torch op after the launch — and resets the ticket. A row
// without an accepted correspondence (rejected, padding, empty target)
// holds zeros and d² = 3e38, as K6's and K7's do: its nearest row may lie
// in a tile that was never scanned.
//
// The score form (SCORE, the `mxu_dist` branch of `_fused_kernel_listed`)
// walks the same boxes with the same chunks, merge and finalize, and ranks
// the candidates by the uncentred score ‖t‖² − 2 t·q (‖t‖² as gicp_prepare
// writes it into ttab column 13, gathered by the wrapper into the target's
// sorted order once per tables and staged through the ring beside the
// tiles). Every row of a tile within max_d2 of the point is a candidate
// (the score is not a distance, so the difference form's skip of tiles
// beyond the best d² so far does not hold for it); winners merge on (score
// made orderable, original row) and the winner's exact d² is taken
// afterwards for the rejector and corr. The score is formed on CUDA cores
// with the rounded operations of the plain version: a tensor-core product
// would have a reduction depth of only 4 (x, y, z, 1), and TF32 keeps about
// three digits, too few to rank neighbours at 100 m coordinates, while a
// 3xTF32 split triples the work on the few pairs the walk leaves. A row
// whose brute-force winner lies within max_d2 gets that winner here too
// (its tile is within max_d2 of the row, so it is scanned); a row whose
// winner is rejected holds zeros and d² = 3e38, as in the difference form.
//
// Against the first forms (gicp_fused.cu's gicp_linearize_kernel<…,
// false|true>, kept for the brute-force lane entries and as the
// yardsticks of both forms): those gave each source row a thread in row
// order and scanned every valid target row. The pose comes as the caller's
// 4×4 matrix, read in place.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "gicp_common.cuh"

namespace {

using namespace sgt;

// ttab [M,16] and qtab [N,16] in original order; tsorted [M,4] Morton-sorted
// target rows x y z | original index, the first *tnum valid; tbox [ceil(M /
// 256), 8]; sperm [N] sorted position → source row, valid rows first; pose
// [4,4] row-major; corr [N,16] in original order; partials [blocks, 44];
// keys [N] (~0 between launches); tickets [blocks + 1] (0 between
// launches); sums [44] float64. Chunk blockIdx.y of source block blockIdx.x.
// SCORE: tnorm [ceil(M / 256) · 256] holds ‖t‖² of the sorted target rows.
template <int FACTOR, int ROBUST, bool SCORE>
__global__ void __launch_bounds__(kLinThreads)
gicp_linearize_listed_kernel(const float* __restrict__ ttab,
                             const float* __restrict__ tsorted,
                             const float* __restrict__ tnorm,
                             const float* __restrict__ tbox,
                             const int* __restrict__ tnum, int mcap,
                             const float* __restrict__ qtab,
                             const int* __restrict__ sperm,
                             const int* __restrict__ qnum, int n,
                             const float* __restrict__ pose, float max_d2,
                             float robust_c, float* __restrict__ corr,
                             float* __restrict__ partials,
                             unsigned long long* __restrict__ keys,
                             unsigned* __restrict__ tickets,
                             double* __restrict__ sums) {
  __shared__ float red[kLinThreads / 32][kLinRed];

  const int i = blockIdx.x * kLinThreads + threadIdx.x;  // sorted position
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
  for (int k = 0; k < 9; ++k) r[k] = pose[(k / 3) * 4 + k % 3];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose[k * 4 + 3];

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

  float best_d;
  int best;
  if (!chunked_nearest<SCORE>(tsorted, tbox, m, block_active, active, i, qx, qy, qz,
                              max_d2, keys, tickets, best_d, best, tnorm))
    return;  // a chunk whose winners another chunk finishes
  if (SCORE && best != kNoIndex) {
    // The score only ranks; the rejector and corr take the winner's exact d².
    const float* row = ttab + (size_t)best * 16;
    float dx, dy, dz;
    best_d = sq_dist(qx, qy, qz, row[0], row[1], row[2], dx, dy, dz);
  }

  linearize_finalize<FACTOR, ROBUST, true>(
      ttab, qrow, active, best == kNoIndex ? -1 : best, best_d, r, qx, qy, qz, px, py,
      pz, max_d2, robust_c, i < n ? corr + (size_t)row * 16 : nullptr,
      partials + (size_t)blockIdx.x * kLinOut, red);

  // Every source block arrives here once (its last chunk, or chunk 0 of a
  // block without a valid row); the last one sums the valid blocks'
  // partials in block order in float64 (the others' are zero).
  if (!last_arrival(tickets + gridDim.x, gridDim.x)) return;
  const int valid_blocks = (nv + kLinThreads - 1) / kLinThreads;
  if (threadIdx.x < kLinOut) {
    double acc = 0.0;
    for (int b = 0; b < valid_blocks; ++b)
      acc += (double)__ldcg(partials + (size_t)b * kLinOut + threadIdx.x);
    sums[threadIdx.x] = acc;
  }
  if (threadIdx.x == 0) tickets[gridDim.x] = 0u;
}

template <int F, int RB, bool SCORE>
void launch_listed(dim3 grid, cudaStream_t stream, const float* ttab,
                   const float* tsorted, const float* tnorm, const float* tbox,
                   const int* tnum, int mcap, const float* qtab, const int* sperm,
                   const int* qnum, int n, const float* pose, float max_d2,
                   float robust_c, float* corr, float* partials,
                   unsigned long long* keys, unsigned* tickets, double* sums) {
  gicp_linearize_listed_kernel<F, RB, SCORE><<<grid, kLinThreads, 0, stream>>>(
      ttab, tsorted, tnorm, tbox, tnum, mcap, qtab, sperm, qnum, n, pose, max_d2,
      robust_c, corr, partials, keys, tickets, sums);
}

using ListedLaunch = void (*)(dim3, cudaStream_t, const float*, const float*,
                              const float*, const float*, const int*, int,
                              const float*, const int*, const int*, int, const float*,
                              float, float, float*, float*, unsigned long long*,
                              unsigned*, double*);

#define SGT_LISTED_ROW(F, S) \
  {launch_listed<F, kNone, S>, launch_listed<F, kHuber, S>, launch_listed<F, kCauchy, S>}
// [score form][factor][robust]
const ListedLaunch kListed[2][3][3] = {
    {SGT_LISTED_ROW(kGicp, false), SGT_LISTED_ROW(kPlaneIcp, false),
     SGT_LISTED_ROW(kIcp, false)},
    {SGT_LISTED_ROW(kGicp, true), SGT_LISTED_ROW(kPlaneIcp, true),
     SGT_LISTED_ROW(kIcp, true)},
};
#undef SGT_LISTED_ROW

int listed(bool score, const float* ttab, const float* tsorted, const float* tnorm,
           const float* tbox, const int* tnum, int mcap, const float* qtab,
           const int* sperm, const int* qnum, int n, const float* pose, float max_d2,
           float robust_c, int factor, int robust, int chunks, float* corr,
           float* partials, unsigned long long* keys, unsigned* tickets, double* sums,
           void* stream) {
  if (factor < 0 || factor > 2 || robust < 0 || robust > 2 || n <= 0 || mcap < 0 ||
      chunks < 1 || chunks > 65535 || !keys || !tickets || !sums || (score && !tnorm))
    return (int)cudaErrorInvalidValue;
  kListed[score][factor][robust](dim3((n + kLinThreads - 1) / kLinThreads, chunks),
                                 (cudaStream_t)stream, ttab, tsorted, tnorm, tbox, tnum,
                                 mcap, qtab, sperm, qnum, n, pose, max_d2, robust_c,
                                 corr, partials, keys, tickets, sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: one pair at one pose [4,4]; `chunks` chunk blocks per source block (1
// to 65,535); partials [ceil(n / 64), 44]; keys [n] int64, ~0 between
// launches; tickets [ceil(n / 64) + 1] int32, 0 between launches (each
// launch leaves them so); sums [44] float64. Returns cudaGetLastError()
// after the launch.
int sgt_gicp_linearize_listed(const float* ttab, const float* tsorted,
                              const float* tbox, const int* tnum, int mcap,
                              const float* qtab, const int* sperm, const int* qnum,
                              int n, const float* pose, float max_d2, float robust_c,
                              int factor, int robust, int chunks, float* corr,
                              float* partials, unsigned long long* keys,
                              unsigned* tickets, double* sums, void* stream) {
  return listed(false, ttab, tsorted, nullptr, tbox, tnum, mcap, qtab, sperm, qnum, n,
                pose, max_d2, robust_c, factor, robust, chunks, corr, partials, keys,
                tickets, sums, stream);
}

// K1's score form: the same arguments and tnorm [ceil(mcap / 256) · 256],
// ‖t‖² of the sorted target rows (ttab column 13 gathered by tsorted's
// original rows), zeros beyond them.
int sgt_gicp_linearize_listed_score(const float* ttab, const float* tsorted,
                                    const float* tnorm, const float* tbox,
                                    const int* tnum, int mcap, const float* qtab,
                                    const int* sperm, const int* qnum, int n,
                                    const float* pose, float max_d2, float robust_c,
                                    int factor, int robust, int chunks, float* corr,
                                    float* partials, unsigned long long* keys,
                                    unsigned* tickets, double* sums, void* stream) {
  return listed(true, ttab, tsorted, tnorm, tbox, tnum, mcap, qtab, sperm, qnum, n, pose,
                max_d2, robust_c, factor, robust, chunks, corr, partials, keys, tickets,
                sums, stream);
}

}  // extern "C"
